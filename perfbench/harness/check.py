"""What decides `correct`: the sampled outputs of the timed path against
the plain reference, every number compared beside its limit.

Outputs are exact integers, so the comparison is exact: a spike bit or a
membrane that differs anywhere is a mismatch, and the limit of each
mismatch count is 0. A run also has to have compared something
(`checked`, at least its limit) and every attempt has to have answered
(`failed`, at most 0)."""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.reference import threefry
from perfbench.reference.snn import PlainSNN

SCRATCH_FOLD = 2 ** 31 - 1      # the stream root of stateless requests
BLOCK = 32                      # reference lanes at once


@dataclass
class Sample:
    """One sampled unit of the timed path's output: a session of a
    resident lane (`lane` >= 0) or a stateless request (`lane` -1 and
    its `seed`), its schedule (T', A), the program's spikes packed a
    window at a time, and its final membranes."""
    lane: int
    seed: int
    counts: np.ndarray
    packed: list = field(default_factory=list)
    membrane: np.ndarray = None


def pack(spikes: np.ndarray) -> np.ndarray:
    return np.packbits(spikes, axis=None)


def start_keys(dep_seed: int, samples, device) -> torch.Tensor:
    """Each sample's first key: a lane's fold(root, lane); a stateless
    request's fold(fold(root, 2**31 - 1), its seed)."""
    root = threefry.root(dep_seed, device)
    lanes = torch.as_tensor([max(s.lane, 0) for s in samples],
                            device=device)
    req = torch.as_tensor([s.seed for s in samples], device=device)
    resident = fold_keys(root, lanes)
    scratch = fold_keys(threefry.fold(root, SCRATCH_FOLD), req)
    is_lane = torch.as_tensor([s.lane >= 0 for s in samples],
                              device=device)[:, None]
    return torch.where(is_lane, resident, scratch)


def fold_keys(key, data):
    return threefry.fold(key.expand(data.shape[0], 2), data)


def reference_outputs(net, dep_seed: int, samples, device, bits: int):
    """The reference's (packed windows, membrane) for each sample, run
    in blocks of equal length."""
    ref = PlainSNN(net, device, bits=bits)
    out = [None] * len(samples)
    by_len = {}
    for i, s in enumerate(samples):
        by_len.setdefault(s.counts.shape[0], []).append(i)
    for _, idx in sorted(by_len.items()):
        for b in range(0, len(idx), BLOCK):
            blk = idx[b:b + BLOCK]
            keys = start_keys(dep_seed, [samples[i] for i in blk], device)
            counts = np.stack([samples[i].counts for i in blk])
            spikes, V = ref.run(keys, counts)
            spikes, V = spikes.cpu().numpy(), V.cpu().numpy()
            for j, i in enumerate(blk):
                T = len(samples[i].packed)
                win = spikes.shape[1] // max(T, 1)
                out[i] = ([pack(spikes[j, w * win:(w + 1) * win])
                           for w in range(T)], V[j])
    return out


def mismatches(samples, ref_out):
    """(spike bits that differ, membranes that differ) over the samples."""
    bits = memb = 0
    for s, (packed, V) in zip(samples, ref_out):
        for a, b in zip(s.packed, packed):
            bits += int(np.unpackbits(np.bitwise_xor(a, b)).sum())
        memb += int((np.asarray(s.membrane) != V).sum())
    return bits, memb


def compare(net, dep_seed: int, samples, failed: int, min_checked: int,
            device) -> dict:
    """The numbers compared, each {"value", "limit", "op"}."""
    ref_out = reference_outputs(net, dep_seed, samples, device,
                                net.membrane_bits)
    spike_bits, memb = mismatches(samples, ref_out)
    return {
        "spike_mismatch": {"value": spike_bits, "limit": 0, "op": "<="},
        "membrane_mismatch": {"value": memb, "limit": 0, "op": "<="},
        "failed": {"value": failed, "limit": 0, "op": "<="},
        "checked": {"value": len(samples), "limit": min_checked,
                    "op": ">="},
    }


def control_samples(net, dep_seed: int, samples, device) -> list:
    """The control in the program's place: each sample's outputs as the
    reference gives them with membranes of the next precision below the
    configuration's (16 bits for its 32), over the same schedules and
    streams."""
    out = reference_outputs(net, dep_seed, samples, device,
                            net.membrane_bits // 2)
    return [Sample(lane=s.lane, seed=s.seed, counts=s.counts, packed=p,
                   membrane=V) for s, (p, V) in zip(samples, out)]


def holds(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["op"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())


def report(checks: dict) -> None:
    """The numbers compared, as the last lines on standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']} {c['op']} {c['limit']}",
              file=sys.stderr, flush=True)


def sample_flags(rng, n: int, share: float) -> np.ndarray:
    """Which of n units (sessions or requests) are compared, from the
    seed: each with probability `share`."""
    return rng.random(n) < share
