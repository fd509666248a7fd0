"""The multi-rank half of tests/test_torch_mesh_runtime.py and
tests/test_torch_distributed_engine.py: gloo ranks on the CPU, started
from a `FileStore`, that never import jax.

    python tests/_torch_mesh_ranks.py mesh CASES_DIR STORE WORLD
    python tests/_torch_mesh_ranks.py pod CASES_NPZ STORE WORLD

`mesh`: every `case*.npz` in CASES_DIR holds a JAX-compiled mesh
artifact's path and the JAX package's outputs for one input sequence
(steps, run, run_batch, two run_lanes windows, a weight write and one
more run); every rank deploys the artifact at each n_devices in
{1, 2, 4, 8} that divides its cores, on both wires, replays the sequence
and holds every output (spikes, V, lane state, reads, per-level traffic,
`shard_rebuilds`) to the reference exactly. `pod`: the pod-scale step on
a (data 2, model WORLD / 2) mesh at each n_loc of CASES_NPZ (one
word-aligned, one not), each rank's V and spikes held, step by step, to
the JAX package's `small_reference_step` on the rank's window and
shard, which CASES_NPZ holds. Prints MESH-RANKS-OK when every rank
passed.
"""
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.compile import CompiledNetwork  # noqa: E402
from repro_torch.core.deploy import deploy  # noqa: E402
from repro_torch.distributed import mesh  # noqa: E402

def replay(dep, ref) -> dict:
    """The reference's input sequence on `dep` (a `Deployment` of either
    package, V read through numpy); returns what it gave."""
    out = {"step_spikes": [], "step_V": []}
    A = ref["step_counts"].shape[1]
    for c in ref["step_counts"]:
        out["step_spikes"].append(dep.step(np.repeat(np.arange(A), c)))
        out["step_V"].append(np.asarray(dep.V))
    out["run_spikes"] = dep.run(ref["run_counts"])
    out["run_V"] = np.asarray(dep.V)
    out["batch_spikes"] = dep.run_batch(ref["batch_counts"])
    dep.alloc_lanes(3)
    spk, V = [], []
    for w, win in enumerate(ref["lane_windows"]):
        s, v = dep.run_lanes([2, -1, 0], win, seeds=[0, 5 + w, 0])
        spk.append(s)
        V.append(v)
    out["lane_spikes"], out["lane_V"] = np.stack(spk), np.stack(V)
    st = dep.lane_state()
    out["lane_state_V"], out["lane_state_keys"] = st["V"], st["keys"]
    dep.write_synapses(ref["write_pre"], ref["write_post"], ref["write_w"])
    out["after_spikes"] = dep.run(ref["after_counts"])
    out["after_V"] = np.asarray(dep.V)
    out["read_back"] = dep.read_synapses(ref["write_pre"],
                                         ref["write_post"])
    out["read_membrane"] = np.asarray(dep.read_membrane(
        range(dep.compiled.n_neurons)))
    c = dep.counter
    out["counters"] = np.asarray([c.pointer_reads, c.row_reads,
                                  c.timesteps] + list(c.level_events),
                                 np.int64)
    for k in ("step_spikes", "step_V"):
        out[k] = np.stack(out[k])
    return out


def mesh_suite(rank: int, world: int, cases_dir: str) -> None:
    from repro_torch.serve import SpikeServer
    torch.set_num_threads(1)
    for path in sorted(Path(cases_dir).glob("case*.npz")):
        with np.load(path) as z:
            ref = {k: z[k] for k in z.files}
        art = str(ref.pop("artifact"))
        C = int(ref["n_cores"])
        for n_dev in [d for d in (1, 2, 4, 8) if C % d == 0 and d <= world]:
            for packed in (True, False):
                c = CompiledNetwork.load(art)
                assert c.target == "mesh"
                dep = deploy(c, seed=int(ref["seed"]), device="cpu",
                             n_devices=n_dev, packed=packed)
                impl = dep.impl
                assert impl.n_devices == n_dev and impl.world_size == world
                assert len(impl._stages) == len(
                    ref[f"stages_{n_dev}"]), (n_dev, impl._stages)
                got = replay(dep, ref)
                where = f"{path.name} n_devices={n_dev} packed={packed} " \
                        f"rank {rank}"
                for k, v in got.items():
                    np.testing.assert_array_equal(v, ref[k],
                                                  err_msg=f"{k}: {where}")
                cores = c.neuron_core[ref["write_post"]]
                want = np.unique(cores // impl.cores_per_device).size
                assert impl.shard_rebuilds == want, \
                    (where, impl.shard_rebuilds, want)
        # a server cannot hold a multi-rank deployment (ROADMAP item 7b)
        try:
            SpikeServer().add_model("m", CompiledNetwork.load(art),
                                    window=2, device="cpu")
        except NotImplementedError as e:
            assert "item 7b" in str(e), e
        else:
            raise AssertionError("a multi-rank SpikeServer did not raise")


def pod_suite(rank: int, world: int, cases: str) -> None:
    from repro_torch.core import distributed_engine as de
    torch.set_num_threads(1)
    with np.load(cases) as z:
        ref = {k: z[k] for k in z.files}
    m = de.make_mesh((2, world // 2), ("data", "model"), "cpu")
    lin = m.get_local_rank("data") * (world // 2) + \
        m.get_local_rank("model")
    for n_loc in ref["n_locs"]:
        cfg = de.SNNShardConfig(n_neurons=world * int(n_loc), block=64,
                                fan_window_blocks=2)
        sl = slice(lin * n_loc, (lin + 1) * n_loc)
        state = {k: torch.as_tensor(ref[f"{n_loc}_{k}"][..., sl].copy())
                 for k in ("V", "theta", "lam", "weights", "spikes")}
        step = de.make_snn_step(cfg, m)
        for s in range(ref[f"{n_loc}_want_V"].shape[0]):
            state = step(state, prng.fold_in(prng.PRNGKey(0), s))
            np.testing.assert_array_equal(
                state["V"].numpy(), ref[f"{n_loc}_want_V"][s, sl],
                err_msg=f"V: rank {rank} n_loc {n_loc} step {s}")
            np.testing.assert_array_equal(
                state["spikes"].numpy(), ref[f"{n_loc}_want_spikes"][s, sl],
                err_msg=f"spikes: rank {rank} n_loc {n_loc} step {s}")


SUITES = {"mesh": mesh_suite, "pod": pod_suite}


def main(argv) -> int:
    suite, arg, store, world = argv[1], argv[2], argv[3], int(argv[4])
    mesh.spawn(SUITES[suite], world, store, (arg,), timeout_s=240)
    print("MESH-RANKS-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
