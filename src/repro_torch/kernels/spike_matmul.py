"""The event-gated int32 spike product — wrapper of the CUDA kernel
`csrc/spike_matmul.cu`, the port of the Pallas kernel in
`repro/kernels/spike_matmul.py` (with the natural-size interface of
`repro.kernels.ops.spike_matmul`).

Two forms, one function:
  * the TPU kernel's contract: spikes (Npre,) bool × weights (Npre,
    Npost) int16 -> (Npost,) int32;
  * the dense simulator's: (B, Npre) int32 event counts × int16 or int32
    weights -> (B, Npost) int32.
The TPU kernel already multiplies `s.astype(int32) * w`, so counts above
1 are the same arithmetic. Any sizes are taken: the TPU wrapper's
padding to 128 is that chip's tiling, and the CUDA kernel masks its own
ragged edges.

Meta tensors (the dry-run) get the launch's empty output and scratch,
planned for the H100's SMs, and no launch; every call is reported to an
open `launch.op_analysis.OpCounter`, charged with the weight rows that
some lane's events make live.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import spike_matmul_ref
from repro_torch.launch import op_analysis

_TILE_BYTES = 2032   # a block's columns: 128 threads x 16 B, less 16 B
_LANES = 8           # lanes per block
_SLICE_ROWS = 512    # rows per slice, at most (the block's live-row list)
_MIN_ROWS = 32       # rows per slice, at least, when slicing to fill SMs
_BLOCKS_PER_SM = 2
H100_SMS = 132       # the plan on meta: the card the port targets


class Plan(NamedTuple):
    """The kernel's grid: `tiles` column tiles of `tile_cols` columns x
    `groups` lane groups of 8 x `slices` row slices of `rows_per_slice`
    rows. Block (x, y, z) sums rows [z * rows_per_slice, ...) of columns
    [x * tile_cols, ...) for lanes [8 y, 8 y + 8), each range cut at its
    edge; the slices' partial sums are then added in order."""
    tile_cols: int
    tiles: int
    groups: int
    slices: int
    rows_per_slice: int


def plan(sms: int, B: int, npre: int, npost: int, w_bytes: int) -> Plan:
    """Column tiles x lane groups x row slices for `sms` SMs: enough
    slices that about _BLOCKS_PER_SM blocks per SM are in flight (each
    slice >= _MIN_ROWS rows), and never more than _SLICE_ROWS rows in a
    slice. Fewer slices mean fewer partial sums to add."""
    tile = _TILE_BYTES // w_bytes
    tiles = -(-npost // tile)
    groups = -(-B // _LANES)
    want = -(-_BLOCKS_PER_SM * sms // max(1, tiles * groups))
    slices = max(-(-npre // _SLICE_ROWS),
                 min(want, -(-npre // _MIN_ROWS)), 1)
    rows = max(1, -(-npre // slices))
    return Plan(tile, tiles, groups, max(1, -(-npre // rows)), rows)


def spike_matmul(spikes, weights):
    """spikes (Npre,) bool/int32 or (B, Npre) int32; weights (Npre, Npost)
    int16 or int32. Returns int32 of shape spikes.shape[:-1] + (Npost,).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise); meta tensors get its output's shape."""
    on = op_analysis.where("spike_matmul", spikes, weights)
    npre, npost = weights.shape[0], weights.shape[-1]

    def cost():
        rows = op_analysis.live_rows(
            lambda: spikes.reshape(-1, npre).ne(0).any(0), npre)
        lanes = spikes.numel() // max(1, npre)
        return (2 * lanes * rows * npost,
                spikes.numel() * spikes.element_size()
                + rows * npost * weights.element_size() + 4 * lanes * npost)
    with op_analysis.kernel(("spike_matmul",), cost, _launch,
                            (spikes, weights), on) as call:
        call.result = spike_matmul_ref(spikes, weights) if on == "cpu" \
            else _launch(spikes, weights)
    return call.result


def _launch(spikes, weights):
    """The card's call: checks, output and scratch, the launch (none on
    meta)."""
    if weights.dim() != 2 or weights.dtype not in (torch.int16,
                                                   torch.int32) \
            or not weights.is_contiguous():
        raise ValueError(f"spike_matmul: want contiguous int16/int32 "
                         f"(Npre, Npost) weights, got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    npre, npost = weights.shape
    if spikes.dim() not in (1, 2) or spikes.shape[-1] != npre:
        raise ValueError(f"spike_matmul: spikes {tuple(spikes.shape)} do "
                         f"not match weights {tuple(weights.shape)}")
    if spikes.dtype == torch.bool:
        spikes = spikes.to(torch.int32)
    if spikes.dtype != torch.int32 or not spikes.is_contiguous():
        raise ValueError(f"spike_matmul: want contiguous bool or int32 "
                         f"spikes, got {spikes.dtype}")
    counts = spikes.reshape(-1, npre)
    B = counts.shape[0]
    dev = weights.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if weights.is_cuda else H100_SMS
    p = plan(sms, B, npre, npost, weights.element_size())
    if not 0 < B <= 65535 * _LANES or npost >= 2 ** 31 - p.tile_cols \
            or p.slices > 65535:
        raise ValueError(f"spike_matmul takes 1..{65535 * _LANES} lanes, "
                         f"< 2**31 columns and < {65535 * _SLICE_ROWS} "
                         f"rows, got {B} x {npre} x {npost}")
    out = torch.empty((B, npost), dtype=torch.int32, device=dev)
    scratch = torch.empty((p.slices, B, npost) if p.slices > 1 else (0,),
                          dtype=torch.int32, device=dev)
    if weights.is_cuda:
        fn = _build.load("spike_matmul")
        err = fn(counts.data_ptr(), weights.data_ptr(),
                 weights.element_size(), out.data_ptr(), scratch.data_ptr(),
                 B, npre, npost, p.tile_cols, p.slices, p.rows_per_slice,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "spike_matmul")
        spike_matmul.launches += 1
    return out.reshape(spikes.shape[:-1] + (npost,))


spike_matmul.launches = 0
