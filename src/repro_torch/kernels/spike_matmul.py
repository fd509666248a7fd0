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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import spike_matmul_ref

_ROWS = 128          # rows per block of rows in the kernel
_LANES = 8           # lanes per thread in the kernel


def _slices(dev, B: int, npre: int, npost: int) -> int:
    """How many row slices to split the product into, so that about two
    blocks per SM are in flight; each slice keeps >= 2 blocks of rows."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-npost // _ROWS) * -(-B // _LANES)
    row_blocks = -(-npre // _ROWS)
    return max(1, min(-(-2 * sms // tiles), -(-row_blocks // 2)))


def spike_matmul(spikes, weights):
    """spikes (Npre,) bool/int32 or (B, Npre) int32; weights (Npre, Npost)
    int16 or int32. Returns int32 of shape spikes.shape[:-1] + (Npost,).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if weights.device.type == "cpu" and spikes.device.type == "cpu":
        return spike_matmul_ref(spikes, weights)
    if weights.device.type != "cuda" or spikes.device != weights.device:
        raise ValueError(f"spike_matmul runs on one cuda device (or the "
                         f"cpu), got spikes on {spikes.device} and weights "
                         f"on {weights.device}")
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
    if not 0 < B <= 65535 * _LANES or npost >= 2 ** 31 - _ROWS:
        raise ValueError(f"spike_matmul takes 1..{65535 * _LANES} lanes "
                         f"and < 2**31 columns, got {B} x {npost}")
    dev = weights.device
    out = torch.empty((B, npost), dtype=torch.int32, device=dev)
    slices = _slices(dev, B, npre, npost)
    scratch = torch.empty((slices, B, npost) if slices > 1 else (0,),
                          dtype=torch.int32, device=dev)
    fn = _build.load("spike_matmul")
    err = fn(counts.data_ptr(), weights.data_ptr(), weights.element_size(),
             out.data_ptr(), scratch.data_ptr(), B, npre, npost, slices,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "spike_matmul")
    spike_matmul.launches += 1
    return out.reshape(spikes.shape[:-1] + (npost,))


spike_matmul.launches = 0
