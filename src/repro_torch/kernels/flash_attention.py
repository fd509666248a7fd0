"""Causal flash attention forward — wrapper of the CUDA kernel
`csrc/flash_attention.cu`, the port of the Pallas kernel
`flash_attention` in `repro/kernels/flash_attention.py` (with the
any-length interface of `repro.kernels.ops.flash_attention`).

q is (B, H, S, D); k and v are (B, KV, S, D) with H % KV == 0, query
head h reading KV head h // (H / KV) — the grouping of
`repro.models.attention._sdpa`, so the model's narrow K/V go in without
being repeated; KV == H is the TPU kernel's function. Any strides with a
dense last axis: the model passes its (B, S, H, D) projections through
`.transpose(1, 2)`, and the output keeps q's strides. Any S >= 1: the
kernel masks its ragged tail where the TPU wrapper padded S.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (64, 128, 256)


def flash_attention(q, k, v, causal: bool = True):
    """Attention with an online fp32 softmax; returns (B, H, S, D) in
    q's dtype. CPU tensors take the plain version; CUDA tensors launch
    the kernel (fp32 or bf16, D in HEAD_DIMS) or raise."""
    devs = {q.device, k.device, v.device}
    if devs == {torch.device("cpu")}:
        return flash_attention_ref(q, k, v, causal)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on one cuda device (or the "
                         f"cpu), got {sorted(map(str, devs))}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (B, H, S, D) and k, v "
                         f"(B, KV, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D) or KV == 0 \
            or H % KV:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H % KV must be 0)")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes fp32 or bf16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if not 0 < B <= 65535 or not 0 < H <= 65535:
        raise ValueError(f"flash_attention takes 1..65535 batch rows and "
                         f"heads, got B={B}, H={H}")
    out = torch.empty_like(q)
    if any(t.stride(3) != 1 for t in (q, k, v, out)):
        raise ValueError("flash_attention: the head dim must be dense "
                         "(stride 1) in q, k and v")
    if S == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    fn = _build.load("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), B, H, KV, S, D, int(causal),
             D ** -0.5, *strides,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
