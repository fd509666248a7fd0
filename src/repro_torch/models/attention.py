"""Grouped-query attention — the port of the GQA half of
`repro/models/attention.py`.

A pass over a whole sequence runs the flash kernels: the training path
(grad enabled and an input that requires grad) through
`flash_attention_trainable`, whose forward is `flash_fwd_lse` and whose
backward is `flash_attention_bwd`; prefill through `flash_attention`
alone. On the card these are the CUDA kernels, on the CPU their plain
versions; the narrow (B, KV, S, hd) K/V go in as they are, never
repeated. JAX's training loss computes the same function in XLA
(`attend`, q-chunked and rematerialized).

Decode (one token against a cache) stays in torch ops, a softmax over
the cache masked to `k_idx <= q_idx` and `k_idx < kv_len`, as JAX
computes it in XLA outside any Pallas kernel.
The decode step writes the new K/V row into the cache in place (JAX
returns an updated copy); like JAX's `dynamic_update_slice` it writes
every batch row at `cache_pos`, clamped into the cache.

JAX's sharding hints (`constrain`, `_seq_shard`) have no counterpart on
one device. MLA, the sliding-window ring buffer and the shard-mapped
sequence-parallel attention come with later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_trainable)
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


class GQA(nn.Module):
    """`wq` (d, H, hd), `wk`/`wv` (d, KV, hd), `wo` (H, hd, d), and
    `bq`/`bk`/`bv` with QKV bias: JAX's `gqa_init`."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        self.wq = dense_init(gen, (d, H, hd), dtype, fan_in=d)
        self.wk = dense_init(gen, (d, KV, hd), dtype, fan_in=d)
        self.wv = dense_init(gen, (d, KV, hd), dtype, fan_in=d)
        self.wo = dense_init(gen, (H, hd, d), dtype, fan_in=H * hd)
        if cfg.qkv_bias:
            zeros = lambda *s: nn.Parameter(torch.zeros(
                s, dtype=dtype, device=gen.device))
            self.bq = zeros(H, hd)
            self.bk = zeros(KV, hd)
            self.bv = zeros(KV, hd)


def _proj(x, w):
    """x (B, S, d) times w (d, n, hd) -> (B, S, n, hd)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _qkv(p, x, cfg, positions):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend(q, k, v, q_start, kv_len):
    """Causal attention of q (B, c, H, hd) at positions q_start.. against
    k/v (B, T, KV, hd), keys at kv_len and past masked: JAX's `_sdpa`
    without a window. Returns (B, c, H, hd) in q's dtype."""
    B, c, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, c, KV, H // KV, hd)
    s = torch.einsum("bcgrk,btgk->bgrct", qg.float() * hd ** -0.5,
                     k.float())                          # (B,KV,rep,c,T)
    q_idx = q_start + torch.arange(c, device=q.device)
    k_idx = torch.arange(T, device=q.device)
    mask = (k_idx[None, :] <= q_idx[:, None]) & (k_idx < kv_len)[None, :]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrct,btgk->bcgrk", a, v.float())
    return o.reshape(B, c, H, hd).to(q.dtype)


def gqa_apply(p, x, cfg, positions, cache=None, cache_pos=None):
    """Full causal GQA. Returns (out, kv). Decode — a cache and one token
    (S == 1) at cache_pos — updates the cache in place and returns it;
    otherwise attention runs over the sequence itself (the flash
    kernels) and kv is its {k, v} (B, S, KV, hd), the prefill's cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if cache is not None and S == 1:
        slot = min(max(cache_pos, 0), cache["k"].shape[1] - 1)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        kv = cache
        out = attend(q, cache["k"], cache["v"], q_start=cache_pos,
                     kv_len=cache_pos + 1)
    else:
        kv = {"k": k, "v": v}
        qkv = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        train = torch.is_grad_enabled() and any(t.requires_grad
                                                for t in qkv)
        fn = flash_attention_trainable if train else flash_attention
        out = fn(*qkv).transpose(1, 2)
    return out.flatten(2) @ p.wo.flatten(0, 1), kv


def gqa_cache_shape(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device)}
