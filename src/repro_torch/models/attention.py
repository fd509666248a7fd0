"""Grouped-query attention, full and sliding-window (local) — the port
of the GQA half of `repro/models/attention.py`.

A pass over a whole sequence runs the flash kernels: the training path
(grad enabled and an input that requires grad) through
`flash_attention_trainable`, whose forward is `flash_fwd_lse` and whose
backward is `flash_attention_bwd`; prefill through `flash_attention`
alone. On the card these are the CUDA kernels, on the CPU their plain
versions; the narrow (B, KV, S, hd) K/V go in as they are, never
repeated, and a window (RecurrentGemma's local attention) goes in as the
kernels' `window`. JAX's training loss computes the same function in XLA
(`attend`, q-chunked and rematerialized).

Decode (one token against a cache) stays in torch ops, a softmax over
the cache masked to `k_idx <= q_idx` and `k_idx < kv_len` (`attend`), or
for a window over the ring's slots masked by the absolute position each
holds (`_masked_decode_attend`), as JAX computes them in XLA outside any
Pallas kernel. The decode step writes the new K/V row into the cache in
place (JAX returns an updated copy); like JAX's `dynamic_update_slice`
it writes every batch row at `cache_pos`, clamped into the cache, or
with a window at the ring slot `cache_pos % T`. A windowed prefill
returns the last min(window, S) rows of K/V, in order, as JAX does.

JAX's sharding hints (`constrain`, `_seq_shard`) have no counterpart on
one device. MLA and the shard-mapped sequence-parallel attention come
with later slices.
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


def attend(q, k, v, q_start, kv_len, window=None):
    """Causal attention of q (B, c, H, hd) at positions q_start.. against
    k/v (B, T, KV, hd), keys at kv_len and past masked, and with a
    window the keys at or before q_idx - window: JAX's `_sdpa`. Returns
    (B, c, H, hd) in q's dtype."""
    B, c, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, c, KV, H // KV, hd)
    s = torch.einsum("bcgrk,btgk->bgrct", qg.float() * hd ** -0.5,
                     k.float())                          # (B,KV,rep,c,T)
    q_idx = q_start + torch.arange(c, device=q.device)
    k_idx = torch.arange(T, device=q.device)
    mask = (k_idx[None, :] <= q_idx[:, None]) & (k_idx < kv_len)[None, :]
    if window is not None:
        mask &= k_idx[None, :] > q_idx[:, None] - window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrct,btgk->bcgrk", a, v.float())
    return o.reshape(B, c, H, hd).to(q.dtype)


def _masked_decode_attend(q, k, v, mask):
    """q (B, 1, H, hd) against k/v (B, T, KV, hd), mask (T,) bool: JAX's
    `_masked_decode_attend`. Returns (B, 1, H, hd) in q's dtype."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bgrk,btgk->bgrt", qg.float() * hd ** -0.5, k.float())
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrt,btgk->bgrk", a, v.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def gqa_apply(p, x, cfg, positions, window=None, cache=None,
              cache_pos=None):
    """Causal GQA, over each query's last `window` keys when given.
    Returns (out, kv). Decode — a cache and one token (S == 1) at
    cache_pos — updates the cache in place and returns it (a window's
    cache is a ring of T = min(window, max_len) slots); otherwise
    attention runs over the sequence itself (the flash kernels) and kv
    is its {k, v} (B, S, KV, hd), or with a window its last min(window,
    S) rows, the prefill's cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if cache is not None and S == 1:
        T = cache["k"].shape[1]
        slot = cache_pos % T if window is not None \
            else min(max(cache_pos, 0), T - 1)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        if window is not None:
            # the absolute position each ring slot holds, masked to the
            # ones written, causal and inside the window
            slots = torch.arange(T, device=x.device)
            abs_pos = cache_pos - torch.remainder(slot - slots, T)
            mask = (abs_pos >= 0) & (abs_pos <= cache_pos) \
                & (abs_pos > cache_pos - window)
            out = _masked_decode_attend(q, cache["k"], cache["v"], mask)
        else:
            out = attend(q, cache["k"], cache["v"], q_start=cache_pos,
                         kv_len=cache_pos + 1)
        kv = cache
    else:
        kv = {"k": k, "v": v}
        if window is not None:
            kv = {n: t[:, S - min(window, S):] for n, t in kv.items()}
        qkv = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        train = torch.is_grad_enabled() and any(t.requires_grad
                                                for t in qkv)
        fn = flash_attention_trainable if train else flash_attention
        out = fn(*qkv, window=window).transpose(1, 2)
    return out.flatten(2) @ p.wo.flatten(0, 1), kv


def gqa_cache_shape(cfg, batch, max_len, dtype=torch.bfloat16, device=None,
                    window=None):
    """Zero K/V {k, v} (batch, T, KV, hd): T = max_len, or min(window,
    max_len) for a windowed layer's ring."""
    T = min(window, max_len) if window else max_len
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {n: torch.zeros((batch, T, kv, hd), dtype=dtype, device=device)
            for n in ("k", "v")}
