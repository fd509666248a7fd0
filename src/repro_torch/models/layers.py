"""Shared layers of the LM stack: norms, RoPE and sinusoidal positions,
MLPs, embeddings and the sequence-chunked cross-entropy loss — the port
of `repro/models/layers.py`.

Parameters live in `nn.Module`s whose attribute names are the JAX
parameter tree's keys (`scale`, `bias`, `w_in`, `w_gate`, `w_out`,
`table`, `out`), in the JAX package's layouts, so a JAX tree maps onto
the port's state by name (`repro_torch.models.weights`). The math is the
plain functions, as in JAX (`apply_norm`, `apply_rope`, `mlp_apply`,
`embed_lookup`, `unembed`); each module's constructor is JAX's `*_init`.
Weights are drawn from a `torch.Generator` on the device they live on:
the same scales as JAX, not the same bits (tests move JAX's weights
over with `weights.params_from_jax`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def dense_init(gen: torch.Generator, shape, dtype, fan_in=None):
    """A weight drawn N(0, 1/fan_in) in fp32 on the generator's device,
    cast to `dtype` (fan_in defaults to shape[0])."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return nn.Parameter((w * (1.0 / math.sqrt(max(1, fan_in)))).to(dtype))


class Norm(nn.Module):
    """RMSNorm (`scale`) or LayerNorm (`scale`, `bias`): JAX's
    `norm_init`."""

    def __init__(self, dim: int, dtype, kind: str = "rmsnorm", device=None):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype,
                                             device=device))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype,
                                                 device=device))

    def forward(self, x):
        return apply_norm(self, x, self.kind)


def apply_norm(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """Normalise over the last axis in fp32; the result in x's dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p.scale.float() + p.bias.float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p.scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- positions
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S) or (S,)
    integer tensor."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() - ang.dim() >= 2:                             # head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions, d_model: int):
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------- MLP
class MLP(nn.Module):
    """`w_in` (d, d_ff), `w_out` (d_ff, d), and `w_gate` (d, d_ff) for
    the gated activations: JAX's `mlp_init`."""

    def __init__(self, cfg, d_ff: int, gen: torch.Generator, dtype):
        super().__init__()
        d = cfg.d_model
        self.act = cfg.act
        self.w_in = dense_init(gen, (d, d_ff), dtype)
        self.w_out = dense_init(gen, (d_ff, d), dtype)
        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = dense_init(gen, (d, d_ff), dtype)

    def forward(self, x):
        return mlp_apply(self, x, self.act)


def mlp_apply(p, x, act: str):
    h = x @ p.w_in
    if act == "swiglu":
        h = F.silu(x @ p.w_gate) * h
    elif act == "geglu":
        h = F.gelu(x @ p.w_gate, approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p.w_out


# ---------------------------------------------------------------- embeddings
def padded_vocab(cfg) -> int:
    return ((cfg.vocab_size + 127) // 128) * 128


class Embed(nn.Module):
    """`table` (Vp, d), and `out` (d, Vp) when the embeddings are not
    tied: JAX's `embed_init`."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        vp, d = padded_vocab(cfg), cfg.d_model
        self.table = dense_init(gen, (vp, d), dtype, fan_in=d)
        if not cfg.tie_embeddings:
            self.out = dense_init(gen, (d, vp), dtype)


def embed_lookup(p, tokens):
    return F.embedding(tokens, p.table)


def unembed(p, h, cfg):
    if cfg.tie_embeddings:
        return h @ p.table.t()
    return h @ p.out


def chunked_ce_loss(emb, h, labels, mask, cfg):
    """Mean next-token cross entropy over the mask: h (B, S, d), labels
    (B, S) integer, mask (B, S) fp32. Returns tot / max(cnt, 1) as an
    fp32 scalar, from `chunked_ce_sums`."""
    tot, cnt = chunked_ce_sums(emb, h, labels, mask, cfg)
    return tot / cnt.clamp(min=1.0)


def chunked_ce_sums(emb, h, labels, mask, cfg):
    """(the masked cross entropy summed, the mask's sum), fp32 scalars.
    The sequence is cut into chunks of the largest divisor of S not
    above `cfg.loss_chunk`, so the (B, S, Vp) logits never exist at
    once; each chunk's fp32 logits mask the vocab padding to -1e30 and
    are rematerialized in the backward (`torch.utils.checkpoint`, JAX's
    `jax.checkpoint` on the scan body). A data-parallel step adds both
    over the ranks before it divides."""
    B, S, _ = h.shape
    chunk = min(cfg.loss_chunk, S)
    while S % chunk:        # largest divisor of S not above loss_chunk
        chunk -= 1

    def body(hx, lx, mx):
        logits = unembed(emb, hx, cfg).float()
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, torch.full((), -1e30, device=h.device),
                             logits)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, lx[..., None].long(),
                                    dim=-1)[..., 0]
        return ((lse - gold) * mx).sum(), mx.sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        ce, n = checkpoint(body, h[:, sl], labels[:, sl], mask[:, sl],
                           use_reentrant=False)
        tot, cnt = tot + ce, cnt + n
    return tot, cnt
