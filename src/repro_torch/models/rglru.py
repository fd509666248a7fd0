"""RecurrentGemma / Griffin recurrent block: conv1d + the RG-LRU gated
linear recurrence — the port of `repro/models/rglru.py`.

Training and prefill compute the recurrence h_t = a_t h_{t-1} + b_t over
the whole sequence with `associative_scan`, the port of
`jax.lax.associative_scan`'s odd/even recursion: ~log2(S) levels of
vectorised torch ops (not S steps), whose products and sums associate as
JAX's do. Decode carries {conv, h}, O(1) a token. It is all torch ops,
as JAX's is XLA outside any Pallas kernel.

The parameters are an `nn.Module` (`RGLRU`) with JAX's names and
layouts: `w_x`, `w_y` (d, W), `conv_w` (K, W), `conv_b`, the
block-diagonal gates `w_i`, `w_r` (nb, bw, bw) (`_gate_blocks`), fp32
`lam` (W,), `w_out` (W, d).

The model axis (ROADMAP item 10.3c). JAX's rules hold `w_x`, `w_y`,
`lam` and `conv_b` over W on 'model', `w_i`/`w_r` over their nb gate
blocks where nb divides, `w_out` row-parallel, `conv_w` whole. With
`w_x` held (d, W/tp) under tp > 1 each rank runs its W/tp channels: x
enters through Megatron's f (`Mesh.copy_to`), the convolution takes the
rank's columns of the whole `conv_w`, and the recurrence is per channel.
The gates of the rank's channels need u of every block that overlaps
them: where the blocks divide, the rank's channels are its whole blocks
of `w_i`/`w_r`; where they do not (RecurrentGemma-2B's 10 blocks at tp =
4), u is gathered over 'model' (its gradient reduce-scattered back) and
the rank computes the gates of its channels from the whole `w_i`/`w_r`.
A leaf held whole and used in the rank's slice (`conv_w`, and `w_i`/
`w_r` held whole) has a partial gradient a rank: the training step sums
it over 'model'. `w_out` is row-parallel through g (`Mesh.reduce_from`).
The caches {conv, h} are held whole, as JAX's `cache_specs` holds them:
after each prefill and decode tick the rank's channels are gathered over
'model'.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.context import get_mesh
from repro_torch.models.layers import dense_init

_C = 8.0   # Griffin's fixed recurrence sharpness


def _gate_blocks(cfg):
    """(nb, bw): the gates' blocks of width bw = min(gate_block, W)."""
    W = cfg.rglru.lru_width
    bw = min(cfg.rglru.gate_block, W)
    if W % bw:
        raise ValueError(f"lru_width {W} is not a multiple of the gate "
                         f"block {bw}")
    return W // bw, bw


class RGLRU(nn.Module):
    """JAX's `rglru_init`: the projections and gates in `dtype`, `lam`
    (the Lambda parameter, 2.0) in fp32."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        d, W = cfg.d_model, cfg.rglru.lru_width
        K = cfg.rglru.d_conv
        nb, bw = _gate_blocks(cfg)
        dev = gen.device
        self.w_x = dense_init(gen, (d, W), dtype)
        self.w_y = dense_init(gen, (d, W), dtype)       # gate branch
        self.conv_w = dense_init(gen, (K, W), dtype, fan_in=K)
        self.conv_b = nn.Parameter(torch.zeros(W, dtype=dtype, device=dev))
        self.w_i = dense_init(gen, (nb, bw, bw), dtype, fan_in=bw)
        self.w_r = dense_init(gen, (nb, bw, bw), dtype, fan_in=bw)
        self.lam = nn.Parameter(torch.full((W,), 2.0, dtype=torch.float32,
                                           device=dev))
        self.w_out = dense_init(gen, (W, d), dtype)


def _conv(w, b, x, state=None):
    """Depthwise causal conv of width K (no activation). x (B, S, W);
    state (B, K - 1, W) or None (zeros). Returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = F.pad(x, (0, 0, K - 1, 0))
    else:
        pad = torch.cat([state, x], dim=1)
    y = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    return y, (pad[:, -(K - 1):] if K > 1 else None)


def _combine(a1, b1, a2, b2):
    """The recurrence's associative operator: (a1, b1) then (a2, b2)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd, dim):
    """even[0], odd[0], even[1], ... along dim (even as long as odd or
    one longer)."""
    n = odd.shape[dim]
    both = torch.stack([even.narrow(dim, 0, n), odd], dim=dim + 1)
    out = both.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, even.narrow(dim, n, 1)], dim=dim)
    return out


def associative_scan(a, b, dim: int = 1):
    """The prefix combination of (a, b) along `dim`: element t is
    (prod_{u<=t} a_u, h_t) with h_t = a_t h_{t-1} + b_t, h_{-1} = 0 —
    `jax.lax.associative_scan(combine, (a, b), axis=dim)`, by its
    recursion: combine adjacent pairs, scan the half-length result (the
    odd elements), combine each odd element with the next even input,
    interleave."""
    n = a.shape[dim]
    if n < 2:
        return a, b

    def sl(t, start, stop=None, step=None):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]
    odd_a, odd_b = associative_scan(
        *_combine(sl(a, 0, -1, 2), sl(b, 0, -1, 2), sl(a, 1, None, 2),
                  sl(b, 1, None, 2)), dim=dim)
    if n % 2 == 0:
        ev_a, ev_b = _combine(sl(odd_a, 0, -1), sl(odd_b, 0, -1),
                              sl(a, 2, None, 2), sl(b, 2, None, 2))
    else:
        ev_a, ev_b = _combine(odd_a, odd_b, sl(a, 2, None, 2),
                              sl(b, 2, None, 2))
    ev_a = torch.cat([sl(a, 0, 1), ev_a], dim=dim)
    ev_b = torch.cat([sl(b, 0, 1), ev_b], dim=dim)
    return _interleave(ev_a, odd_a, dim), _interleave(ev_b, odd_b, dim)


def _gates(p, uf, cfg, chans: slice, mesh):
    """(r, i), the block-diagonal gates of uf's channels (B, S, n): all
    W on one rank; under the model axis the rank's `chans` of W, from
    its own blocks of `w_r`/`w_i` when they are held cut, else from u
    gathered over 'model' and the blocks that overlap the channels."""
    B, S, n = uf.shape
    nb, bw = _gate_blocks(cfg)
    wr, wi = p.w_r.float(), p.w_i.float()
    lo = 0
    if n < cfg.rglru.lru_width and wr.shape[0] == nb:     # cut mid-block
        b0, b1 = chans.start // bw, (chans.stop - 1) // bw + 1
        uf = mesh.all_gather(uf, "model", dim=-1)[..., b0 * bw:b1 * bw]
        wr, wi, lo = wr[b0:b1], wi[b0:b1], chans.start - b0 * bw
    ub = uf.reshape(B, S, -1, bw)
    out = []
    for w in (wr, wi):
        g = torch.sigmoid(torch.einsum("bshw,hwv->bshv", ub, w))
        out.append(g.reshape(B, S, -1)[..., lo:lo + n])
    return out


def rglru_apply(p, x, cfg, cache=None):
    """x (B, S, d) -> (y, new_cache). Training: no cache (new_cache
    None). Prefill: a cache and S > 1 (its h is not read: the scan starts
    from 0, as JAX's does), returning {conv, h} with h in x's dtype.
    Decode: a cache {conv (B, K - 1, W), h (B, W)} and S == 1. Under the
    model axis: the module docstring."""
    B, S, _ = x.shape
    W = cfg.rglru.lru_width
    mesh = get_mesh()
    tp = mesh.shape.get("model", 1)
    cut = tp > 1 and p.w_x.shape[1] < W
    chans, conv_w = slice(0, W), p.conv_w
    if cut:
        r, n = mesh.coords["model"], W // tp
        chans = slice(r * n, (r + 1) * n)
        x = mesh.copy_to(x, "model")
        conv_w = conv_w[:, chans]
    gate = F.gelu(x @ p.w_y, approximate="tanh")
    u = x @ p.w_x
    conv_state = cache["conv"][..., chans] if cache is not None else None
    u, new_conv = _conv(conv_w, p.conv_b, u, conv_state)
    uf = u.float()
    r, i = _gates(p, uf, cfg, chans, mesh)
    log_a = -_C * r * F.softplus(p.lam)                       # (B,S,W) <= 0
    a = torch.exp(log_a)
    gated = i * uf
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    if cache is not None and S == 1:
        h = a[:, 0] * cache["h"][..., chans].float() + b[:, 0]
        y = h[:, None]
        new_cache = {"conv": new_conv, "h": h.to(cache["h"].dtype)}
    else:
        _, y = associative_scan(a, b, dim=1)
        new_cache = None
        if cache is not None:   # prefill
            new_cache = {"conv": new_conv, "h": y[:, -1].to(x.dtype)}
    if new_cache is not None and cut:       # held whole: every channel
        with torch.no_grad():
            new_cache = {k: mesh.all_gather(t.contiguous(), "model", dim=-1)
                         for k, t in new_cache.items()}
    y = y.to(x.dtype) * gate
    if cut:
        return mesh.reduce_from(y @ p.w_out, "model"), new_cache
    return y @ p.w_out, new_cache


def rglru_cache_shape(cfg, batch, dtype=torch.bfloat16, device=None):
    """Zero state {conv (batch, K - 1, W), h (batch, W)}."""
    W, K = cfg.rglru.lru_width, cfg.rglru.d_conv
    return {"conv": torch.zeros((batch, K - 1, W), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, W), dtype=dtype, device=device)}
