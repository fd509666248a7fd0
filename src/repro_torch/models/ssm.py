"""Mamba-2 SSD (state-space duality) block, chunked scan formulation — the
port of `repro/models/ssm.py`.

Training and prefill run the blocked SSD algorithm (`ssd_chunked`: the
quadratic intra-chunk term, then the inter-chunk state recurrence, one
chunk of `cfg.ssm.chunk_size` rows at a time); decode runs the O(1)
recurrent update h = a h + B x_dt, y = C.h against the carried
{conv, ssd} state. All of it is torch ops: JAX computes it in XLA,
outside any Pallas kernel.

One departure from the reference, in `ssd_chunked`: the intra-chunk decay
exp(cum_t - cum_s) is masked in its exponent (exp(-inf) = 0 above the
diagonal), where JAX takes the exponential of every (t, s) pair and masks
the result. The forward is the same value for value; JAX's backward forms
0 * exp(cum_t - cum_s) above the diagonal, where that exponential
overflows to inf once the chunk's summed log-decay passes ~88 (chunk_size
256 at a ≈ e^-0.8), so its gradients turn to NaN at Mamba2-780m's
published chunk size. The port's stay finite.

The mixer's parameters are an `nn.Module` (`SSM`) with JAX's names and
layouts: `w_in` (d, 2 d_in + 2 N + H), `conv_w` (K, d_in + 2 N),
`conv_b`, fp32 `a_log`, `dt_bias` and `d_skip` (H,), `out_norm.scale`
(d_in,), `w_out` (d_in, d).

The model axis (ROADMAP item 10.3c). JAX's rules hold `w_out` over d_in
on 'model' and every other leaf whole. With `w_out` held (d_in/tp, d)
under tp > 1 each rank computes the whole projection and convolution,
which then enter through Megatron's f (`Mesh.copy_to`: their gradient,
and so `w_in`'s, `conv_w`'s and `conv_b`'s, summed whole on every rank)
before the rank takes its H/tp heads of z, x and dt (B and C are every
head's). The scan runs on those heads, with `a_log`, `dt_bias` and
`d_skip` sliced to them (their gradients, and `out_norm.scale`'s, are
partial sums over 'model': the training step adds them). `out_norm`
normalises over the whole d_in, so the rank's sum of squares is summed
over 'model' first (`Mesh.psum`, a sum both ways); then `w_out` is
row-parallel through g (`Mesh.reduce_from`). The caches are held whole,
as JAX's `cache_specs` holds them: after each prefill and decode tick the
rank's heads of the new ssd state are gathered over 'model'.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.context import get_mesh
from repro_torch.models.layers import Norm, apply_norm, dense_init


class SSM(nn.Module):
    """JAX's `ssm_init`: the projections in `dtype`, the decay, step and
    skip parameters in fp32."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        d_in = s.expand * d
        H, N = d_in // s.head_dim, s.d_state
        conv_dim = d_in + 2 * N             # x_ssm + B + C (single group)
        dev = gen.device

        def full(n, value, dt):
            return nn.Parameter(torch.full((n,), value, dtype=dt,
                                           device=dev))
        self.w_in = dense_init(gen, (d, 2 * d_in + 2 * N + H), dtype)
        self.conv_w = dense_init(gen, (s.d_conv, conv_dim), dtype,
                                 fan_in=s.d_conv)
        self.conv_b = full(conv_dim, 0.0, dtype)
        self.a_log = full(H, 0.0, torch.float32)
        self.dt_bias = full(H, 0.0, torch.float32)
        self.d_skip = full(H, 1.0, torch.float32)
        self.out_norm = Norm(d_in, dtype, device=dev)
        self.w_out = dense_init(gen, (d_in, d), dtype)


def _split_in(cfg, proj):
    """proj (B, S, 2 d_in + 2 N + H) -> (z, xbc, dt, d_in, N, H)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    N = s.d_state
    H = d_in // s.head_dim
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * N, H], dim=-1)
    return z, xbc, dt, d_in, N, H


def _causal_conv(w, b, x, state=None):
    """Depthwise causal conv of width K, then SiLU. x (B, S, C); state
    (B, K - 1, C), the last inputs before x (zeros when None). Returns
    (y, new_state), new_state the last K - 1 rows of [state, x] (in
    their promoted dtype, as JAX's concatenate gives them)."""
    K = w.shape[0]
    if state is None:
        pad = F.pad(x, (0, 0, K - 1, 0))
    else:
        pad = torch.cat([state, x], dim=1)
    y = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    new_state = pad[:, -(K - 1):] if K > 1 else None
    return F.silu(y), new_state


def ssd_chunked(xh, a, Bm, Cm, chunk: int, init_state=None):
    """Blocked SSD. xh (B, S, H, P) inputs (dt-scaled); a (B, S, H) decay
    factors in (0, 1); Bm, Cm (B, S, N); init_state (B, H, P, N) or None
    (zeros). Returns (y (B, S, H, P) fp32, final_state (B, H, P, N)
    fp32). The chunk recurrence (JAX's `lax.scan`) is a loop over the
    S / chunk chunks."""
    B, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S = {S} is not a multiple of the "
                         f"chunk {chunk}")
    nc = S // chunk

    def r(t):
        return t.reshape(B, nc, chunk, *t.shape[2:]).float()
    xc, ac, Bc, Cc = r(xh), r(a), r(Bm), r(Cm)
    la = torch.log(torch.clamp(ac, min=1e-20))                 # (B,nc,c,H)
    cum = torch.cumsum(la, dim=2)                              # within-chunk
    # intra-chunk (quadratic in chunk): y_t = sum_{s<=t} C_t.B_s prod a,
    # the decay masked in its exponent so that its gradient stays finite
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,t,s,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=xh.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, diff, torch.full(
        (), float("-inf"), device=xh.device)))
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    M = cb[..., None] * decay                                  # (B,nc,t,s,H)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", M, xc)
    # chunk-final states: sum_s prod_{s<u<=c} a * B_s x_s
    tail = torch.exp(cum[:, :, -1:, :] - cum)                  # (B,nc,c,H)
    st = torch.einsum("bcsh,bcsn,bcshp->bchpn", tail, Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)
    h = (torch.zeros((B, H, Pd, N), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + st[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # (B,nc,H,P,N)
    # inter-chunk contribution: C_t . (decay-to-t * h_prev)
    y_inter = torch.einsum("bcth,bctn,bchpn->bcthp", torch.exp(cum), Cc,
                           h_prev)
    return (y_intra + y_inter).reshape(B, S, H, Pd), h


def _norm_cut(scale, y, d_in: int, mesh, eps: float = 1e-6):
    """`apply_norm`'s RMSNorm of y (B, S, d_in/tp), the rank's block of a
    d_in-wide vector: its sum of squares summed over 'model'."""
    yf = y.float()
    ms = mesh.psum(yf.square().sum(-1, keepdim=True), "model") / d_in
    return (yf * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


def ssm_apply(p, x, cfg, cache=None):
    """x (B, S, d) -> (y, new_cache). Training: no cache (new_cache
    None). Prefill: a cache and S > 1, returning {conv, ssd} (the ssd
    state in x's dtype). Decode: a cache {conv (B, K - 1, C), ssd (B, H,
    P, N)} and S == 1, the recurrent update; the new ssd state in the
    cache's dtype. Under the model axis: the module docstring."""
    s = cfg.ssm
    B, S, _ = x.shape
    z, xbc, dt, d_in, N, H = _split_in(cfg, x @ p.w_in)
    Pd = s.head_dim
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(p.conv_w, p.conv_b, xbc, conv_state)
    mesh = get_mesh()
    tp = mesh.shape.get("model", 1)
    cut = tp > 1 and p.w_out.shape[0] < d_in
    heads = slice(None)
    a_log, dt_bias, d_skip = p.a_log, p.dt_bias, p.d_skip
    if cut:
        if H % tp:
            raise ValueError(f"{H} SSD heads do not divide over {tp} model "
                             f"ranks")
        z, xbc, dt = torch.split(mesh.copy_to(torch.cat(
            [z, xbc, dt], dim=-1), "model"), [d_in, d_in + 2 * N, H], dim=-1)
        r, hl = mesh.coords["model"], H // tp
        heads = slice(r * hl, (r + 1) * hl)
        z = z[..., r * hl * Pd:(r + 1) * hl * Pd]
        dt = dt[..., heads]
        a_log, dt_bias, d_skip = a_log[heads], dt_bias[heads], d_skip[heads]
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    Hl = H // tp if cut else H
    xs = xs.unflatten(-1, (H, Pd))[:, :, heads]
    dt = F.softplus(dt.float() + dt_bias)                      # (B,S,Hl)
    a = torch.exp(-torch.exp(a_log) * dt)                      # (B,S,Hl)
    xdt = xs.float() * dt[..., None]
    if cache is not None and S == 1:
        # recurrent decode step: h = a h + B x_dt ; y = C.h
        h = cache["ssd"][:, heads].float()                     # (B,Hl,P,N)
        h = h * a[:, 0, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xdt[:, 0], Bm[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)[:, None]
        new_cache = {"conv": new_conv, "ssd": h.to(cache["ssd"].dtype)}
    else:
        y, hT = ssd_chunked(xdt, a, Bm, Cm, min(s.chunk_size, S))
        new_cache = None
        if cache is not None:   # prefill
            new_cache = {"conv": new_conv, "ssd": hT.to(x.dtype)}
    if new_cache is not None and cut:       # held whole: every head
        with torch.no_grad():
            new_cache["ssd"] = mesh.all_gather(new_cache["ssd"].contiguous(),
                                               "model", dim=1)
    y = y + xs.float() * d_skip[..., None]
    y = y.reshape(B, S, Hl * Pd).to(x.dtype)
    y = y * F.silu(z)
    if cut:
        scale = p.out_norm.scale[r * hl * Pd:(r + 1) * hl * Pd]
        return mesh.reduce_from(_norm_cut(scale, y, d_in, mesh) @ p.w_out,
                                "model"), new_cache
    y = apply_norm(p.out_norm, y)
    return y @ p.w_out, new_cache


def ssm_cache_shape(cfg, batch, dtype=torch.bfloat16, device=None):
    """Zero state {conv (batch, K - 1, d_in + 2 N), ssd (batch, H, P,
    N)}."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return {"conv": torch.zeros((batch, s.d_conv - 1, d_in + 2 * s.d_state),
                                dtype=dtype, device=device),
            "ssd": torch.zeros((batch, H, s.head_dim, s.d_state),
                               dtype=dtype, device=device)}
