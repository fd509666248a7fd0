"""Mixture-of-Experts with HiAER-style address-event routing — the port
of the single-device half of `repro/models/moe.py`.

A token choosing its top-k experts is an address event, and dispatch is
HiAER's two-phase routing: `_pack` is the pointer lookup (each event's
slot in its expert's capacity buffer), the expert FFN runs on the
buffers, and `_unpack` delivers each result back to its token, weighted.

`moe_apply` is JAX's `decode or S == 1 or tp == 1` branch at tp = 1:
every expert is local, so the buffer is the whole (E, C, d) and the
psum is the identity. The expert-parallel half — the all_to_all
exchange, `_hiaer_exchange` and `_decode_moe_2d` — needs a device mesh
and comes with the distribution slice (ROADMAP item 10.3).

The order of JAX's arithmetic is kept where it decides which events are
dropped: the top-k of the fp32 *probabilities* in `lax.top_k`'s order
(descending, the lower expert first among equal values), events taken
token-major then by choice, an event's position in its expert the
exclusive count of earlier events there, and events past the capacity
sent to a sentinel row. The products are plain `torch.bmm`/`matmul`, as
JAX's are einsums outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init


class Shared(nn.Module):
    """The shared (always-on) experts as one gated FFN: `w_in`,
    `w_gate` (d, n_shared·F) and `w_out` (n_shared·F, d)."""

    def __init__(self, d: int, f: int, gen: torch.Generator, dtype):
        super().__init__()
        self.w_in = dense_init(gen, (d, f), dtype)
        self.w_gate = dense_init(gen, (d, f), dtype)
        self.w_out = dense_init(gen, (f, d), dtype)


class MoE(nn.Module):
    """`router` (d, E), fp32 whatever the model's dtype; `w_in`,
    `w_gate` (E, d, F) and `w_out` (E, F, d); `shared` when the config
    has shared experts: JAX's `moe_init`."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        mo, d = cfg.moe, cfg.d_model
        E, F_ = mo.n_routed, mo.d_ff_expert
        self.router = dense_init(gen, (d, E), torch.float32)
        self.w_in = dense_init(gen, (E, d, F_), dtype, fan_in=d)
        self.w_gate = dense_init(gen, (E, d, F_), dtype, fan_in=d)
        self.w_out = dense_init(gen, (E, F_, d), dtype, fan_in=F_)
        if mo.n_shared:
            self.shared = Shared(d, mo.n_shared * F_, gen, dtype)


def _act(cfg, g, h):
    if cfg.act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    return F.silu(g) * h


def _onehot(flat_e, E: int):
    """(N,) expert ids -> (E, N) int64 one-hot columns (a comparison,
    where `F.one_hot` would read the ids' range back to the host)."""
    return (torch.arange(E, device=flat_e.device)[:, None] == flat_e).long()


def _route(x_tok, router, cfg):
    """x_tok (T, d) -> the top-k weights (T, k) fp32, expert ids (T, k)
    int64 and the load-balance aux loss (Switch style, E · Σ_e f_e ·
    p̄_e times the aux weight; f counts every choice, dropped or not)."""
    mo = cfg.moe
    E = mo.n_routed
    probs = torch.softmax(x_tok.float() @ router.float(), dim=-1)
    # lax.top_k's order: a stable descending sort puts the lower expert
    # first among equal probabilities (torch.topk leaves ties unordered)
    ids = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :mo.top_k]
    w = probs.gather(1, ids)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    f = _onehot(ids.reshape(-1), E).sum(1).float()
    f = f / f.sum().clamp(min=1.0)
    aux = E * (f * probs.mean(0)).sum() * mo.router_aux_weight
    return w, ids, aux


def _capacity(T: int, cfg) -> int:
    mo = cfg.moe
    c = int(math.ceil(T * mo.top_k / mo.n_routed * mo.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def _pack(x_tok, ids, w, C: int, E: int):
    """Scatter each (token, choice) event's token into its expert's
    capacity buffer: (buf (E·C, d), slot (T·k,), keep (T·k,)). An
    event's slot is e·C + its position among the expert's events,
    token-major; past C it is dropped to the sentinel E·C."""
    T, d = x_tok.shape
    k = ids.shape[1]
    flat_e = ids.reshape(-1)
    # the count of the expert's events up to each event, less its own:
    # a scan along the events (the innermost axis, which the card scans
    # in parallel; along the outer axis one thread walks each expert)
    pos = _onehot(flat_e, E).cumsum(1).gather(0, flat_e[None])[0] - 1
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)
    # kept slots are unique, so each kept row is one write
    buf = x_tok.new_zeros((E * C + 1, d)).index_add(
        0, slot, x_tok.repeat_interleave(k, dim=0))
    return buf[:-1], slot, keep


def _unpack(buf, slot, keep, w, T: int, k: int):
    """Gather each event's result, weight it (0 if dropped) and sum a
    token's k events in the buffer's dtype: (T, d)."""
    buf = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))])
    # index_select's backward adds into the rows (every kept slot is read
    # once), where indexing's sorts the slots first
    y = buf.index_select(0, slot)
    y = y * (keep[:, None] * w.reshape(-1)[:, None]).to(y.dtype)
    return y.reshape(T, k, -1).sum(1)


def _expert_ffn(p, cfg, toks):
    """toks (E, N, d) -> (E, N, d), each expert's gated FFN."""
    h = torch.bmm(toks, p.w_in)
    g = torch.bmm(toks, p.w_gate)
    return torch.bmm(_act(cfg, g, h), p.w_out)


def _shared_ffn(sp, cfg, x):
    return _act(cfg, x @ sp.w_gate, x @ sp.w_in) @ sp.w_out


def moe_apply(p, x, cfg):
    """x (B, S, d) -> (y (B, S, d), aux): route every token, pack the
    events into (E, C, d) buffers at C = `_capacity(B·S)`, run every
    expert on its buffer, unpack, and add the shared experts."""
    mo = cfg.moe
    B, S, d = x.shape
    E, T = mo.n_routed, B * S
    xt = x.reshape(T, d)
    w, ids, aux = _route(xt, p.router, cfg)
    C = _capacity(T, cfg)
    buf, slot, keep = _pack(xt, ids, w, C, E)
    out = _expert_ffn(p, cfg, buf.reshape(E, C, d))
    y = _unpack(out.reshape(E * C, d), slot, keep, w, T,
                mo.top_k).reshape(B, S, d)
    if hasattr(p, "shared"):
        y = y + _shared_ffn(p.shared, cfg, x)
    return y, aux


def moe_flops(cfg, n_tokens: int) -> int:
    """Active FLOPs (top-k and shared experts) for n_tokens tokens."""
    mo = cfg.moe
    per_tok = (mo.top_k + mo.n_shared) * 3 * 2 * cfg.d_model * mo.d_ff_expert
    return per_tok * n_tokens
