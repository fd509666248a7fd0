"""Grouped-query attention, full and sliding-window (local), and
DeepSeek-V2's multi-head latent attention (MLA) — the port of
`repro/models/attention.py`.

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

MLA (`mla_apply`) keeps JAX's two forms. Over a sequence (training,
prefill) the naive form decompresses K and V from the latent c_kv,
concatenates k_nope with k_rope broadcast over the heads and runs the
same flash kernels with KV == H at the head-dim pair (nope + rope,
v_head_dim) = (192, 128) at DeepSeek-V2's widths: V and the output stay
v_head_dim wide, where JAX pads V with zeros to 192 (`_pad_last`) and
slices the output back (the zeros add nothing: the two differ only in
the order of the sums); the prefill's cache is the compressed {c_kv,
k_rope}. Decode runs the
absorbed form on that cache in torch ops, as JAX computes it in XLA:
q_nope through w_uk into the latent space, fp32 scores against c_kv and
k_rope, the output back through w_uv. Its new row is written in place
at `cache_pos`, clamped into the cache as the GQA decode writes.

The model axis (ROADMAP item 10.3b; tp > 1 on the context mesh), in
JAX's two layouts (`gqa_apply(..., layout=)`, chosen by
`launch.sharding.attn_layout` as JAX's `_attn_layout`):
  * "heads" (Megatron): `wq`/`bq`/`wo` held as the rank's H/tp heads,
    `wk`/`wv`/`bk`/`bv` as its KV/tp heads when KV % tp == 0 and whole
    otherwise, each local query head then reading global KV head
    (rank H/tp + h) // (H/KV) (JAX's replicated narrow GQA); the input
    enters through f, `wo` is row-parallel through g (with a sequence-
    parallel residual the rank's rows are gathered along S instead and
    the output reduce-scattered back). A whole `wk`'s gradient is
    partial on each rank: the step sums it over 'model'.
  * "seq" (JAX's `_shardmap_seq_attention`, for head counts that do not
    divide): every leaf whole; the rank projects its S/tp rows at their
    RoPE positions, K/V are gathered over 'model' along S (the gather's
    backward a reduce-scatter), kernels 4-6 run at q_start = rank S/tp
    against the gathered K/V, `wo` takes the rank's rows, and the rows
    are gathered back (`Mesh.gather_from`) or kept where the residual is
    sequence-parallel. JAX's contiguous split is kept: the last rank
    does ~2 tp - 1 times the first's causal work.
The prefill's cache holds every KV head (JAX's `cache_specs`), its T
rows over 'model' when T >= 4,096 and T % tp == 0 (`_seq_shard`). Decode
over such a cache (`cache_len` the whole length, the rank holding rows
rank T/tp ..) writes position cache_pos on the rank that owns it; each
rank computes its partial softmax over its rows (max, sum, weighted V)
and the ranks combine them over 'model'.

MLA on the model axis (ROADMAP item 10.3c): JAX's rules hold `w_uq`,
`w_uk`, `w_uv` as the rank's H/tp heads and `w_o` row-parallel; the
compressions `w_dq`, `w_dkv` and the norms stay whole (an FSDP config's
d over 'data'). Every rank compresses x whole; cq, c_kv and k_rope then
enter through Megatron's f (`Mesh.copy_to`), so every whole leaf's
gradient comes whole. Over a sequence each rank runs kernels 4-6 on its
heads at (192, 128) as above, `w_o` through g. The prefill's
compressed cache is every row's (B, T, .), its T over 'model' when T >=
4,096 and T % tp == 0 (JAX's `cache_specs`). The absorbed decode over
such a cache gathers q_lat and q_rope over the heads, takes each rank's
partial softmax over its rows for every head and combines them over
'model', then keeps the rank's heads for `w_uv` and `w_o`; over a whole
cache it runs on the rank's heads alone. With tp = 1 every path is the
one-device one.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.context import get_mesh
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_trainable)
from repro_torch.models.layers import (Norm, apply_norm, apply_rope,
                                       dense_init)

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
              cache_pos=None, layout="heads", seq_sharded=False,
              with_cache=True, cache_len=None):
    """Causal GQA, over each query's last `window` keys when given.
    Returns (out, kv). Decode — a cache and one token (S == 1) at
    cache_pos — updates the cache in place and returns it (a window's
    cache is a ring of T = min(window, max_len) slots); otherwise
    attention runs over the sequence itself (the flash kernels) and kv
    is its {k, v} (B, S, KV, hd), or with a window its last min(window,
    S) rows, the prefill's cache (None under tp > 1 without
    `with_cache`). Under tp > 1: the module docstring (`seq_sharded`: x
    is the rank's S/tp rows of a sequence-parallel residual;
    `cache_len`: a decode cache's whole length, its rows sharded over
    'model' when it differs from the rank's). Every collective below is
    the identity at tp = 1."""
    mesh = get_mesh()
    tp = mesh.shape.get("model", 1)
    r = mesh.coords["model"] if tp > 1 else 0
    heads = p.wq.shape[1] < cfg.n_heads       # the "heads" layout's blocks
    kv_cut = p.wk.shape[1] < cfg.n_kv_heads
    B, S, _ = x.shape
    decode = cache is not None and S == 1
    if tp > 1 and layout == "seq" and not heads and not decode:
        return _seq_attention(p, x, cfg, positions, window, seq_sharded,
                              with_cache, mesh)
    if heads and seq_sharded and not decode:
        x = mesh.all_gather(x, "model", dim=1)
    elif heads:
        x = mesh.copy_to(x, "model")
    q, k, v = _qkv(p, x, cfg, positions)
    if decode:
        if kv_cut:                            # the new row, every KV head
            k = mesh.all_gather(k.contiguous(), "model", dim=2)
            v = mesh.all_gather(v.contiguous(), "model", dim=2)
        T = cache["k"].shape[1]
        if tp > 1 and window is None and cache_len not in (None, T):
            # the cache's T rows held over 'model'
            out = _sharded_decode(q, k, v, cache, cache_pos, cache_len, cfg,
                                  heads, mesh)
        else:
            slot = cache_pos % T if window is not None \
                else min(max(cache_pos, 0), T - 1)
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            kc, vc = cache["k"], cache["v"]
            if kv_cut:
                n = cfg.n_kv_heads // tp
                kc = kc[:, :, r * n:(r + 1) * n]
                vc = vc[:, :, r * n:(r + 1) * n]
            elif heads:
                kc, vc = _local_kv(p, cfg, kc, vc, tp, r)
            if window is not None:
                # the absolute position each ring slot holds, masked to
                # the ones written, causal and inside the window
                slots = torch.arange(T, device=x.device)
                abs_pos = cache_pos - torch.remainder(slot - slots, T)
                mask = (abs_pos >= 0) & (abs_pos <= cache_pos) \
                    & (abs_pos > cache_pos - window)
                out = _masked_decode_attend(q, kc, vc, mask)
            else:
                out = attend(q, kc, vc, q_start=cache_pos,
                             kv_len=cache_pos + 1)
        kv = cache
    else:
        kq, vq = _local_kv(p, cfg, k, v, tp, r) if heads else (k, v)
        out = _flash(q, kq, vq, window)
        kv = {"k": k, "v": v}
        if window is not None:
            kv = {n: t[:, S - min(window, S):] for n, t in kv.items()}
        if heads:
            kv = _held_kv(kv, kv_cut, with_cache, mesh)
    y = out.flatten(2) @ p.wo.flatten(0, 1)
    if heads and seq_sharded and not decode:
        y = mesh.reduce_scatter(y, "model", dim=1)
    elif heads:
        y = mesh.reduce_from(y, "model")
    return y, kv


def _kv_heads(cfg, tp: int, r: int) -> list:
    """The global KV heads rank r's H/tp query heads read, to take from
    K/V held whole: one per group of local query heads when the groups
    are even (the kernels then read the narrow K/V), else one per local
    query head."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    hl, rep = H // tp, H // KV
    idx = [(r * hl + h) // rep for h in range(hl)]
    uniq = sorted(set(idx))
    g = hl // len(uniq)
    if hl % len(uniq) == 0 and all(idx[i] == uniq[i // g]
                                   for i in range(hl)):
        return uniq
    return idx


def _local_kv(p, cfg, k, v, tp: int, r: int):
    """K/V (B, T, ., hd) for the rank's query heads: its KV heads as held
    when `wk` is its block, else `_kv_heads`' selection of the whole."""
    if p.wk.shape[1] < cfg.n_kv_heads:
        return k, v
    idx = _kv_heads(cfg, tp, r)
    return k[:, :, idx], v[:, :, idx]


def _seq_rows(t, tp: int, r: int):
    """The rank's T/tp rows of a prefill cache leaf (B, T, ...) when T
    >= 4,096 divides over 'model' (JAX's `_seq_shard`), else t."""
    T = t.shape[1]
    if T >= 4096 and T % tp == 0:
        n = T // tp
        return t[:, r * n:(r + 1) * n]
    return t


def _held_kv(kv, kv_cut: bool, with_cache: bool, mesh):
    """The "heads" prefill's cache: None without `with_cache`, else every
    KV head (gathered over 'model' when the rank computed its block), its
    T rows the rank's (`_seq_rows`)."""
    if not with_cache:
        return None
    tp, r = mesh.shape["model"], mesh.coords["model"]
    with torch.no_grad():
        if kv_cut:
            kv = {n: mesh.all_gather(t.contiguous(), "model", dim=2)
                  for n, t in kv.items()}
        return {n: _seq_rows(t, tp, r) for n, t in kv.items()}


def _seq_attention(p, x, cfg, positions, window, seq_sharded, with_cache,
                   mesh):
    """The "seq" layout over a sequence: the rank's rows against K/V
    gathered along S (the module docstring). Returns (out, kv)."""
    tp, r = mesh.shape["model"], mesh.coords["model"]
    xr = x if seq_sharded else mesh.split(x, "model", dim=1)
    n = xr.shape[1]
    q, k, v = _qkv(p, xr, cfg, positions[..., r * n:(r + 1) * n])
    kf = mesh.all_gather(k, "model", dim=1)
    vf = mesh.all_gather(v, "model", dim=1)
    out = _flash(q, kf, vf, window, q_start=r * n)
    y = out.flatten(2) @ p.wo.flatten(0, 1)
    if not seq_sharded:
        y = mesh.gather_from(y, "model", dim=1)
    kv = None
    if with_cache:          # a window's last rows, the rank's when cut
        T = kf.shape[1]
        W = T if window is None else min(window, T)
        kv = {n: _seq_rows(t[:, T - W:].detach(), tp, r)
              for n, t in (("k", kf), ("v", vf))}
    return y, kv


def _sharded_decode(q, k, v, cache, cache_pos: int, cache_len: int, cfg,
                    heads: bool, mesh):
    """A decode tick over a cache whose T rows are held over 'model' (the
    rank's T = cache_len/tp from rank T ..): the new row k/v written on
    the rank that owns position cache_pos, then `_sharded_decode_attend`
    over every query head, the rank's heads kept in the "heads" layout."""
    tp, r = mesh.shape["model"], mesh.coords["model"]
    T = cache["k"].shape[1]
    slot = min(max(cache_pos, 0), cache_len - 1)
    if slot // T == r:
        cache["k"][:, slot - r * T] = k[:, 0]
        cache["v"][:, slot - r * T] = v[:, 0]
    qa = mesh.all_gather(q.contiguous(), "model", dim=2) if heads else q
    out = _sharded_decode_attend(qa, cache["k"], cache["v"], r * T,
                                 cache_pos, mesh)
    if heads:
        hl = cfg.n_heads // tp
        out = out[:, :, r * hl:(r + 1) * hl]
    return out


def _sharded_decode_attend(q, k, v, r0: int, cache_pos: int, mesh):
    """q (B, 1, H, hd) against the rank's rows r0.. of a cache k/v (B,
    T/tp, KV, hd), rows past cache_pos masked: each rank's partial
    softmax (its max, its sum of exp, its weighted V) combined over
    'model'. Returns (B, 1, H, hd) in q's dtype."""
    B, _, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bgrk,btgk->bgrt", qg.float() * hd ** -0.5, k.float())
    rows = r0 + torch.arange(T, device=q.device)
    s = torch.where(rows <= cache_pos, s,
                    torch.full((), NEG_INF, device=q.device))
    m = mesh.pmax(s.amax(dim=-1), "model")
    e = torch.exp(s - m[..., None])
    num = mesh.psum(torch.einsum("bgrt,btgk->bgrk", e, v.float()), "model")
    den = mesh.psum(e.sum(dim=-1), "model")
    return (num / den[..., None]).reshape(B, 1, H, hd).to(q.dtype)


def _flash(q, k, v, window=None, q_start=0):
    """Causal attention of a whole sequence, q (B, S, H, hd), k (B, Sk,
    KV, hd) and v (B, Sk, KV, hd_v), q's rows at positions q_start.., on
    the flash kernels: the trainable one (forward with lse, the backward
    kernels) when grad is on and an input requires it, the forward alone
    otherwise. Returns (B, S, H, hd_v)."""
    qkv = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    train = torch.is_grad_enabled() and any(t.requires_grad for t in qkv)
    fn = flash_attention_trainable if train else flash_attention
    return fn(*qkv, window=window, q_start=q_start).transpose(1, 2)


def gqa_cache_shape(cfg, batch, max_len, dtype=torch.bfloat16, device=None,
                    window=None):
    """Zero K/V {k, v} (batch, T, KV, hd): T = max_len, or min(window,
    max_len) for a windowed layer's ring."""
    T = min(window, max_len) if window else max_len
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {n: torch.zeros((batch, T, kv, hd), dtype=dtype, device=device)
            for n in ("k", "v")}


# ===================================================================== MLA
class MLA(nn.Module):
    """`w_dq` (d, q_lora), `w_uq` (q_lora, H, nope + rope), `w_dkv` (d,
    kv_lora + rope), `w_uk` (kv_lora, H, nope), `w_uv` (kv_lora, H, v),
    `w_o` (H, v, d) and the RMSNorm scales `q_norm`, `kv_norm`: JAX's
    `mla_init`."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.w_dq = dense_init(gen, (d, m.q_lora_rank), dtype)
        self.w_uq = dense_init(gen, (m.q_lora_rank, H, qk), dtype,
                               fan_in=m.q_lora_rank)
        self.w_dkv = dense_init(gen, (d, m.kv_lora_rank
                                      + m.qk_rope_head_dim), dtype)
        self.w_uk = dense_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim),
                               dtype, fan_in=m.kv_lora_rank)
        self.w_uv = dense_init(gen, (m.kv_lora_rank, H, m.v_head_dim), dtype,
                               fan_in=m.kv_lora_rank)
        self.w_o = dense_init(gen, (H, m.v_head_dim, d), dtype,
                              fan_in=H * m.v_head_dim)
        self.q_norm = Norm(m.q_lora_rank, dtype, device=gen.device)
        self.kv_norm = Norm(m.kv_lora_rank, dtype, device=gen.device)


def _mla_compress(p, x, cfg, positions):
    """The down-projections every MLA form shares: (cq, c_kv, k_rope),
    (B, S, q_lora), (B, S, kv_lora) and (B, S, rope)."""
    m = cfg.mla
    cq = apply_norm(p.q_norm, x @ p.w_dq)
    dkv = x @ p.w_dkv
    c_kv = apply_norm(p.kv_norm, dkv[..., :m.kv_lora_rank])
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:], positions, cfg.rope_theta)
    return cq, c_kv, k_rope


def mla_apply(p, x, cfg, positions, cache=None, cache_pos=None,
              cache_len=None):
    """MLA. Returns (out, kv). Decode — a cache {c_kv, k_rope} and one
    token (S == 1) at cache_pos — writes the token's row in place (at
    cache_pos clamped into the cache) and attends in the absorbed form
    over the rows up to cache_pos; kv is the cache. Otherwise the naive
    form runs the flash kernels at the head-dim pair (nope + rope,
    v_head_dim) over K and V decompressed, and kv is the sequence's
    {c_kv, k_rope}, the prefill's cache. Under the model axis (`w_uq`,
    `w_uk`, `w_uv` and `w_o` held as the rank's H/tp heads): the module
    docstring; `cache_len` is a decode cache's whole length."""
    m = cfg.mla
    B, S, _ = x.shape
    nope = m.qk_nope_head_dim
    mesh = get_mesh()
    tp = mesh.shape.get("model", 1)
    r = mesh.coords["model"] if tp > 1 else 0
    heads = p.w_uq.shape[1] < cfg.n_heads
    decode = cache is not None and S == 1
    cq, c_kv, k_rope = _mla_compress(p, x, cfg, positions)
    kv = {"c_kv": c_kv, "k_rope": k_rope}
    if heads and not decode:
        cq, c_kv, k_rope = (mesh.copy_to(t, "model")
                            for t in (cq, c_kv, k_rope))
    q = _proj(cq, p.w_uq)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    if decode:
        ck, cr = cache["c_kv"], cache["k_rope"]
        T = ck.shape[1]
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p.w_uk)
        if tp > 1 and cache_len not in (None, T):   # T rows over 'model'
            o_lat = _mla_sharded_decode(q_lat, q_rope, c_kv, k_rope, cache,
                                        cache_pos, cache_len, cfg, heads,
                                        mesh)
        else:
            slot = min(max(cache_pos, 0), T - 1)
            ck[:, slot] = c_kv[:, 0]
            cr[:, slot] = k_rope[:, 0]
            scale = (nope + m.qk_rope_head_dim) ** -0.5
            s = (torch.einsum("bshr,btr->bhst", q_lat.float(), ck.float())
                 + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                cr.float())) * scale
            t_idx = torch.arange(T, device=x.device)
            s = torch.where(t_idx <= cache_pos, s,
                            torch.full((), NEG_INF, device=x.device))
            a = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhst,btr->bshr", a, ck.float())
        o = torch.einsum("bshr,rhk->bshk", o_lat.to(x.dtype), p.w_uv)
        y = o.flatten(2) @ p.w_o.flatten(0, 1)
        return (mesh.reduce_from(y, "model") if heads else y), cache
    k_nope = _proj(c_kv, p.w_uk)
    v = _proj(c_kv, p.w_uv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, k_nope.shape[2], m.qk_rope_head_dim)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    out = _flash(qq, k, v)
    y = out.flatten(2) @ p.w_o.flatten(0, 1)
    if tp > 1:              # the cache's T rows the rank's when cut
        kv = {n: _seq_rows(t.detach(), tp, r) for n, t in kv.items()}
    return (mesh.reduce_from(y, "model") if heads else y), kv


def _mla_sharded_decode(q_lat, q_rope, c_kv, k_rope, cache, cache_pos: int,
                        cache_len: int, cfg, heads: bool, mesh):
    """The absorbed decode over a compressed cache whose T rows are held
    over 'model' (the rank's T = cache_len/tp from rank T ..): the new
    row written on the rank that owns cache_pos, q_lat and q_rope
    gathered over the heads, each rank's masked fp32 scores and partial
    softmax over its rows for every head, merged over 'model' (the max,
    then the sums); the rank's heads of o_lat kept in the "heads"
    layout. Returns o_lat (B, 1, heads, kv_lora) fp32."""
    m = cfg.mla
    tp, r = mesh.shape["model"], mesh.coords["model"]
    ck, cr = cache["c_kv"], cache["k_rope"]
    T = ck.shape[1]
    slot = min(max(cache_pos, 0), cache_len - 1)
    if slot // T == r:
        ck[:, slot - r * T] = c_kv[:, 0]
        cr[:, slot - r * T] = k_rope[:, 0]
    if heads:
        q_lat = mesh.all_gather(q_lat.contiguous(), "model", dim=2)
        q_rope = mesh.all_gather(q_rope.contiguous(), "model", dim=2)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s = (torch.einsum("bshr,btr->bhst", q_lat.float(), ck.float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(), cr.float())) \
        * scale
    rows = r * T + torch.arange(T, device=ck.device)
    s = torch.where(rows <= cache_pos, s,
                    torch.full((), NEG_INF, device=ck.device))
    mx = mesh.pmax(s.amax(dim=-1), "model")
    e = torch.exp(s - mx[..., None])
    num = mesh.psum(torch.einsum("bhst,btr->bshr", e, ck.float()), "model")
    den = mesh.psum(e.sum(dim=-1), "model")                     # (B,H,1)
    o_lat = num / den.transpose(1, 2)[..., None]
    if heads:
        hl = cfg.n_heads // tp
        o_lat = o_lat[:, :, r * hl:(r + 1) * hl]
    return o_lat


def mla_cache_shape(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    """Zero compressed caches {c_kv (batch, max_len, kv_lora), k_rope
    (batch, max_len, rope)}."""
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
