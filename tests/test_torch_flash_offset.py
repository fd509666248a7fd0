"""Kernels 4-6 with a query offset (`q_start`), on the CPU: their plain
versions (`repro_torch.kernels.ref`, which CPU tensors take) against
JAX's `models.attention.attend(q, k, v, cfg, q_start=..., kv_len=Sk,
window=...)` — the function the sequence-sharded layout's rank computes
on its rows against the gathered K/V (`_shardmap_seq_attention`).

q (B, H, Sq, D) at positions q_start .. q_start + Sq - 1 against k, v
(B, KV, Sk, D), in fp32 and bf16 (inputs rounded to bf16 the same way in
both packages), at D 64, 128, 192 and 256, with and without a window,
on ragged and tile-aligned Sq; the trainable version's gradients
against `jax.vjp` of `attend`; keys no query sees get zero dK and dV;
q_start = 0 with Sq == Sk gives the bits of the plain versions' earlier
formula (the lower-triangular mask, copied here); and the interface
refuses an offset past Sk or below 0 on the CPU as on the card.
Tolerances are tests/test_kernels.py's: 2e-5 for fp32 outputs and lse,
2e-2 for bf16, 1e-4 of the largest magnitude for gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_trainable,
                                                 flash_fwd_lse)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, flash_fwd_lse_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (B, Sq, Sk, H, KV, D), q_start, window
CASES = [
    ((1, 64, 256, 4, 2, 64), 192, None),       # the last of 4 seq blocks
    ((1, 64, 256, 4, 2, 64), 64, None),
    ((2, 37, 200, 4, 1, 128), 101, None),      # ragged, unaligned
    ((1, 40, 160, 4, 4, 192), 80, 30),         # MLA's D, a window
    ((1, 32, 128, 2, 1, 256), 96, 64),         # the hybrid's D and MQA
    ((1, 50, 300, 4, 2, 64), 0, None),         # keys past the queries
    ((1, 17, 90, 8, 2, 128), 70, 9),           # Sq + q_start < Sk, window
]
IDS = [f"{c[0]}@{c[1]}" + (f"w{c[2]}" if c[2] else "") for c in CASES]


def inputs(seed, shape):
    B, Sq, Sk, H, KV, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D), np.float32),
            rng.standard_normal((B, KV, Sk, D), np.float32),
            rng.standard_normal((B, KV, Sk, D), np.float32),
            rng.standard_normal((B, H, Sq, D), np.float32))


def jax_attend(q, k, v, q_start, window):
    """JAX's attend on (B, heads, S, D) arrays: q rows at q_start.."""
    o = jattn.attend(q.swapaxes(1, 2), k.swapaxes(1, 2), v.swapaxes(1, 2),
                     None, q_start=q_start, kv_len=k.shape[2],
                     window=window)
    return o.swapaxes(1, 2)


def err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,q0,W", CASES, ids=IDS)
def test_forward_matches_jax_attend(shape, q0, W, dtype):
    jdt, tdt = DT[dtype]
    q, k, v, _ = inputs(sum(shape) + q0, shape)
    want = np.asarray(jax_attend(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                 q0, W), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    o = flash_attention(tq, tk, tv, window=W, q_start=q0)
    o2, lse = flash_fwd_lse(tq, tk, tv, window=W, q_start=q0)
    assert o.shape == tq.shape and lse.shape == tq.shape[:3]
    assert err(o.float(), want) <= TOL[dtype]
    assert torch.equal(o, o2)
    # lse: the row's logsumexp of the scaled, masked scores
    s = torch.einsum("bgrqd,bgkd->bgrqk", tq.float().reshape(
        shape[0], shape[4], -1, shape[1], shape[5]) * shape[5] ** -0.5,
        tk.float())
    pos = q0 + torch.arange(shape[1])[:, None]
    key = torch.arange(shape[2])[None, :]
    mask = (key <= pos) & ((key > pos - W) if W else True)
    want_lse = torch.logsumexp(torch.where(mask, s, -1e30), dim=-1)
    assert err(lse, want_lse.reshape(lse.shape)) <= TOL["float32"]


@pytest.mark.parametrize("shape,q0,W", CASES, ids=IDS)
def test_trainable_gradients_match_jax_vjp(shape, q0, W):
    q, k, v, do = inputs(sum(shape) + q0 + 1, shape)
    out, vjp = jax.vjp(lambda a, b, c: jax_attend(a, b, c, q0, W),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention_trainable(tq, tk, tv, window=W, q_start=q0)
    assert err(o.detach(), np.asarray(out)) <= TOL["float32"]
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(w).max() > 0
        assert err(g, w) <= GRAD_TOL * np.abs(w).max()
    # and the backward's plain version on the forward's own o and lse
    ro, rlse = flash_fwd_lse_ref(tq.detach(), tk.detach(), tv.detach(),
                                 True, W, q0)
    bw = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), ro,
                             rlse, torch.from_numpy(do), window=W,
                             q_start=q0)
    for g, w in zip(bw, want):
        assert err(g, w) <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("window", [None, 7])
def test_keys_no_query_sees_get_zero_gradients(window):
    """Sq rows at q_start against Sk keys: the keys after the last row's
    position (and, with a window, before the first row's window) get dK
    = dV = 0 exactly."""
    shape, q0 = (1, 20, 100, 4, 2, 64), 40
    q, k, v, do = (torch.from_numpy(a) for a in inputs(3, shape))
    o, lse = flash_fwd_lse_ref(q, k, v, True, window, q0)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, True, window,
                                         q0)
    assert (dk[:, :, q0 + 20:] == 0).all() and (dv[:, :, q0 + 20:] == 0).all()
    assert dk[:, :, q0 + 19].abs().max() > 0
    if window:
        first = q0 - window + 1
        assert (dk[:, :, :first] == 0).all() and (dv[:, :, :first] == 0).all()
        assert dv[:, :, first].abs().max() > 0


def _old_scores(q, k, window):
    """The plain versions' mask before the offset: S x S, tril (and
    triu(1 - window))."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    qg = q.reshape(B, KV, H // KV, S, D).float() * D ** -0.5
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float())
    mask = torch.ones((S, S), dtype=torch.bool).tril()
    if window is not None:
        mask = mask.triu(1 - window)
    return torch.where(mask, s, torch.full((), -1e30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_no_offset_gives_the_earlier_bits(dtype, window):
    """q_start = 0 with Sq == Sk: forward, lse and backward equal the
    earlier formula's (the lower-triangular mask) bit for bit."""
    tdt = DT[dtype][1]
    shape = (2, 45, 45, 4, 2, 64)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in inputs(9, shape))
    s = _old_scores(q, k, window)
    B, H, S, D = q.shape
    o_old = torch.einsum("bgrqk,bgkd->bgrqd", torch.softmax(s, dim=-1),
                         v.float()).reshape(B, H, S, D).to(tdt)
    m = s.amax(dim=-1)
    lse_old = (m + torch.log(torch.exp(s - m[..., None]).sum(dim=-1)
                             .clamp(min=1e-30))).reshape(B, H, S)
    assert torch.equal(flash_attention(q, k, v, window=window), o_old)
    assert torch.equal(flash_attention_ref(q, k, v, True, window, 0), o_old)
    o, lse = flash_fwd_lse(q, k, v, window=window)
    assert torch.equal(o, o_old) and torch.equal(lse, lse_old)
    new = flash_attention_bwd(q, k, v, o, lse, do, window=window)
    same = flash_attention_bwd(q, k, v, o, lse, do, window=window,
                               q_start=0)
    assert all(torch.equal(a, b) for a, b in zip(new, same))


@pytest.mark.parametrize("q0,Sq,Sk", [(1, 64, 64), (-1, 8, 64),
                                      (60, 8, 64)])
def test_offsets_past_the_keys_raise(q0, Sq, Sk):
    """q_start + Sq > Sk, or q_start < 0, raises ValueError in every
    entry (the CPU's plain versions as the card's kernels)."""
    q = torch.zeros((1, 2, Sq, 64))
    k = v = torch.zeros((1, 1, Sk, 64))
    for fn in (lambda: flash_attention(q, k, v, q_start=q0),
               lambda: flash_fwd_lse(q, k, v, q_start=q0),
               lambda: flash_attention_trainable(q, k, v, q_start=q0),
               lambda: flash_attention_bwd(q, k, v, q, q[..., 0], q,
                                           q_start=q0)):
        with pytest.raises(ValueError, match="q_start"):
            fn()
    with pytest.raises(ValueError, match="q_start"):
        flash_attention(q, k, v, q_start=True)
