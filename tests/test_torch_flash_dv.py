"""Kernels 4-6 at a head-dim pair (D, D_v) = (192, 128), DeepSeek-V2's
MLA (q and k 128 + 64 wide, v 128), on the CPU:

  1. the port's plain versions (which CPU tensors take) against JAX's
     Pallas kernels in interpret mode (bq = bk = 64), fed V and dO
     zero-padded to 192 as JAX's MLA pads them, their o, dV sliced back
     to 128 (the padded columns of JAX's o and dV read 0): the forward,
     the forward with lse and the backward, MHA and GQA, S = 128, a
     ragged S and a query offset. JAX's kernels take S % 64 == 0 and no
     offset, so q's rows sit at their positions in a sequence of a
     multiple of 64 rows, the other rows zero with dO = 0 there (such a
     row adds nothing to dK or dV), and the keys past Sk are zeros in
     their future;
  2. torch emulations of the redesigned bf16 tensor-core kernels'
     arithmetic at the pair (csrc/flash_attention.cu: key tiles of 128
     at D_v = 128, P as P_hi + P_lo; csrc/flash_attention_bwd.cu: the
     dK/dV kernel's chunks, dQ's 64-key tiles, P and dS rounded to bf16
     once) within the bf16 tolerances of the fp32 plain versions on a
     plain, a peaky and a flat softmax;
  3. the wrapper's interface: the pair passes its check, o and dV come
     back D_v wide in q's and v's layouts, any other pair raises
     ValueError naming it; the dK/dV chunk count at the pair's 128-key
     blocks;
  4. the cost the wrappers report (each product at its own width) and a
     meta dry-run of a DeepSeek-V2 prefill at MLA's published head dims
     counting kernel 4's flops at 192 + 128.

Tolerances are tests/test_kernels.py's: 2e-5 for fp32 outputs and lse,
2e-2 for bf16, 1e-4 for fp32 gradients; the backward emulation is held
to half the bf16 gradient tolerance, 1e-2 of each gradient's largest
magnitude, as tests/test_torch_flash_attention.py holds it."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.distributed.context import Mesh, mesh_context
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_trainable,
                                                 flash_fwd_lse)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, flash_fwd_lse_ref)
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.sharding import attn_layout
from repro_torch.optim import AdamWConfig

D, DV = 192, 128
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
EMU_TOL = 0.5 * 2e-2


def err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return err(got, want) / float(np.abs(want).max())


def to_np(t):
    return t.detach().float().numpy()


def pair_inputs(seed, B, H, KV, Sq, Sk, qmul=1.0, kmul=1.0):
    """q (B, H, Sq, 192), k (B, KV, Sk, 192), v (B, KV, Sk, 128) and dO
    (B, H, Sq, 128), N(0, 1) from numpy (q and k times qmul, kmul)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D), np.float32) * qmul,
            rng.standard_normal((B, KV, Sk, D), np.float32) * kmul,
            rng.standard_normal((B, KV, Sk, DV), np.float32),
            rng.standard_normal((B, H, Sq, DV), np.float32))


# --------------------------------------------- 1. against JAX's Pallas kernels
def embed(x, L, at):
    """x's rows (axis 2) at rows at.. of L zero rows."""
    out = np.zeros(x.shape[:2] + (L,) + x.shape[3:], np.float32)
    out[:, :, at:at + x.shape[2]] = x
    return out


def pad_last(x, n):
    return np.concatenate([x, np.zeros(x.shape[:-1] + (n - x.shape[-1],),
                                       np.float32)], axis=-1)


# (H, KV, Sq, Sk, q_start)
PALLAS_CASES = [(2, 2, 128, 128, 0), (4, 2, 128, 128, 0),
                (4, 2, 100, 100, 0),        # ragged S
                (2, 2, 50, 128, 70)]        # a query offset, Sk past it
PALLAS_IDS = ["mha", "gqa", "ragged", "offset"]


@pytest.mark.parametrize("H,KV,Sq,Sk,q0", PALLAS_CASES, ids=PALLAS_IDS)
def test_pair_matches_pallas_kernels_on_padded_v(H, KV, Sq, Sk, q0):
    """The forward (kernel 4), the forward with lse (5) and the backward
    (6) at (192, 128) against JAX's three Pallas kernels in interpret mode
    fed V and dO zero-padded to 192: o, lse, dQ, dK, dV within 2e-5,
    2e-5 and 1e-4; JAX's o and dV read 0 past column 128."""
    B, rep = 1, H // KV
    q, k, v, do = pair_inputs(H + Sq + q0, B, H, KV, Sq, Sk)
    L = -(-Sk // 64) * 64
    jq, jdo = embed(q, L, q0), embed(pad_last(do, D), L, q0)
    jk, jv = (np.repeat(embed(a, L, 0), rep, axis=1)
              for a in (k, pad_last(v, D)))
    rows = slice(q0, q0 + Sq)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))

    want_o = np.asarray(ops.flash_attention(*map(jnp.asarray, (jq, jk, jv)),
                                            bq=64, bk=64), np.float32)
    assert np.abs(want_o[..., DV:]).max() == 0
    o = flash_attention(tq, tk, tv, q_start=q0)
    assert o.shape == (B, H, Sq, DV)
    assert err(to_np(o), want_o[:, :, rows, :DV]) < TOL["float32"]

    jo, jlse = jfa._flash_fwd_lse(*map(jnp.asarray, (jq, jk, jv)), True, 64,
                                  64, True)
    jo = np.array(jo, np.float32)
    jlse = np.array(jlse, np.float32).reshape(B, H, L)
    o2, lse = flash_fwd_lse(tq, tk, tv, q_start=q0)
    assert err(to_np(o2), jo[:, :, rows, :DV]) < TOL["float32"]
    assert err(lse.numpy(), jlse[:, :, rows]) < 2e-5

    jdq, jdk, jdv = (np.asarray(g, np.float32) for g in
                     jfa.flash_attention_bwd(
        *map(jnp.asarray, (jq, jk, jv, jo)),
        jnp.asarray(jlse.reshape(B * H, L)), jnp.asarray(jdo), causal=True,
        bq=64, bk=64, interpret=True))
    assert np.abs(jdv[..., DV:]).max() == 0
    got = flash_attention_bwd(
        tq, tk, tv, torch.from_numpy(jo[:, :, rows, :DV].copy()),
        torch.from_numpy(jlse[:, :, rows].copy()), tdo,
        q_start=q0)

    def group(a, n):
        return a.reshape(B, KV, rep, L, a.shape[-1]).sum(2)[:, :, :Sk, :n]
    want = (jdq[:, :, rows], group(jdk, D), group(jdv, DV))
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and np.abs(w).max() > 0, n
        assert err(to_np(g), w) < GRAD_TOL, n


def test_trainable_pair_matches_autograd_on_padded_v():
    """The differentiable call at (192, 128) against autograd through the
    plain forward on V zero-padded to 192 and its output sliced to 128
    (JAX's MLA form, in torch): o and every gradient within 2e-5 and
    1e-4."""
    q, k, v, do = pair_inputs(7, 1, 4, 2, 96, 96)

    def grads(fn, v_in):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v_in)]
        o = fn(*ts)
        gs = torch.autograd.grad(o, ts, torch.from_numpy(do))
        return o, gs
    o, g = grads(flash_attention_trainable, v)
    ro, rg = grads(lambda a, b, c: flash_attention_ref(a, b, c)[..., :DV],
                   pad_last(v, D))
    assert o.shape[-1] == DV and err(to_np(o), to_np(ro)) < TOL["float32"]
    assert err(to_np(rg[2])[..., DV:], 0.0) == 0
    for a, b in zip(g, (rg[0], rg[1], rg[2][..., :DV])):
        assert a.shape == b.shape
        assert err(to_np(a), to_np(b)) < GRAD_TOL


# ------------------------------------- 2. the bf16 tensor-core kernels' math
def forward_emulation(q, k, v):
    """The redesigned bf16 forward (`flash_attention_wgmma_kernel`) at a
    (D, D_v) pair, in torch on the CPU: fp32 scores of the bf16 inputs at
    D, the scale applied to them (folded with log2 e into exp2), an online
    softmax over key tiles of BK (128 at D_v <= 128, 64 above: the
    consumer's registers) with the running max in log2 units, P as P_hi +
    P_lo (both bf16) for P V at D_v, the denominator the sum of the
    unrounded p, the output rounded to bf16 once. Each warpgroup of 64
    rows walks its block's tiles: a tile wholly in its rows' future adds
    p = 0 once the row has a key, as here. Returns (o bf16, lse fp32)."""
    B, H, S, Dq = q.shape
    Dv = v.shape[3]
    rep = H // k.shape[1]
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    c = torch.tensor(Dq ** -0.5 * np.log2(np.e), dtype=torch.float32)
    bk = 128 if Dv <= 128 else 64
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, Dv))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf[:, :, k0:k0 + bk])
        keys = torch.arange(k0, min(k0 + bk, S))[None, :]
        s = torch.where(keys > rows, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", hi + lo, vf[:, :, k0:k0 + bk])
        m = m_new
    den = l.clamp(min=1e-30)
    return ((acc / den[..., None]).bfloat16(),
            m * np.float32(np.log(2.0)) + torch.log(den))


def backward_emulation(q, k, v, o, lse, do):
    """The redesigned bf16 backward kernels at a pair, in torch on the CPU:
    fp32 products of the bf16 inputs, S and dK and dQ at D, dP and dV at
    D_v; p = exp2(s scale log2 e - lse log2 e), 0 where masked; P and dS
    rounded to bf16 once before the products that take them; the dK/dV
    kernel's blocks summing head after head of the chunk and q tile (64
    rows) after q tile, dK scaled at the end, the chunks summed in order;
    dQ summed over key tiles of 64 keys and
    scaled at the end; delta = rowsum(do * o) in fp32 at D_v; each
    gradient rounded to bf16 once. Returns (dq, dk, dv) in bf16."""
    B, H, S, Dq = q.shape
    KV, Dv = k.shape[1], v.shape[3]
    rep = H // KV
    chunks = tfa.dkv_chunks(True, B, H, KV, S, Dq, Dv)
    scale = torch.tensor(Dq ** -0.5, dtype=torch.float32)
    c = torch.tensor(Dq ** -0.5 * np.log2(np.e), dtype=torch.float32)
    lse2 = lse.float() * torch.tensor(np.log2(np.e), dtype=torch.float32)
    delta = (do.float() * o.float()).sum(-1)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    pos = torch.arange(S)
    zero = torch.zeros(())

    def bf(x):
        return x.bfloat16().float()
    dk, dv = torch.zeros(B, KV, S, Dq), torch.zeros(B, KV, S, Dv)
    per = rep // chunks
    for ch in range(chunks):
        ak, av = torch.zeros(B, KV, S, Dq), torch.zeros(B, KV, S, Dv)
        for j in range(per):
            hs = torch.arange(KV) * rep + ch * per + j
            for q0 in range(0, S, 64):
                qt, dot = qf[:, hs, q0:q0 + 64], dof[:, hs, q0:q0 + 64]
                pt = torch.exp2(torch.einsum("bgkd,bgqd->bgkq", kf, qt) * c
                                - lse2[:, hs, None, q0:q0 + 64])
                pt = torch.where(pos[:, None] > pos[None, q0:q0 + 64], zero,
                                 pt)
                av += torch.einsum("bgkq,bgqd->bgkd", bf(pt), dot)
                dpt = torch.einsum("bgkd,bgqd->bgkq", vf, dot)
                dst = pt * (dpt - delta[:, hs, None, q0:q0 + 64])
                ak += torch.einsum("bgkq,bgqd->bgkd", bf(dst), qt)
        dk += ak * scale
        dv += av
    bk = 128 if Dq <= 128 else 64
    kr, vr = kf.repeat_interleave(rep, 1), vf.repeat_interleave(rep, 1)
    dq = torch.zeros(B, H, S, Dq)
    for k0 in range(0, S, bk):
        kt, vt = kr[:, :, k0:k0 + bk], vr[:, :, k0:k0 + bk]
        p = torch.exp2(torch.einsum("bhqd,bhkd->bhqk", qf, kt) * c
                       - lse2[..., None])
        p = torch.where(pos[None, k0:k0 + bk] > pos[:, None], zero, p)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vt)
                  - delta[..., None])
        dq += torch.einsum("bhqk,bhkd->bhqd", bf(ds), kt)
    return (dq * scale).bfloat16(), dk.bfloat16(), dv.bfloat16()


# (B, H, KV, S), (q, k) x: a plain softmax (ragged against the 128-key
# tiles), a peaky one (one key takes nearly all the weight) and a flat
# one over the most keys the CPU affords
EMU_CASES = [((1, 2, 2, 320), (1.0, 1.0)), ((1, 4, 2, 256), (4.0, 4.0)),
             ((1, 1, 1, 1024), (0.05, 1.0))]
EMU_IDS = ["plain", "peaky", "flat"]


def bf16_inputs(seed, shape, mul):
    B, H, KV, S = shape
    q, k, v, do = pair_inputs(seed, B, H, KV, S, S, *mul)
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v,
                                                                   do))


@pytest.mark.parametrize("shape,mul", EMU_CASES, ids=EMU_IDS)
def test_forward_emulation_at_pair_matches_fp32_plain(shape, mul):
    """P_hi + P_lo over 128-key tiles at (192, 128): o and lse within 2e-2
    of the fp32 plain forward on the same bf16 inputs."""
    q, k, v, _ = bf16_inputs(sum(shape), shape, mul)
    got, lse = forward_emulation(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == shape[:2] + (
        shape[3], DV)
    ro, rlse = flash_fwd_lse_ref(q.float(), k.float(), v.float())
    assert err(to_np(got), to_np(ro)) < TOL["bfloat16"]
    assert err(lse.numpy(), rlse.numpy()) < TOL["bfloat16"]


@pytest.mark.parametrize("shape,mul", EMU_CASES, ids=EMU_IDS)
def test_backward_emulation_at_pair_matches_fp32_plain(shape, mul):
    """P and dS rounded to bf16 once at (192, 128): dQ, dK, dV within 1e-2
    of each gradient's largest magnitude of the fp32 plain backward on the
    same bf16 inputs, o and lse."""
    q, k, v, do = bf16_inputs(sum(shape) + 1, shape, mul)
    o, lse = flash_fwd_lse_ref(q, k, v)
    got = backward_emulation(q, k, v, o, lse, do)
    want = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse,
                                   do.float())
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, n
        assert float(w.abs().max()) > 0, n
        assert rel(to_np(g), to_np(w)) <= EMU_TOL, n


# ------------------------------------------------------ 3. the interface
def model_layout(B, S, n, width, dtype=torch.float32, device="cpu"):
    """(B, n, S, width) seen through .transpose(1, 2) of (B, S, n, width)
    storage, as the model passes its projections."""
    return torch.zeros((B, S, n, width), dtype=dtype,
                       device=device).transpose(1, 2)


def test_check_takes_the_pair_and_names_any_other():
    q, k = model_layout(1, 8, 2, D), model_layout(1, 8, 1, D)
    assert tfa.HEAD_DIM_PAIRS == ((192, 128),)
    assert tfa._check("flash_attention", q, k, model_layout(1, 8, 1, DV)) \
        == (1, 2, 1, 8, D)
    for dq, dv in ((192, 64), (128, 192)):
        with pytest.raises(ValueError, match=rf"\({dq}, {dv}\)"):
            tfa._check("flash_attention", model_layout(1, 8, 2, dq),
                       model_layout(1, 8, 1, dq), model_layout(1, 8, 1, dv))
    with pytest.raises(ValueError, match="v"):
        tfa._check("flash_attention", q, k, model_layout(1, 9, 1, DV))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_launch_path_gives_d_v_wide_outputs_in_q_layout(dtype):
    """On meta (the card's launch path without the launch) o is (B, H, S,
    128) with q's axes order, lse (B, H, S), dV v's shape and the dK/dV
    partials of their own widths; (192, 64) and (128, 192) raise."""
    B, H, KV, S = 2, 4, 2, 100
    q = model_layout(B, S, H, D, dtype, "meta")
    k = model_layout(B, S, KV, D, dtype, "meta")
    v = model_layout(B, S, KV, DV, dtype, "meta")
    o = flash_attention(q, k, v)
    assert o.shape == (B, H, S, DV) and o.dtype == dtype
    assert o.transpose(1, 2).is_contiguous()
    o2, lse = flash_fwd_lse(q, k, v)
    assert o2.shape == (B, H, S, DV) and lse.shape == (B, H, S)
    with op_analysis.OpCounter() as c:
        c.arguments(q, k, v, o2, lse, o2)
        dq, dk, dv = flash_attention_bwd(q, k, v, o2, lse, o2)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    chunks = tfa.dkv_chunks(dtype == torch.bfloat16, B, H, KV, S, D, DV)
    assert c.peak_bytes - c.argument_bytes >= 4 * B * KV * chunks * S * (
        D + DV)
    for dq_, dv_ in ((192, 64), (128, 192)):
        with pytest.raises(ValueError, match=rf"\({dq_}, {dv_}\)"):
            flash_attention(model_layout(1, 8, 2, dq_, dtype, "meta"),
                            model_layout(1, 8, 1, dq_, dtype, "meta"),
                            model_layout(1, 8, 1, dv_, dtype, "meta"))


def test_dkv_chunks_at_the_pair():
    """The Python twin of `flash_bwd_dkv_chunks` at (192, 128): blocks of
    128 keys (each consumer warpgroup holds dK and dV of 64), where the
    padded (192, 192) instance's blocks hold 64."""
    assert tfa.dkv_chunks(True, 1, 16, 2, 4096, D, DV) == 4     # 64 blocks
    assert tfa.dkv_chunks(True, 1, 16, 2, 4096, D) == 2         # 128 blocks
    assert tfa.dkv_chunks(False, 1, 16, 2, 4096, D, DV) == 8


def test_cpu_pair_equals_padded_v_sliced():
    """On the CPU the pair's plain forward and backward equal the padded
    V's, sliced, within 1e-6 (the zero columns add nothing; the sums may
    be blocked apart), and o keeps q's layout."""
    q, k, v, do = pair_inputs(3, 1, 4, 4, 70, 70)
    tq = torch.from_numpy(np.ascontiguousarray(q.transpose(0, 2, 1, 3))) \
        .transpose(1, 2)
    tk, tv, tdo = map(torch.from_numpy, (k, v, do))
    o, lse = flash_fwd_lse(tq, tk, tv)
    assert o.shape == (1, 4, 70, DV) and o.transpose(1, 2).is_contiguous()
    po, plse = flash_fwd_lse(tq, tk, torch.from_numpy(pad_last(v, D)))
    assert err(to_np(o), to_np(po)[..., :DV]) < 1e-6
    assert torch.equal(lse, plse)
    got = flash_attention_bwd(tq, tk, tv, o, lse, tdo)
    want = flash_attention_bwd(tq, tk, torch.from_numpy(pad_last(v, D)),
                               po, plse, torch.from_numpy(pad_last(do, D)))
    for g, w in zip(got, (want[0], want[1], want[2][..., :DV])):
        assert err(to_np(g), to_np(w)) < 1e-6


# ------------------------------------------------ 4. the cost and the dry-run
def test_cost_charges_each_product_at_its_width():
    B, H, KV, S = 1, 4, 2, 100
    q, k, v = (torch.zeros((B, n, S, w), device="meta")
               for n, w in ((H, D), (KV, D), (KV, DV)))
    pairs = S * (S + 1) // 2
    assert tfa._cost(q, k, v, True, 0, 0, 1, 1) == \
        2 * B * H * pairs * (D + DV)
    assert tfa._cost(q, k, v, True, 0, 0, 3, 2) == \
        2 * B * H * pairs * (3 * D + 2 * DV)
    with op_analysis.OpCounter() as c:
        o, lse = flash_fwd_lse(q, k, v)
        flash_attention_bwd(q, k, v, o, lse, o)
    assert c.kernel_flops["flash_fwd_lse"] == 2 * B * H * pairs * (D + DV)
    assert c.kernel_flops["flash_bwd_dkv"] == \
        2 * B * H * pairs * (3 * D + 2 * DV)


def test_dryrun_prefill_counts_kernel4_at_the_pair():
    """A meta dry-run of a reduced DeepSeek-V2 prefill at MLA's published
    head dims (128 + 64, 128; everything else reduced) charges kernel 4
    n_layers 2 B H pairs (192 + 128) flops: V is never padded."""
    base = get_reduced("deepseek_v2_236b")
    cfg = dataclasses.replace(base, mla=dataclasses.replace(
        base.mla, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=DV))
    B, S = 2, 64
    mesh = Mesh((1, 1), ("data", "model"))
    with mesh_context(mesh):
        step, args, held = dryrun.lm_step(
            cfg, ShapeSpec("p", "prefill", S, B), AdamWConfig(),
            attn_layout(cfg, 1), mesh, device="meta", dtype=torch.float32)
        rec = dryrun.count(step, args, held)
    assert rec["kernel_calls"]["flash_attention"] == cfg.n_layers
    assert rec["kernel_flops"]["flash_attention"] == \
        cfg.n_layers * 2 * B * cfg.n_heads * (S * (S + 1) // 2) * (D + DV)
