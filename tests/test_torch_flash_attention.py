"""The port's flash attention (on CPU tensors, its plain versions) against
the JAX package's: the Pallas kernels in interpret mode (bq = bk = 64) —
the forward through `repro.kernels.ops`, `_flash_fwd_lse`,
`flash_attention_bwd` and the custom_vjp `flash_attention_trainable` —
and the jnp oracle `ref.flash_attention_ref`, at the shapes of
tests/test_kernels.py plus ragged lengths; the grouped (GQA) form against
repeated heads and against `models.attention._sdpa`; causality; the
head dim 192 of DeepSeek-V2's MLA (128 + 64, V padded), MHA and GQA.
Torch
emulations of the bf16 tensor-core kernels' arithmetic (the forward's P
split into two bf16 parts before P V; the backward's P and dS rounded to
bf16 once, its tile and chunk order of summation) are held against the
same JAX kernels and the fp32 plain versions, since the kernels
themselves run only on the card.
Tolerances are tests/test_kernels.py's: 2e-5 for fp32 outputs and lse,
2e-2 for bf16 (inputs rounded to bf16 the same way in both packages),
1e-4 for gradients; the backward emulation is held to half the bf16
gradient tolerance, 1e-2 of each gradient's largest magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_trainable,
                                                 flash_fwd_lse)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, flash_fwd_lse_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def qkv(seed, B, H, KV, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), np.float32),
            rng.standard_normal((B, KV, S, D), np.float32),
            rng.standard_normal((B, KV, S, D), np.float32))


def err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def to_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (2, 3, 256, 64),
                                   (1, 2, 512, 128), (2, 2, 200, 64),
                                   (1, 1, 77, 32)])
def test_plain_matches_pallas_kernel_and_oracle(shape, dtype):
    B, H, S, D = shape
    jdt, tdt = DT[dtype]
    q, k, v = qkv(sum(shape), B, H, H, S, D)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == tdt and got.shape == (B, H, S, D)
    kernel = ops.flash_attention(jq, jk, jv, bq=64, bk=64)
    oracle = jref.flash_attention_ref(jq, jk, jv)
    assert err(to_np(got), kernel.astype(jnp.float32)) < TOL[dtype]
    assert err(to_np(got), oracle.astype(jnp.float32)) < TOL[dtype]


@pytest.mark.parametrize("H,KV", [(4, 2), (16, 2), (6, 3), (4, 1)])
def test_grouped_heads_match_repeated_heads_and_sdpa(H, KV):
    B, S, D = 2, 96, 64
    q, k, v = qkv(H * 10 + KV, B, H, KV, S, D)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)))
    rep = H // KV
    kr, vr = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    repeated = flash_attention(*map(torch.from_numpy, (q, kr, vr)))
    assert err(to_np(got), to_np(repeated)) < 1e-6
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, kr, vr)))
    assert err(to_np(got), want) < TOL["float32"]
    # JAX's model attention groups heads the same way: h reads h // rep
    sd = jattn._sdpa(jnp.asarray(q.transpose(0, 2, 1, 3)),
                     jnp.asarray(k.transpose(0, 2, 1, 3)),
                     jnp.asarray(v.transpose(0, 2, 1, 3)), 0, S, None,
                     D ** -0.5)
    assert err(to_np(got), np.asarray(sd).transpose(0, 2, 1, 3)) \
        < TOL["float32"]


def test_strided_inputs_as_the_model_passes_them():
    """(B, S, H, D) storage seen through .transpose(1, 2), as attention's
    prefill hands its projections over; the result keeps q's strides."""
    B, H, KV, S, D = 2, 4, 2, 70, 64
    q, k, v = qkv(5, B, H, KV, S, D)
    dense = flash_attention(*map(torch.from_numpy, (q, k, v)))
    qs, ks, vs = (torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3))).transpose(1, 2) for a in (q, k, v))
    assert not qs.is_contiguous()
    got = flash_attention(qs, ks, vs)
    assert got.shape == (B, H, S, D)
    assert err(to_np(got), to_np(dense)) < 1e-6


@pytest.mark.parametrize("S,p", [(128, 100), (200, 63), (66, 64)])
def test_causality(S, p):
    """Perturbing the keys and values after position p leaves every
    output up to p unchanged."""
    q, k, v = map(torch.from_numpy, qkv(S + p, 1, 4, 2, S, 64))
    o1 = flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, p + 1:] += 7.0
    v2[:, :, p + 1:] -= 3.0
    o2 = flash_attention(q, k2, v2)
    assert torch.equal(o1[:, :, :p + 1], o2[:, :, :p + 1])
    assert not torch.equal(o1[:, :, p + 1:], o2[:, :, p + 1:])


def test_full_attention_matches_oracle():
    """causal=False: every key is seen (the TPU kernel's other mode)."""
    q, k, v = qkv(9, 1, 2, 2, 128, 64)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=False)
    assert err(to_np(got), want) < TOL["float32"]


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, qkv(1, 1, 2, 1, 33, 64))
    counters = (flash_attention, flash_fwd_lse, tfa._bwd_dkv, tfa._bwd_dq)
    before = [f.launches for f in counters]
    assert torch.equal(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    o, lse = flash_fwd_lse(q, k, v)
    ro, rlse = flash_fwd_lse_ref(q, k, v)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    do = torch.ones_like(q)
    for a, b in zip(flash_attention_bwd(q, k, v, o, lse, do),
                    flash_attention_bwd_ref(q, k, v, o, lse, do)):
        assert torch.equal(a, b)
    assert [f.launches for f in counters] == before


# ------------------------------------------------------------------ training
def jax_fwd_lse(q, k, v, causal=True):
    """JAX's `_flash_fwd_lse` in interpret mode: (o, lse (B*H, S))."""
    return jfa._flash_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, 64, 64, True)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("D", [32, 64])
def test_fwd_lse_matches_pallas_kernel(S, D):
    B, H = 2, 3
    q, k, v = qkv(S + D, B, H, H, S, D)
    jo, jlse = jax_fwd_lse(q, k, v)
    o, lse = flash_fwd_lse(*map(torch.from_numpy, (q, k, v)))
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert lse.shape == (B, H, S)
    assert err(to_np(o), jo) < TOL["float32"]
    assert err(lse.reshape(B * H, S).numpy(), jlse) < 2e-5
    # lse is the rows' logsumexp of the scaled, masked scores
    s = np.einsum("bhqd,bhkd->bhqk", q * D ** -0.5, k)
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert err(lse.numpy(), want) < 2e-5


@pytest.mark.parametrize("S,causal", [(128, True), (256, True),
                                      (128, False)])
def test_bwd_matches_pallas_kernels(S, causal):
    """The plain backward fed JAX's own o and lse, against JAX's two
    Pallas backward kernels (KV == H, S % 64 == 0: their contract)."""
    B, H, D = 1, 2, 64
    q, k, v = qkv(S + 1, B, H, H, S, D)
    do = np.random.default_rng(S).standard_normal((B, H, S, D)) \
        .astype(np.float32)
    jo, jlse = jax_fwd_lse(q, k, v, causal)
    want = jfa.flash_attention_bwd(
        *map(jnp.asarray, (q, k, v, jo, jlse, do)), causal=causal, bq=64,
        bk=64, interpret=True)
    got = flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, np.array(jo),
                                np.array(jlse).reshape(B, H, S), do)),
        causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert err(to_np(g), w) < 1e-4


def torch_grads(fn, q, k, v):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    return torch.autograd.grad(torch.tanh(fn(*ts)).sum(), ts)


@pytest.mark.parametrize("H,S,D", [(2, 128, 64), (1, 256, 32)])
def test_trainable_grads_match_jax_custom_vjp(H, S, D):
    """torch.autograd.grad of sum(tanh(flash_attention_trainable)) against
    jax.grad of JAX's flash_attention_trainable (fwd and bwd both Pallas
    kernels in interpret mode)."""
    q, k, v = qkv(H * S + D, 1, H, H, S, D)

    def jloss(q, k, v):
        return jnp.sum(jnp.tanh(jfa.flash_attention_trainable(
            q, k, v, True, 64, 64, True)))
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = torch_grads(flash_attention_trainable, q, k, v)
    for g, w in zip(got, want):
        assert err(to_np(g), w) < 1e-4


@pytest.mark.parametrize("H,KV,S,causal", [(4, 2, 96, True),
                                           (8, 2, 64, True),
                                           (4, 1, 80, True),
                                           (6, 3, 100, False)])
def test_trainable_grouped_heads_match_repeated_heads(H, KV, S, causal):
    """GQA (KV < H): dK/dV come back (B, KV, S, D), each the sum over its
    group's query heads — autograd through the plain forward with the
    KV heads repeated gives the same."""
    q, k, v = qkv(H + KV + S, 2, H, KV, S, 64)
    got = torch_grads(lambda *t: flash_attention_trainable(*t, causal),
                      q, k, v)
    rep = H // KV

    def repeated(q, k, v):
        return flash_attention_ref(q, k.repeat_interleave(rep, 1),
                                   v.repeat_interleave(rep, 1), causal)
    want = torch_grads(repeated, q, k, v)
    assert got[1].shape == (2, KV, S, 64)
    for g, w in zip(got, want):
        assert err(to_np(g), to_np(w)) < 1e-4


@pytest.mark.parametrize("S,causal", [(100, True), (77, False), (1, True)])
def test_trainable_ragged_lengths(S, causal):
    """Any S: against autograd through the port's plain forward (JAX's
    kernels take only S % 64 == 0)."""
    q, k, v = qkv(S, 1, 4, 2, S, 64)
    got = torch_grads(lambda *t: flash_attention_trainable(*t, causal),
                      q, k, v)
    want = torch_grads(lambda *t: flash_attention_ref(*t, causal), q, k, v)
    for g, w in zip(got, want):
        assert err(to_np(g), to_np(w)) < 1e-4


def test_bwd_bf16_rounds_like_the_inputs():
    """bf16 in: fp32 arithmetic, each gradient rounded to bf16 once,
    within 2e-2 of the fp32 backward on the same rounded inputs."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in qkv(3, 1, 4, 2, 128, 64))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    o, lse = flash_fwd_lse(q, k, v)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse,
                                   do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert err(to_np(g), to_np(w)) < TOL["bfloat16"]


# ------------------------------------------ the bf16 tensor-core kernel's math
def tensor_core_emulation(q, k, v, causal=True):
    """The arithmetic of the bf16 tensor-core kernel (csrc/flash_attention.cu,
    `flash_attention_wgmma_kernel`) written out in torch on the CPU: fp32
    scores of the bf16 inputs, the scale applied to them after the product
    (folded with log2 e into exp2), an online softmax over key tiles of BK
    (128 at D <= 128, 64 above) with the running max in log2 units, P
    taken under that running max as P_hi + P_lo, both bf16 (p rounded, and
    the rest rounded), for P V while the denominator sums the unrounded p,
    and the output rounded to bf16 once. Returns (o in bf16, lse in
    fp32)."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    c = torch.tensor(D ** -0.5 * np.log2(np.e), dtype=torch.float32)
    bk = 128 if D <= 128 else 64
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf[:, :, k0:k0 + bk])
        if causal:
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


# the shapes of tests/test_kernels.py, then a peaky softmax (q and k x 4:
# one key takes nearly all the weight) and a flat one (q x 0.05) over the
# most keys the CPU affords, where the rounding of P adds up over most terms
TC_CASES = [((1, 1, 128, 64), 1.0, 1.0), ((2, 3, 256, 64), 1.0, 1.0),
            ((1, 2, 512, 128), 1.0, 1.0), ((1, 2, 256, 128), 4.0, 4.0),
            ((1, 1, 1024, 128), 0.05, 1.0), ((1, 2, 320, 192), 1.0, 1.0)]


@pytest.mark.parametrize("shape,qmul,kmul", TC_CASES)
def test_tensor_core_numerics_match_pallas_kernel_and_oracle(shape, qmul,
                                                            kmul):
    """P as P_hi + P_lo in bf16 before P V (the rounding the fp32 contract
    lacks) keeps the bf16 kernel's arithmetic within 2e-2 of JAX's Pallas
    kernel (interpret mode, bf16), of JAX's oracle and of the port's plain
    version, on the same bf16 inputs."""
    B, H, S, D = shape
    q, k, v = qkv(sum(shape), B, H, H, S, D)
    q, k = q * qmul, k * kmul
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got, lse = tensor_core_emulation(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, D)
    kernel = ops.flash_attention(jq, jk, jv, bq=64, bk=64)
    oracle = jref.flash_attention_ref(jq, jk, jv)
    assert err(to_np(got), kernel.astype(jnp.float32)) < TOL["bfloat16"]
    assert err(to_np(got), oracle.astype(jnp.float32)) < TOL["bfloat16"]
    ro, rlse = flash_fwd_lse_ref(tq, tk, tv)
    assert err(to_np(got), to_np(ro)) < TOL["bfloat16"]
    assert err(lse.numpy(), rlse.numpy()) < TOL["bfloat16"]


def test_tensor_core_numerics_lse_and_groups_match_pallas_lse_kernel():
    """The emulation's lse against JAX's `_flash_fwd_lse` (interpret mode)
    on bf16 inputs, and grouped heads (KV < H) against the same heads
    repeated: the kernel maps the groups, the arithmetic is per head."""
    B, H, KV, S, D = 1, 4, 2, 256, 64
    q, k, v = qkv(11, B, H, KV, S, D)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got, lse = tensor_core_emulation(tq, tk, tv)
    rep = H // KV
    kr, vr = (t.repeat_interleave(rep, 1) for t in (tk, tv))
    rgot, rlse = tensor_core_emulation(tq, kr, vr)
    assert torch.equal(got, rgot) and torch.equal(lse, rlse)
    jo, jlse = jfa._flash_fwd_lse(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (tq, kr, vr)), True, 64, 64, True)
    assert err(to_np(got), jnp.asarray(jo).astype(jnp.float32)) \
        < TOL["bfloat16"]
    assert err(lse.reshape(B * H, S).numpy(), jlse) < TOL["bfloat16"]


@pytest.mark.parametrize("S,causal", [(200, True), (65, True), (1, True),
                                      (300, False)])
def test_tensor_core_numerics_ragged_and_full(S, causal):
    """Ragged lengths (the kernel masks its last tile; TMA fills zeros),
    S = 1 and causal=False, D = 256 (key tiles of 64): within 2e-2 of the
    port's plain version on the same bf16 inputs."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in qkv(S + 3, 1, 2, 1, S, 256))
    got, lse = tensor_core_emulation(q, k, v, causal)
    ro, rlse = flash_fwd_lse_ref(q, k, v, causal)
    assert err(to_np(got), to_np(ro)) < TOL["bfloat16"]
    assert err(lse.numpy(), rlse.numpy()) < TOL["bfloat16"]


# ------------------------------- the bf16 tensor-core backward kernels' math
def dkv_chunks(B, H, KV, S, D):
    """The bf16 dK/dV kernel's chunk count (csrc/flash_attention_bwd.cu,
    `dkv_chunks`): the fewest chunks of a group's H / KV query heads (a
    divisor) that give at least 256 blocks of 128 keys (64 above D =
    128)."""
    rep, keys = H // KV, 64 if D > 128 else 128
    base = B * KV * -(-S // keys)
    return next((c for c in range(1, rep) if rep % c == 0
                 and base * c >= 256), rep)


def backward_tensor_core_emulation(q, k, v, o, lse, do, causal=True,
                                   chunks=None):
    """The arithmetic of the bf16 tensor-core backward kernels
    (csrc/flash_attention_bwd.cu) written out in torch on the CPU: fp32
    products of the bf16 inputs; p = exp2(s * scale * log2 e - lse *
    log2 e) (the scale applied to the fp32 scores, 0 where masked); P and
    dS rounded to bf16 once before the products that take them; dK/dV
    summed per chunk of each group's query heads, head after head and q
    tile (64 rows) after q tile, dK scaled at the end, the chunks summed
    in order; dQ summed key tile (128 keys, 64 above D = 128) after key
    tile
    and scaled at the end; delta = rowsum(do * o) in fp32; each gradient
    rounded to bf16 once. Returns (dq, dk, dv) in bf16."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    rep = H // KV
    chunks = chunks or dkv_chunks(B, H, KV, S, D)
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    c = torch.tensor(D ** -0.5 * np.log2(np.e), dtype=torch.float32)
    lse2 = lse.float() * torch.tensor(np.log2(np.e), dtype=torch.float32)
    delta = (do.float() * o.float()).sum(-1)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    pos = torch.arange(S)
    zero = torch.zeros(())

    def bf(x):
        return x.bfloat16().float()
    dk = torch.zeros(B, KV, S, D)
    dv = torch.zeros(B, KV, S, D)
    per = rep // chunks
    for ch in range(chunks):
        ak, av = torch.zeros(B, KV, S, D), torch.zeros(B, KV, S, D)
        for j in range(per):
            hs = torch.arange(KV) * rep + ch * per + j
            for q0 in range(0, S, 64):
                qt, dot = qf[:, hs, q0:q0 + 64], dof[:, hs, q0:q0 + 64]
                st = torch.einsum("bgkd,bgqd->bgkq", kf, qt)
                pt = torch.exp2(st * c - lse2[:, hs, None, q0:q0 + 64])
                if causal:
                    pt = torch.where(pos[:, None] > pos[None, q0:q0 + 64],
                                     zero, pt)
                av += torch.einsum("bgkq,bgqd->bgkd", bf(pt), dot)
                dpt = torch.einsum("bgkd,bgqd->bgkq", vf, dot)
                dst = pt * (dpt - delta[:, hs, None, q0:q0 + 64])
                ak += torch.einsum("bgkq,bgqd->bgkd", bf(dst), qt)
        dk += ak * scale
        dv += av
    bk = 128 if D <= 128 else 64
    kr, vr = kf.repeat_interleave(rep, 1), vf.repeat_interleave(rep, 1)
    dq = torch.zeros(B, H, S, D)
    for k0 in range(0, S, bk):
        kt, vt = kr[:, :, k0:k0 + bk], vr[:, :, k0:k0 + bk]
        p = torch.exp2(torch.einsum("bhqd,bhkd->bhqk", qf, kt) * c
                       - lse2[..., None])
        if causal:
            p = torch.where(pos[None, k0:k0 + bk] > pos[:, None], zero, p)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vt)
                  - delta[..., None])
        dq += torch.einsum("bhqk,bhkd->bhqd", bf(ds), kt)
    return (dq * scale).bfloat16(), dk.bfloat16(), dv.bfloat16()


def bwd_inputs(seed, B, H, KV, S, D, qmul=1.0, kmul=1.0, causal=True):
    """bf16 q, k, v, do (q and k times qmul, kmul) with o and lse from the
    plain forward on them, as phase 13 of chip_smoke.py feeds the
    kernels."""
    q, k, v = qkv(seed, B, H, KV, S, D)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape) \
        .astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q * qmul, k * kmul, v, do))
    o, lse = flash_fwd_lse_ref(tq, tk, tv, causal)
    return tq, tk, tv, o, lse, tdo


# half the bf16 gradient tolerance (2e-2 of each gradient's largest
# magnitude): the design's margin before P or dS would be split hi + lo
EMU_TOL = 0.5 * 2e-2


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return err(got, want) / float(np.abs(want).max())


# (B, H, KV, S, D), causal, (q, k) x, chunks (None: the kernel's rule)
BWD_TC_CASES = [
    ((1, 8, 1, 256, 128), True, (1.0, 1.0), 4),     # GQA 8, 4 chunks of 2
    ((1, 2, 2, 200, 64), True, (1.0, 1.0), None),   # KV == H, ragged S
    ((1, 4, 2, 130, 128), False, (1.0, 1.0), None),  # full, ragged S
    ((1, 2, 1, 160, 256), True, (1.0, 1.0), None),  # D = 256, ragged S
    ((1, 4, 4, 200, 192), True, (1.0, 1.0), None),  # MLA's D = 192, MHA
    ((1, 8, 1, 256, 128), True, (4.0, 4.0), 2),     # peaky softmax
    ((1, 2, 1, 512, 128), True, (0.05, 1.0), None),  # flat softmax
]


@pytest.mark.parametrize("shape,causal,mul,chunks", BWD_TC_CASES)
def test_backward_tensor_core_numerics_match_fp32_plain(shape, causal, mul,
                                                       chunks):
    """P and dS rounded to bf16 once stay within half the bf16 tolerance
    (1e-2 of each gradient's largest magnitude) of the plain backward in
    fp32 on the same bf16 inputs, o and lse."""
    B, H, KV, S, D = shape
    tq, tk, tv, o, lse, tdo = bwd_inputs(S + D, *shape, *mul, causal)
    got = backward_tensor_core_emulation(tq, tk, tv, o, lse, tdo, causal,
                                         chunks)
    want = flash_attention_bwd_ref(*(t.float() for t in (tq, tk, tv, o)),
                                   lse, tdo.float(), causal)
    for g, w, n in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert float(w.abs().max()) > 0, n
        assert rel(to_np(g), to_np(w)) <= EMU_TOL, n


@pytest.mark.parametrize("shape,causal,mul", [
    ((1, 2, 2, 128, 64), True, (1.0, 1.0)),
    ((1, 2, 2, 128, 128), False, (1.0, 1.0)),
    ((1, 8, 1, 128, 64), True, (1.0, 1.0)),         # GQA against repeats
    ((1, 1, 1, 128, 256), True, (1.0, 1.0)),
    ((1, 2, 2, 128, 64), True, (4.0, 4.0)),         # peaky
    ((1, 1, 1, 256, 64), True, (0.05, 1.0)),        # flat
])
def test_backward_tensor_core_numerics_match_pallas_kernels(shape, causal,
                                                           mul):
    """The same emulation against JAX's two Pallas backward kernels in
    interpret mode (bq = bk = 64) on the same bf16 inputs, o and lse:
    within 1e-2 of each gradient's largest magnitude. JAX's kernels take
    KV == H, so a GQA case gives them the KV heads repeated and sums
    their dK/dV over each group."""
    B, H, KV, S, D = shape
    tq, tk, tv, o, lse, tdo = bwd_inputs(S + D + 7, *shape, *mul, causal)
    got = backward_tensor_core_emulation(tq, tk, tv, o, lse, tdo, causal)
    rep = H // KV
    jt = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in
          (tq, tk.repeat_interleave(rep, 1), tv.repeat_interleave(rep, 1),
           o, tdo)]
    jdq, jdk, jdv = jfa.flash_attention_bwd(
        *jt[:4], jnp.asarray(lse.reshape(B * H, S).numpy()), jt[4],
        causal=causal, bq=64, bk=64, interpret=True)

    def group(a):
        return np.asarray(a, np.float32).reshape(B, KV, rep, S, D).sum(2)
    for g, w in zip(got, (np.asarray(jdq, np.float32), group(jdk),
                          group(jdv))):
        assert np.abs(w).max() > 0
        assert rel(to_np(g), w) <= EMU_TOL


# ------------------------------------------- head dim 192 (DeepSeek-V2's MLA)
@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2)])
def test_head_dim_192_matches_pallas_kernels(H, KV):
    """D = 192, the MLA naive form's query/key head dim (128 + 64, V
    padded to it), at S = 128: the plain forward, forward with lse and
    backward against JAX's Pallas kernels in interpret mode (bq = bk =
    64), MHA as they take it and GQA against them fed the KV heads
    repeated, dK/dV summed over each group."""
    B, S, D = 1, 128, 192
    rep = H // KV
    q, k, v = qkv(H + 192, B, H, KV, S, D)
    do = np.random.default_rng(H).standard_normal((B, H, S, D)) \
        .astype(np.float32)
    kr, vr = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = flash_attention(tq, tk, tv)
    assert err(to_np(o), ops.flash_attention(
        *map(jnp.asarray, (q, kr, vr)), bq=64, bk=64)) < TOL["float32"]
    jo, jlse = jax_fwd_lse(q, kr, vr)
    o2, lse = flash_fwd_lse(tq, tk, tv)
    assert err(to_np(o2), jo) < TOL["float32"]
    assert err(lse.reshape(B * H, S).numpy(), jlse) < 2e-5
    want = jfa.flash_attention_bwd(
        *map(jnp.asarray, (q, kr, vr, jo, jlse, do)), causal=True, bq=64,
        bk=64, interpret=True)
    got = flash_attention_bwd(tq, tk, tv, torch.from_numpy(np.array(jo)),
                              torch.from_numpy(np.array(jlse)).reshape(
                                  B, H, S), tdo)
    groups = [np.asarray(w, np.float32) for w in want]
    groups[1:] = [w.reshape(B, KV, rep, S, D).sum(2) for w in groups[1:]]
    for g, w in zip(got, groups):
        assert g.shape == w.shape and np.abs(w).max() > 0
        assert err(to_np(g), w) < 1e-4


def test_kernel_interface_takes_the_head_dims_it_has_instances_for():
    """The wrapper's check (run before a launch) takes D in HEAD_DIMS,
    192 among them, and names the tuple when it refuses one."""
    assert tfa.HEAD_DIMS == (64, 128, 192, 256)
    for D in tfa.HEAD_DIMS:
        q, k, v = map(torch.from_numpy, qkv(D, 1, 2, 1, 8, D))
        assert tfa._check("flash_attention", q, k, v) == (1, 2, 1, 8, D)
    q, k, v = map(torch.from_numpy, qkv(0, 1, 2, 1, 8, 96))
    with pytest.raises(ValueError, match=r"head dim 96 not in \(64, 128, "
                                         r"192, 256\)"):
        tfa._check("flash_attention", q, k, v)
