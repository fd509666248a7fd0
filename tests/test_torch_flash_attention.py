"""The port's flash attention (on CPU tensors, its plain version) against
the JAX package's: the Pallas kernel through `repro.kernels.ops` in
interpret mode (bq = bk = 64) and the jnp oracle `ref.flash_attention_ref`,
at the shapes of tests/test_kernels.py plus ragged lengths; the grouped
(GQA) form against repeated heads and against `models.attention._sdpa`;
causality. Tolerances are tests/test_kernels.py's: 2e-5 for fp32, 2e-2
for bf16 (inputs rounded to bf16 the same way in both packages)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_ref

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
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    assert flash_attention.launches == before
