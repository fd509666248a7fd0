"""The port's fixed-point neuron math and the plain version of its
`lif_step` kernel against the JAX package, bit for bit (integer math:
no tolerance anywhere)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import neuron as jn
from repro.kernels import ops
from repro_torch.core import neuron as tn
from repro_torch.core import prng
from repro_torch.kernels.lif_step import lif_step

V32 = np.array([0, 1, -1, 2, -2, 1000, -1000, 2 ** 30, -(2 ** 30),
                2 ** 31 - 1, -(2 ** 31) + 1, -(2 ** 31), 12345, -54321],
               np.int32)


def t(a):
    return torch.as_tensor(np.asarray(a))


def test_noise_from_u_every_nu():
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.integers(-2 ** 16, 2 ** 16, 500),
                        [-2 ** 16, 2 ** 16 - 1, 0, -1, 1]]).astype(np.int32)
    for nu in range(-32, 32):
        nus = np.full(u.shape, nu, np.int32)
        want = np.asarray(jn.noise_from_u(jnp.asarray(u), jnp.asarray(nus)))
        got = tn.noise_from_u(t(u), t(nus)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"nu={nu}")


@pytest.mark.parametrize("lam", range(64))
def test_leak_every_lambda(lam):
    rng = np.random.default_rng(lam)
    V = np.concatenate([V32, rng.integers(-2 ** 31, 2 ** 31, 200)]) \
        .astype(np.int32)
    lams = np.full(V.shape, lam, np.int32)
    want = np.asarray(jn.leak(jnp.asarray(V), jnp.asarray(lams)))
    np.testing.assert_array_equal(tn.leak(t(V), t(lams)).numpy(), want)


def test_leak_lambda63_is_floor_division():
    """The λ = 63 cases of tests/test_leak_exact.py: V - V // 2**63 in
    unbounded ints."""
    V = V32[V32 != -(2 ** 31)]
    want = np.array([v - (v // 2 ** 63) for v in V.tolist()], np.int64)
    got = tn.leak(t(V), torch.full(V.shape, 63, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def random_neurons(seed, n):
    rng = np.random.default_rng(seed)
    return dict(
        V=rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
        .astype(np.int32),
        syn=rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
        .astype(np.int32),
        u=rng.integers(-2 ** 16, 2 ** 16, n).astype(np.int32),
        theta=rng.integers(-2 ** 20, 2 ** 20, n).astype(np.int32),
        nu=rng.integers(-32, 32, n).astype(np.int32),
        lam=rng.integers(0, 64, n).astype(np.int32),
        is_lif=rng.random(n) < 0.6)


@pytest.mark.parametrize("seed", range(3))
def test_fire_phase_with_key(seed):
    p = random_neurons(seed, 200)
    jv, js = jn.fire_phase(jnp.asarray(p["V"]), jnp.asarray(p["theta"]),
                           jnp.asarray(p["nu"]), jnp.asarray(p["lam"]),
                           jnp.asarray(p["is_lif"]),
                           jax.random.PRNGKey(seed))
    tv, ts = tn.fire_phase(t(p["V"]), t(p["theta"]), t(p["nu"]),
                           t(p["lam"]), t(p["is_lif"]), prng.PRNGKey(seed))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tn.integrate_phase(tv, t(p["syn"])).numpy(),
        np.asarray(jn.integrate_phase(jv, jnp.asarray(p["syn"]))))


@pytest.mark.parametrize("n", [1, 77, 300, 1000])
def test_plain_lif_step_matches_pallas_kernel(n):
    """On CPU tensors the `lif_step` wrapper takes its plain version; it
    equals the Pallas kernel (interpret mode) at unaligned N."""
    p = random_neurons(n, n)
    jV, js = ops.lif_step(*(jnp.asarray(p[k]) for k in
                            ("V", "syn", "u", "theta", "nu", "lam",
                             "is_lif")))
    tV, ts = lif_step(*(t(p[k]) for k in ("V", "syn", "u", "theta", "nu",
                                          "lam", "is_lif")))
    np.testing.assert_array_equal(tV.numpy(), np.asarray(jV))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_lif_step_lanes_are_independent():
    """A (B, N) call equals B single-lane calls; parameters broadcast."""
    p = random_neurons(5, 90)
    rng = np.random.default_rng(1)
    V = rng.integers(-2 ** 31, 2 ** 31, (3, 90), dtype=np.int64) \
        .astype(np.int32)
    u = rng.integers(-2 ** 16, 2 ** 16, (3, 90)).astype(np.int32)
    params = [t(p[k]) for k in ("theta", "nu", "lam", "is_lif")]
    Vb, sb = lif_step(t(V), t(V[::-1].copy()), t(u), *params)
    for b in range(3):
        V1, s1 = lif_step(t(V[b]), t(V[2 - b]), t(u[b]), *params)
        assert torch.equal(Vb[b], V1) and torch.equal(sb[b], s1)


def test_lif_step_rejects_other_devices():
    x = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lif_step(x, x, x, x, x, x, x.bool())


def test_pack_models():
    models = [tn.LIF_neuron(5, 1, 3), tn.ANN_neuron(7, -20)]
    jm = [jn.LIF_neuron(5, 1, 3), jn.ANN_neuron(7, -20)]
    for a, b in zip(tn.pack_models(models, device="cpu"),
                    jn.pack_models(jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tn.LIF_neuron(5, nu=40)
