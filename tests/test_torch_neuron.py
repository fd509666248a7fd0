"""The port's fixed-point neuron math and the plain version of its
`lif_step` kernel against the JAX package, bit for bit (integer math:
no tolerance anywhere), and a numpy model of the kernel's work
partition."""
import re
from pathlib import Path

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


class _Elsewhere:
    """A tensor's stand-in on a device the port does not run on (the
    wrappers read its device first)."""
    device = torch.device("xpu")


def test_lif_step_rejects_other_devices():
    """The kernel runs on the card, its plain version on the CPU and its
    shapes on meta (the dry-run); any other device, or a mix, raises."""
    x = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda device, the cpu or meta"):
        lif_step(*[_Elsewhere()] * 7)
    with pytest.raises(ValueError, match="cuda device, the cpu or meta"):
        lif_step(x, x, x, x, x, x, torch.zeros(4, dtype=torch.bool))


def test_pack_models():
    models = [tn.LIF_neuron(5, 1, 3), tn.ANN_neuron(7, -20)]
    jm = [jn.LIF_neuron(5, 1, 3), jn.ANN_neuron(7, -20)]
    for a, b in zip(tn.pack_models(models, device="cpu"),
                    jn.pack_models(jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tn.LIF_neuron(5, nu=40)


# ------------------------------------- the lif_step kernel's work partition
LIF_SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
              / "csrc" / "lif_step.cu").read_text()
BASE = 1 << 20        # a 16 B aligned address; the model adds each offset


def lif_constant(name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, LIF_SOURCE)
               .group(1))


def membrane_np(V, u, theta, nu, lam, lif, syn):
    """membrane.cuh's `membrane_step` in numpy int64, wrapping to int32."""
    def wrap(x):
        return (x + 2 ** 31) % 2 ** 32 - 2 ** 31
    u = u | 1
    left = wrap(u << np.minimum(np.maximum(nu, 0), 31))
    right = np.sign(u) * (np.abs(u) >> np.minimum(-np.minimum(nu, 0), 31))
    v = wrap(V + np.where(nu >= 0, left, wrap(right)))
    spike = v > theta
    v = np.where(spike, 0, v)
    v = np.where(lif, wrap(v - (v >> np.clip(lam, 0, 31))), 0)
    return wrap(v + syn), spike


def lif_kernel_model(V, syn, u, theta, nu, lam, is_lif, offsets=None):
    """`csrc/lif_step.cu`'s mapping in numpy: thread g of grid row b owns
    neurons 4g .. 4g + 3 (fewer at the row's end) of lane b; each lane
    takes the widest access (16, 8 or 4 B; 4, 2 or 1 spike bytes) that
    its rows allow, from the row start and the bases' byte offsets
    (`offsets`: each array's base address mod 16), and the last group
    scalar accesses. Asserts every access aligned and every (lane,
    neuron) read and written exactly once. Returns (V_next, spikes)."""
    threads, per = lif_constant("kThreads"), lif_constant("kNeurons")
    off = dict.fromkeys(("V", "syn", "u", "V_out", "spikes", "theta", "nu",
                         "lam", "is_lif"), 0)
    off.update(offsets or {})
    B, n = V.shape
    base_or = (off["V"] | off["syn"] | off["u"] | off["V_out"]
               | off["spikes"] << 2) & 15
    params_vec = (off["theta"] | off["nu"] | off["lam"]
                  | off["is_lif"] << 2) & 15 == 0
    aligned = n % per == 0 and base_or == 0 and params_vec
    groups = -(-n // per)
    g = np.arange(-(-groups // threads) * threads)
    j0 = per * g[per * g < n]                      # live threads
    m = np.minimum(per, n - j0)
    k = np.arange(per)
    own = k[None, :] < m[:, None]                  # (threads, 4)
    j = np.where(own, j0[:, None] + k, 0)

    def check(name, elem, w, size=4):
        """Every access of w elements at element offsets `elem` is
        aligned to its width."""
        addr = BASE + off[name] + elem * size
        assert (addr % (w * size) == 0).all(), (name, w)

    vec = params_vec & (m == per)
    for name, size in (("theta", 4), ("nu", 4), ("lam", 4), ("is_lif", 1)):
        check(name, j0[vec], per, size)
    V_out = np.zeros_like(V)
    spikes = np.zeros((B, n), bool)
    reads = np.zeros((B, n), int)
    writes = np.zeros((B, n), int)
    for b in range(B):
        row = b * n
        a = (base_or | row * 4) & 15
        w = np.where(m < per, 1, 4 if aligned or a == 0
                     else 2 if a & 7 == 0 else 1)
        for wd in (4, 2):
            at = j0[w == wd]
            for h in range(0, per, wd):
                for name in ("V", "syn", "u", "V_out"):
                    check(name, row + at + h, wd)
                check("spikes", row + at + h, wd, 1)
        np.add.at(reads[b], j[own], 1)
        out, s = membrane_np(
            V[b][j].astype(np.int64), u[b][j].astype(np.int64),
            theta[j].astype(np.int64), nu[j].astype(np.int64),
            lam[j].astype(np.int64), is_lif[j], syn[b][j].astype(np.int64))
        V_out[b][j[own]] = out[own]
        spikes[b][j[own]] = s[own]
        np.add.at(writes[b], j[own], 1)
    assert (reads == 1).all() and (writes == 1).all()
    return V_out, spikes


def lanes_of(seed, B, n):
    p = random_neurons(seed, n)
    rng = np.random.default_rng(seed + 1)
    V = rng.integers(-2 ** 31, 2 ** 31, (B, n), dtype=np.int64)
    syn = rng.integers(-2 ** 31, 2 ** 31, (B, n), dtype=np.int64)
    u = rng.integers(-2 ** 16, 2 ** 16, (B, n))
    return [V.astype(np.int32), syn.astype(np.int32), u.astype(np.int32),
            p["theta"], p["nu"], p["lam"], p["is_lif"]]


@pytest.mark.parametrize("B", [1, 8, 13])
@pytest.mark.parametrize("n", [1, 3, 5, 1001, 3010, 125_000])
def test_lif_kernel_partition_covers_every_element_once(B, n):
    args = lanes_of(n + B, B, n)
    got_V, got_s = lif_kernel_model(*args)
    want_V, want_s = lif_step(*(t(a) for a in args))
    np.testing.assert_array_equal(got_V, want_V.numpy())
    np.testing.assert_array_equal(got_s, want_s.numpy())


@pytest.mark.parametrize("offsets", [
    {"V": 8}, {"V": 4, "u": 8}, {"spikes": 2}, {"spikes": 1},
    {"theta": 4}, {"is_lif": 2}, {"V_out": 12, "is_lif": 1}])
def test_lif_kernel_partition_at_misaligned_bases(offsets):
    """Tensors whose storage starts off a 16 B boundary take narrower
    accesses, still aligned and still once each."""
    for B, n in ((3, 8), (13, 3010), (2, 1001)):
        args = lanes_of(B * n, B, n)
        got_V, got_s = lif_kernel_model(*args, offsets=offsets)
        want_V, want_s = lif_step(*(t(a) for a in args))
        np.testing.assert_array_equal(got_V, want_V.numpy())
        np.testing.assert_array_equal(got_s, want_s.numpy())
