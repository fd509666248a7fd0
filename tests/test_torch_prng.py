"""The port's threefry replica (`repro_torch.core.prng`) against live
`jax.random` (legacy uint32 keys, partitionable threefry): every way the
engine path uses a key, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import neuron as jn
from repro_torch.core import neuron as tn
from repro_torch.core import prng

SEEDS = [0, 1, 2 ** 31 - 1, -1, -12345, -(2 ** 31)]


def host(k):
    return prng.to_host(k)


def test_jax_runs_partitionable_threefry():
    """The replica follows `jax_threefry_partitionable=True`."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    np.testing.assert_array_equal(host(prng.PRNGKey(seed)),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3])
def test_split(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(host(prng.split(prng.PRNGKey(seed), num)),
                                  want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    for d in [0, 1, 7, 2 ** 31 - 1, -1, -(2 ** 31)]:
        want = np.asarray(jax.random.fold_in(key, jnp.int32(d)))
        np.testing.assert_array_equal(
            host(prng.fold_in(prng.PRNGKey(seed), d)), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 17, 1000])
def test_randint_noise_range(seed, n):
    lo, hi = -(2 ** 16), 2 ** 16
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,),
                                         lo, hi, dtype=jnp.int32))
    got = prng.randint(prng.PRNGKey(seed), n, lo, hi).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 10), (-5, 1000), (3, 3), (9, 2),
                                   (-(2 ** 31), 2 ** 31 - 1)])
def test_randint_other_spans(lo, hi):
    """Spans that are not a power of two draw the high bits too."""
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.random.randint(key, (37,), lo, hi,
                                         dtype=jnp.int32))
    np.testing.assert_array_equal(
        prng.randint(prng.PRNGKey(4), 37, lo, hi).numpy(), want)


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(OverflowError):
        prng.randint(prng.PRNGKey(0), 3, 0, 2 ** 31)


def test_engine_key_uses_over_lanes():
    """The engine's chain on B lanes at once: lane roots fold_in(root, b),
    the scratch root fold_in(root, 2**31-1), then per step
    `key, sub = split(key)` and `noise_draw(sub, n)`."""
    root = jax.random.PRNGKey(11)
    lanes = jnp.arange(5, dtype=jnp.int32)
    jkeys = jax.vmap(lambda b: jax.random.fold_in(root, b))(lanes)
    tkeys = prng.fold_in(prng.PRNGKey(11), torch.arange(5))
    np.testing.assert_array_equal(host(tkeys), np.asarray(jkeys))
    np.testing.assert_array_equal(
        host(prng.fold_in(prng.PRNGKey(11), 2 ** 31 - 1)),
        np.asarray(jax.random.fold_in(root, 2 ** 31 - 1)))
    for _ in range(3):
        jsplit = jax.vmap(jax.random.split)(jkeys)
        jkeys, jsub = jsplit[:, 0], jsplit[:, 1]
        tkeys, tsub = prng.split(tkeys)
        np.testing.assert_array_equal(host(tkeys), np.asarray(jkeys))
        ju = jax.vmap(lambda k: jn.noise_draw(k, 300))(jsub)
        np.testing.assert_array_equal(tn.noise_draw(tsub, 300).numpy(),
                                      np.asarray(ju))


def test_host_round_trip():
    k = np.asarray(jax.random.split(jax.random.PRNGKey(3), 4))
    np.testing.assert_array_equal(prng.to_host(prng.from_host(k)), k)
    assert prng.to_host(prng.from_host(k)).dtype == np.uint32
