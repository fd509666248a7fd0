"""The port's `spike_matmul` (on CPU tensors, its plain version) against
the JAX package's: the Pallas kernel through `repro.kernels.ops` in
interpret mode on bool × int16 at 128-aligned, ragged and all-silent
shapes, and jnp's int32 `@` on event counts × int32 weights whose sums
wrap. Integer results: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels.ref import spike_matmul_ref
from repro_torch.kernels.spike_matmul import spike_matmul


def bool_case(seed, npre, npost, density):
    rng = np.random.default_rng(seed)
    spikes = rng.random(npre) < density
    w = rng.integers(-2 ** 15, 2 ** 15, (npre, npost)).astype(np.int16)
    return spikes, w


@pytest.mark.parametrize("npre,npost,density", [
    (128, 128, 0.1), (256, 384, 0.3), (512, 128, 0.02), (300, 77, 0.2),
    (1, 5, 1.0), (130, 129, 0.5)])
def test_bool_int16_matches_pallas_kernel(npre, npost, density):
    spikes, w = bool_case(npre + npost, npre, npost, density)
    want = np.asarray(ops.spike_matmul(jnp.asarray(spikes), jnp.asarray(w)))
    got = spike_matmul(torch.as_tensor(spikes), torch.as_tensor(w))
    assert got.dtype == torch.int32 and got.shape == (npost,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_all_silent_is_zero():
    w = torch.ones((256, 128), dtype=torch.int16)
    out = spike_matmul(torch.zeros(256, dtype=torch.bool), w)
    want = np.asarray(ops.spike_matmul(jnp.zeros((256,), bool),
                                       jnp.ones((256, 128), jnp.int16)))
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(out.abs().max()) == 0


@pytest.mark.parametrize("seed", range(3))
def test_int32_counts_wrap_like_jnp(seed):
    """Weights near ±2**30 and counts up to 3: the int32 sums wrap, and
    the plain version wraps exactly as jnp's int32 dot does."""
    rng = np.random.default_rng(seed)
    B, npre, npost = 4, 200, 33
    counts = rng.integers(0, 4, (B, npre)).astype(np.int32)
    w = (np.where(rng.random((npre, npost)) < 0.5, 1, -1)
         * rng.integers(2 ** 30 - 2 ** 20, 2 ** 30, (npre, npost))) \
        .astype(np.int32)
    want = np.asarray(jnp.asarray(counts) @ jnp.asarray(w))
    exact = counts.astype(np.int64) @ w.astype(np.int64)
    assert (np.abs(exact) > 2 ** 31).any()           # the sum does wrap
    got = spike_matmul(torch.as_tensor(counts), torch.as_tensor(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_lanes_equal_single_lane_calls():
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 3, (5, 150)).astype(np.int32)
    counts[2] = 0                                    # one silent lane
    w = torch.as_tensor(rng.integers(-500, 500, (150, 40)).astype(np.int32))
    got = spike_matmul(torch.as_tensor(counts), w)
    for b in range(5):
        one = spike_matmul(torch.as_tensor(counts[b]), w)
        assert torch.equal(got[b], one)


def test_small_chunks_give_the_same_sum():
    """The plain version's row chunking does not change the result."""
    rng = np.random.default_rng(9)
    counts = torch.as_tensor(rng.integers(0, 4, (3, 97)).astype(np.int32))
    w = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (97, 11),
                                     dtype=np.int64).astype(np.int32))
    assert torch.equal(spike_matmul_ref(counts, w, max_elems=1),
                       spike_matmul_ref(counts, w))


def test_rejects_other_devices():
    x = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda device"):
        spike_matmul(x[0], x)
