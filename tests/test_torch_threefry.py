"""The port's per-step key split and noise draw (`kernels.threefry.
split_randint`, CUDA kernel `csrc/threefry.cu`) against live
`jax.random` (legacy uint32 keys, partitionable threefry), bit for bit:
the wrapper's plain version on CPU tensors, and a numpy uint32 model of
the kernel's work (its grid, each block's lane prologue, each thread's
elements and the fold), whose constants are read from the CUDA source."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import neuron as jn
from repro_torch.core import neuron as tn
from repro_torch.core import prng
from repro_torch.kernels.threefry import split_randint

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "threefry.cu").read_text()
SPANS = {"noise": (tn.NOISE_MIN, tn.NOISE_MAX),
         "not a power of two": (-7, 1_000_003),
         "full int32": (-(2 ** 31), 2 ** 31 - 1)}
SHAPES = [(1, 1), (3, 1001), (8, 3010)]
STEPS = 3


def constant(name):
    return int(re.search(r"constexpr \w+ %s = (\w+);" % name, SOURCE)
               .group(1), 0)


def rotations():
    """The kernel's rotation table, in the order its rounds take it."""
    body = re.search(r"int rotation\(int r\) \{(.*?)\}", SOURCE, re.S)
    pairs = dict(re.findall(r"r == (\d) \? (\d+)", body.group(1)))
    last = re.search(r": (\d+);", body.group(1)).group(1)
    return [int(pairs.get(str(r), last)) for r in range(8)]


def threefry_np(k0, k1, x0, x1):
    """threefry2x32 in numpy uint32, as the kernel computes it (its
    rotation table and parity constant)."""
    rot = rotations()
    u32 = np.uint32
    with np.errstate(over="ignore"):
        ks = (u32(k0), u32(k1), u32(k0) ^ u32(k1) ^ u32(constant("kParity")))
        x0 = np.asarray(x0, u32) + ks[0]
        x1 = np.asarray(x1, u32) + ks[1]
        for i in range(5):
            for r in rot[4 * (i % 2):4 * (i % 2) + 4]:
                x0 = x0 + x1
                x1 = ((x1 << u32(r)) | (x1 >> u32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def kernel_model(keys, n, minval, maxval):
    """The kernel's work over its grid (neuron blocks, lanes), in numpy:
    thread 0 of each block derives the lane's draw keys, the lane's first
    block writes its new key, and thread t of block x draws elements
    x * kThreads * kPerThread + k * kThreads + t. Asserts every element
    and every new key is written exactly once. keys (B, 2) uint32 ->
    (keys' uint32, u int32)."""
    threads, per = constant("kThreads"), constant("kPerThread")
    lo, span, mult = prng.randint_fold(minval, maxval)
    span, mult = np.uint32(span), np.uint32(mult)
    pow2 = int(span) & (int(span) - 1) == 0
    B = keys.shape[0]
    blocks = max(1, -(-n // (threads * per)))
    keys_out = np.zeros((B, 2), np.uint32)
    u = np.zeros((B, n), np.uint32)
    key_writes = np.zeros(B, int)
    writes = np.zeros((B, n), int)
    t = np.arange(threads)
    with np.errstate(over="ignore"):
        for b in range(B):
            k0, k1 = keys[b]
            sub = threefry_np(k0, k1, 0, 1)
            low = threefry_np(*sub, 0, 1)
            high = None if pow2 else threefry_np(*sub, 0, 0)
            for x in range(blocks):
                if x == 0:
                    keys_out[b] = [w.item() for w in
                                   threefry_np(k0, k1, 0, 0)]
                    key_writes[b] += 1
                for k in range(per):
                    j = x * threads * per + k * threads + t
                    j = j[j < n]
                    x0, x1 = threefry_np(*low, np.zeros_like(j), j)
                    if pow2:
                        off = (x0 ^ x1) & (span - np.uint32(1))
                    else:
                        off = (x0 ^ x1) % span
                        if mult:
                            y0, y1 = threefry_np(*high, np.zeros_like(j), j)
                            off = ((y0 ^ y1) % span * mult + off) % span
                    u[b, j] = off + np.uint32(lo & prng.MASK)
                    writes[b, j] += 1
    assert (key_writes == 1).all() and (writes == 1).all()
    return keys_out, u.view(np.int32)


def jax_step(jkeys, n, span):
    """jax.vmap(jax.random.split), then the JAX package's noise draw (or
    jax.random.randint for another span) on each lane's sub key."""
    s = jax.vmap(jax.random.split)(jkeys)
    lo, hi = SPANS[span]
    if span == "noise":
        u = jax.vmap(lambda k: jn.noise_draw(k, n))(s[:, 1])
    else:
        u = jax.vmap(lambda k: jax.random.randint(k, (n,), lo, hi,
                                                  jnp.int32))(s[:, 1])
    return s[:, 0], np.asarray(u)


def lane_keys(seed, B):
    root = jax.random.PRNGKey(seed)
    return jax.vmap(lambda b: jax.random.fold_in(root, b))(
        jnp.arange(B, dtype=jnp.int32))


def test_kernel_constants_are_jax_threefry():
    assert rotations() == [13, 15, 26, 6, 17, 29, 16, 24]
    assert constant("kParity") == 0x1BD11BDA


@pytest.mark.parametrize("span", list(SPANS))
@pytest.mark.parametrize("B,n", SHAPES)
@pytest.mark.parametrize("seed", [0, -12345])
def test_split_randint_matches_jax(seed, B, n, span):
    """The wrapper on CPU tensors (its plain version) over chained steps:
    each step's keys' feed the next."""
    jkeys = lane_keys(seed, B)
    tkeys = prng.from_host(np.asarray(jkeys))
    for _ in range(STEPS):
        before = tkeys.clone()
        tkeys, tu = split_randint(tkeys, n, *SPANS[span])
        assert torch.equal(before, prng.from_host(np.asarray(jkeys)))
        jkeys, ju = jax_step(jkeys, n, span)
        np.testing.assert_array_equal(prng.to_host(tkeys), np.asarray(jkeys))
        assert tu.dtype == torch.int32 and tu.shape == (B, n)
        np.testing.assert_array_equal(tu.numpy(), ju)


@pytest.mark.parametrize("span", list(SPANS))
@pytest.mark.parametrize("B,n", SHAPES + [(2, 2048), (2, 4097)])
def test_kernel_model_matches_jax(B, n, span):
    """The numpy model of the kernel's per-thread work, bit for bit
    against JAX over chained steps (n = 2,048 and 4,097: one full block
    and a block's edge)."""
    jkeys = lane_keys(B + n, B)
    keys = np.asarray(jkeys)
    for _ in range(STEPS):
        keys, u = kernel_model(keys, n, *SPANS[span])
        jkeys, ju = jax_step(jkeys, n, span)
        np.testing.assert_array_equal(keys, np.asarray(jkeys))
        np.testing.assert_array_equal(u, ju)


def test_kernel_model_draws_nothing_at_n0():
    """n = 0: one block a lane still writes the lane's new key."""
    keys = np.asarray(lane_keys(3, 2))
    out, u = kernel_model(keys, 0, *SPANS["noise"])
    want = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(keys))[:, 0])
    np.testing.assert_array_equal(out, want)
    assert u.shape == (2, 0)


class _Elsewhere:
    """A tensor's stand-in on a device the port does not run on (the
    wrapper reads its device first)."""
    device = torch.device("xpu")


def test_split_randint_rejects_other_devices():
    """The kernel runs on the card, its plain version on the CPU and its
    shapes on meta (the dry-run, which gets the launch's outputs); any
    other device raises."""
    keys = torch.zeros((2, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cuda device, the cpu or meta"):
        split_randint(_Elsewhere(), 4, *SPANS["noise"])
    out, u = split_randint(keys, 4, *SPANS["noise"])
    assert (out.device.type, u.device.type) == ("meta", "meta")
    assert out.shape == (2, 2) and u.shape == (2, 4) \
        and u.dtype == torch.int32
