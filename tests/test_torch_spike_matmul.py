"""The port's `spike_matmul` (on CPU tensors, its plain version) against
the JAX package's: the Pallas kernel through `repro.kernels.ops` in
interpret mode on bool × int16 at 128-aligned, ragged and all-silent
shapes, and jnp's int32 `@` on event counts × int32 weights whose sums
wrap; the CUDA kernel's host-side work plan, and a numpy emulation of
the kernel's staged row windows at unaligned row pitches. Integer
results: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import spike_matmul as sm
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


class _Elsewhere:
    """A tensor's stand-in on a device the port does not run on (the
    wrapper reads its device first)."""
    device = torch.device("xpu")
    shape = (4, 4)


def test_rejects_other_devices():
    """The kernel runs on the card, its plain version on the CPU and its
    shapes on meta (the dry-run); any other device, or a mix, raises."""
    x = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda device"):
        spike_matmul(_Elsewhere(), _Elsewhere())
    with pytest.raises(ValueError, match="cuda device"):
        spike_matmul(x[0], torch.zeros((4, 4), dtype=torch.int32))


# ------------------------------------------------ the kernel's work plan
def blocks(p, B, npre, npost):
    """Each block's (lanes, rows, columns) as ranges, as the kernel
    computes them from its block index and the plan."""
    for z in range(p.slices):
        rows = range(z * p.rows_per_slice,
                     min((z + 1) * p.rows_per_slice, npre))
        for y in range(p.groups):
            lanes = range(y * sm._LANES, min((y + 1) * sm._LANES, B))
            for x in range(p.tiles):
                yield lanes, rows, range(x * p.tile_cols,
                                         min((x + 1) * p.tile_cols, npost))


def test_plan_at_the_main_shapes_fills_the_card():
    """The simulator's step shape and 16k x 16k int32 on 132 SMs: at
    least one block per SM, slices of at most 512 rows, and few enough
    slices that the partial sums stay a small share of the weights."""
    for B, npre, npost in ((8, 3794, 3010), (8, 16384, 16384)):
        p = sm.plan(132, B, npre, npost, 4)
        n_blocks = p.tiles * p.groups * p.slices
        assert n_blocks >= 132 and p.rows_per_slice <= sm._SLICE_ROWS
        assert p.slices * B * npost <= 0.25 * npre * npost


@pytest.mark.parametrize("w_bytes", [2, 4])
@pytest.mark.parametrize("B", [1, 8, 13])
@pytest.mark.parametrize("npre", [515, 3794])
@pytest.mark.parametrize("npost", [77, 300, 3010])
def test_plan_covers_every_element_once(npost, npre, B, w_bytes):
    """The blocks' (lane, row, column) ranges partition the product,
    at ragged shapes and on a card of 132 SMs or of 1."""
    for sms in (132, 1):
        p = sm.plan(sms, B, npre, npost, w_bytes)
        assert p.tile_cols * w_bytes == sm._TILE_BYTES
        assert 0 < p.rows_per_slice <= sm._SLICE_ROWS
        assert p.slices * p.rows_per_slice >= npre
        assert max(p.tiles, p.groups, p.slices) <= 65535
        seen = {"lanes": np.zeros(B, int), "rows": np.zeros(npre, int),
                "cols": np.zeros(npost, int)}
        all_blocks = list(blocks(p, B, npre, npost))
        assert len(all_blocks) == p.tiles * p.groups * p.slices
        assert len({(a[0], a[-1], b[0], b[-1], c[0], c[-1])
                    for a, b, c in all_blocks if len(b)}) == \
            sum(1 for _, b, _ in all_blocks if len(b))
        for lanes, rows, cols in all_blocks:
            assert len(lanes) and len(cols)     # no empty lane or tile
            if rows.start == 0 and cols.start == 0:
                seen["lanes"][lanes] += 1
            if lanes.start == 0 and cols.start == 0:
                seen["rows"][rows] += 1
            if lanes.start == 0 and rows.start == 0:
                seen["cols"][cols] += 1
        for axis, hits in seen.items():
            assert (hits == 1).all(), axis


def emulate_kernel(counts, w, sms=132):
    """`csrc/spike_matmul.cu` in numpy, byte for byte: per block, the
    slice's live rows (any lane of the group), each row's 2,048 B window
    from the 16 B boundary at or below its segment copied in 16 B chunks
    (those past the segment skipped, the last one cut at W's end), each
    thread's columns read at the row's byte shift; the slices' partial
    sums added in order. W's base is 16 B-aligned, as torch allocates."""
    B, npre = counts.shape
    npost, esize = w.shape[1], w.dtype.itemsize
    p = sm.plan(sms, B, npre, npost, esize)
    flat = w.reshape(-1).view(np.uint8)
    part = np.zeros((p.slices, B, npost), np.int64)
    for lanes, rows, cols in blocks(p, B, npre, npost):
        z = rows.start // p.rows_per_slice if len(rows) else 0
        for r in rows:
            if not counts[lanes, r].any():
                continue
            seg = (r * npost + cols.start) * esize
            end = seg + len(cols) * esize
            win = np.zeros(2048, np.uint8)
            for t, src in enumerate(range(seg & ~15, end, 16)):
                n = min(16, flat.size - src)
                win[16 * t:16 * t + n] = flat[src:src + n]
            shift = seg & 15
            vals = win[shift:shift + sm._TILE_BYTES].view(w.dtype)
            part[z, lanes.start:lanes.stop, cols.start:cols.stop] += (
                counts[lanes, r, None].astype(np.int64)
                * vals[None, :len(cols)])
            part %= 2 ** 32
    out = part.sum(axis=0) % 2 ** 32
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


@pytest.mark.parametrize("B,npre,npost,dtype", [
    (8, 515, 300, np.int32), (8, 200, 1030, np.int32),   # pitch 8 mod 16
    (13, 515, 77, np.int16), (1, 300, 1001, np.int16),   # odd int16 pitch
    (3, 97, 1019, np.int16), (2, 40, 509, np.int32)])    # one past a tile
def test_kernel_emulation_matches_plain_and_jnp(B, npre, npost, dtype):
    """The kernel's windows and shifts at row pitches that are not a
    multiple of 16 B give the plain version's sums and jnp's."""
    rng = np.random.default_rng(npre + npost)
    counts = ((rng.random((B, npre)) < 0.2)
              * rng.integers(1, 4, (B, npre))).astype(np.int32)
    counts[:, ::7] = 0                                 # whole rows silent
    hi = 2 ** 15 if dtype == np.int16 else 2 ** 31
    w = rng.integers(-hi, hi, (npre, npost), dtype=np.int64).astype(dtype)
    got = emulate_kernel(counts, w)
    want = spike_matmul_ref(torch.as_tensor(counts), torch.as_tensor(w))
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jnp.asarray(counts) @ jnp.asarray(w, jnp.int32)))
