"""A replica of `jax.random`'s legacy threefry keys in plain torch ops.

The engine's noise stream must be bit-identical to the JAX package's, so
this module reproduces, for raw uint32 ``(2,)`` keys and JAX's
``jax_threefry_partitionable=True`` mode:

  * ``PRNGKey(seed)``  — ``threefry_seed``: ``(seed >> 32, seed & 0xFFFFFFFF)``
    of the seed taken as a 32-bit integer;
  * ``split(key)``     — ``_threefry_split_foldlike``: threefry2x32 of the
    key over the 64-bit iota ``0 .. num-1``, one key per count;
  * ``fold_in(key, d)`` — ``_threefry_fold_in``: threefry2x32 of the key
    over the count pair ``(0, d)``;
  * ``random_bits``    — ``_threefry_random_bits_partitionable`` at 32
    bits: ``bits1 ^ bits2`` of threefry2x32 over the iota;
  * ``randint``        — ``random._randint`` for int32: two draws from
    ``split(key)`` folded through the span with the same unsigned
    arithmetic.

Keys are int64 tensors of shape ``(..., 2)`` holding values in
``[0, 2**32)``: torch has no ``<<`` for uint32 on the CPU, so every word
lives in int64 and each add or shift is masked back to 32 bits. Every
function takes leading key axes, so B lanes split, fold and draw in one
call. Host keys convert with `to_host`/`from_host` (uint32 numpy).
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), elementwise over broadcast
    int64 words; the rolled form of JAX's `_threefry2x32_lowering`."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as an int64 ``(2,)`` tensor. JAX takes
    a Python int seed as int32 (64-bit mode off), so the high word is 0
    and the low word is the seed's 32-bit two's complement."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit int32")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _iota(n: int, device):
    """`iota_2x32_shape((n,))`: the high and low words of 0 .. n-1."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` for keys ``(..., 2)``: returns
    ``(num, ..., 2)``."""
    hi, lo = _iota(num, key.device)
    shape = (num,) + (1,) * (key.dim() - 1)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1],
                          hi.view(shape), lo.view(shape))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: ``data`` (an int or an integer
    tensor broadcast against the key's leading axes) is taken as uint32."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 uniform bits per element: keys ``(..., 2)`` -> ``(..., n)``."""
    hi, lo = _iota(n, key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return b1 ^ b2


def randint_fold(minval: int, maxval: int):
    """`randint`'s constants for int32 bounds: (minval, span, mult), the
    span taken mod 2**32 (1 when maxval <= minval) and mult the factor
    of the high draw (0 when 2**32 % span == 0 skips it). The bounds are
    Python ints in int32 range (JAX raises OverflowError outside it, and
    so does this)."""
    lo_v, hi_v = int(minval), int(maxval)  # tracelint: allow=host-sync
    for b in (lo_v, hi_v):
        if not -(2 ** 31) <= b < 2 ** 31:
            raise OverflowError(f"randint bound {b} does not fit int32")
    span = 1 if hi_v <= lo_v else (hi_v - lo_v) & MASK
    mult = (2 ** 16) % span
    return lo_v, span, ((mult * mult) & MASK) % span


def randint(key: torch.Tensor, n: int, minval: int, maxval: int
            ) -> torch.Tensor:
    """`jax.random.randint(key, (n,), minval, maxval, jnp.int32)` for
    keys ``(..., 2)`` -> int32 ``(..., n)``."""
    lo_v, span, mult = randint_fold(minval, maxval)
    keys = split(key)
    lower = random_bits(keys[1], n)
    off = lower % span
    if mult:                            # 2**32 % span == 0 skips the draw
        higher = random_bits(keys[0], n)
        off = (((higher % span) * mult) & MASK) + off
        off = (off & MASK) % span
    v = (off + lo_v) & MASK
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def to_host(keys: torch.Tensor) -> np.ndarray:
    """int64 key words -> uint32 numpy (the JAX package's key dtype)."""
    return keys.cpu().numpy().astype(np.uint32)


def from_host(keys, device=None) -> torch.Tensor:
    """uint32 (or any integer) key words -> int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(keys).astype(np.int64),
                           device=device)
