"""Threefry-2x32 (20 rounds; Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011) and the key protocol of the noise stream that
the port's engine draws from (JAX's legacy keys in its partitionable
mode), frozen here for the plain reference.

Words are uint32 values held in int64 tensors (torch's uint32 support is
partial), so every add and shift is masked back to 32 bits. A key is an
int64 tensor (..., 2). The protocol:

  root(seed)       = (0, seed mod 2**32)
  fold(key, d)     = threefry(key; 0, d mod 2**32)
  split(key)       = threefry(key; 0, 0), threefry(key; 0, 1)
  uniform17(key,n) = the noise draw of a step: with (_, sub) = split(key)
                     the step's subkey and (_, k) = split(sub), bits_i =
                     x0 ^ x1 of threefry(k; 0, i), i < n, and the value
                     (bits_i mod 2**17) - 2**16 (a uniform int32 draw in
                     [-2**16, 2**16): the span divides 2**32, so one
                     32-bit draw a neuron suffices)
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
KS_PARITY = 0x1BD11BDA
NOISE_SPAN = 2 ** 17


def threefry(k0, k1, x0, x1):
    """Threefry-2x32 of the counter (x0, x1) under the key (k0, k1),
    elementwise over broadcast int64 words."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for r in range(20):
        rot = ROTATIONS[r % 8]
        x0 = (x0 + x1) & M32
        x1 = (((x1 << rot) & M32) | (x1 >> (32 - rot))) ^ x0
        if r % 4 == 3:                  # key injection every four rounds
            i = r // 4 + 1
            x0 = (x0 + ks[i % 3]) & M32
            x1 = (x1 + ks[(i + 1) % 3] + i) & M32
    return x0, x1


def root(seed: int, device=None) -> torch.Tensor:
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold(key: torch.Tensor, data) -> torch.Tensor:
    """Keys (..., 2) folded with `data` (an int or a tensor broadcast
    against the keys' leading axes)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    x0, x1 = threefry(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([x0, x1], dim=-1)


def split(key: torch.Tensor):
    """(first, second) child keys of keys (..., 2)."""
    zero = torch.zeros_like(key[..., 0])
    a = threefry(key[..., 0], key[..., 1], zero, zero)
    b = threefry(key[..., 0], key[..., 1], zero, zero + 1)
    return torch.stack(a, dim=-1), torch.stack(b, dim=-1)


def uniform17(key: torch.Tensor, n: int) -> torch.Tensor:
    """The step's raw noise: keys (B, 2) -> int64 (B, n) in
    [-2**16, 2**16)."""
    _, sub = split(key)
    _, k = split(sub)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry(k[:, :1], k[:, 1:], torch.zeros_like(i), i)
    return ((x0 ^ x1) % NOISE_SPAN) - NOISE_SPAN // 2
