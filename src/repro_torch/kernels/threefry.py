"""One SNN step's key split and noise draw — wrapper of the CUDA kernel
`csrc/threefry.cu`, which has no Pallas counterpart (XLA fuses this work
in the JAX step, `repro.core.engine`'s `split` then
`repro.core.neuron.noise_draw`).

Per lane b: ``(keys'[b], sub) = split(keys[b])`` and ``u[b] =
randint(sub, (n,), minval, maxval)``, bit for bit with `jax.random` in
its partitionable threefry mode, as the plain version `core.prng` is.
Keys are int64 ``(B, 2)`` tensors of uint32 words (`core.prng`'s
layout).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels import _build
from repro_torch.kernels.ref import split_randint_ref


def split_randint(keys, n: int, minval: int, maxval: int):
    """keys (B, 2) int64 -> (keys' (B, 2) int64, u (B, n) int32). CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise). keys' is a new tensor: keys is left as it was."""
    if keys.device.type == "cpu":
        return split_randint_ref(keys, n, minval, maxval)
    if keys.device.type != "cuda":
        raise ValueError(f"split_randint runs on cuda or cpu, not "
                         f"{keys.device}")
    lo, span, mult = prng.randint_fold(minval, maxval)
    if keys.dtype != torch.int64 or keys.dim() != 2 \
            or keys.shape[1] != 2 or not keys.is_contiguous():
        raise ValueError(f"split_randint: want contiguous int64 (B, 2) "
                         f"keys, got {keys.dtype} {tuple(keys.shape)}")
    B = keys.shape[0]
    if not 0 < B <= 65535 or not 0 <= n < 2 ** 31:
        raise ValueError(f"split_randint takes 1..65535 lanes and "
                         f"0 <= n < 2**31, got B={B}, n={n}")
    keys_out = torch.empty_like(keys)
    u = torch.empty((B, n), dtype=torch.int32, device=keys.device)
    fn = _build.load("threefry")
    err = fn(keys.data_ptr(), keys_out.data_ptr(), u.data_ptr(), B, n,
             lo & prng.MASK, span, mult,
             torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(err, "split_randint")
    split_randint.launches += 1
    return keys_out, u


split_randint.launches = 0
