"""One SNN step's key split and noise draw — wrapper of the CUDA kernel
`csrc/threefry.cu`, which has no Pallas counterpart (XLA fuses this work
in the JAX step, `repro.core.engine`'s `split` then
`repro.core.neuron.noise_draw`).

Per lane b: ``(keys'[b], sub) = split(keys[b])`` and ``u[b] =
randint(sub, (n,), minval, maxval)``, bit for bit with `jax.random` in
its partitionable threefry mode, as the plain version `core.prng` is.
Keys are int64 ``(B, 2)`` tensors of uint32 words (`core.prng`'s
layout). Meta tensors (the dry-run) get the launch's empty outputs and no
launch; every call is reported to an open `launch.op_analysis.OpCounter`.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels import _build
from repro_torch.kernels.ref import split_randint_ref
from repro_torch.launch import op_analysis


def split_randint(keys, n: int, minval: int, maxval: int):
    """keys (B, 2) int64 -> (keys' (B, 2) int64, u (B, n) int32). CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise); meta tensors get its outputs' shapes. keys' is a new tensor:
    keys is left as it was."""
    on = op_analysis.where("split_randint", keys)

    def launch(keys):
        return _launch(keys, n, minval, maxval)
    # the keys read and written, the draws written
    n_bytes = 2 * keys.numel() * keys.element_size() + 4 * keys.shape[0] * n
    with op_analysis.kernel(("split_randint",), (0, n_bytes), launch,
                            (keys,), on) as call:
        call.result = split_randint_ref(keys, n, minval, maxval) \
            if on == "cpu" else launch(keys)
    return call.result


def _launch(keys, n: int, minval: int, maxval: int):
    """The card's call: checks, outputs, the launch (none on meta)."""
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
    if keys.is_cuda:
        fn = _build.load("threefry")
        err = fn(keys.data_ptr(), keys_out.data_ptr(), u.data_ptr(), B, n,
                 lo & prng.MASK, span, mult,
                 torch.cuda.current_stream(keys.device).cuda_stream)
        _build.check(err, "split_randint")
        split_randint.launches += 1
    return keys_out, u


split_randint.launches = 0
