"""The fused LIF/ANN membrane update — wrapper of the CUDA kernel
`csrc/lif_step.cu`, the port of the Pallas kernel in
`repro/kernels/lif_step.py` (with the natural-size interface of
`repro.kernels.ops.lif_step`).

One pass over the membrane file does noise shift, threshold/reset, leak
and synaptic integration; all math is int32 and bit-exact against
`repro.core.neuron`. Noise comes in as pre-drawn 17-bit uniforms `u`,
so the kernel is deterministic and byte-for-byte testable.

The kernel takes any N: the TPU wrapper's padding of N to 256 is that
chip's tiling, and the CUDA kernel masks its own ragged edge.

Meta tensors (the dry-run) get the launch's empty outputs and no launch;
every call is reported to an open `launch.op_analysis.OpCounter`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lif_step_ref
from repro_torch.launch import op_analysis


def _lanes(*xs):
    """(N,) tensors gain a lane axis; (B, N) pass through."""
    return [x if x.dim() == 2 else x.unsqueeze(0) for x in xs]


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {'' if x.is_contiguous() else 'non-contiguous '}"
            f"{x.dtype} {tuple(x.shape)} on {x.device}")


def lif_step(V, syn_in, noise_u, theta, nu, lam, is_lif):
    """V, syn_in, noise_u: (N,) or (B, N) int32; theta, nu, lam: (N,)
    int32; is_lif: (N,) bool. Returns (V_next int32, spikes bool) of V's
    shape. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise); meta tensors get its outputs' shapes."""
    on = op_analysis.where("lif_step", V, syn_in, noise_u, theta, nu, lam,
                           is_lif)
    # one pass over the membrane file: V, syn_in, u in and V out a lane,
    # the spikes out, the per-neuron parameters once
    n_bytes = 3 * _nb(V) + _nb(theta, nu, lam, is_lif) + V.numel() * 5
    args = (V, syn_in, noise_u, theta, nu, lam, is_lif)
    with op_analysis.kernel(("lif_step",), (0, n_bytes), _launch, args,
                            on) as call:
        call.result = lif_step_ref(*args) if on == "cpu" else _launch(*args)
    return call.result


def _nb(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _launch(V, syn_in, noise_u, theta, nu, lam, is_lif):
    """The card's call: checks, outputs, the launch (none on meta)."""
    Vb, sb, ub = _lanes(V, syn_in, noise_u)
    B, n = Vb.shape
    if not 0 < B <= 65535:
        raise ValueError(f"lif_step takes 1..65535 lanes, got {B}")
    for name, x in (("V", Vb), ("syn_in", sb), ("noise_u", ub)):
        _check(name, x, torch.int32, (B, n), V.device)
    for name, x in (("theta", theta), ("nu", nu), ("lam", lam)):
        _check(name, x, torch.int32, (n,), V.device)
    _check("is_lif", is_lif, torch.bool, (n,), V.device)
    V_out = torch.empty_like(Vb)
    spikes = torch.empty((B, n), dtype=torch.bool, device=V.device)
    if V.is_cuda:
        fn = _build.load("lif_step")
        err = fn(Vb.data_ptr(), sb.data_ptr(), ub.data_ptr(),
                 theta.data_ptr(), nu.data_ptr(), lam.data_ptr(),
                 is_lif.data_ptr(), V_out.data_ptr(), spikes.data_ptr(), B,
                 n, torch.cuda.current_stream(V.device).cuda_stream)
        _build.check(err, "lif_step")
        lif_step.launches += 1
    return V_out.view(V.shape), spikes.view(V.shape)


lif_step.launches = 0
