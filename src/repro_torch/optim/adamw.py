"""AdamW (decoupled weight decay), global-norm clipping and the cosine
schedule — the port of `repro/optim/adamw.py`, with its arithmetic:
moments kept in `moment_dtype`, math in fp32, bias corrections
1 - b**step in fp32, and the decay inside the update,
p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), on every leaf
(`torch.optim.AdamW` orders the decay differently).

Parameters are an `nn.Module` or a dict of tensors; gradients and
moments are dicts keyed by the parameters' state-dict names. JAX returns
new trees; the port updates the parameters and the moments in place, leaf
by leaf, and keeps the step counter, the learning rate and the norm as
device tensors, so an update never waits on the host. The clip scale is
applied inside each leaf's update: no fp32 copy of every gradient is
built at once (at Qwen2.5-3B's width that copy alone is 12.3 GB).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000


def named_leaves(params) -> Dict[str, torch.Tensor]:
    """The parameters by state-dict name, from a module or a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def cosine_schedule(oc: AdamWConfig, step):
    """Linear warmup to oc.lr, then a cosine decay to 0 at total_steps;
    `step` an integer tensor, the result an fp32 tensor beside it."""
    step = step.float()
    warm = oc.lr * step / max(oc.warmup_steps, 1)
    frac = ((step - oc.warmup_steps)
            / max(oc.total_steps - oc.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * oc.lr * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < oc.warmup_steps, warm, cos)


def adamw_init(params, oc: AdamWConfig):
    """{"mu", "nu": zeros in oc.moment_dtype per leaf, "step": int32 0},
    on the parameters' device."""
    leaves = named_leaves(params)
    dt = getattr(torch, oc.moment_dtype)
    dev = next(iter(leaves.values())).device
    return {"mu": {n: torch.zeros_like(p, dtype=dt)
                   for n, p in leaves.items()},
            "nu": {n: torch.zeros_like(p, dtype=dt)
                   for n, p in leaves.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


_ROW = 1 << 16


def _square_sum(g: torch.Tensor):
    """g's fp32 sum of squares, without an fp32 copy. The CPU's
    `vector_norm` accumulates in long runs and loses precision on leaves
    of millions of elements, so a larger leaf is reduced in rows of
    65,536 and the rows added."""
    flat = g.reshape(-1)
    n = flat.numel() // _ROW * _ROW
    sq = torch.linalg.vector_norm(flat[n:], dtype=torch.float32).square()
    if n:
        rows = torch.linalg.vector_norm(flat[:n].view(-1, _ROW), dim=1,
                                        dtype=torch.float32)
        sq = sq + rows.square().sum()
    return sq


def global_norm(grads: Dict[str, torch.Tensor]):
    """sqrt of the sum of every leaf's fp32 sum of squares, as a device
    tensor."""
    return torch.stack([_square_sum(g) for g in grads.values()]).sum().sqrt()


def _clip_scale(norm, max_norm: float):
    return (max_norm / norm.clamp(min=1e-9)).clamp(max=1.0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """JAX's `clip_by_global_norm`: (fp32 grads times min(1, max_norm /
    norm), norm). `adamw_update` applies the same scale leaf by leaf
    instead of building these copies."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g.float() * scale for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params, grads: Dict[str, torch.Tensor], state,
                 oc: AdamWConfig, norm=None):
    """One AdamW step on every leaf, in place. Returns (params, state,
    {"grad_norm", "lr"}), the metrics fp32 device tensors. `norm` is the
    gradients' global norm when the caller has it over more than the
    leaves it passes (a ZeRO-1 step passes its blocks); by default it is
    `global_norm(grads)`."""
    leaves = named_leaves(params)
    norm = global_norm(grads) if norm is None else norm
    scale = _clip_scale(norm, oc.clip_norm)
    step = state["step"] + 1
    lr = cosine_schedule(oc, step)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    for n, p in leaves.items():
        g = grads[n].float() * scale
        m, v = state["mu"][n], state["nu"][n]
        mf = m.float().mul_(b1).add_(g * (1 - b1))   # in place when fp32
        vf = v.float().mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        if m.dtype != torch.float32:
            m.copy_(mf)
            v.copy_(vf)
        delta = (mf / bc1).div_((vf / bc2).sqrt_().add_(oc.eps))
        delta.add_(p.float() * oc.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float().sub_(delta))
    state["step"] = step
    return params, state, {"grad_norm": norm, "lr": lr}
