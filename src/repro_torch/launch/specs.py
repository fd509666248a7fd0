"""Shape-and-dtype stand-ins for every input of a step (meta tensors:
nothing allocated) and the parameter, optimizer and cache trees on the
meta device — the twin of `repro/launch/specs.py`, the substrate of the
dry-run (`launch.dryrun`).

Without a mesh each function gives JAX's global shapes. With a mesh (a
shape-only one does: `Mesh(shape, names, rank=r)`) it gives what rank r
holds: its blocks of the parameters (`lm.init_params(..., mesh=)`), its
ZeRO-1 blocks of the moments (`steps.init_opt_state`), its rows of the
batch (`rank_batch`) and its blocks of the caches (`cache_specs`).
`concretize` makes seeded values of such a tree, for smoke runs only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import mesh as pg
from repro_torch.distributed.context import mesh_context
from repro_torch.launch.sharding import ShardingRules, local_slice
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig

META = torch.device("meta")


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_shapes(cfg, shape) -> dict:
    """The global input batch of an (arch, shape) cell: int32 tokens (B,
    1) for a decode cell, else (B, S less the patch tokens) and, for a
    `vision_patches` config, bf16 `patch_embeds` (B, n_patch_tokens,
    d_model) before them."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _empty((B, 1), torch.int32)}
    n_patch = cfg.n_patch_tokens if cfg.frontend == "vision_patches" else 0
    out = {"tokens": _empty((B, S - n_patch), torch.int32)}
    if n_patch:
        out["patch_embeds"] = _empty((B, n_patch, cfg.d_model),
                                     torch.bfloat16)
    return out


def rank_batch(batch: dict, cfg, mesh) -> dict:
    """The rank's rows of a global batch (`batch_specs`), as views."""
    with mesh_context(mesh):
        specs = ShardingRules(cfg, mesh, "heads").batch_specs(batch)
    return {k: v[local_slice(specs[k], v.shape, mesh)]
            for k, v in batch.items()}


def params_shapes(cfg, dtype=torch.bfloat16, mesh=None,
                  layout: str = "heads"):
    """The `lm.LM` on meta: global leaves, or the rank's held blocks
    under `mesh`."""
    return lm.init_params(cfg, dtype=dtype, device=META, mesh=mesh,
                          layout=layout)


def opt_shapes(cfg, oc: AdamWConfig, dtype=torch.bfloat16, mesh=None,
               layout: str = "heads", params=None):
    """The AdamW state on meta: the moments of every leaf, or the rank's
    ZeRO-1 blocks of its held leaves under `mesh`."""
    from repro_torch.launch.steps import init_opt_state
    from repro_torch.optim import adamw_init
    params = params_shapes(cfg, dtype, mesh, layout) if params is None \
        else params
    if mesh is None:
        return adamw_init(params, oc)
    return init_opt_state(params, oc, cfg, mesh, layout)


def cache_shapes(cfg, shape, dtype=torch.bfloat16, mesh=None) -> dict:
    """The decode caches of a cell (`lm.init_cache` of its global batch
    and length) on meta: global, or the rank's blocks under `mesh`
    (`cache_specs`: the batch over the batch axes, T >= 4,096 over
    'model')."""
    glob = lm.init_cache(cfg, shape.global_batch, shape.seq_len, dtype,
                         device=META)
    if mesh is None:
        return glob
    with mesh_context(mesh):
        specs = ShardingRules(cfg, mesh, "heads").cache_specs(glob)

    def cut(t, spec):
        if isinstance(t, dict):
            return {k: cut(v, spec[k]) for k, v in t.items()}
        return t[local_slice(spec, t.shape, mesh)].clone()
    return cut(glob, specs)


def concretize(tree, seed: int = 0, device=None):
    """Seeded values of a tree of (meta) tensors on `device` (the rank's
    card unless another device is asked for, `distributed.mesh.
    rank_device`: it raises without one): integer leaves zero, float
    leaves N(0, 1) * 0.02 — for smoke runs and examples only, never the
    full configs."""
    device = pg.rank_device(device)
    gen = np.random.default_rng(seed)

    def make(t):
        if isinstance(t, dict):
            return {k: make(v) for k, v in t.items()}
        if not t.dtype.is_floating_point:
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        x = gen.standard_normal(tuple(t.shape)).astype(np.float32) * 0.02
        return torch.from_numpy(x).to(device=device, dtype=t.dtype)
    return make(tree)
