"""Parameter, optimizer, input and cache sharding rules — the port of
`repro/launch/sharding.py`, rule for rule.

Specs are derived from each leaf's name and the arch config. Two
regimes:
  TP    — weights sharded over 'model' only (heads / d_ff / experts /
          vocab), replicated over 'data' (+'pod'); right for < 100 B
          parameters.
  FSDP  — additionally shard the residual-stream dim over 'data'
          (ZeRO-3); the llama3-405b and deepseek-v2-236b configs.
Optimizer moments get ZeRO-1 treatment for TP archs: the first unsharded
dim that divides is additionally sharded over 'data'.

A spec is a tuple with one entry per dim: None (replicated), an axis
name, or a tuple of axis names (the batch axes): the port's
`PartitionSpec`. Leaves are named by the port's state-dict names; a
stacked segment's layer axis is per layer in the port, so
`blocks.3.attn.wq` gets JAX's `blocks/attn/wq` spec without the leading
None. Caches keep JAX's layer-stacked layout and JAX's specs.

`zero1_spec` is JAX's function of a spec and a shape. Over the port's
per-layer leaves it cuts a layer's first free dim that divides: where
JAX's cuts the stacked layer axis over 'data' (a segment of L layers, L
divisible by the data axis: MusicGen's and Mamba-2's 48 and LLaVA's 32
layers on the 16-wide production axis) each rank holds L/16 whole
layers' moments in JAX and 1/16 of every layer's in the port, the same
bytes.

`local_slice` and `assemble` are the port's `to_named` / `device_put`:
a rank's block of a leaf under a spec, and the blocks put back together.

What the port holds (`held_spec`): the rules' own `param_spec` for
every family of the registry (ROADMAP items 10.3b and 10.3c): heads,
d_ff, the routed experts and the vocab over 'model'; MLA's `w_uq`,
`w_uk`, `w_uv` over heads and `w_o` row-parallel; the SSM's `w_out` over
d_in; the RG-LRU's `w_x`/`w_y`, `lam` and `conv_b` over its width W,
`w_i`/`w_r` over their gate blocks where the blocks divide, and its
`w_out` row-parallel; for an FSDP config the residual dim over 'data'
too. The moments are held by `zero1_spec` (`held_moment_spec`).
`shard_params` cuts a whole state to a rank's held blocks (`assemble`
puts blocks back together).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from repro_torch.distributed.context import Mesh, batch_axes

Spec = Tuple


def _div(dim_size: int, mesh, axis) -> bool:
    if axis is None:
        return False
    return dim_size % mesh.shape[axis] == 0


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


class ShardingRules:
    def __init__(self, cfg, mesh, layout: str):
        self.cfg = cfg
        self.mesh = mesh
        self.layout = layout                      # attention layout
        self.fsdp = "data" if cfg.fsdp else None

    def _m(self, size, axis="model"):
        return axis if _div(size, self.mesh, axis) else None

    def _f(self, size):
        return self.fsdp if _div(size, self.mesh, self.fsdp) else None

    def param_spec(self, name: str, shape) -> Spec:
        names = tuple(name.split("."))
        s = _shape(shape)
        name = names[-1]
        parent = names[-2] if len(names) > 1 else ""

        def spec(*axes):
            return tuple(axes)

        if name in ("scale", "bias", "a_log", "dt_bias", "d_skip", "lam",
                    "conv_b"):
            # norms / small vectors: lam & conv_b are width-sharded in rglru
            if name in ("lam", "conv_b") and parent != "ssm" \
                    and self.cfg.rglru is not None and len(s) == 1 \
                    and s[0] == self.cfg.rglru.lru_width:
                return spec(self._m(s[0]))
            return spec(*([None] * len(s)))
        if name == "table":                        # (Vp, d)
            return (self._m(s[0]), self._f(s[1]))
        if name == "out" and parent == "embed":    # (d, Vp)
            return (self._f(s[0]), self._m(s[1]))
        if name in ("wq", "wk", "wv"):             # (d, H, hd)
            h_ax = self._m(s[1]) if self.layout == "heads" else None
            return spec(self._f(s[0]), h_ax, None)
        if name in ("bq", "bk", "bv"):
            h_ax = self._m(s[0]) if self.layout == "heads" else None
            return spec(h_ax, None)
        if name == "wo":                           # (H, hd, d)
            h_ax = self._m(s[0]) if self.layout == "heads" else None
            return spec(h_ax, None, self._f(s[2]))
        # --- MLA ---
        if name in ("w_dq", "w_dkv"):              # (d, r)
            return spec(self._f(s[0]), None)
        if name in ("w_uq", "w_uk", "w_uv"):       # (r, H, k)
            return spec(None, self._m(s[1]), None)
        if name == "w_o":                          # (H, v, d)
            return spec(self._m(s[0]), None, self._f(s[2]))
        # --- SSM (before the generic mlp names: w_in is a fused
        # projection whose output mixes z/x/B/C/dt -- unsharded out dim)
        if parent == "ssm":
            if name == "w_in":
                return spec(self._f(s[0]), None)
            if name == "conv_w":
                return spec(None, None)
            if name == "w_out":                    # (d_in, d)
                return spec(self._m(s[0]), self._f(s[1]))
        # --- MoE ---
        if name == "router":                       # (d, E)
            return spec(None, None)
        if parent == "shared" or (self.cfg.moe is None):
            if name in ("w_in", "w_gate"):         # (d, ff)
                return spec(self._f(s[0]), self._m(s[1]))
            if name == "w_out":                    # (ff, d)
                return spec(self._m(s[0]), self._f(s[1]))
        if self.cfg.moe is not None and len(s) == 3 \
                and name in ("w_in", "w_gate", "w_out"):
            # routed experts (E, d, ff) / (E, ff, d): experts over 'model'
            if name == "w_out":
                return spec(self._m(s[0]), None, self._f(s[2]))
            return spec(self._m(s[0]), self._f(s[1]), None)
        if name in ("w_in", "w_gate"):             # dense mlp (d, ff)
            return spec(self._f(s[0]), self._m(s[1]))
        if name == "w_out":
            return spec(self._m(s[0]), self._f(s[1]))
        # --- SSM ---
        if parent == "ssm" or name == "conv_w":
            if name == "w_in":
                return spec(self._f(s[0]), None)
            if name == "conv_w":                   # (K, C)
                return spec(None, None)
            if name == "w_out":                    # (d_in, d)
                return spec(self._m(s[0]), self._f(s[1]))
        # --- RG-LRU ---
        if name in ("w_x", "w_y"):                 # (d, W)
            return spec(self._f(s[0]), self._m(s[1]))
        if name in ("w_i", "w_r"):                 # (W, W)
            return spec(self._m(s[0]), None)
        return spec(*([None] * len(s)))

    def params_specs(self, params_shapes: Dict[str, object]):
        """{name: spec} for {name: shape or tensor}."""
        return {n: self.param_spec(n, l) for n, l in params_shapes.items()}

    def zero1_spec(self, spec: Spec, shape) -> Spec:
        """Extend a param spec over 'data' for optimizer moments
        (ZeRO-1)."""
        if self.fsdp:                               # already data-sharded
            return spec
        return _zero1(spec, _shape(shape), self.mesh)

    def opt_specs(self, params_shapes, param_specs):
        mom = {n: self.zero1_spec(param_specs[n], l)
               for n, l in params_shapes.items()}
        return {"mu": mom, "nu": dict(mom), "step": ()}

    def _bdiv(self, dim) -> bool:
        n = 1
        for a in batch_axes():
            n *= self.mesh.shape[a]
        return dim % n == 0

    def batch_specs(self, batch_shapes):
        b = _entry(batch_axes())
        return {k: (b if self._bdiv(_shape(l)[0]) else None,
                    *([None] * (len(_shape(l)) - 1)))
                for k, l in batch_shapes.items()}

    def cache_specs(self, cache_shapes):
        b = _entry(batch_axes())

        def per_leaf(l):
            # (L, B, T, ...): batch over data axes; long seq dims (>= 4096)
            # additionally over 'model' (2D KV-cache sharding).
            s = _shape(l)
            rest = [None] * (len(s) - 2)
            if len(s) >= 4 and s[2] >= 4096 \
                    and _div(s[2], self.mesh, "model"):
                rest[0] = "model"
            return (None, b if self._bdiv(s[1]) else None, *rest)

        def walk(t):
            return {k: walk(v) if isinstance(v, dict) else per_leaf(v)
                    for k, v in t.items()}
        return walk(cache_shapes)

    # ------------------------------------------------- what the port holds
    def held_spec(self, name: str, shape) -> Spec:
        """The spec the port holds a parameter in (its global shape):
        `param_spec`."""
        return self.param_spec(name, shape)

    def held_moment_spec(self, name: str, shape) -> Spec:
        """The spec the port holds a parameter's AdamW moments in:
        `zero1_spec` of its held spec (nothing more for an FSDP
        config)."""
        return self.zero1_spec(self.param_spec(name, shape), shape)

    def held_params_specs(self, params_shapes):
        return {n: self.held_spec(n, l) for n, l in params_shapes.items()}

    def held_opt_specs(self, params_shapes):
        mom = {n: self.held_moment_spec(n, l)
               for n, l in params_shapes.items()}
        return {"mu": mom, "nu": dict(mom), "step": ()}


def attn_layout(cfg, tp: int) -> str:
    """JAX's `_attn_layout`: "heads" when the heads divide over the
    model axis, "seq" otherwise."""
    return "heads" if cfg.n_heads % max(tp, 1) == 0 else "seq"


def shard_params(state, cfg, mesh: Mesh, layout: str = "heads",
                 coords: Optional[Dict[str, int]] = None) -> dict:
    """A rank's blocks (`local_slice` of `held_spec`) of a whole state
    {name: tensor or array}, copies; the whole leaves on a mesh of one
    rank."""
    rules = ShardingRules(cfg, mesh, layout)
    return {n: _copy(t[local_slice(rules.held_spec(n, t.shape),
                                   t.shape, mesh, coords)])
            for n, t in state.items()}


def _copy(t):
    return t.clone() if hasattr(t, "clone") else t.copy()


def _entry(axes: tuple):
    """A spec entry for a tuple of axes: the name alone for one axis, as
    `PartitionSpec` normalises it."""
    return axes[0] if len(axes) == 1 else axes


def _zero1(spec: Spec, shape: tuple, mesh) -> Spec:
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and _div(dim, mesh, "data"):
            parts[i] = "data"
            break
    return tuple(parts)


def local_slice(spec: Spec, shape, mesh: Mesh,
                coords: Optional[Dict[str, int]] = None) -> tuple:
    """The index (one slice a dim) of the block a rank at `coords`
    (default: this rank's) holds of a leaf of global `shape` under
    `spec`: dim i is cut into prod(sizes of its axes) equal blocks,
    numbered row-major over its axes."""
    coords = mesh.coords if coords is None else coords
    shape = _shape(shape)
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        n, k = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            k = k * mesh.shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"dim {i} of {shape} does not divide over "
                             f"{axes} ({n})")
        b = dim // n
        out.append(slice(k * b, (k + 1) * b))
    return tuple(out)


def rank_coords(mesh: Mesh, rank: int) -> Dict[str, int]:
    import numpy as np
    return dict(zip(mesh.axis_names,
                    (int(c) for c in np.unravel_index(
                        rank, tuple(mesh.shape.values())))))


def assemble(blocks: Sequence, spec: Spec, shape, mesh: Mesh, out=None):
    """The leaf of global `shape` from its blocks, one per rank of the
    mesh in rank order (numpy arrays or tensors); into `out` when given
    (else a new array of the first block's kind and dtype). Replicas of
    one block write the same values."""
    import numpy as np
    import torch
    shape = _shape(shape)
    if out is None:
        b0 = blocks[0]
        out = (b0.new_empty(shape) if torch.is_tensor(b0)
               else np.empty(shape, dtype=b0.dtype))
    for r, blk in enumerate(blocks):
        out[local_slice(spec, shape, mesh, rank_coords(mesh, r))] = blk
    return out
