"""The mesh context shared by model code — the port of
`repro/distributed/context.py`.

Model code needs the mesh to run its expert-parallel blocks (the MoE
dispatch, the hierarchical exchange) and to know which axes exist ('pod'
only on the multi-pod mesh). A thread-local context avoids threading the
mesh through every layer's signature.

The mesh is the port's own `Mesh`: axis names, the shape, this rank's
coordinates and, over a live world, one process group per axis and per
tuple of axes, built once when the mesh is made (by every rank, in one
order, through `distributed.mesh.stage_groups`). Ranks are laid out
row-major over the shape, as `np.arange(size).reshape(shape)` gives
them: rank r's coordinates are `np.unravel_index(r, shape)`. A mesh
built without groups is shape-only: it answers every question about
shapes and blocks (the sharding rules at 256 or 512 devices); its
collectives take meta tensors only, giving the output's shape
(`distributed.mesh.ShapeGroup`: the dry-run of one rank, `launch.dryrun`),
and raise RuntimeError for a real tensor.

    mesh = launch.mesh.make_mesh((2, 1), ("data", "model"))
    with mesh_context(mesh):
        dp_size(), tp_size()              # 2, 1
        y = mesh.all_gather(x, "data", dim=0)
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

_state = threading.local()

Axes = Tuple[str, ...]


def _axes(axes) -> Axes:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """A mesh of `prod(shape)` ranks named by `axis_names`. `rank` is
    this process's index among the mesh's ranks, `ranks` the world
    ranks that make up the mesh (default: the first prod(shape) ranks
    of the world). With `groups`, every rank of the world must build the
    mesh (the groups are collectives of the whole world), and the
    collectives below run over them; without, the mesh is shape-only."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: int = 0, ranks: Optional[Sequence[int]] = None,
                 groups: bool = False):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} has {len(shape)} axes, "
                             f"names {tuple(axis_names)}")
        self.axis_names: Axes = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = int(np.prod(shape, dtype=np.int64))
        self.ranks = tuple(range(self.size) if ranks is None else ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"a {tuple(shape)} mesh needs {self.size} "
                             f"ranks, got {len(self.ranks)}")
        self.rank = int(rank)
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(self.rank, tuple(shape)))))
        self._groups: Optional[Dict[Axes, object]] = None
        if groups:
            self._build_groups()

    # ------------------------------------------------------------ shapes
    def axis_size(self, axes) -> int:
        """The product of the sizes of `axes` (a name or a tuple)."""
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's index along `axes`, row-major over them in the
        order given: `lax.axis_index` of a tuple of axes."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def partition(self, axes) -> list:
        """The mesh's ranks grouped by `axes`: one list per setting of
        the other axes, each in row-major order over `axes` (ascending
        world ranks, so a gather concatenates in that order)."""
        axes = _axes(axes)
        grid = np.asarray(self.ranks).reshape(tuple(self.shape.values()))
        src = [self.axis_names.index(a) for a in axes]
        dst = list(range(grid.ndim - len(axes), grid.ndim))
        return np.moveaxis(grid, src, dst).reshape(
            -1, self.axis_size(axes)).tolist()

    def _build_groups(self) -> None:
        from repro_torch.distributed import mesh as pg
        self._groups = {}
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                if self.axis_size(axes) > 1:
                    self._groups[axes] = pg.stage_groups(
                        [self.partition(axes)])[0]

    @property
    def live(self) -> bool:
        """Whether the mesh holds process groups (not shape-only)."""
        return self._groups is not None

    def group(self, axes, x: Optional[torch.Tensor] = None):
        """This rank's process group over `axes` (axes in the mesh's
        order) for a collective of `x`; on a shape-only mesh a
        `ShapeGroup` when `x` is a meta tensor, and RuntimeError
        otherwise."""
        axes = tuple(a for a in self.axis_names if a in _axes(axes))
        if self._groups is None:
            if x is None or x.device.type != "meta":
                raise RuntimeError(f"the mesh {self.shape} is shape-only: no "
                                   f"process group over {axes}")
            from repro_torch.distributed import mesh as pg
            return pg.ShapeGroup(self.axis_size(axes), self.index(axes))
        return self._groups[axes]

    # ------------------------------------------------------- collectives
    # Each is the identity over axes of size 1, and autograd-aware
    # (`distributed.mesh`'s functions: the backward of a gather is a
    # reduce-scatter, of an all_to_all the reverse all_to_all).
    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        if self.axis_size(axes) == 1:
            return x
        from repro_torch.distributed import mesh as pg
        return pg.all_reduce_ad(x, self.group(axes, x))

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0,
                   ) -> torch.Tensor:
        """Every member's `x` concatenated along `dim`, in the order of
        `index(axes)`: JAX's `all_gather(..., tiled=True)`."""
        if self.axis_size(axes) == 1:
            return x
        from repro_torch.distributed import mesh as pg
        return pg.all_gather_ad(x, self.group(axes, x), dim)

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """x (m, ...) with m = axis_size(axes): block i goes to member i,
        and block j of the result came from member j: JAX's
        `all_to_all(x, axes, 0, 0, tiled=False)`."""
        if self.axis_size(axes) == 1:
            return x
        from repro_torch.distributed import mesh as pg
        return pg.all_to_all_ad(x, self.group(axes, x))

    # the model axis's region functions (`distributed.mesh`): each the
    # identity over axes of size 1
    def copy_to(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Megatron's f: x, its gradient summed over `axes`."""
        if self.axis_size(axes) == 1:
            return x
        from repro_torch.distributed import mesh as pg
        return pg.copy_to_ad(x, self.group(axes, x))

    def reduce_from(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Megatron's g: x summed over `axes`, its gradient passed."""
        if self.axis_size(axes) == 1:
            return x
        from repro_torch.distributed import mesh as pg
        return pg.reduce_from_ad(x, self.group(axes, x))

    def split(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's block of x along `dim` (`index(axes)`), the
        gradient's blocks gathered."""
        if self.axis_size(axes) == 1:
            return x
        from repro_torch.distributed import mesh as pg
        return pg.split_ad(x, self.group(axes, x), dim)

    def gather_from(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The members' x concatenated along `dim`, the gradient's block
        of this rank kept."""
        if self.axis_size(axes) == 1:
            return x
        from repro_torch.distributed import mesh as pg
        return pg.gather_from_ad(x, self.group(axes, x), dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int
                       ) -> torch.Tensor:
        """The members' x summed, this rank's block along `dim`; the
        gradient's blocks gathered."""
        if self.axis_size(axes) == 1:
            return x
        from repro_torch.distributed import mesh as pg
        return pg.reduce_scatter_ad(x, self.group(axes, x), dim)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The elementwise max over `axes`, without a gradient."""
        if self.axis_size(axes) == 1:
            return x
        from repro_torch.distributed import mesh as pg
        return pg.all_reduce_max(x, self.group(axes, x))

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The mean of a scalar over `axes`: every member's value
        gathered and summed in member order, so that every rank (and a
        single-process loop over the shards) adds in one order."""
        n = self.axis_size(axes)
        if n == 1:
            return x
        return self.all_gather(x.reshape(1), axes).sum() / n


def set_mesh(mesh: Optional[Mesh]) -> None:
    _state.mesh = mesh


def get_mesh() -> Mesh:
    """The context's mesh; by default a trivial (1, 1) ('data',
    'model') mesh of this process alone."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        mesh = Mesh((1, 1), ("data", "model"))
        _state.mesh = mesh
    return mesh


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    prev = getattr(_state, "mesh", None)
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def batch_axes() -> Axes:
    """Axes the global batch is sharded over ('pod' included when
    present)."""
    mesh = get_mesh()
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def tp_axis() -> str:
    return "model"


def tp_size() -> int:
    return get_mesh().shape[tp_axis()]


def dp_size() -> int:
    mesh = get_mesh()
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def constrain(x, *spec):
    """JAX's `with_sharding_constraint` against the context mesh, which
    tells GSPMD where a value should live. Eager PyTorch has no sharding
    propagation: a tensor is the block its rank computed, and the port's
    layers place their blocks themselves (slicing their own positions,
    gathering outputs). So this returns x unchanged."""
    return x
