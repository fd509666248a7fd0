"""Production meshes — the port of `repro/launch/mesh.py`.

Functions, not module-level constants, so that importing never touches
the process group. The production system is a TPU v5e pod of 16 x 16 =
256 chips ('data' x 'model'); multi-pod doubles it with a leading 'pod'
axis (2 pods = 512 chips). Mapping to the paper's hierarchy: 'model' =
cores within an FPGA (NoC), 'data' = FPGAs within a server (FireFly),
'pod' = servers (Ethernet).

A mesh is over the live world (`distributed.mesh.world()`): one rank a
device, row-major over the shape. A mesh of more than one rank builds
its process groups when it is made, on every rank of the world, in one
order.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.distributed import mesh as pg
from repro_torch.distributed.context import Mesh


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A mesh of `shape` over `ranks` of the world (default: the whole
    world, whose size must then be prod(shape)). Every rank of the world
    calls it; a rank outside `ranks` builds the groups with the others
    and gets None."""
    rank, world = pg.world()
    n = int(np.prod(shape, dtype=np.int64))
    ranks = list(range(world) if ranks is None else ranks)
    if len(ranks) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; "
                         f"{len(ranks)} given (world size {world})")
    if max(ranks) >= world:
        raise ValueError(f"ranks {ranks} are not all in a world of {world}")
    member = rank in ranks
    mesh = Mesh(shape, axis_names, rank=ranks.index(rank) if member else 0,
                ranks=ranks, groups=n > 1)
    return mesh if member else None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh() -> Mesh:
    """The whole world as a (1, n) ('data', 'model') mesh — used by the
    smoke tests and the single-host examples."""
    _, n = pg.world()
    return make_mesh((1, n), ("data", "model"))
