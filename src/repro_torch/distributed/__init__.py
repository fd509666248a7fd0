"""The mesh context (`context`), the process groups and collectives of
the mesh tier and of the distribution slice (`mesh`), gradient
compression (`compression`), and the training loop's supervision and
elastic resharding (`elastic`)."""
from repro_torch.distributed.context import (batch_axes, get_mesh,
                                             mesh_context, set_mesh, tp_axis,
                                             tp_size)

__all__ = ["batch_axes", "get_mesh", "mesh_context", "set_mesh", "tp_axis",
           "tp_size"]
