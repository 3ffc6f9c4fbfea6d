"""Parallel substrate of the port (counterpart of paddle_tpu/parallel):
the training mesh of logical ranks and the serving shards' device list
(``mesh``), the counted collectives over per-rank tensors
(``collective``), the SPMD pipeline (``pipeline``) and ring attention
(``ring_attention``)."""
from . import collective, mesh, pipeline, ring_attention  # noqa: F401
from .mesh import (build_mesh, get_mesh, mesh_axis_size,  # noqa: F401
                   serving_shard_devices, set_mesh)

__all__ = ["build_mesh", "collective", "get_mesh", "mesh", "mesh_axis_size",
           "pipeline", "ring_attention", "serving_shard_devices",
           "set_mesh"]
