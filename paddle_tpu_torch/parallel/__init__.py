"""Parallel substrate of the port (counterpart of paddle_tpu/parallel):
the serving shards' device list. The training mesh, the SPMD pipeline
and ring attention are not ported here."""
from . import mesh  # noqa: F401
from .mesh import serving_shard_devices  # noqa: F401

__all__ = ["mesh", "serving_shard_devices"]
