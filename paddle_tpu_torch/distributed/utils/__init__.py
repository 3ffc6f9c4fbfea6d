"""paddle.distributed.utils (counterpart of paddle_tpu/distributed/
utils/__init__.py): the MoE count-based dispatch."""
from .moe_utils import global_gather, global_scatter  # noqa: F401

__all__ = ["global_scatter", "global_gather"]
