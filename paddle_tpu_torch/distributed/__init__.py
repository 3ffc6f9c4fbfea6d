"""paddle.distributed (counterpart of paddle_tpu/distributed/
__init__.py): the environment's ranks, communication groups,
``DataParallel``, ``fleet`` with its hybrid-parallel wrappers,
``sharding``, ``checkpoint`` and the MoE dispatch ``utils``. One process
holds every rank (LOGICAL ranks of ``parallel/mesh.py``); the
collectives are ``parallel/collective.py``'s."""
from . import checkpoint, env, fleet, sharding, utils  # noqa: F401
from .communication import (Group, ReduceOp, get_world_group,  # noqa: F401
                            new_group)
from .parallel import DataParallel, get_rank, get_world_size  # noqa: F401
from .utils import global_gather, global_scatter  # noqa: F401


def is_initialized():
    return env.is_initialized()
