"""paddle.distributed (counterpart of paddle_tpu/distributed/
__init__.py): the environment's ranks, ``init_parallel_env`` with its
``torch.distributed`` process group, communication groups and the eager
collectives, ``DataParallel``, ``fleet`` with its hybrid-parallel
wrappers and the elastic supervisor, ``launch``, ``rpc``, ``sharding``,
``checkpoint`` and the MoE dispatch ``utils``. The trainer's ranks are
``parallel/mesh.py``'s (LOGICAL ranks, several in one process, and
owned by the processes once a process group is up); their collectives
are ``parallel/collective.py``'s. ``auto_parallel``, ``passes`` and
``io`` are not ported (ROADMAP item 12.7)."""
from . import checkpoint, env, fleet, launch, rpc, sharding, utils  # noqa: F401
from .communication import (Group, P2POp, ReduceOp, all_gather,  # noqa: F401
                            all_gather_object, all_reduce, all_to_all,
                            alltoall, alltoall_single, barrier,
                            batch_isend_irecv, broadcast, get_world_group,
                            irecv, isend, new_group, recv, reduce,
                            reduce_scatter, scatter, send, stream, wait)
from .parallel import (DataParallel, get_rank, get_world_size,  # noqa: F401
                       init_parallel_env)
from .utils import global_gather, global_scatter  # noqa: F401


def is_initialized():
    return env.is_initialized()


def is_available():
    return True


def get_backend(group=None):
    """``gloo`` once a process group is up (the port's only backend
    across processes), else ``logical``: one process holds every rank."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return "logical"


def destroy_process_group(group=None):
    """Tear down the process group (``group=None``: the world) and the
    port's cached subgroups."""
    import torch.distributed as dist
    from ..parallel import collective
    if dist.is_available() and dist.is_initialized():
        if group is None:
            dist.destroy_process_group()
            collective.forget_groups()
        else:
            pg = group.process_group
            if pg is not group and pg is not dist.group.WORLD:
                dist.destroy_process_group(pg)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """The reference's single-run semantic (``:43-48``): run ``func``
    once in this process, which holds every rank of the mesh. Several
    processes come from ``launch``."""
    func(*args)
    return None
