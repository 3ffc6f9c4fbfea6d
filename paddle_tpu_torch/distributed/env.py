"""The distributed environment's ranks (counterpart of
paddle_tpu/distributed/env.py:1-64).

A rank is a process once ``init_parallel_env`` has brought up a
``torch.distributed`` process group (``distributed/parallel.py``); the
port's mesh may still hold several LOGICAL ranks in each process
(``parallel/mesh.py``). The rank and world size are, in this order: the
installed HybridCommunicateGroup's (``fleet.init``; ``fleet/topology.py``
holds it), the process group's, else ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` (0 and 1 when unset).
"""
from __future__ import annotations

import os

_state = {"initialized": False}


def _hcg():
    from .fleet.topology import get_hybrid_communicate_group
    return get_hybrid_communicate_group()


def _pg_up():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def mark_initialized():
    _state["initialized"] = True


def is_initialized():
    return _state["initialized"]


def process_rank() -> int:
    """This process's rank in the process group (0 without one)."""
    if _pg_up():
        import torch.distributed as dist
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The number of processes in the process group (1 without one)."""
    if _pg_up():
        import torch.distributed as dist
        return dist.get_world_size()
    return 1


def get_rank():
    hcg = _hcg()
    if hcg is not None:
        return hcg.get_global_rank()
    if _pg_up():
        return process_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size():
    hcg = _hcg()
    if hcg is not None:
        return hcg.get_world_size()
    if _pg_up():
        return process_count()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def get_data_world_size():
    """Size of the data-parallel axis (sharding x dp under hybrid)."""
    hcg = _hcg()
    if hcg is not None:
        return (hcg.get_data_parallel_world_size()
                * hcg.get_sharding_parallel_world_size())
    return get_world_size()


def get_data_rank():
    hcg = _hcg()
    if hcg is not None:
        return (hcg.get_data_parallel_rank()
                * hcg.get_sharding_parallel_world_size()
                + hcg.get_sharding_parallel_rank())
    return get_rank()
