"""The distributed environment's ranks (counterpart of
paddle_tpu/distributed/env.py:1-64).

One process holds every rank of the port's mesh (logical ranks, see
``parallel/mesh.py``), so there is no per-process rank to read: the
rank and world size are the installed HybridCommunicateGroup's
(``fleet.init``; ``fleet/topology.py`` holds it), else
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` (0 and 1 when unset).
"""
from __future__ import annotations

import os

_state = {"initialized": False}


def _hcg():
    from .fleet.topology import get_hybrid_communicate_group
    return get_hybrid_communicate_group()


def mark_initialized():
    _state["initialized"] = True


def is_initialized():
    return _state["initialized"]


def get_rank():
    hcg = _hcg()
    if hcg is not None:
        return hcg.get_global_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size():
    hcg = _hcg()
    if hcg is not None:
        return hcg.get_world_size()
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
