"""Communication groups (counterpart of paddle_tpu/distributed/
communication/group.py:1-92).

A Group is a list of global ranks, and names the mesh axis
(``parallel/mesh.py`` ``AXIS_ORDER``) it runs along when it is one
axis's slice. The collectives over a group are those of
``parallel/collective.py``, over the group's ranks' tensors. Once a
process group is up (``init_parallel_env``) a rank is a process: a
group of several processes carries their ``torch.distributed`` group
(``process_group``), and the world group is the processes' world.
"""
from __future__ import annotations

from typing import List, Optional

from .. import env


def _world_up() -> bool:
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)

__all__ = ["Group", "ReduceOp", "axis_group", "get_world_group",
           "new_group"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    def __init__(self, ranks: List[int], gid: int = 0,
                 axis: Optional[str] = None, name: Optional[str] = None):
        self.ranks = list(ranks)
        self.id = gid
        self.axis = axis
        self._name = name or f"group_{gid}"

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    @property
    def world_size(self) -> int:
        return len(self.ranks)

    @property
    def name(self):
        return self._name

    @property
    def process_group(self):
        """The ``torch.distributed`` group of the ranks' processes once a
        process group is up, else the Group itself (one process holds
        every rank)."""
        if not _world_up():
            return self
        from ...parallel.collective import process_group
        return process_group(self.ranks)

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def rank(self):
        return self.get_group_rank(env.get_rank())

    def __repr__(self):
        return f"Group(id={self.id}, axis={self.axis}, ranks={self.ranks})"


_group_counter = [0]


def _new_group_id():
    _group_counter[0] += 1
    return _group_counter[0]


def get_world_group() -> Group:
    """Every process once a process group is up, else every rank of the
    installed topology (one when none is)."""
    if _world_up():
        return Group(list(range(env.process_count())), 0, name="world")
    return Group(list(range(env.get_world_size())), 0, name="world")


def new_group(ranks=None, backend=None, timeout=None, axis=None) -> Group:
    """A group of ``ranks``; with a process group up its processes get
    their ``torch.distributed`` group now (every member calls this)."""
    if ranks is None:
        return get_world_group()
    g = Group(list(ranks), _new_group_id(), axis=axis)
    if _world_up() and len(set(g.ranks)) > 1:
        g.process_group
    return g


def axis_group(axis: str, ranks: List[int]) -> Group:
    return Group(ranks, _new_group_id(), axis=axis, name=f"{axis}_group")
