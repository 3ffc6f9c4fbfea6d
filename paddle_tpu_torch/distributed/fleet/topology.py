"""Hybrid-parallel topology (counterpart of paddle_tpu/distributed/fleet/
topology.py: ``CommunicateTopology`` :28-83, ``HybridCommunicateGroup``
:84-219).

The rank arithmetic is the reference's: ranks in row-major order over
the hybrid axes, one group per axis slice. The topology IS the port's
training mesh (``parallel/mesh.py``): ``HybridCommunicateGroup`` builds
and installs it, and each axis's group names its mesh axis. One process
holds every rank (LOGICAL ranks where the mesh repeats a device).
"""
from __future__ import annotations

import collections
import itertools

import numpy as np

from ...parallel import mesh as mesh_mod
from ..communication.group import Group, axis_group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group"]

_HYBRID_PARALLEL_GROUP = None

# the reference's hybrid axis names -> the mesh's
_AXIS_TO_MESH = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                 "sep": "sep", "model": "mp"}


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = collections.namedtuple(
            "Coordinate", self._parallel_names)
        self.world_size = int(np.prod(self._dims))
        all_coords = [self.coordinate(*c) for c in itertools.product(
            *[range(d) for d in self._dims])]
        self._coord2rank = {c: i for i, c in enumerate(all_coords)}
        self._rank2coord = {i: c for c, i in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def get_rank(self, **args):
        return self._coord2rank[self.coordinate(**args)]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in self._rank2coord.items() if c[axis] == index]

    def get_comm_list(self, axis_name):
        """All rank lists along ``axis_name`` (one per coordinate of the
        other axes)."""
        axis = self._parallel_names.index(axis_name)
        other = [i for i in range(len(self._dims)) if i != axis]
        lists = []
        for combo in itertools.product(*[range(self._dims[i])
                                         for i in other]):
            ranks = []
            for k in range(self._dims[axis]):
                coord = [0] * len(self._dims)
                for i, v in zip(other, combo):
                    coord[i] = v
                coord[axis] = k
                ranks.append(self._coord2rank[self.coordinate(*coord)])
            lists.append(ranks)
        return lists

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = self.get_coord(global_rank)
        return self.get_rank(**coord._replace(**kwargs)._asdict())


class HybridCommunicateGroup:
    """The groups of ``topology`` seen from ``global_rank``; builds and
    installs the mesh over ``devices`` (``parallel/mesh.build_mesh``:
    every card when None; repeat a device to place several ranks on
    it)."""

    def __init__(self, topology: CommunicateTopology, global_rank=0, *,
                 devices=None):
        self._topo = topology
        self.global_rank = int(global_rank)
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._mp_degree = topology.get_dim("model")
        self._sep_degree = topology.get_dim("sep") if \
            "sep" in topology.get_hybrid_group_names() else 1

        coord = topology.get_coord(self.global_rank)
        self._dp_rank = coord.data
        self._pp_rank = coord.pipe
        self._sharding_rank = coord.sharding
        self._mp_rank = coord.model
        self._sep_rank = getattr(coord, "sep", 0)

        mesh_mod.build_mesh(dp=self._dp_degree, pp=self._pp_degree,
                            sharding=self._sharding_degree,
                            sep=self._sep_degree, mp=self._mp_degree,
                            devices=devices)

        def _grp(name):
            lists = topology.get_comm_list(name)
            mine = next((l for l in lists if self.global_rank in l),
                        lists[0])
            return axis_group(_AXIS_TO_MESH[name], mine)

        self._dp_group = _grp("data")
        self._pp_group = _grp("pipe")
        self._sharding_group = _grp("sharding")
        self._mp_group = _grp("model")
        self._sep_group = _grp("sep") if \
            "sep" in topology.get_hybrid_group_names() else None
        self._check_group = Group(list(range(topology.world_size)), 0,
                                  axis=None, name="check")

    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1:
            return "data_parallel"
        if self._sharding_degree > 1 and self._mp_degree == 1 and \
                self._pp_degree == 1 and self._dp_degree == 1:
            return "sharding_parallel"
        if self._mp_degree > 1 and self._pp_degree == 1:
            return "tensor_parallel"
        if self._pp_degree > 1:
            return "pipeline_parallel"
        return "data_parallel"

    def get_global_rank(self):
        return self.global_rank

    def get_world_size(self):
        return self._topo.world_size

    # data parallel
    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # pipeline parallel
    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_rank(self):
        return self._pp_rank

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_p2p_groups(self):
        return None

    def is_first_stage(self):
        return self._pp_rank == 0

    def is_last_stage(self):
        return self._pp_rank == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    # sep
    def get_sep_parallel_rank(self):
        return self._sep_rank

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._sep_group

    def get_check_parallel_group(self, *a):
        return self._check_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)


def set_hybrid_communicate_group(hcg):
    """Install ``hcg`` (None uninstalls it) for the layers, the models'
    ``_mp_active`` and ``distributed.env``."""
    global _HYBRID_PARALLEL_GROUP
    _HYBRID_PARALLEL_GROUP = hcg


def get_hybrid_communicate_group():
    return _HYBRID_PARALLEL_GROUP
