"""The fleet facade (counterpart of paddle_tpu/distributed/fleet/
fleet.py:16-168): ``init`` builds the hybrid topology and the port's
mesh, ``distributed_model`` wraps a model for the topology's parallel
mode, ``distributed_optimizer`` wraps its optimizer.

The port runs the tensor- and data-parallel modes. Every rank is a
LOGICAL rank of one process (``parallel/mesh.py``): ``init(...,
device=...)`` places them all on that device (``"cuda"`` on one card,
``"cpu"`` for the CPU paths); without it the mesh takes every card,
whose mp rows the mpu layers refuse (ROADMAP Queue A item 10b). The
pipeline and sharding modes, and the meta-optimizers other than at
their defaults, wait for item 11b.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...device import resolve_device
from ...framework.unported import require_defaults, unported
from .. import env as dist_env
from .strategy import DistributedStrategy
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       get_hybrid_communicate_group,
                       set_hybrid_communicate_group)

__all__ = ["HybridParallelOptimizer", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "barrier_worker", "distributed_model",
           "distributed_optimizer", "init", "is_first_worker",
           "is_initialized", "worker_index", "worker_num"]


class _FleetState:
    def __init__(self):
        self.initialized = False
        self.strategy: Optional[DistributedStrategy] = None


_fleet = _FleetState()


def init(role_maker=None, is_collective=False, strategy=None,
         log_level="INFO", *, device=None):
    """Build the topology of ``strategy.hybrid_configs`` (data, pipe,
    sharding, sep, model; ``dp_degree`` <= 0 fills the devices left),
    install it and its mesh, and seed the model-parallel RNG streams
    (``tensor_parallel_configs.tensor_init_seed``, random when -1).
    ``device``: every rank a logical rank on it; None: the mesh over
    every card."""
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    names = ["data", "pipe", "sharding", "sep", "model"]
    degrees = [hc["dp_degree"], hc["pp_degree"], hc["sharding_degree"],
               hc.get("sep_degree", 1), hc["mp_degree"]]
    rest = degrees[1] * degrees[2] * degrees[3] * degrees[4]
    if degrees[0] <= 0:
        n_dev = torch.cuda.device_count() if device is None else rest
        degrees[0] = max(n_dev // rest, 1)
    topo = CommunicateTopology(names, degrees)
    devices = (None if device is None
               else [resolve_device(device)] * topo.world_size)
    rank = dist_env.get_rank()
    hcg = HybridCommunicateGroup(
        topo, global_rank=rank if rank < topo.world_size else 0,
        devices=devices)
    set_hybrid_communicate_group(hcg)
    _fleet.initialized = True
    _fleet.strategy = strategy
    dist_env.mark_initialized()
    from .layers.mpu import random as mpu_random
    seed = strategy.tensor_parallel_configs.get("tensor_init_seed", -1)
    mpu_random.model_parallel_random_seed(
        None if seed in (-1, None) else seed)
    return None


def is_initialized():
    return _fleet.initialized


def worker_index():
    return dist_env.get_rank()


def worker_num():
    return dist_env.get_world_size()


def is_first_worker():
    return dist_env.get_rank() == 0


def barrier_worker():
    pass


def distributed_model(model):
    """``model`` wrapped for the installed topology: ``TensorParallel``
    in the tensor-parallel mode, ``DataParallel`` in the data-parallel
    one."""
    hcg = get_hybrid_communicate_group()
    from ..parallel import DataParallel
    from .meta_parallel.meta_parallel_base import TensorParallel
    mode = hcg.get_parallel_mode()
    if mode == "tensor_parallel":
        return TensorParallel(model, hcg, _fleet.strategy)
    if mode == "data_parallel":
        return DataParallel(model)
    unported("fleet.distributed_model", f"the {mode} mode", "11b")


class HybridParallelOptimizer:
    """The user's optimizer under the hybrid topology. Gradients of the
    mpu layers are full logical tensors and the dp ranks' batch is one
    global batch, so there is nothing to reduce: the wrapper hands
    ``step`` and the rest through."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        if strategy is not None and \
                strategy.hybrid_configs["sharding_degree"] > 1:
            unported("HybridParallelOptimizer", "sharding_degree > 1",
                     "11b")
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)

    def step(self):
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()`` (dygraph's minimize)."""
        require_defaults("HybridParallelOptimizer.minimize",
                         startup_program=(startup_program, None),
                         parameters=(parameters, None),
                         no_grad_set=(no_grad_set, None))
        loss.backward()
        self.step()
        return [], []

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad


_META_FLAGS = ("lars", "lamb", "dgc", "gradient_merge", "localsgd")


def distributed_optimizer(optimizer, strategy=None):
    """``optimizer`` in a HybridParallelOptimizer. The strategy's
    meta-optimizer flags (lars, lamb, dgc, gradient_merge, localsgd) are
    accepted only off."""
    strategy = strategy or _fleet.strategy
    if strategy is not None:
        require_defaults("fleet.distributed_optimizer", **{
            f: (bool(getattr(strategy, f, False)), False)
            for f in _META_FLAGS})
    return HybridParallelOptimizer(optimizer,
                                   get_hybrid_communicate_group(), strategy)


class UserDefinedRoleMaker:
    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        self._kwargs = kwargs


class PaddleCloudRoleMaker(UserDefinedRoleMaker):
    pass
