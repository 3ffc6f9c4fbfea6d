"""Hybrid-parallel gradient and parameter sync helpers (counterpart of
paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py).

The port's ranks are LOGICAL ranks of one process (``parallel/
mesh.py``): every gradient is the one global value of the global batch,
and every parameter one logical tensor, as on the reference's global
view. So the mean over a group of identical values, and a broadcast of
one value, change nothing: each helper is the identity and moves
nothing (no collective is counted).
"""
from __future__ import annotations

__all__ = ["fused_allreduce_gradients", "broadcast_mp_parameters",
           "broadcast_dp_parameters", "sharding_reduce_gradients",
           "broadcast_sharding_parameters"]


def fused_allreduce_gradients(parameter_list, hcg=None):
    """Mean of each gradient (``main_grad`` where a parameter has one)
    over the data-parallel group: the gradient itself."""


def sharding_reduce_gradients(parameter_list, hcg=None):
    """Mean over the sharding group: the gradient itself."""


def broadcast_mp_parameters(model, hcg=None):
    """Rank 0's weights across the model-parallel group: the weights."""


def broadcast_dp_parameters(model, hcg=None):
    """Rank 0's weights across the data-parallel group: the weights."""


def broadcast_sharding_parameters(model, hcg=None):
    """Rank 0's weights across the sharding group: the weights."""
