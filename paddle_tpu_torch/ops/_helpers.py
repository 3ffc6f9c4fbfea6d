"""Shared helpers of the Paddle ops (counterpart of
``paddle_tpu/ops/_helpers.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dtype import convert_dtype, get_default_dtype
from ..framework.op import apply, apply_inplace, unwrap, wrap
from ..framework.tensor import Tensor

__all__ = ["apply", "apply_inplace", "unwrap", "wrap", "Tensor", "torch",
           "np", "convert_dtype", "get_default_dtype", "op", "nodiff_op",
           "normalize_axis", "dims", "as_like", "long"]


def op(name, impl, *tensors, **kwargs):
    """Apply a differentiable op."""
    return apply(impl, tensors, kwargs, op_name=name)


def nodiff_op(name, impl, *tensors, **kwargs):
    return apply(impl, tensors, kwargs, differentiable=False, op_name=name)


def normalize_axis(axis):
    """Paddle axes may be Tensors / ints / lists; canonicalize to Python
    ints."""
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.numpy()
    if isinstance(axis, (list, tuple, np.ndarray)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(ax, ndim):
    """An axis argument (None: every axis) as a tuple of dims."""
    if ax is None:
        return tuple(range(ndim))
    return (ax,) if isinstance(ax, int) else tuple(ax)


def as_like(v, like):
    """``v`` (a Python number or a tensor) as a tensor on ``like``'s
    device."""
    if isinstance(v, torch.Tensor):
        return v.to(like.device)
    return torch.as_tensor(v, device=like.device)


def long(idx):
    """Index tensors as int64, which torch's gather / scatter / index ops
    take (the handles hold int32, as the JAX package's do)."""
    return idx if idx.dtype in (torch.long, torch.bool) else idx.long()
