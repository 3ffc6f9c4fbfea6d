"""The top level's tail (counterpart of
``paddle_tpu/framework/api_extras.py``): dtype limits, print options,
``LazyGuard``, ``check_shape`` and the CUDA generator's state."""
from __future__ import annotations

import numpy as np
import torch

from .dtype import convert_dtype, dtype_name

__all__ = ["iinfo", "finfo", "dtype", "set_printoptions", "LazyGuard",
           "check_shape", "get_cuda_rng_state", "set_cuda_rng_state"]


class _IInfo:
    def __init__(self, d):
        i = torch.iinfo(d)
        self.min, self.max, self.bits = int(i.min), int(i.max), int(i.bits)
        self.dtype = dtype_name(d)

    def __repr__(self):
        return (f"paddle.iinfo(min={self.min}, max={self.max}, "
                f"bits={self.bits}, dtype={self.dtype})")


class _FInfo:
    def __init__(self, d):
        f = torch.finfo(d)
        self.min, self.max = float(f.min), float(f.max)
        self.eps = float(f.eps)
        self.bits = int(f.bits)
        self.tiny = float(f.tiny)
        self.smallest_normal = float(f.smallest_normal)
        self.resolution = float(f.resolution)
        self.dtype = dtype_name(d)

    def __repr__(self):
        return (f"paddle.finfo(min={self.min}, max={self.max}, "
                f"eps={self.eps}, bits={self.bits}, dtype={self.dtype})")


def iinfo(d):
    """Machine limits of an integer dtype."""
    return _IInfo(convert_dtype(d))


def finfo(d):
    """Machine limits of a floating dtype."""
    return _FInfo(convert_dtype(d))


# paddle.dtype: the type of the port's dtypes
dtype = torch.dtype


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """A Tensor's repr prints its numpy value: numpy's print options are
    set (torch's too, for the torch tensors underneath)."""
    kw = {}
    if precision is not None:
        kw["precision"] = int(precision)
    if threshold is not None:
        kw["threshold"] = int(threshold)
    if edgeitems is not None:
        kw["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        kw["linewidth"] = int(linewidth)
    np.set_printoptions(**kw, **({} if sci_mode is None else
                                 {"suppress": not bool(sci_mode)}))
    torch.set_printoptions(**kw, **({} if sci_mode is None else
                                    {"sci_mode": bool(sci_mode)}))


class LazyGuard:
    """Parameters are made when their layer is; the guard changes
    nothing (``Parameter.initialize`` returns the parameter)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def check_shape(shape):
    """Validate a shape argument of a creation op."""
    from .tensor import Tensor
    if isinstance(shape, Tensor):
        if shape.dtype not in (torch.int32, torch.int64):
            raise TypeError("shape tensor must be int32 or int64, got "
                            f"{shape.dtype}")
        return
    for ele in shape:
        if isinstance(ele, Tensor):
            continue
        if not isinstance(ele, (int, np.integer)):
            raise TypeError("All elements in ``shape`` must be integers "
                            "when it's a list or tuple")
        if ele < 0:
            raise ValueError("All elements in ``shape`` must be positive "
                             "when it's a list or tuple")


def get_cuda_rng_state():
    """The states of every card's default generator."""
    return torch.cuda.get_rng_state_all()


def set_cuda_rng_state(state):
    torch.cuda.set_rng_state_all(state)
