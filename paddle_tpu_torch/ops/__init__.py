"""Paddle's functional ops over torch (counterpart of
``paddle_tpu/ops/__init__.py``): every op unwraps its Tensor handles,
runs a torch impl and wraps the result (``framework/op.py`` ``apply``).
``install_tensor_methods`` makes them Tensor methods and dunders, as the
reference does. ``hopper`` holds the hand-written kernels, one module per
Pallas file of ``paddle_tpu/ops/pallas``."""
from __future__ import annotations

from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403

from . import creation, linalg, logic, manipulation, math, search  # noqa: F401

import torch as _torch

from ..framework.dtype import is_floating, is_integer
from ..framework.op import wrap as _wrap
from ..framework.tensor import Tensor


def rank(x):
    return _wrap(_torch.tensor(x.ndim, dtype=_torch.int32,
                               device=x._data.device))


def shape(x):
    return _wrap(_torch.tensor(x.shape, dtype=_torch.int32,
                               device=x._data.device))


def is_floating_point(x):
    return is_floating(x.dtype)


def is_integer_point(x):
    return is_integer(x.dtype)


def is_complex(x):
    return x._data.is_complex()


# ---------------------------------------------------------------------------
# Tensor method installation (the reference's monkey_patch_tensor)
# ---------------------------------------------------------------------------

_METHOD_SOURCES = [creation, math, manipulation, linalg, logic, search]

# every public op whose first positional arg is a Tensor becomes a method
_NON_METHODS = {
    "to_tensor", "zeros", "ones", "full", "empty", "arange", "linspace",
    "logspace", "eye", "meshgrid", "rand", "randn", "randint", "randperm",
    "uniform", "normal", "standard_normal", "bernoulli", "multinomial",
    "poisson", "assign", "one_hot", "complex", "tril_indices",
    "triu_indices", "einsum", "broadcast_shape", "is_tensor",
    "broadcast_tensors", "add_n", "multi_dot", "randint_like",
}


def _make_method(fn):
    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)
    method.__name__ = fn.__name__
    method.__doc__ = fn.__doc__
    return method


def install_tensor_methods():
    for mod in _METHOD_SOURCES:
        for name in getattr(mod, "__all__", []):
            if name in _NON_METHODS or hasattr(Tensor, name):
                continue
            fn = getattr(mod, name)
            if callable(fn):
                setattr(Tensor, name, _make_method(fn))

    for name, fn in [("rank", rank), ("is_floating_point", is_floating_point),
                     ("is_complex", is_complex)]:
        if not hasattr(Tensor, name):
            setattr(Tensor, name, _make_method(fn))

    # arithmetic dunders
    from .math import (add, subtract, multiply, divide, floor_divide, mod,
                       pow as _pow, neg, abs as _abs)
    from .logic import (equal, not_equal, less_than, less_equal, greater_than,
                        greater_equal)
    from .linalg import matmul

    def _flip(fn):
        def m(self, other):
            return fn(other, self)
        return m

    Tensor.__add__ = lambda s, o: add(s, o)
    Tensor.__radd__ = lambda s, o: add(s, o)
    Tensor.__sub__ = lambda s, o: subtract(s, o)
    Tensor.__rsub__ = _flip(subtract)
    Tensor.__mul__ = lambda s, o: multiply(s, o)
    Tensor.__rmul__ = lambda s, o: multiply(s, o)
    Tensor.__truediv__ = lambda s, o: divide(s, o)
    Tensor.__rtruediv__ = _flip(divide)
    Tensor.__floordiv__ = lambda s, o: floor_divide(s, o)
    Tensor.__rfloordiv__ = _flip(floor_divide)
    Tensor.__mod__ = lambda s, o: mod(s, o)
    Tensor.__rmod__ = _flip(mod)
    Tensor.__pow__ = lambda s, o: _pow(s, o)
    Tensor.__rpow__ = _flip(_pow)
    Tensor.__neg__ = lambda s: neg(s)
    Tensor.__abs__ = lambda s: _abs(s)
    Tensor.__matmul__ = lambda s, o: matmul(s, o)
    Tensor.__rmatmul__ = _flip(matmul)
    Tensor.__eq__ = lambda s, o: equal(s, o)
    Tensor.__ne__ = lambda s, o: not_equal(s, o)
    Tensor.__lt__ = lambda s, o: less_than(s, o)
    Tensor.__le__ = lambda s, o: less_equal(s, o)
    Tensor.__gt__ = lambda s, o: greater_than(s, o)
    Tensor.__ge__ = lambda s, o: greater_equal(s, o)
    Tensor.__invert__ = lambda s: logic.logical_not(s)
    Tensor.__and__ = lambda s, o: logic.bitwise_and(s, o)
    Tensor.__or__ = lambda s, o: logic.bitwise_or(s, o)
    Tensor.__xor__ = lambda s, o: logic.bitwise_xor(s, o)
    Tensor.__hash__ = lambda s: id(s)
