"""Comparison / logical / bitwise ops (counterpart of
``paddle_tpu/ops/logic.py``)."""
from __future__ import annotations

import torch

from ._helpers import (Tensor, as_like, dims, nodiff_op, normalize_axis,
                       unwrap, wrap)

__all__ = [
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "is_empty", "isclose", "allclose", "equal_all", "all", "any",
    "is_tensor", "isreal", "iscomplex", "isposinf", "isneginf",
]


def equal(x, y, name=None):
    return nodiff_op("equal", lambda a, b: a == b, x, y)


def not_equal(x, y, name=None):
    return nodiff_op("not_equal", lambda a, b: a != b, x, y)


def less_than(x, y, name=None):
    return nodiff_op("less_than", lambda a, b: a < b, x, y)


def less_equal(x, y, name=None):
    return nodiff_op("less_equal", lambda a, b: a <= b, x, y)


def greater_than(x, y, name=None):
    return nodiff_op("greater_than", lambda a, b: a > b, x, y)


def greater_equal(x, y, name=None):
    return nodiff_op("greater_equal", lambda a, b: a >= b, x, y)


def _binary(fn):
    return lambda a, b: fn(a, as_like(b, a))


def logical_and(x, y, out=None, name=None):
    return nodiff_op("logical_and", _binary(torch.logical_and), x, y)


def logical_or(x, y, out=None, name=None):
    return nodiff_op("logical_or", _binary(torch.logical_or), x, y)


def logical_xor(x, y, out=None, name=None):
    return nodiff_op("logical_xor", _binary(torch.logical_xor), x, y)


def logical_not(x, out=None, name=None):
    return nodiff_op("logical_not", torch.logical_not, x)


def bitwise_and(x, y, out=None, name=None):
    return nodiff_op("bitwise_and", _binary(torch.bitwise_and), x, y)


def bitwise_or(x, y, out=None, name=None):
    return nodiff_op("bitwise_or", _binary(torch.bitwise_or), x, y)


def bitwise_xor(x, y, out=None, name=None):
    return nodiff_op("bitwise_xor", _binary(torch.bitwise_xor), x, y)


def bitwise_not(x, out=None, name=None):
    return nodiff_op("bitwise_not", torch.bitwise_not, x)


def is_empty(x, name=None):
    a = unwrap(x)
    return wrap(torch.tensor(a.numel() == 0, device=a.device))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return nodiff_op("isclose", lambda a, b: torch.isclose(
        a, as_like(b, a).to(a.dtype), rtol=rtol, atol=atol,
        equal_nan=equal_nan), x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return nodiff_op("allclose", lambda a, b: torch.isclose(
        a, as_like(b, a).to(a.dtype), rtol=rtol, atol=atol,
        equal_nan=equal_nan).all(), x, y)


def equal_all(x, y, name=None):
    def impl(a, b):
        b = as_like(b, a)
        if a.shape != b.shape:
            return torch.tensor(False, device=a.device)
        return (a == b).all()
    return nodiff_op("equal_all", impl, x, y)


def all(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return nodiff_op("reduce_all", lambda a: torch.all(
        a.bool(), dim=dims(ax, a.ndim), keepdim=keepdim), x)


def any(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return nodiff_op("reduce_any", lambda a: torch.any(
        a.bool(), dim=dims(ax, a.ndim), keepdim=keepdim), x)


def is_tensor(x):
    return isinstance(x, Tensor)


def isreal(x, name=None):
    return nodiff_op("isreal", torch.isreal, x)


def iscomplex(x):
    return unwrap(x).is_complex()


def isposinf(x, name=None):
    return nodiff_op("isposinf", torch.isposinf, x)


def isneginf(x, name=None):
    return nodiff_op("isneginf", torch.isneginf, x)
