"""The op-boundary hook: the port's counterpart of the one place where
the JAX package casts, checks and records every op application
(``paddle_tpu/framework/op.py:197-240``: ``maybe_cast_inputs`` at
``:211``, the host-event record at ``:223-228``, the
``FLAGS_check_nan_inf`` scan at ``:234-235``).

The port has no dispatcher. Every functional and layer on its training
paths calls ``op_inputs(op_name, *tensors)`` at its head, under the JAX
package's op name, and computes on what it returns:

- under ``amp.auto_cast`` the inputs come back cast by the amp rule
  (``amp/auto_cast.py`` ``maybe_cast_inputs``);
- while operator stats are collected (``amp/debugging.py``) the call is
  counted under its name;
- with ``FLAGS_check_nan_inf`` on, the floating inputs are scanned and
  a NaN/Inf raises naming the op. The reference scans an op's outputs;
  here the inputs of the next hooked op are scanned, so a bad value is
  reported at the first hooked op that consumes it.

With amp off and nothing watching, a call costs one thread-local read
and one module attribute read. ``add``, ``multiply``, ``concat`` and
``matmul`` are the elementwise and product ops whose reference
counterparts go through the hook (``Tensor.__add__`` is
``elementwise_add`` through ``apply``, ``paddle_tpu/ops/math.py:44-53``):
under O2 an fp32 and a bf16 input meet in bf16 there, where torch's type
promotion would give fp32. The serving modules call no hook.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..amp.auto_cast import _state as _amp
from ..amp.auto_cast import maybe_cast_inputs

__all__ = ["add", "concat", "counter", "matmul", "multiply", "op_inputs",
           "refresh_watch", "unwatch", "watch"]


class _Watch:
    """Who watches the hook: the nan/inf scan (``FLAGS_check_nan_inf``)
    and the observers (operator stats, tests' dtype traces)."""
    on = False
    check = False
    observers: list = []


def refresh_watch():
    from ..flags import get_flag
    _Watch.check = bool(get_flag("FLAGS_check_nan_inf", False))
    _Watch.on = _Watch.check or bool(_Watch.observers)


def watch(observer):
    """Call ``observer(op_name, tensors)`` at every hooked op (after the
    cast) until ``unwatch(observer)``."""
    _Watch.observers = _Watch.observers + [observer]
    refresh_watch()


def unwatch(observer):
    _Watch.observers = [o for o in _Watch.observers if o is not observer]
    refresh_watch()


def counter():
    """An observer that counts calls per op name (``.counts``)."""
    counts = Counter()

    def observe(op_name, tensors):
        counts[op_name] += 1
    observe.counts = counts
    return observe


def _check_nan_inf(op_name, tensors):
    for i, t in enumerate(tensors):
        if not isinstance(t, torch.Tensor) or not (
                t.is_floating_point() or t.is_complex()):
            continue
        if not bool(torch.isfinite(t).all()):
            n_nan = int(torch.isnan(t).sum())
            n_inf = int(torch.isinf(t).sum())
            raise RuntimeError(
                f"Operator {op_name or 'op'} input {i} contains NaN/Inf "
                f"(nan={n_nan}, inf={n_inf}, shape={tuple(t.shape)}, "
                f"dtype={t.dtype}). Triggered by FLAGS_check_nan_inf.")


def op_inputs(op_name, *tensors):
    """The inputs of one application of ``op_name``, cast under amp; see
    the module docstring."""
    if _amp.enabled:
        tensors = maybe_cast_inputs(op_name, tensors)
    if _Watch.on:
        if _Watch.check:
            _check_nan_inf(op_name, tensors)
        for observe in _Watch.observers:
            observe(op_name, tensors)
    return tensors


def add(x, y):
    """``x + y`` as the reference's ``elementwise_add``."""
    x, y = op_inputs("elementwise_add", x, y)
    return x + y


def multiply(x, y):
    """``x * y`` as the reference's ``elementwise_mul``."""
    x, y = op_inputs("elementwise_mul", x, y)
    return x * y


def concat(tensors, axis=0):
    """``paddle.concat``: torch.cat after the hook."""
    return torch.cat(list(op_inputs("concat", *tensors)), dim=axis)


def matmul(x, y, transpose_x=False, transpose_y=False):
    """``paddle.matmul`` (op name ``matmul``)."""
    x, y = op_inputs("matmul", x, y)
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return x @ y
