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

The Paddle surface (``framework/tensor.py``, ``ops/``) runs every op
through ``apply`` (``paddle_tpu/framework/op.py:197-279``): it unwraps
the ``Tensor`` handles, passes plain torch tensors through, calls
``op_inputs(op_name, ...)`` (so amp, operator stats and
``FLAGS_check_nan_inf`` see every Paddle op as in the reference), runs
the torch impl and wraps what it returns. Gradients are torch's: there
is no tape and no executable cache (``_op_exec_for`` is XLA's; eager
torch needs none). ``apply_inplace`` writes the result into the
target's ``_data`` in place. ``takes_handles`` is the boundary of the
port's torch-native functionals and layers: handles in, handles out.
"""
from __future__ import annotations

import functools
from collections import Counter

import numpy as np
import torch

from ..amp.auto_cast import _state as _amp
from ..amp.auto_cast import maybe_cast_inputs
from .device import current_device
from .tensor import Tensor

__all__ = ["add", "apply", "apply_inplace", "check_inplace", "concat",
           "counter", "matmul", "multiply", "op_inputs", "refresh_watch",
           "takes_handles", "unwatch", "unwrap", "wrap", "watch"]


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


# -- the Paddle surface: handles over torch tensors --------------------------

def unwrap(x):
    """A handle's torch tensor; anything else as it is."""
    return x._data if isinstance(x, Tensor) else x


def wrap(x, stop_gradient=None):
    """A handle over the torch tensor ``x`` (a Python or numpy value
    becomes a tensor on the current device first); ``stop_gradient=True``
    detaches it."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=current_device())
    if stop_gradient and x.requires_grad:
        x = x.detach()
    return Tensor._wrap(x)


def _arrays(tensor_args):
    """The op's inputs as torch tensors: handles unwrapped, numpy arrays
    moved to the device of the first tensor, numpy scalars as Python
    numbers."""
    arrays = [unwrap(a) for a in tensor_args]
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
               None)
    for i, a in enumerate(arrays):
        if isinstance(a, np.ndarray):
            arrays[i] = torch.from_numpy(np.ascontiguousarray(a)).to(
                dev if dev is not None else current_device())
        elif isinstance(a, np.generic):
            arrays[i] = a.item()
    return arrays


def _wrap_out(out):
    if isinstance(out, (tuple, list)):
        return tuple(_wrap_out(o) for o in out)
    return wrap(out)


def apply(impl, tensor_args, kwargs=None, differentiable=True, op_name=None):
    """``impl(*torch_tensors, **kwargs)`` for one Paddle op: handles
    unwrapped, the inputs through ``op_inputs(op_name, ...)``, the
    outputs wrapped (a tuple for a tuple). ``differentiable=False`` runs
    under no_grad."""
    arrays = op_inputs(op_name, *_arrays(tensor_args))
    if differentiable:
        out = impl(*arrays, **(kwargs or {}))
    else:
        with torch.no_grad():
            out = impl(*arrays, **(kwargs or {}))
    return _wrap_out(out)


def check_inplace(target):
    """Paddle's rule: an in-place op on a leaf that needs a gradient
    raises while gradients are recorded."""
    t = target._data
    if t.requires_grad and t.grad_fn is None and torch.is_grad_enabled():
        raise ValueError(
            f"Leaf Tensor {target.name} that doesn't stop gradient can't "
            "use an inplace strategy")


def apply_inplace(target, impl, tensor_args, kwargs=None,
                  differentiable=True):
    """The in-place variant: ``impl``'s result is written into
    ``target._data`` in place (cast to its dtype), or, where the shape
    changes (``reshape_``, ``squeeze_``), rebinds it. While gradients are
    recorded the op reads a clone of the target, so nothing it saves for
    its backward is overwritten."""
    check_inplace(target)
    arrays = _arrays(tensor_args)
    t = target._data
    grad_on = differentiable and torch.is_grad_enabled()
    if grad_on and any(isinstance(a, torch.Tensor) and a.requires_grad
                       for a in arrays):
        arrays = [a.clone() if a is t else a for a in arrays]
    with torch.set_grad_enabled(grad_on):
        out = impl(*arrays, **(kwargs or {}))
        if tuple(out.shape) == tuple(t.shape):
            t.copy_(out)
        else:
            target._data = out.to(t.dtype)
    return target


def _tree(x, leaf):
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_tree(v, leaf) for v in x)
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    return leaf(x)


def _has_handle(x):
    if isinstance(x, Tensor):
        return True
    if isinstance(x, (list, tuple)):
        return any(_has_handle(v) for v in x)
    if isinstance(x, dict):
        return any(_has_handle(v) for v in x.values())
    return False


def _wrap_tree(x):
    return _tree(x, lambda v: wrap(v) if isinstance(v, torch.Tensor) else v)


def call_with_handles(fn, args, kwargs):
    """``fn(*args, **kwargs)`` with every handle in ``args`` / ``kwargs``
    (in lists, tuples and dicts too) unwrapped, and every torch tensor it
    returns wrapped."""
    args, kwargs = _tree((args, kwargs), unwrap)
    return _wrap_tree(fn(*args, **kwargs))


def takes_handles(fn):
    """The boundary of a torch-native functional: called with a
    ``Tensor`` handle anywhere in its arguments it unwraps them and
    returns handles; called with torch tensors it is ``fn``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _has_handle(args) or _has_handle(kwargs):
            return call_with_handles(fn, args, kwargs)
        return fn(*args, **kwargs)
    return wrapper
