"""``paddle._C_ops`` (counterpart of ``paddle_tpu/_C_ops.py``): a name
shim over the functional layer. ``paddle._C_ops.matmul(x, y)`` resolves
in the op modules, ``nn.functional`` and the top level, in that order;
a trailing-underscore name without an in-place op of its own runs the
base op and writes the result into its first Tensor argument."""
from __future__ import annotations

import functools

_NAMESPACES = None


def _namespaces():
    global _NAMESPACES
    if _NAMESPACES is None:
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.nn import functional
        from paddle_tpu_torch.ops import (creation, linalg, logic,
                                          manipulation, math, search)
        _NAMESPACES = [math, manipulation, creation, linalg, logic,
                       search, functional, paddle]
    return _NAMESPACES


def _inplace_wrap(fn, name):
    """``name`` (``relu_``) as ``fn`` (``relu``) whose result is written
    into the first Tensor argument (in place where the shape stays, else
    rebound, as ``reshape_`` needs)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        from paddle_tpu_torch.framework.op import apply_inplace
        from paddle_tpu_torch.framework.tensor import Tensor
        i = next((j for j, a in enumerate(args) if isinstance(a, Tensor)),
                 None)
        if i is None:
            return fn(*args, **kwargs)
        target = args[i]

        def impl(t):
            out = fn(*args[:i], Tensor._wrap(t), *args[i + 1:], **kwargs)
            first = out[0] if isinstance(out, (tuple, list)) else out
            return first._data
        apply_inplace(target, impl, (target,))
        return target
    wrapped.__name__ = name
    return wrapped


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    inplace = name.endswith("_") and not name.endswith("__")
    base = name[:-1] if inplace else name
    for ns in _namespaces():
        fn = getattr(ns, name, None)
        if callable(fn):            # a real in-place impl exists: use it
            return fn
        fn = getattr(ns, base, None)
        if callable(fn):
            return _inplace_wrap(fn, name) if inplace else fn
    raise AttributeError(
        f"paddle._C_ops.{name}: no such op in the functional layer")
