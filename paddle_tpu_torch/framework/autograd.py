"""Autograd of the Paddle surface over torch's graph (counterpart of
``paddle_tpu/framework/autograd.py``).

The JAX package records a tape of ``jax.vjp`` closures and walks it in
``backward`` (its ``autograd.py:123-259``); that is JAX's way to
differentiate. Here a ``Tensor``'s ``_data`` is a ``torch.Tensor`` and
torch's autograd graph is the tape: ``backward`` and ``grad`` call
torch's, ``no_grad`` / ``enable_grad`` / ``set_grad_enabled`` switch
torch's grad mode, and ``stop_gradient`` is ``not requires_grad``.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["backward", "enable_grad", "grad", "is_leaf", "no_grad",
           "set_grad_enabled", "tape_enabled"]


def tape_enabled() -> bool:
    return torch.is_grad_enabled()


class _GradMode:
    """Context manager and decorator that sets torch's grad mode."""

    mode = True

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self.mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with type(self)():
                return fn(*a, **kw)
        return wrapper


class no_grad(_GradMode):
    """``with paddle.no_grad():`` / ``@paddle.no_grad()``."""
    mode = False


class enable_grad(_GradMode):
    mode = True


def set_grad_enabled(mode: bool):
    """Sets the grad mode now; as a context manager, restores it on
    exit."""
    class _Ctx:
        def __init__(self):
            self._prev = torch.is_grad_enabled()
            torch.set_grad_enabled(bool(mode))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            torch.set_grad_enabled(self._prev)
            return False

    return _Ctx()


def is_leaf(t) -> bool:
    return t._data.grad_fn is None


def _seed(out, g):
    if g is None:
        return torch.ones_like(out._data)
    return (g._data if hasattr(g, "_data") else torch.as_tensor(g)).to(
        out._data.device, out._data.dtype)


def backward(tensor, grad_tensor=None, retain_graph=False):
    """``Tensor.backward()``: seeds ``tensor`` with ones (or
    ``grad_tensor``) and accumulates into the leaves' ``.grad``."""
    if tensor.stop_gradient:
        raise RuntimeError(
            "Tensor.backward() on a tensor with stop_gradient=True")
    tensor._data.backward(_seed(tensor, grad_tensor),
                          retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` as Tensors, without writing ``.grad``."""
    from .tensor import Tensor
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    seeds = [_seed(o, g) for o, g in zip(outputs, grad_outputs)]
    if retain_graph is None:
        retain_graph = create_graph
    try:
        gs = torch.autograd.grad([o._data for o in outputs],
                                 [t._data for t in inputs], seeds,
                                 retain_graph=retain_graph,
                                 create_graph=create_graph,
                                 allow_unused=allow_unused)
    except RuntimeError as e:
        if "not have been used in the graph" in str(e):
            raise RuntimeError(
                "one of the input tensors receives no gradient (pass "
                "allow_unused=True to return None instead)") from e
        raise
    return [None if g is None else Tensor._wrap(g) for g in gs]
