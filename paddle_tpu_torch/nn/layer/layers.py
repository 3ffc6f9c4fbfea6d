"""The ``nn.Layer`` base (counterpart of paddle_tpu/nn/layer/layers.py):
``Layer``, ``ParamAttr`` and ``HookRemoveHelper``.

``Layer`` is a ``torch.nn.Module`` with Paddle's layer surface on top.
Where torch already owns a name (``parameters``, ``named_parameters``,
``state_dict``, ``train``, ``eval``, ``to``, ``apply``, ``float``,
``half``, ``bfloat16``, ``register_buffer``,
``register_forward_pre_hook``) torch's semantics stay: the optimizers,
``amp.decorate`` and the models rely on them. The Paddle names added
here are ``add_parameter``, ``add_sublayer``, ``astype``,
``clear_gradients``, ``create_parameter``, ``full_name``,
``named_sublayers``, ``sublayers``, ``register_forward_post_hook`` and
``set_state_dict`` (alias ``set_dict``, ``load_dict``).

Called with Paddle ``Tensor`` handles (``framework/tensor.py``), a
layer unwraps them and returns handles (``__call__``); its parameters
stay ``torch.nn.Parameter``s, which the optimizers, ZeRO and the
checkpoints rest on.

``create_parameter`` draws through ``nn.initializer`` with the layer's
``generator`` (a CPU torch.Generator; torch's default one when None) on
the layer's ``device`` (``cuda`` unless the layer was given another),
both keyword-only arguments of ``Layer.__init__``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from .. import initializer as I
from ...framework.dtype import convert_dtype, get_default_dtype
from ...framework.op import _has_handle, call_with_handles

__all__ = ["HookRemoveHelper", "Layer", "ParamAttr"]


class ParamAttr:
    """A parameter's name, initializer, learning rate, regularizer and
    trainability (Paddle's ``ParamAttr``)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"invalid ParamAttr {attr!r}")


class HookRemoveHelper:
    """``remove()`` takes the hook registered under ``idx`` out of
    ``hooks``."""

    def __init__(self, hooks, idx):
        self._hooks, self._idx = hooks, idx

    def remove(self):
        self._hooks.pop(self._idx, None)


def _named_sublayers(module, prefix, include_self, layers_set):
    """Paddle's pre-order walk over ``_modules``; any torch module may
    sit in the tree."""
    if include_self and id(module) not in layers_set:
        layers_set.add(id(module))
        yield prefix, module
    for name, sub in module._modules.items():
        if sub is None or id(sub) in layers_set:
            continue
        layers_set.add(id(sub))
        sub_prefix = f"{prefix}.{name}" if prefix else name
        yield sub_prefix, sub
        yield from _named_sublayers(sub, sub_prefix, False, layers_set)


def _as_tensor(value):
    """A torch tensor of a state-dict value: a torch tensor, a numpy
    array, or anything with ``.numpy()`` (a JAX package Tensor)."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    if hasattr(value, "numpy"):
        value = value.numpy()
    return torch.from_numpy(np.array(value))


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32", *, device=None,
                 generator=None):
        super().__init__()
        self._full_name = name_scope or type(self).__name__.lower()
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        self._device = device
        self._generator = generator

    def __call__(self, *args, **kwargs):
        if _has_handle(args) or _has_handle(kwargs):
            return call_with_handles(super().__call__, args, kwargs)
        return super().__call__(*args, **kwargs)

    # -- construction helpers ---------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A ``torch.nn.Parameter`` of ``shape`` drawn by ``attr``'s
        initializer, else ``default_initializer``, else zeros for a bias
        and Xavier-normal for a weight; None for ``attr=False``. The
        caller assigns it (Paddle registers nothing here either). The
        attribute's name is kept as ``param_name`` (torch owns a
        tensor's ``name``), with ``optimize_attr``, ``regularizer`` and
        ``need_clip`` as Paddle keeps them."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = self._dtype if dtype is None else convert_dtype(dtype)
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierNormal())
        data = init([int(s) for s in shape], dtype,
                    generator=self._generator,
                    device=resolve_device(self._device))
        p = torch.nn.Parameter(data, requires_grad=bool(attr.trainable))
        p.param_name = attr.name
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        if not isinstance(sublayer, torch.nn.Module):
            raise TypeError("add_sublayer expects a Layer")
        self.add_module(str(name), sublayer)
        return sublayer

    # -- traversal ---------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """(name, layer) of every sublayer, pre-order, each once."""
        return _named_sublayers(self, prefix, include_self,
                                set() if layers_set is None else layers_set)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(
            include_self=include_self)]

    def full_name(self):
        return self._full_name

    # -- state dict ---------------------------------------------------------
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (torch tensors, numpy arrays or
        anything with ``.numpy()``) into this layer's parameters and
        persistent buffers by name, each cast to its target's dtype;
        returns ``(missing, unexpected)`` key lists and raises on a
        shape mismatch."""
        missing, unexpected = [], list(state_dict.keys())
        with torch.no_grad():
            for name, target in self.state_dict(keep_vars=True).items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                value = _as_tensor(state_dict[name])
                if list(value.shape) != list(target.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: got "
                        f"{list(value.shape)}, expected "
                        f"{list(target.shape)}")
                target.copy_(value.to(target.device, target.dtype))
                unexpected.remove(name)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype, gradients, hooks ----------------------------------------------
    def astype(self, dtype):
        """Cast every floating parameter and buffer to ``dtype`` (a
        Paddle name or a torch dtype), in place as ``to(dtype)`` does."""
        dtype = convert_dtype(dtype)
        self.to(dtype=dtype)
        for l in self.sublayers(include_self=True):
            if isinstance(l, Layer):
                l._dtype = dtype
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after every forward; a value
        it returns replaces the outputs."""
        handle = self.register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, handle.id)
