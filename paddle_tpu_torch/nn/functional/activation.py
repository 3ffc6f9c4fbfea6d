"""Activation functionals (counterpart of
paddle_tpu/nn/functional/activation.py); each goes through the
op-boundary hook under the reference's op name."""
from __future__ import annotations

import torch

from ...framework.dtype import convert_dtype
from ...framework.op import op_inputs


def gelu(x, approximate: bool = False, name=None):
    """GELU; the exact erf form unless ``approximate`` (tanh form)."""
    x, = op_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    x, = op_inputs("relu", x)
    return torch.relu(x)


def tanh(x, name=None):
    x, = op_inputs("tanh", x)
    return torch.tanh(x)


def silu(x, name=None):
    x, = op_inputs("silu", x)
    return torch.nn.functional.silu(x)


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis`` (in ``dtype`` when given: "float32",
    "bfloat16", "float16" or a torch dtype)."""
    x, = op_inputs("softmax", x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=axis)
