"""Weight initializers (counterpart of paddle_tpu/nn/initializer/
__init__.py:27-214).

An initializer is a callable ``init(shape, dtype=None, *,
generator=None, device=None) -> torch.Tensor``; ``Layer.
create_parameter`` calls it with the layer's generator and device. The
draw runs on the generator's device (a CPU ``torch.Generator``; torch's
default one when None) and the result moves to ``device`` (``cuda``
unless named), so the same generator state gives the same weights on
every device. Fans are computed from the shape as the reference does
(Paddle's ``[in, out]`` linear layout; ``[out, in, *k]`` kernels).
``Orthogonal`` and ``Dirac`` are not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...device import resolve_device

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "calculate_gain", "set_global_initializer",
]

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Record the global weight and bias initializers (the reference
    records them and reads them nowhere; so does the port)."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def convert_dtype(dtype):
    """A torch dtype from a Paddle dtype name or a torch dtype (None:
    float32, the default dtype)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def _compute_fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _fans(shape, fan_in, fan_out=None):
    """(fan_in, fan_out) of ``shape``, each overridden where given."""
    fi, fo = _compute_fans(shape)
    return (fi if fan_in is None else fan_in,
            fo if fan_out is None else fan_out)


class Initializer:
    def __call__(self, shape, dtype=None, *, generator=None, device=None):
        g = torch.default_generator if generator is None else generator
        out = self._draw(tuple(int(s) for s in shape), convert_dtype(dtype),
                         g)
        return out.to(resolve_device(device))

    def _draw(self, shape, dtype, generator):
        """The values, on ``generator``'s device."""
        raise NotImplementedError


def _empty(shape, dtype, generator):
    return torch.empty(shape, dtype=dtype, device=generator.device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, dtype, generator):
        return torch.full(shape, self.value, dtype=dtype)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _draw(self, shape, dtype, generator):
        return _empty(shape, dtype, generator).normal_(
            self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """N(mean, std^2) cut to [a, b] (absolute bounds, as the
    reference's)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _draw(self, shape, dtype, generator):
        return torch.nn.init.trunc_normal_(
            _empty(shape, torch.float32, generator), self.mean, self.std,
            self.a, self.b, generator=generator).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _draw(self, shape, dtype, generator):
        return _empty(shape, dtype, generator).uniform_(
            self.low, self.high, generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, dtype, generator):
        fi, fo = _fans(shape, self.fan_in, self.fan_out)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _empty(shape, dtype, generator).normal_(0.0, std,
                                                       generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, dtype, generator):
        fi, fo = _fans(shape, self.fan_in, self.fan_out)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _empty(shape, dtype, generator).uniform_(
            -limit, limit, generator=generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, dtype, generator):
        fi, _ = _fans(shape, self.fan_in)
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return _empty(shape, dtype, generator).normal_(
            0.0, gain / math.sqrt(fi), generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, dtype, generator):
        fi, _ = _fans(shape, self.fan_in)
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _empty(shape, dtype, generator).uniform_(
            -limit, limit, generator=generator)


class Assign(Initializer):
    """The given values (a tensor, an array or a nested list), reshaped
    to ``shape``."""

    def __init__(self, value, name=None):
        self.value = value

    def _draw(self, shape, dtype, generator):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        elif hasattr(v, "numpy"):
            v = v.numpy()
        return torch.from_numpy(np.array(v)).to(dtype).reshape(shape)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d",
                        "conv_transpose1d", "conv_transpose2d",
                        "conv_transpose3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a * a))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError(f"unknown nonlinearity {nonlinearity}")
