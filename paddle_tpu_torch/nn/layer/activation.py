"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py)."""
from __future__ import annotations

from ..functional.activation import gelu, tanh
from .layers import Layer


class GELU(Layer):
    def __init__(self, approximate=False):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return gelu(x, self._approximate)


class Tanh(Layer):
    def forward(self, x):
        return tanh(x)
