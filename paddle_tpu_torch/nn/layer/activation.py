"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py)."""
from __future__ import annotations

import torch

from ..functional.activation import gelu, tanh


class GELU(torch.nn.Module):
    def __init__(self, approximate=False):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return gelu(x, self._approximate)


class Tanh(torch.nn.Module):
    def forward(self, x):
        return tanh(x)
