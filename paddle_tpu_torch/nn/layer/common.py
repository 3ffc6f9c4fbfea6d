"""Common layers (counterpart of paddle_tpu/nn/layer/common.py)."""
from __future__ import annotations

import math

import torch

from ...device import resolve_device


class Linear(torch.nn.Module):
    """y = x W + b with Paddle's weight layout [in_features,
    out_features]; Xavier-normal weight, zero bias (Paddle's defaults),
    drawn from ``generator`` when given. On ``cuda`` unless ``device``
    names another device."""

    def __init__(self, in_features, out_features, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = torch.nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = torch.nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(
                0.0, math.sqrt(2.0 / (in_features + out_features)),
                generator=generator)

    def forward(self, x):
        return torch.nn.functional.linear(x, self.weight.t(), self.bias)
