"""Normalization layers (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch

from ...device import resolve_device
from ..functional.norm import layer_norm


class LayerNorm(torch.nn.Module):
    """LayerNorm with fp32 statistics; on ``cuda`` unless ``device``
    names another device."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self._shape = (normalized_shape,) if isinstance(
            normalized_shape, int) else tuple(normalized_shape)
        self._epsilon = float(epsilon)
        self.weight = torch.nn.Parameter(
            torch.ones(self._shape, device=device, dtype=dtype))
        self.bias = torch.nn.Parameter(
            torch.zeros(self._shape, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self._shape, self.weight, self.bias,
                          self._epsilon)
