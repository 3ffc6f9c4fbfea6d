"""Normalization layers (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch

from ...device import resolve_device
from ...framework.unported import require_defaults
from ..functional.norm import layer_norm, rms_norm
from .layers import Layer


class LayerNorm(Layer):
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


class RMSNorm(Layer):
    """Weight-only RMS normalization over the last axis (the Llama
    family's norm); ``F.rms_norm``, hence the RMSNorm kernel on the
    card."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        require_defaults("nn.RMSNorm", weight_attr=(weight_attr, None))
        super().__init__()
        self._epsilon = float(epsilon)
        self.weight = torch.nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)
