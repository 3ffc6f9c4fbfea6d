"""Containers (counterpart of paddle_tpu/nn/layer/container.py)."""
from __future__ import annotations

import torch

from .layers import Layer


class LayerList(torch.nn.ModuleList, Layer):
    """``paddle.nn.LayerList``: a ``torch.nn.ModuleList`` and a
    ``Layer``, under Paddle's name and constructor."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
