"""Containers (counterpart of paddle_tpu/nn/layer/container.py)."""
from __future__ import annotations

import torch


class LayerList(torch.nn.ModuleList):
    """``paddle.nn.LayerList``: a ``torch.nn.ModuleList`` under Paddle's
    name and constructor."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
