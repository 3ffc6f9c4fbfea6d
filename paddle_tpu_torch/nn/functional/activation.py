"""Activation functionals (counterpart of
paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch


def gelu(x, approximate: bool = False):
    """GELU; the exact erf form unless ``approximate`` (tanh form)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)
