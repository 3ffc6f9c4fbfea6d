"""Common layers (counterpart of paddle_tpu/nn/layer/common.py)."""
from __future__ import annotations

import math

import torch

from ...device import resolve_device
from ..functional.common import dropout, embedding


def _normal_(t, std, generator):
    """t ~ N(0, std^2) drawn by ``generator``, which may live on another
    device than t (a CPU generator for CUDA weights)."""
    with torch.no_grad():
        if generator is None or generator.device.type == t.device.type:
            t.normal_(0.0, std, generator=generator)
        else:
            t.copy_(torch.empty(t.shape, dtype=t.dtype,
                                device=generator.device).normal_(
                0.0, std, generator=generator))


class Linear(torch.nn.Module):
    """y = x W + b with Paddle's weight layout [in_features,
    out_features]; Xavier-normal weight, zero bias (Paddle's defaults),
    drawn from ``generator`` when given (on any device). On ``cuda``
    unless ``device`` names another device."""

    def __init__(self, in_features, out_features, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = torch.nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = torch.nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype))
        _normal_(self.weight, math.sqrt(2.0 / (in_features + out_features)),
                 generator)

    def forward(self, x):
        return torch.nn.functional.linear(x, self.weight.t(), self.bias)


class Dropout(torch.nn.Module):
    """Paddle's Dropout; seeds come from ``generator`` (a CPU
    torch.Generator; torch's default one when None)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", *,
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.p, self.axis, self.training, self.mode,
                       generator=self.generator)


class Embedding(torch.nn.Module):
    """Lookup table, weight [num_embeddings, embedding_dim] ~ N(0, 1)
    (Paddle's default)."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = torch.nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        _normal_(self.weight, 1.0, generator)

    def forward(self, x):
        return embedding(x, self.weight)
