"""Common layers (counterpart of paddle_tpu/nn/layer/common.py)."""
from __future__ import annotations

import math

import torch

from ...device import resolve_device
from ...framework.op import op_inputs
from ...framework.unported import require_defaults
from ..functional.common import (alpha_dropout, dropout, dropout2d,
                                 dropout3d, embedding)
from .layers import Layer


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


class Linear(Layer):
    """y = x W + b with Paddle's weight layout [in_features,
    out_features]; Xavier-normal weight, zero bias (Paddle's defaults),
    drawn from ``generator`` when given (on any device). ``bias_attr=
    False`` makes no bias (``self.bias`` is None); other parameter
    attributes are not ported. On ``cuda`` unless ``device`` names
    another device."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        require_defaults("nn.Linear", weight_attr=(weight_attr, None),
                         bias_attr=(None if bias_attr is False
                                    else bias_attr, None))
        super().__init__()
        device = resolve_device(device)
        self.weight = torch.nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = torch.nn.Parameter(torch.zeros(
                out_features, device=device, dtype=dtype))
        _normal_(self.weight, math.sqrt(2.0 / (in_features + out_features)),
                 generator)

    def forward(self, x):
        x, w, b = op_inputs("linear", x, self.weight, self.bias)
        return torch.nn.functional.linear(x, w.t(), b)


class Dropout(Layer):
    """Paddle's Dropout; seeds come from ``generator`` (a CPU
    torch.Generator; torch's default one when None)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.p, self.axis, self.training, self.mode,
                       generator=self.generator)


class Dropout2D(Layer):
    """Whole-channel dropout of 4-D inputs; masks from ``generator``."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return dropout2d(x, self.p, self.training, self.data_format,
                         generator=self.generator)


class Dropout3D(Layer):
    """Whole-channel dropout of 5-D inputs; masks from ``generator``."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return dropout3d(x, self.p, self.training, self.data_format,
                         generator=self.generator)


class AlphaDropout(Layer):
    """SELU-preserving dropout; masks from ``generator``."""

    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return alpha_dropout(x, self.p, self.training,
                             generator=self.generator)


class Embedding(Layer):
    """Lookup table, weight [num_embeddings, embedding_dim] ~ N(0, 1)
    (Paddle's default); with ``padding_idx`` that row starts at zero and
    its ids look up zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        require_defaults("nn.Embedding", sparse=(sparse, False),
                         weight_attr=(weight_attr, None))
        super().__init__()
        device = resolve_device(device)
        self._padding_idx = padding_idx
        self.weight = torch.nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        _normal_(self.weight, 1.0, generator)
        if padding_idx is not None:
            if not -num_embeddings <= padding_idx < num_embeddings:
                raise ValueError(
                    f"padding_idx must be within [-{num_embeddings}, "
                    f"{num_embeddings}), got {padding_idx}")
            with torch.no_grad():
                self.weight[padding_idx].zero_()

    def forward(self, x):
        return embedding(x, self.weight, self._padding_idx)
