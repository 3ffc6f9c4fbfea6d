"""Common functionals: linear, dropout, embedding (counterpart of
paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch

from ...flags import get_flag
from ...framework.random import bernoulli_keep, draw_seed
from ...ops.hopper.fused_norm import _dropout_via_vjp


def linear(x, weight, bias=None):
    """y = x @ W (+ b); Paddle's weight layout [in, out]."""
    y = x @ weight
    return y if bias is None else y + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Paddle's dropout. With ``upscale_in_train``, ``axis=None``,
    ``0 < p < 1`` and ``FLAGS_tpu_fused_dropout`` on, the fused dropout
    kernel (its plain version for a CPU tensor) with a seed drawn from
    ``generator``; every other case the plain Bernoulli form (a mask
    broadcast over the axes not in ``axis``; ``downscale_in_infer``
    keeps x in training and scales by 1 - p in inference)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    p = float(p)
    if (axis is None and mode == "upscale_in_train" and 0.0 < p < 1.0
            and get_flag("FLAGS_tpu_fused_dropout", True)):
        return _dropout_via_vjp(x, p, draw_seed(generator))
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        keep_axes = {ax % x.ndim for ax in axes}
        shape = [s if i in keep_axes else 1 for i, s in enumerate(x.shape)]
    keep = bernoulli_keep(shape, 1.0 - p, x.device, generator)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def embedding(x, weight):
    """Rows of ``weight`` [num_embeddings, dim] at the ids ``x``."""
    return weight[x]
