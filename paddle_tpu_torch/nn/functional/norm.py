"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

import torch

from ...framework.random import draw_seed
from ...ops.hopper.fused_norm import fused_layer_norm_residual_dropout


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm with float32 statistics whatever the input dtype (as
    paddle_tpu's ``layer_norm``); the result comes back in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    out = torch.nn.functional.layer_norm(
        x.float(), tuple(normalized_shape),
        None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon)
    return out.to(x.dtype)


def fused_ln_residual_dropout(x, residual, weight, bias, epsilon=1e-5,
                              dropout_p=0.0, training=True, name=None, *,
                              generator=None):
    """y = layernorm(dropout(x) + residual) * weight + bias through the
    fused kernels (``ops/hopper/fused_norm.py``): the dropout kernel,
    seeded from ``generator`` when it drops anything, then the LayerNorm
    + residual kernel. Returns y only."""
    rate = float(dropout_p) if training else 0.0
    seed = draw_seed(generator) if rate > 0.0 else 0
    y, _ = fused_layer_norm_residual_dropout(
        x, residual, weight, bias, eps=float(epsilon), dropout_rate=rate,
        seed=seed)
    return y
