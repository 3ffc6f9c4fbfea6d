"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py), each through the op-boundary hook."""
from __future__ import annotations

import torch

from ...framework.op import op_inputs
from ...framework.random import draw_seed
from ...ops.hopper.fused_norm import (_dropout_via_vjp, fused_rms_norm,
                                      fused_layer_norm_residual_dropout)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm with float32 statistics whatever the input dtype (as
    paddle_tpu's ``layer_norm``); the result comes back in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = op_inputs("layer_norm", x, weight, bias)
    out = torch.nn.functional.layer_norm(
        x.float(), tuple(normalized_shape),
        None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon)
    return out.to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis (``paddle_tpu/nn/functional/norm.py:
    74-84``): float32 statistics, ``x * rsqrt(mean(x^2) + eps) * w``,
    the result in x's dtype. Goes through the RMSNorm kernel
    (``ops/hopper/fused_norm.py`` ``fused_rms_norm``; its plain version
    for a CPU tensor), which takes x and w of one dtype (float32 or
    bfloat16) and raises for any other: there is no fallback."""
    if weight is None:
        weight = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
        x, = op_inputs("rms_norm", x)
    else:
        x, weight = op_inputs("rms_norm", x, weight)
    return fused_rms_norm(x, weight, epsilon)


def fused_ln_residual_dropout(x, residual, weight, bias, epsilon=1e-5,
                              dropout_p=0.0, training=True, name=None, *,
                              generator=None):
    """y = layernorm(dropout(x) + residual) * weight + bias through the
    fused kernels (``ops/hopper/fused_norm.py``): the dropout kernel,
    seeded from ``generator`` when it drops anything, then the LayerNorm
    + residual kernel. Returns y only.

    Inputs of mixed dtypes (O1: a bf16 ``x`` from a white-list linear
    beside an fp32 residual and fp32 weights) compute what the JAX
    package's Pallas kernel computes there (``paddle_tpu/ops/pallas/
    fused_norm.py:62-74``): dropout in x's dtype, then the sum, the
    statistics and the affine in float32 over the exact float32 values
    of every input, y rounded to x's dtype. Here that is the same two
    kernels, the LayerNorm one launched in float32."""
    rate = float(dropout_p) if training else 0.0
    seed = draw_seed(generator) if rate > 0.0 else 0
    x, residual, weight, bias = op_inputs("fused_ln_residual_dropout", x,
                                          residual, weight, bias)
    if residual.dtype == weight.dtype == bias.dtype == x.dtype:
        y, _ = fused_layer_norm_residual_dropout(
            x, residual, weight, bias, eps=float(epsilon),
            dropout_rate=rate, seed=seed)
        return y
    if rate > 0.0:
        x = _dropout_via_vjp(x, rate, seed)
    y, _ = fused_layer_norm_residual_dropout(
        x.float(), residual.float(), weight.float(), bias.float(),
        eps=float(epsilon))
    return y.to(x.dtype)
