"""Common functionals: linear, the dropouts, embedding (counterpart of
paddle_tpu/nn/functional/common.py). Each goes through the op-boundary
hook (``framework/op.py``) under the reference's op name."""
from __future__ import annotations

import torch

from ...flags import get_flag
from ...framework.op import op_inputs
from ...framework.random import bernoulli_keep, draw_seed
from ...framework.unported import require_defaults
from ...ops.hopper.fused_norm import _dropout_via_vjp


def linear(x, weight, bias=None, name=None):
    """y = x @ W (+ b); Paddle's weight layout [in, out]."""
    x, weight, bias = op_inputs("linear", x, weight, bias)
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
            x, = op_inputs("dropout", x)
            return x * (1.0 - p)
        return x
    p = float(p)
    x, = op_inputs("dropout", x)
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


def _channel_dropout(op_name, x, p, training, shape, generator):
    """Whole-channel inverted dropout: a keep mask of ``shape``
    (broadcast over the spatial axes), kept entries scaled by 1/(1 - p).
    The mask comes from ``generator``; the reference draws its own bits."""
    if not training or p == 0.0:
        return x
    x, = op_inputs(op_name, x)
    keep = bernoulli_keep(shape, 1.0 - p, x.device, generator)
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator=None):
    """Drops whole channels of a 4-D input (``NCHW`` or ``NHWC``)."""
    shape = (x.shape[0], x.shape[1], 1, 1) if data_format == "NCHW" \
        else (x.shape[0], 1, 1, x.shape[3])
    return _channel_dropout("dropout2d", x, p, training, shape, generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator=None):
    """Drops whole channels of a 5-D input (``NCDHW`` or ``NDHWC``)."""
    shape = (x.shape[0], x.shape[1], 1, 1, 1) if data_format == "NCDHW" \
        else (x.shape[0], 1, 1, 1, x.shape[4])
    return _channel_dropout("dropout3d", x, p, training, shape, generator)


def alpha_dropout(x, p=0.5, training=True, name=None, *, generator=None):
    """SELU-preserving dropout: dropped entries become ``alpha_p =
    -alpha * scale``, then ``coef_a * x + coef_b`` keeps the mean and
    variance (the reference's coefficients)."""
    if not training or p == 0.0:
        return x
    x, = op_inputs("alpha_dropout", x)
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = bernoulli_keep(x.shape, 1.0 - p, x.device, generator)
    coef_a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    coef_b = -coef_a * p * alpha_p
    return (coef_a * torch.where(keep, x, alpha_p) + coef_b).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` [num_embeddings, dim] at the ids ``x``. Ids
    equal to ``padding_idx`` (negative counts from the end) give zero
    output rows, hence no gradient into that row. ``sparse`` gradients
    are not ported."""
    require_defaults("nn.functional.embedding", sparse=(sparse, False))
    if padding_idx is not None:
        n_rows = weight.shape[0]
        if not -n_rows <= padding_idx < n_rows:
            raise ValueError(
                f"padding_idx must be within [-{n_rows}, {n_rows}), got "
                f"{padding_idx}")
    x, weight = op_inputs("embedding", x, weight)
    out = weight[x]
    if padding_idx is None:
        return out
    pi = padding_idx if padding_idx >= 0 else weight.shape[0] + padding_idx
    return torch.where((x == pi)[..., None], torch.zeros((), dtype=out.dtype,
                                                         device=out.device),
                       out)
