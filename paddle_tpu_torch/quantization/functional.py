"""Quantization primitives (counterpart of
paddle_tpu/quantization/functional.py): symmetric int8 ``quantize`` /
``dequantize`` and the weight-only ``quantized_matmul`` behind the int8
serving path.

Each formula keeps the JAX package's written order, so the int8 bytes
are equal on the same float inputs: ``round(x / s * qmax)`` with
round-half-to-even (``torch.round``, like ``jnp.round``), clipped to
``[-qmax - 1, qmax]``.
"""
from __future__ import annotations

import torch

from ..ops.hopper.int8_matmul import w8a16_matmul

__all__ = ["quantize", "dequantize", "quantized_matmul"]

# the largest row count the w8a16 kernel serves (decode batches and
# prefill chunks); larger calls dequantize and run one library product,
# as the JAX package leaves them to XLA
KERNEL_MAX_ROWS = 256


def _per_axis(s, ndim, axis):
    if axis is None:
        return s
    shape = [1] * ndim
    shape[axis] = -1
    return s.reshape(shape)


def quantize(x, scale, bits=8, axis=None):
    """float -> int8 (symmetric): round(x / scale * qmax), clipped."""
    qmax = 2 ** (bits - 1) - 1
    s = _per_axis(torch.as_tensor(scale, device=x.device), x.dim(), axis)
    q = torch.round(x / s * qmax)
    return torch.clamp(q, -qmax - 1, qmax).to(torch.int8)


def dequantize(q, scale, bits=8, axis=None, dtype=torch.float32):
    qmax = 2 ** (bits - 1) - 1
    s = _per_axis(torch.as_tensor(scale, device=q.device), q.dim(), axis)
    return q.to(dtype) * (s / qmax)


def quantized_matmul(x, w_int8, w_scale, x_scale=None, bits=8,
                     out_dtype=torch.float32):
    """x [..., K] @ int8 weight [K, N] with per-output-channel scales
    ``w_scale`` [N] -> [..., N] of ``out_dtype``. Weight-only: a call of
    at most 256 rows runs the w8a16 kernel and scales its fp32 result by
    ``w_scale / qmax``; a larger one dequantizes the weight and runs one
    ``torch.matmul``."""
    if x_scale is not None:
        raise NotImplementedError(
            "the int8 x int8 product (x_scale=) comes in a later slice of "
            "the PyTorch port; the serving path is weight-only")
    qmax = 2 ** (bits - 1) - 1
    if x.dim() >= 2 and w_int8.dim() == 2:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if x2.shape[0] <= KERNEL_MAX_ROWS:
            acc = w8a16_matmul(x2, w_int8)
            out = acc * (w_scale.float() / qmax)
            return out.to(out_dtype).reshape(*lead, w_int8.shape[1])
    # dequantize in f32 (scale precision), matmul in out_dtype
    wf = (w_int8.float() * (w_scale / qmax)).to(out_dtype)
    return torch.matmul(x.to(out_dtype), wf)
