"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

import torch


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
