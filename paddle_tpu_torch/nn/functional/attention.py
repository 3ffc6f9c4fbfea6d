"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` takes Paddle's flash-attention layout
``[batch, seqlen, num_heads, head_dim]``. As the JAX package does on its
accelerator, unmasked attention on the card with head_dim a multiple of
64 goes to the hand-written flash-attention kernel
(``ops/hopper/flash_attention.py`` ``flash_attention_blhd``, which takes
head_dim 64 and 128 and raises for wider heads); masked attention, and
every call on the CPU, is einsum + fp32 softmax (the JAX package's
``_sdpa_jnp``).
"""
from __future__ import annotations

import math

import torch

from ...ops.hopper.flash_attention import flash_attention_blhd

NEG_INF = -1e30


def _sdpa(q, k, v, mask, causal, scale):
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, L, D]
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * s
    if causal:
        ql, kl = scores.shape[-2], scores.shape[-1]
        cm = torch.ones((ql, kl), dtype=torch.bool,
                        device=q.device).tril(kl - ql)
        scores = scores.masked_fill(
            ~cm, NEG_INF if scores.dtype == torch.float32 else -3e4)
    if mask is not None:
        scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vh).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal: bool = False, scale=None):
    """Masked attention; ``attn_mask`` is ADDITIVE (0 keeps, -1e30
    drops) and broadcasts against [B, H, Lq, Lk]."""
    hd = query.shape[-1]
    if query.is_cuda and attn_mask is None and hd >= 64 and hd % 64 == 0:
        return flash_attention_blhd(query, key, value, causal=is_causal,
                                    sm_scale=scale)
    return _sdpa(query, key, value, attn_mask, is_causal, scale)
