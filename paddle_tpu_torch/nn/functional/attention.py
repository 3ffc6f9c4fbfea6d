"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` takes Paddle's flash-attention layout
``[batch, seqlen, num_heads, head_dim]`` and the JAX package's signature
and routing. On the card, with head_dim a multiple of 64 and no mask,
the hand-written flash-attention kernel (``ops/hopper/flash_attention.py``
``flash_attention_blhd``, head_dim 64 and 128) runs: without dropout
always, with dropout when both lengths are at least 1024 (its
position-hash dropout; below that the dense path is faster, as the JAX
package measured). Everything else — masked attention, short sequences
with dropout, every call on the CPU — is the dense einsum + fp32 softmax
(``_sdpa``, the JAX package's ``_sdpa_jnp``) with Bernoulli dropout of
the probabilities.
"""
from __future__ import annotations

import math

import torch

from ...framework.op import op_inputs
from ...framework.random import bernoulli_keep, draw_seed
from ...framework.unported import require_defaults
from ...ops.hopper.flash_attention import flash_attention_blhd

NEG_INF = -1e30
FLASH_DROPOUT_MIN_LEN = 1024


def _sdpa(q, k, v, mask, causal, scale, dropout_p=0.0, generator=None):
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
    if dropout_p >= 1.0:
        probs = torch.zeros_like(probs)
    elif dropout_p > 0.0:
        keep = bernoulli_keep(probs.shape, 1.0 - dropout_p, probs.device,
                              generator)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            0.0).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vh).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, *, scale=None,
                                 generator=None):
    """paddle.nn.functional.scaled_dot_product_attention. ``attn_mask`` is
    ADDITIVE (0 keeps, -1e30 drops) and broadcasts against [B, H, Lq, Lk];
    ``dropout_p`` applies while ``training``, with seeds drawn from
    ``generator`` (a CPU torch.Generator). Goes through the op-boundary
    hook as ``flash_attention`` (the JAX package's op name for every
    path here)."""
    rate = float(dropout_p) if training else 0.0
    query, key, value, attn_mask = op_inputs(
        "flash_attention", query, key, value, attn_mask)
    hd = query.shape[-1]
    if query.is_cuda and attn_mask is None and hd >= 64 and hd % 64 == 0:
        if rate == 0.0:
            return flash_attention_blhd(query, key, value, causal=is_causal,
                                        sm_scale=scale)
        if min(query.shape[1], key.shape[1]) >= FLASH_DROPOUT_MIN_LEN:
            return flash_attention_blhd(
                query, key, value, causal=is_causal, sm_scale=scale,
                dropout_rate=rate, seed=draw_seed(generator))
    return _sdpa(query, key, value, attn_mask, is_causal, scale, rate,
                 generator)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, *,
                    generator=None):
    """Paddle's ``nn.functional.flash_attention`` (``paddle_tpu/nn/
    functional/attention.py:129-136``): ``scaled_dot_product_attention``
    without a mask, returning ``(out, None)``; the softmax is not
    returned."""
    require_defaults("nn.functional.flash_attention",
                     return_softmax=(return_softmax, False),
                     fixed_seed_offset=(fixed_seed_offset, None))
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training,
                                       generator=generator)
    return out, None
