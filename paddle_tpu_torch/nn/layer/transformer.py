"""Transformer encoder layers (counterpart of
paddle_tpu/nn/layer/transformer.py): ``MultiHeadAttention`` (without the
``Cache``/``StaticCache`` decode path), ``TransformerEncoderLayer`` and
``TransformerEncoder``. Attention goes through
``F.scaled_dot_product_attention``; with ``FLAGS_tpu_fused_encoder`` the
(post-norm) layer sends dropout + residual + LayerNorm through the fused
kernels (``F.fused_ln_residual_dropout``).

Every layer takes ``device`` (``cuda`` unless named) and ``generator``,
a CPU torch.Generator that draws the initial weights and every dropout
seed."""
from __future__ import annotations

import copy

import torch

from ...flags import get_flag
from ...framework.unported import require_defaults
from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm


def _convert_attn_mask(mask, dtype):
    """bool mask (True keeps) -> additive float mask (0 / -1e4)."""
    if mask is None or mask.dtype != torch.bool:
        return mask
    return (mask.to(dtype) - 1.0) * 1e4


class MultiHeadAttention(torch.nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, *, device=None,
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be a multiple of num_heads")
        self.generator = generator
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))       # [B, L, H, D]
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attn_mask(attn_mask, q.dtype),
            dropout_p=self.dropout if self.training else 0.0,
            is_causal=False, training=self.training,
            generator=self.generator)
        out = out.reshape(out.shape[0], out.shape[1], self.embed_dim)
        return self.out_proj(out)


class TransformerEncoderLayer(torch.nn.Module):
    """Post-norm encoder layer (Paddle's ``normalize_before=False``, the
    only form the port has)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, generator=None):
        require_defaults("nn.TransformerEncoderLayer",
                         normalize_before=(normalize_before, False),
                         weight_attr=(weight_attr, None),
                         bias_attr=(bias_attr, None))
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.generator = generator
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def _add_norm(self, src, residual, norm, drop):
        if get_flag("FLAGS_tpu_fused_encoder"):
            # dropout + residual + LayerNorm through the fused kernels
            return F.fused_ln_residual_dropout(
                src, residual, norm.weight, norm.bias, norm._epsilon,
                drop.p, self.training, generator=self.generator)
        return norm(residual + drop(src))

    def forward(self, src, src_mask=None):
        src = self._add_norm(self.self_attn(src, src, src, src_mask), src,
                             self.norm1, self.dropout1)
        ffn = self.linear2(self.dropout(self.activation(self.linear1(src))))
        return self._add_norm(ffn, src, self.norm2, self.dropout2)


class TransformerEncoder(torch.nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (Paddle deep-copies it,
    so every layer starts from the same weights); the copies share its
    dropout generator."""

    def __init__(self, encoder_layer, num_layers):
        super().__init__()
        g = encoder_layer.generator
        memo = {} if g is None else {id(g): g}
        self.layers = torch.nn.ModuleList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer,
                                                        dict(memo))
             for i in range(num_layers)])
        self.num_layers = num_layers

    def forward(self, src, src_mask=None):
        for mod in self.layers:
            src = mod(src, src_mask)
        return src
