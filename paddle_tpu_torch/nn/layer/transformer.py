"""Transformer layers (counterpart of paddle_tpu/nn/layer/transformer.py):
``MultiHeadAttention`` with its ``Cache``/``StaticCache`` decode path,
``TransformerEncoderLayer``/``TransformerEncoder`` (pre- or post-norm),
``TransformerDecoderLayer``/``TransformerDecoder`` and ``Transformer``.
Attention goes through ``F.scaled_dot_product_attention``; with
``FLAGS_tpu_fused_encoder`` the post-norm encoder layer sends dropout +
residual + LayerNorm through the fused kernels
(``F.fused_ln_residual_dropout``), the reference's post-norm-only branch
(``:129-132``). Residual sums and cache concatenations go through the
op-boundary hook as the reference's ``elementwise_add`` and ``concat``.

Every layer takes ``device`` (``cuda`` unless named) and ``generator``,
a CPU torch.Generator that draws the initial weights and every dropout
seed. ``weight_attr``/``bias_attr`` other than None are not ported."""
from __future__ import annotations

import collections
import copy

import torch

from ...flags import get_flag
from ...framework.op import add, concat
from ...framework.unported import require_defaults
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


def _convert_attn_mask(mask, dtype):
    """bool mask (True keeps) -> additive float mask (0 / -1e4)."""
    if mask is None or mask.dtype != torch.bool:
        return mask
    return (mask.to(dtype) - 1.0) * 1e4


def _clones(layer, num_layers):
    """``num_layers`` copies of ``layer`` (Paddle deep-copies it, so every
    layer starts from the same weights); the copies share its dropout
    generator."""
    g = getattr(layer, "generator", None)
    memo = {} if g is None else {id(g): g}
    return LayerList([layer if i == 0 else copy.deepcopy(layer, dict(memo))
                      for i in range(num_layers)])


class MultiHeadAttention(torch.nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        require_defaults("nn.MultiHeadAttention",
                         weight_attr=(weight_attr, None),
                         bias_attr=(bias_attr, None))
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be a multiple of num_heads")
        self.generator = generator
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key``/``value``'s projections (cross
        attention), or an empty incremental ``Cache`` [B, 0, H, D] in
        key's dtype."""
        if type == MultiHeadAttention.StaticCache or (
                value is not None and type is None):
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None
                                        else key))
            return MultiHeadAttention.StaticCache(k, v)
        z = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                        dtype=key.dtype, device=key.device)
        return MultiHeadAttention.Cache(z, z)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))       # [B, L, H, D]
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
            out_cache = cache
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                k = concat([cache.k, k], axis=1)
                v = concat([cache.v, v], axis=1)
                out_cache = MultiHeadAttention.Cache(k, v)
            else:
                out_cache = None
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attn_mask(attn_mask, q.dtype),
            dropout_p=self.dropout if self.training else 0.0,
            is_causal=False, training=self.training,
            generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)      # the reference returns no weights
        if cache is not None:
            outs.append(out_cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(torch.nn.Module):
    """Pre-norm (``normalize_before``) or post-norm encoder layer."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, generator=None):
        require_defaults("nn.TransformerEncoderLayer",
                         weight_attr=(weight_attr, None),
                         bias_attr=(bias_attr, None))
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
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

    def _fuse_post_ln(self):
        return (not self.normalize_before
                and bool(get_flag("FLAGS_tpu_fused_encoder")))

    def _add_norm(self, src, residual, norm, drop):
        if self._fuse_post_ln():
            # dropout + residual + LayerNorm through the fused kernels
            return F.fused_ln_residual_dropout(
                src, residual, norm.weight, norm.bias, norm._epsilon,
                drop.p, self.training, generator=self.generator)
        src = add(residual, drop(src))
        return src if self.normalize_before else norm(src)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = self._add_norm(src, residual, self.norm1, self.dropout1)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = self._add_norm(src, residual, self.norm2, self.dropout2)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


class TransformerEncoder(torch.nn.Module):
    """``num_layers`` copies of ``encoder_layer``, then ``norm`` when
    given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(torch.nn.Module):
    """Self attention, cross attention over ``memory``, FFN; pre- or
    post-norm. ``cache`` is ``(Cache, StaticCache)`` from ``gen_cache``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, generator=None):
        require_defaults("nn.TransformerDecoderLayer",
                         weight_attr=(weight_attr, None),
                         bias_attr=(bias_attr, None))
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.generator = generator
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def _pre(self, x, norm):
        return norm(x) if self.normalize_before else x

    def _post(self, x, residual, norm, drop):
        x = add(residual, drop(x))
        return x if self.normalize_before else norm(x)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        tgt = self._pre(tgt, self.norm1)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = self._post(tgt, residual, self.norm1, self.dropout1)
        residual = tgt
        tgt = self._pre(tgt, self.norm2)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = self._post(tgt, residual, self.norm2, self.dropout2)
        residual = tgt
        tgt = self._pre(tgt, self.norm3)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = self._post(tgt, residual, self.norm3, self.dropout3)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory,
                                               type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(torch.nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(torch.nn.Module):
    """Encoder-decoder (``paddle.nn.Transformer``); with
    ``normalize_before`` both stacks end in a LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            enc_norm = LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            dec_norm = LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] float32 additive causal mask (0 on and below
        the diagonal, -1e4 above), on the model's device."""
        dev = next(self.parameters()).device
        m = torch.ones(length, length, dtype=torch.float32,
                       device=dev).tril()
        return (m - 1.0) * 1e4
