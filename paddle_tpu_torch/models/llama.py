"""The Llama family (the port's own copy of ``paddle_tpu/models/
llama.py:74-293``): RMSNorm, rotary position embeddings, grouped-query
attention with a ``(k, v)`` cache, a SwiGLU MLP, ``LlamaForCausalLM``
with greedy and sampled ``generate``. The same configuration, modules,
parameter names and ``[in, out]`` Linear layouts, as
``nn.Layer``s.

Every model takes ``device`` (``cuda`` unless named) and ``generator``,
a CPU torch.Generator that draws the initial weights
(``torch.Generator().manual_seed(0)`` when None) and the samples of a
sampled ``generate``. The rotary tables are buffers outside the state
dict (``persistable=False`` in the reference). Under ``fleet.init`` with
``mp_degree`` > 1 (``_mp_active``) the projections are the mpu layers,
as in the reference: q/k/v/gate/up ``ColumnParallelLinear`` without
gathering, o/down ``RowParallelLinear`` on the parallel input, a
``VocabParallelEmbedding`` and a gathering ``lm_head``; the activations
between them stay the reference's global values, so attention runs once
over all heads. ``num_key_value_heads`` must divide by the mp degree
(GQA shards the kv heads). The residual sums and the rotary products go
through the op-boundary hook (``framework/op.py``) as the reference's
elementwise ops, so under O2 they meet in bf16 as there.
``tie_word_embeddings`` ties ``lm_head``'s [in, out] weight to the
[vocab, hidden] embedding table as the reference does, which fits only
where vocab == hidden; under mp the head is not tied.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import nn
from ..device import model_kw, resolve_device
from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                               RowParallelLinear,
                                               VocabParallelEmbedding)
from ..distributed.fleet.topology import get_hybrid_communicate_group
from ..framework.op import add, concat, multiply
from ..framework.recompute import recompute
from ..nn import functional as F


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    recompute: bool = False
    dtype: str = "float32"

    @staticmethod
    def llama2_7b():
        return LlamaConfig()

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, inter=128,
             seq=128):
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           num_hidden_layers=layers,
                           num_attention_heads=heads,
                           num_key_value_heads=kv_heads,
                           intermediate_size=inter,
                           max_position_embeddings=seq)


def _mp_active():
    hcg = get_hybrid_communicate_group()
    return hcg is not None and hcg.get_model_parallel_world_size() > 1


def _linear(in_f, out_f, col=True, gather=False, has_bias=False, **kw):
    if _mp_active():
        if col:
            return ColumnParallelLinear(in_f, out_f, has_bias=has_bias,
                                        gather_output=gather, **kw)
        return RowParallelLinear(in_f, out_f, has_bias=has_bias,
                                 input_is_parallel=True, **kw)
    return nn.Linear(in_f, out_f, bias_attr=None if has_bias else False,
                     **kw)


def rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q, k: [B, L, H, D]; cos, sin: [1, L, 1, D]."""
    q_out = add(multiply(q, cos), multiply(rotate_half(q), sin))
    k_out = add(multiply(k, cos), multiply(rotate_half(k), sin))
    return q_out, k_out


class LlamaRotaryEmbedding(nn.Layer):
    def __init__(self, dim, max_pos=4096, theta=10000.0, *, device=None):
        super().__init__()
        self.dim = dim
        self.theta = theta
        inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
        t = np.arange(max_pos, dtype=np.float32)
        emb = np.concatenate([np.outer(t, inv)] * 2, axis=-1)
        dev = resolve_device(device)
        for name, table in (("cos_cached", np.cos(emb)),
                            ("sin_cached", np.sin(emb))):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(table, np.float32)).to(dev),
                persistent=False)

    def forward(self, seq_len, offset=0):
        cos = self.cos_cached[offset:offset + seq_len]
        sin = self.sin_cached[offset:offset + seq_len]
        return cos[None, :, None, :], sin[None, :, None, :]


class LlamaAttention(nn.Layer):
    def __init__(self, config: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.config = config
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        kv_out = self.num_kv_heads * self.head_dim
        if _mp_active():
            mp = get_hybrid_communicate_group() \
                .get_model_parallel_world_size()
            if self.num_kv_heads % mp:
                raise ValueError(f"num_key_value_heads {self.num_kv_heads} "
                                 f"does not divide by mp degree {mp}")
        self.q_proj = _linear(self.hidden_size, self.hidden_size, **kw)
        self.k_proj = _linear(self.hidden_size, kv_out, **kw)
        self.v_proj = _linear(self.hidden_size, kv_out, **kw)
        self.o_proj = _linear(self.hidden_size, self.hidden_size, col=False,
                              **kw)
        self.rotary = LlamaRotaryEmbedding(
            self.head_dim, config.max_position_embeddings, config.rope_theta,
            device=kw["device"])

    def forward(self, x, attn_mask=None, cache=None):
        b, l = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(b, l, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, l, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, l, self.num_kv_heads, self.head_dim)
        offset = cache[0].shape[1] if cache is not None else 0
        cos, sin = self.rotary(l, offset)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        new_cache = None
        if cache is not None:
            k = concat([cache[0], k], axis=1)
            v = concat([cache[1], v], axis=1)
            new_cache = (k, v)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            is_causal=(attn_mask is None and l > 1))
        out = self.o_proj(out.reshape(b, l, self.num_heads * self.head_dim))
        if cache is not None:
            return out, new_cache
        return out


class LlamaMLP(nn.Layer):
    def __init__(self, config: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.gate_proj = _linear(config.hidden_size,
                                 config.intermediate_size, **kw)
        self.up_proj = _linear(config.hidden_size, config.intermediate_size,
                               **kw)
        self.down_proj = _linear(config.intermediate_size,
                                 config.hidden_size, col=False, **kw)

    def forward(self, x):
        return self.down_proj(multiply(F.silu(self.gate_proj(x)),
                                       self.up_proj(x)))


class LlamaDecoderLayer(nn.Layer):
    def __init__(self, config: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.self_attn = LlamaAttention(config, **kw)
        self.mlp = LlamaMLP(config, **kw)
        self.input_layernorm = nn.RMSNorm(config.hidden_size,
                                          config.rms_norm_eps,
                                          device=kw["device"])
        self.post_attention_layernorm = nn.RMSNorm(
            config.hidden_size, config.rms_norm_eps, device=kw["device"])

    def forward(self, x, attn_mask=None, cache=None):
        residual = x
        h = self.input_layernorm(x)
        if cache is not None:
            h, new_cache = self.self_attn(h, attn_mask, cache)
        else:
            h = self.self_attn(h, attn_mask)
            new_cache = None
        x = add(residual, h)
        residual = x
        h = self.post_attention_layernorm(x)
        x = add(residual, self.mlp(h))
        if cache is not None:
            return x, new_cache
        return x


class LlamaModel(nn.Layer):
    def __init__(self, config: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.config = config
        if _mp_active():
            self.embed_tokens = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, **kw)
        else:
            self.embed_tokens = nn.Embedding(config.vocab_size,
                                             config.hidden_size, **kw)
        self.layers = nn.LayerList(
            [LlamaDecoderLayer(config, **kw)
             for _ in range(config.num_hidden_layers)])
        self.norm = nn.RMSNorm(config.hidden_size, config.rms_norm_eps,
                               device=kw["device"])

    def forward(self, input_ids, attn_mask=None, caches=None):
        x = self.embed_tokens(input_ids)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x, c = layer(x, attn_mask, caches[i])
                new_caches.append(c)
            elif self.config.recompute and self.training:
                x = recompute(layer, x, attn_mask)
            else:
                x = layer(x, attn_mask)
        x = self.norm(x)
        if caches is not None:
            return x, new_caches
        return x


def _sample(probs, generator):
    """One id per row of ``probs`` [B, V] by inverse CDF, the uniforms
    drawn on the host by ``generator``."""
    u = torch.rand(probs.shape[0], 1, generator=generator,
                   dtype=torch.float64).to(probs.device)
    cdf = probs.double().cumsum(-1)
    idx = (cdf < u * cdf[:, -1:]).sum(-1, keepdim=True)
    return idx.clamp_max(probs.shape[-1] - 1)


class LlamaForCausalLM(nn.Layer):
    def __init__(self, config: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.config = config
        self.generator = kw["generator"]
        self.llama = LlamaModel(config, **kw)
        self.lm_head = _linear(config.hidden_size, config.vocab_size,
                               gather=True, **kw)
        if config.tie_word_embeddings and not _mp_active():
            self.lm_head.weight = self.llama.embed_tokens.weight

    def forward(self, input_ids, labels=None, attn_mask=None):
        h = self.llama(input_ids, attn_mask)
        logits = self.lm_head(h)
        if labels is not None:
            loss = F.cross_entropy(
                logits[:, :-1].reshape(-1, self.config.vocab_size),
                labels[:, 1:].reshape(-1))
            return loss, logits
        return logits

    @classmethod
    def from_config(cls, config, *, device=None, generator=None):
        return cls(config, device=device, generator=generator)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0, *,
                 generator=None):
        """Greedy (``temperature`` 0) or sampled decode with a per-layer
        KV cache: the prompt in one forward, then one token a forward.
        Samples draw from ``generator`` (the model's when None). The
        reference also runs the model on the last sampled token, whose
        output it discards; here that forward is skipped."""
        c = self.config
        hd = c.hidden_size // c.num_attention_heads
        z = torch.zeros(input_ids.shape[0], 0, c.num_key_value_heads, hd,
                        device=input_ids.device)
        caches = [(z, z) for _ in range(c.num_hidden_layers)]
        h, caches = self.llama(input_ids, None, caches)
        logits = self.lm_head(h[:, -1:])
        out = input_ids
        g = self.generator if generator is None else generator
        for i in range(max_new_tokens):
            if temperature > 0:
                nxt = _sample(F.softmax(logits[:, -1] / temperature,
                                        axis=-1), g)
            else:
                nxt = logits[:, -1].argmax(-1, keepdim=True)
            out = torch.cat([out, nxt.to(out.dtype)], dim=1)
            if i + 1 < max_new_tokens:
                h, caches = self.llama(nxt, None, caches)
                logits = self.lm_head(h)
        return out
