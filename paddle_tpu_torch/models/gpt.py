"""The GPT-2/3 family (the port's own copy of ``paddle_tpu/models/
gpt.py``: config #4 is the 13B-class model trained with recompute and
AMP O2). The same configuration, modules, parameter names and
``[in, out]`` Linear layouts, as ``nn.Layer``s.

Every model takes ``device`` (``cuda`` unless named) and ``generator``,
a CPU torch.Generator that draws the initial weights and every dropout
seed (``torch.Generator().manual_seed(0)`` when None). Under
``fleet.init`` with ``mp_degree`` > 1 (``_mp_active``) a block's ``qkv``
and ``fc_in`` are ``ColumnParallelLinear`` without gathering, ``proj``
and ``fc_out`` ``RowParallelLinear`` on the parallel input, and ``wte``
a ``VocabParallelEmbedding``, as in the reference; the fused qkv output
is the reference's global value, split into q, k and v as without mp.
The head is tied: ``logits = matmul(h, wte.weight, transpose_y=True)``,
a plain product with the full table under mp too. With
``config.recompute`` each block is recomputed in the backward
(``framework/recompute.py``, whose replay redraws the same dropout
masks).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..device import model_kw
from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                               RowParallelLinear,
                                               VocabParallelEmbedding)
from ..distributed.fleet.topology import get_hybrid_communicate_group
from ..framework.op import add, concat, matmul
from ..framework.recompute import recompute
from ..nn import functional as F


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    recompute: bool = False

    @staticmethod
    def gpt3_13b():
        return GPTConfig(hidden_size=5120, num_hidden_layers=40,
                         num_attention_heads=40, intermediate_size=20480,
                         max_position_embeddings=2048)

    @staticmethod
    def tiny(vocab=512, hidden=64, layers=2, heads=4, inter=128, seq=64):
        return GPTConfig(vocab_size=vocab, hidden_size=hidden,
                         num_hidden_layers=layers, num_attention_heads=heads,
                         intermediate_size=inter,
                         max_position_embeddings=seq)


def _mp_active():
    hcg = get_hybrid_communicate_group()
    return hcg is not None and hcg.get_model_parallel_world_size() > 1


class GPTBlock(nn.Layer):
    def __init__(self, config: GPTConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        H = config.hidden_size
        self.generator = kw["generator"]
        self.ln_1 = nn.LayerNorm(H, config.layer_norm_eps,
                                 device=kw["device"])
        self.ln_2 = nn.LayerNorm(H, config.layer_norm_eps,
                                 device=kw["device"])
        if _mp_active():
            self.qkv = ColumnParallelLinear(H, 3 * H, gather_output=False,
                                            **kw)
            self.proj = RowParallelLinear(H, H, input_is_parallel=True, **kw)
            self.fc_in = ColumnParallelLinear(H, config.intermediate_size,
                                              gather_output=False, **kw)
            self.fc_out = RowParallelLinear(config.intermediate_size, H,
                                            input_is_parallel=True, **kw)
        else:
            self.qkv = nn.Linear(H, 3 * H, **kw)
            self.proj = nn.Linear(H, H, **kw)
            self.fc_in = nn.Linear(H, config.intermediate_size, **kw)
            self.fc_out = nn.Linear(config.intermediate_size, H, **kw)
        self.n_head = config.num_attention_heads
        self.head_dim = H // config.num_attention_heads
        self.attn_drop = nn.Dropout(config.attention_probs_dropout_prob,
                                    generator=self.generator)
        self.resid_drop = nn.Dropout(config.hidden_dropout_prob,
                                     generator=self.generator)

    def forward(self, x, cache=None):
        b, l = x.shape[0], x.shape[1]
        h = self.ln_1(x)
        q, k, v = (t.reshape(b, l, self.n_head, self.head_dim)
                   for t in self.qkv(h).chunk(3, dim=-1))
        new_cache = None
        if cache is not None:
            k = concat([cache[0], k], axis=1)
            v = concat([cache[1], v], axis=1)
            new_cache = (k, v)
        attn = F.scaled_dot_product_attention(
            q, k, v, is_causal=l > 1,
            dropout_p=self.attn_drop.p if self.training else 0.0,
            generator=self.generator)
        attn = attn.reshape(b, l, self.n_head * self.head_dim)
        x = add(x, self.resid_drop(self.proj(attn)))
        h = self.ln_2(x)
        h = self.fc_out(F.gelu(self.fc_in(h), approximate=True))
        x = add(x, self.resid_drop(h))
        if cache is not None:
            return x, new_cache
        return x


class GPTModel(nn.Layer):
    def __init__(self, config: GPTConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.config = config
        if _mp_active():
            self.wte = VocabParallelEmbedding(config.vocab_size,
                                              config.hidden_size, **kw)
        else:
            self.wte = nn.Embedding(config.vocab_size, config.hidden_size,
                                    **kw)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size, **kw)
        self.drop = nn.Dropout(config.hidden_dropout_prob,
                               generator=kw["generator"])
        self.h = nn.LayerList([GPTBlock(config, **kw)
                               for _ in range(config.num_hidden_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size, config.layer_norm_eps,
                                 device=kw["device"])

    def forward(self, input_ids, caches=None, pos_offset=0):
        l = input_ids.shape[1]
        pos = torch.arange(pos_offset, pos_offset + l,
                           device=input_ids.device)[None]
        x = self.drop(add(self.wte(input_ids), self.wpe(pos)))
        new_caches = [] if caches is not None else None
        for i, block in enumerate(self.h):
            if caches is not None:
                x, c = block(x, caches[i])
                new_caches.append(c)
            elif self.config.recompute and self.training:
                x = recompute(block, x)
            else:
                x = block(x)
        x = self.ln_f(x)
        if caches is not None:
            return x, new_caches
        return x


class GPTForCausalLM(nn.Layer):
    def __init__(self, config: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config, **model_kw(device, generator))

    def forward(self, input_ids, labels=None):
        h = self.gpt(input_ids)
        logits = matmul(h, self.gpt.wte.weight, transpose_y=True)
        if labels is not None:
            loss = F.cross_entropy(
                logits[:, :-1].reshape(-1, self.config.vocab_size),
                labels[:, 1:].reshape(-1))
            return loss, logits
        return logits
