"""BERT (the port's own copy of ``paddle_tpu/models/bert.py``): the same
configuration, modules, parameter names and ``[in, out]`` Linear
layouts, as ``nn.Layer``s.

Every model takes ``device`` (``cuda`` unless named) and ``generator``, a
CPU torch.Generator that draws the initial weights and every dropout
seed (``torch.Generator().manual_seed(0)`` when None). Pretraining, as
the JAX package's dygraph step:

    model = BertForPretraining(BertConfig.base(), generator=g)
    opt = AdamW(1e-4, parameters=model.parameters())
    loss, _ = model(ids, masked_lm_labels=mlm, next_sentence_label=nsp)
    loss.backward(); opt.step(); opt.clear_grad()

Mixed precision as the JAX package's AMP-O2 leg: ``amp.decorate(model,
level="O2", dtype="bfloat16")``, ``AdamW(..., multi_precision=True)``
and the forward under ``amp.auto_cast(level="O2")``; the functionals
cast at the op-boundary hook (``framework/op.py``), so the loss is bf16
as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..device import model_kw
from ..framework.op import add, matmul
from ..nn import functional as F


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny(vocab=1000, hidden=64, layers=2, heads=4, inter=128, seq=64):
        return BertConfig(vocab_size=vocab, hidden_size=hidden,
                          num_hidden_layers=layers, num_attention_heads=heads,
                          intermediate_size=inter,
                          max_position_embeddings=seq)


class BertEmbeddings(nn.Layer):
    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h,
                                                  **kw)
        self.layer_norm = nn.LayerNorm(h, config.layer_norm_eps,
                                       device=kw["device"])
        self.dropout = nn.Dropout(config.hidden_dropout_prob,
                                  generator=kw["generator"])

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = add(self.word_embeddings(input_ids),
                  self.position_embeddings(pos[None]))
        if token_type_ids is not None:
            emb = add(emb, self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Layer):
    def __init__(self, config, *, device=None, generator=None):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               **model_kw(device, generator))
        self.activation = nn.Tanh()

    def forward(self, hidden):
        return self.activation(self.dense(hidden[:, 0]))


class BertModel(nn.Layer):
    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        enc_layer = nn.TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size,
            dropout=config.hidden_dropout_prob, activation="gelu",
            attn_dropout=config.attention_probs_dropout_prob,
            layer_norm_eps=config.layer_norm_eps, **kw)
        self.encoder = nn.TransformerEncoder(enc_layer,
                                             config.num_hidden_layers)
        self.pooler = BertPooler(config, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # [B, L] 1/0 -> additive [B, 1, 1, L]
            m = attention_mask.to(torch.float32)[:, None, None, :]
            attention_mask = (m - 1.0) * 1e4
        x = self.encoder(x, attention_mask)
        return x, self.pooler(x)


class BertForSequenceClassification(nn.Layer):
    def __init__(self, config: BertConfig, num_classes=2, *, device=None,
                 generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.bert = BertModel(config, **kw)
        self.dropout = nn.Dropout(config.hidden_dropout_prob,
                                  generator=kw["generator"])
        self.classifier = nn.Linear(config.hidden_size, num_classes, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits


class BertLMHead(nn.Layer):
    """transform -> GELU -> LayerNorm -> decoder. With
    ``embedding_weights`` the decoder is tied: ``x @ W_emb^T +
    decoder.bias``, and ``decoder.weight`` stays a parameter that gets no
    gradient (as in the JAX package)."""

    def __init__(self, config: BertConfig, embedding_weights=None, *,
                 device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.transform = nn.Linear(config.hidden_size, config.hidden_size,
                                   **kw)
        self.activation = nn.GELU()
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       config.layer_norm_eps,
                                       device=kw["device"])
        self.decoder = nn.Linear(config.hidden_size, config.vocab_size, **kw)
        # a tuple, so the tied weight is not registered here a second time
        self._tied = (embedding_weights,) if embedding_weights is not None \
            else None

    def forward(self, x):
        x = self.layer_norm(self.activation(self.transform(x)))
        if self._tied is not None:
            return add(matmul(x, self._tied[0], transpose_y=True),
                       self.decoder.bias)
        return self.decoder(x)


class BertForPretraining(nn.Layer):
    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.bert = BertModel(config, **kw)
        self.cls = BertLMHead(config,
                              self.bert.embeddings.word_embeddings.weight,
                              **kw)
        self.nsp = nn.Linear(config.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_label=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask)
        pred = self.cls(seq_out)
        nsp_logits = self.nsp(pooled)
        if masked_lm_labels is not None:
            loss = F.cross_entropy(pred.reshape(-1, pred.shape[-1]),
                                   masked_lm_labels.reshape(-1),
                                   ignore_index=-100)
            if next_sentence_label is not None:
                # the reference's elementwise_add: bf16 under O2 although
                # both cross entropies are float32
                loss = add(loss, F.cross_entropy(nsp_logits,
                                                 next_sentence_label))
            return loss, pred
        return pred, nsp_logits
