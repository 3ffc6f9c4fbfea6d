"""The Llama configuration (the port's own copy of the JAX package's
``paddle_tpu.models.llama.LlamaConfig``: same fields, defaults and
presets). ``LlamaForCausalLM`` needs the Paddle ``Tensor``/``Layer``
surface and is not ported yet; the trainer in ``llama_spmd.py`` reads
only this configuration."""
from __future__ import annotations

from dataclasses import dataclass


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
