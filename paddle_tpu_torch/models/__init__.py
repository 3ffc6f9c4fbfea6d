"""Models of the port: BERT (pretraining and classification), Llama
(``LlamaForCausalLM``), GPT (``GPTForCausalLM``) and ``LlamaSpmdTrainer``
(the training flagship, on one device or a mesh of logical ranks)."""
from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .llama_spmd import LlamaSpmdTrainer  # noqa: F401

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "GPTConfig",
           "GPTForCausalLM", "GPTModel", "LlamaConfig", "LlamaForCausalLM",
           "LlamaSpmdTrainer"]
