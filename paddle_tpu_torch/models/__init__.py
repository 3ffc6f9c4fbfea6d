"""Models of the port: BERT (pretraining and classification), the Llama
configuration and the single-device ``LlamaSpmdTrainer`` (the training
flagship)."""
from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel)
from .llama import LlamaConfig  # noqa: F401
from .llama_spmd import LlamaSpmdTrainer  # noqa: F401

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "LlamaConfig",
           "LlamaSpmdTrainer"]
