"""Models of the port: the Llama configuration and the single-device
``LlamaSpmdTrainer`` (the training flagship)."""
from .llama import LlamaConfig  # noqa: F401
from .llama_spmd import LlamaSpmdTrainer  # noqa: F401

__all__ = ["LlamaConfig", "LlamaSpmdTrainer"]
