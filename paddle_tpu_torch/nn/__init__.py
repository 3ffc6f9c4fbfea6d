"""paddle.nn counterparts used by the port's slices."""
from . import functional  # noqa: F401
from .layer import (GELU, Dropout, Embedding, LayerNorm, Linear,  # noqa: F401
                    MultiHeadAttention, Tanh, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["functional", "Dropout", "Embedding", "GELU", "LayerNorm",
           "Linear", "MultiHeadAttention", "Tanh", "TransformerEncoder",
           "TransformerEncoderLayer"]
