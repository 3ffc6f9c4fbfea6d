"""paddle.nn counterparts used by the port's slices."""
from . import functional  # noqa: F401
from .layer import (GELU, AlphaDropout, Dropout, Dropout2D,  # noqa: F401
                    Dropout3D, Embedding, LayerList, LayerNorm, Linear,
                    MultiHeadAttention, RMSNorm, Tanh, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "AlphaDropout", "Dropout", "Dropout2D",
           "Dropout3D", "Embedding", "GELU", "LayerList", "LayerNorm",
           "Linear", "MultiHeadAttention", "RMSNorm", "Tanh", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
