"""paddle.nn counterparts used by the port's slices."""
from . import functional, initializer  # noqa: F401
from .layer import (GELU, AlphaDropout, Dropout, Dropout2D,  # noqa: F401
                    Dropout3D, Embedding, Layer, LayerList, LayerNorm,
                    Linear, MultiHeadAttention, ParamAttr, RMSNorm, Tanh,
                    Transformer, TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "AlphaDropout", "Dropout",
           "Dropout2D", "Dropout3D", "Embedding", "GELU", "Layer",
           "LayerList", "LayerNorm", "Linear", "MultiHeadAttention",
           "ParamAttr", "RMSNorm", "Tanh", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
