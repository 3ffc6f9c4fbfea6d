"""paddle.quantization counterpart, PyTorch port: the serving slice's
int8 primitives (the observers, QAT and PTQ of the JAX package come
later)."""
from .functional import dequantize, quantize, quantized_matmul  # noqa: F401

__all__ = ["quantize", "dequantize", "quantized_matmul"]
