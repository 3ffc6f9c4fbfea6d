"""Dtypes (counterpart of ``paddle_tpu/framework/dtype.py``).

The public dtypes are torch dtypes (``float32 = torch.float32``).
``convert_dtype`` takes Paddle's names and aliases (``"fp32"``,
``"bf16"``, ``"double"``, ...), numpy dtypes and scalar types (an
``ml_dtypes`` bfloat16 too) and torch dtypes, and returns a torch dtype.

The JAX package runs JAX with 64-bit types off: a Python int, an int64
array or a request for ``"int64"`` gives int32, float64 gives float32 and
complex128 complex64. The port's ``Tensor`` holds the same types
(``canonical``), so every op's output dtype has the reference's name;
ops that need int64 indices (``torch.gather`` and the like) cast inside.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bfloat16", "bool_", "canonical", "complex128", "complex64",
           "convert_dtype", "dtype_name", "float16", "float32", "float64",
           "get_default_dtype", "int16", "int32", "int64", "int8",
           "is_floating", "is_integer", "set_default_dtype", "uint8"]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "uint8": uint8,
    "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}
_PY_TYPES = {bool: bool_, int: int64, float: float32, complex: complex64}
# the JAX package's types with 64-bit types off
_CANONICAL = {int64: int32, float64: float32, complex128: complex64}

_DEFAULT_DTYPE = float32


def set_default_dtype(d):
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = convert_dtype(d)


def get_default_dtype():
    return _DEFAULT_DTYPE


def convert_dtype(dtype):
    """A torch dtype from a Paddle name or alias, a numpy dtype or scalar
    type, a Python type or a torch dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR_ALIASES:
            raise ValueError(f"unsupported dtype string: {dtype!r}")
        return _STR_ALIASES[dtype]
    if dtype in _PY_TYPES:
        return _PY_TYPES[dtype]
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"unsupported dtype: {dtype!r}") from None
    if name not in _STR_ALIASES:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _STR_ALIASES[name]


def canonical(dtype):
    """The dtype a Tensor of ``dtype`` holds (64-bit types narrowed)."""
    return _CANONICAL.get(dtype, dtype)


def dtype_name(dtype) -> str:
    """Paddle's name of a dtype: ``"float32"``, ``"bool"``, ..."""
    return str(convert_dtype(dtype)).rsplit(".", 1)[-1]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == bool_)
