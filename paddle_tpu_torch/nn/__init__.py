"""paddle.nn counterparts used by the serving slice."""
from . import functional  # noqa: F401
from .layer import LayerNorm, Linear  # noqa: F401

__all__ = ["functional", "LayerNorm", "Linear"]
