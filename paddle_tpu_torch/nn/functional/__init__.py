"""paddle.nn.functional counterparts used by the serving slice."""
from .activation import gelu, relu  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .norm import layer_norm  # noqa: F401

__all__ = ["gelu", "layer_norm", "relu", "scaled_dot_product_attention"]
