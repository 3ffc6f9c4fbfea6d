"""paddle.nn.functional counterparts used by the port's slices."""
from .activation import gelu, relu, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import fused_ln_residual_dropout, layer_norm  # noqa: F401

__all__ = ["cross_entropy", "dropout", "embedding",
           "fused_ln_residual_dropout", "gelu", "layer_norm", "linear",
           "relu", "scaled_dot_product_attention", "tanh"]
