"""paddle.nn.functional counterparts used by the port's slices."""
from .activation import gelu, relu, silu, softmax, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import (alpha_dropout, dropout, dropout2d,  # noqa: F401
                     dropout3d, embedding, linear)
from .loss import cross_entropy  # noqa: F401
from .norm import (fused_ln_residual_dropout, layer_norm,  # noqa: F401
                   rms_norm)

__all__ = ["alpha_dropout", "cross_entropy", "dropout", "dropout2d",
           "dropout3d", "embedding", "fused_ln_residual_dropout", "gelu",
           "layer_norm", "linear", "relu", "rms_norm",
           "scaled_dot_product_attention", "silu", "softmax", "tanh"]
