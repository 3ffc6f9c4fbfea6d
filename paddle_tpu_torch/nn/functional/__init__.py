"""paddle.nn.functional counterparts used by the port's slices.

Each works on ``torch.Tensor``s; called with Paddle ``Tensor`` handles
(``framework/tensor.py``) it unwraps them and returns handles
(``framework/op.py`` ``takes_handles``)."""
from ...framework.op import takes_handles
from . import activation, attention, common, loss, norm

__all__ = ["alpha_dropout", "cross_entropy", "dropout", "dropout2d",
           "dropout3d", "embedding", "flash_attention",
           "fused_ln_residual_dropout", "gelu", "layer_norm", "linear",
           "relu", "rms_norm", "scaled_dot_product_attention", "silu",
           "softmax", "tanh"]

_SOURCES = (activation, attention, common, loss, norm)
for _name in __all__:
    _fn = next(getattr(m, _name) for m in _SOURCES if hasattr(m, _name))
    globals()[_name] = takes_handles(_fn)
del _name, _fn
