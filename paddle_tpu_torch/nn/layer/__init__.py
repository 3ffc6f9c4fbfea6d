from .activation import GELU, Tanh  # noqa: F401
from .common import (AlphaDropout, Dropout, Dropout2D,  # noqa: F401
                     Dropout3D, Embedding, Linear)
from .container import LayerList  # noqa: F401
from .layers import HookRemoveHelper, Layer, ParamAttr  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
