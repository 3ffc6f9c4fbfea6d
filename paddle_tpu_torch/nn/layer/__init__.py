from .common import Linear  # noqa: F401
from .norm import LayerNorm  # noqa: F401
