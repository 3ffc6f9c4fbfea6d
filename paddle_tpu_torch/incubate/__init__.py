"""paddle.incubate counterparts used by the serving slice."""
from . import nn  # noqa: F401
