"""paddle.incubate counterparts: the serving slice's ``nn`` and the
Mixture-of-Experts training layer (``moe``, ``MoELayer``)."""
from . import moe, nn  # noqa: F401
from .moe import MoELayer  # noqa: F401
