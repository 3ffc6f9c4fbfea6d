"""paddle.distributed.fleet.utils (counterpart of paddle_tpu/distributed/
fleet/utils/__init__.py): recompute, the file systems, the hybrid-
parallel gradient helpers, the fleet logger and the fp32 main-grad
wrappers."""
from .. import recompute as _recompute_mod  # noqa: F401
from ..recompute import recompute, recompute_sequential  # noqa: F401
from . import fs  # noqa: F401
from . import hybrid_parallel_util  # noqa: F401
from . import log_util  # noqa: F401
from . import mix_precision_utils  # noqa: F401
from .fs import HDFSClient, LocalFS  # noqa: F401
from .log_util import logger, set_log_level  # noqa: F401

__all__ = ["recompute", "recompute_sequential", "LocalFS", "HDFSClient",
           "logger", "set_log_level", "fs", "hybrid_parallel_util",
           "log_util", "mix_precision_utils"]
