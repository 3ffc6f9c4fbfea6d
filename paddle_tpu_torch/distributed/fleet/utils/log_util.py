"""The fleet logger (counterpart of paddle_tpu/distributed/fleet/utils/
log_util.py)."""
from __future__ import annotations

import logging

__all__ = ["logger", "set_log_level", "layer_to_str"]

logger = logging.getLogger("paddle_tpu_torch.distributed.fleet")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logger.addHandler(_h)
logger.setLevel(logging.INFO)


def set_log_level(level):
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    logger.setLevel(level)


def layer_to_str(base, *args, **kwargs):
    """``base(arg, ..., key=value, ...)``."""
    parts = [str(a) for a in args] + [f"{k}={v}" for k, v in kwargs.items()]
    return f"{base}({', '.join(parts)})"
