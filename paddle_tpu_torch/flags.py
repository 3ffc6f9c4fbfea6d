"""Runtime flags of the port (counterpart of ``paddle_tpu/flags.py``).

Only the flags the port reads are defined, with the JAX package's
defaults:

- ``FLAGS_check_nan_inf`` (False): the op-boundary hook
  (``framework/op.py``) scans every hooked op's floating inputs for
  NaN/Inf and raises naming the op.
- ``FLAGS_tpu_fused_dropout`` (True): ``nn.functional.dropout`` in the
  ``upscale_in_train`` mode goes through the fused dropout kernel
  (``ops/hopper/fused_norm.py``; its plain version on the CPU).
- ``FLAGS_tpu_fused_encoder`` (False): ``TransformerEncoderLayer`` sends
  dropout + residual + LayerNorm through the fused LayerNorm kernel.
"""
from __future__ import annotations

from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_tpu_fused_dropout": True,
    "FLAGS_tpu_fused_encoder": False,
}


def get_flag(name: str, default=None):
    return _REGISTRY.get(name, default)


def set_flags(flags: Dict[str, Any]) -> None:
    """Set several flags at once; an unknown name raises ValueError and
    sets none of them."""
    unknown = [k for k in flags if k not in _REGISTRY]
    if unknown:
        raise ValueError(f"unknown flags {unknown}; the port defines "
                         f"{sorted(_REGISTRY)}")
    _REGISTRY.update(flags)
    from .framework import op
    op.refresh_watch()
