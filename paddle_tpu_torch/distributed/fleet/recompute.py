"""Activation recomputation for fleet (counterpart of paddle_tpu/
distributed/fleet/recompute.py): ``fleet.utils.recompute`` and
``recompute_sequential`` are the port's ``framework/recompute.py``."""
from ...framework.recompute import (  # noqa: F401
    recompute, recompute_sequential)

__all__ = ["recompute", "recompute_sequential"]
