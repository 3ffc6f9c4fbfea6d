"""``paddle.amp`` for the port: ``auto_cast`` (O1/O2/OD, bf16 and fp16,
custom lists) applied by the op-boundary hook (``framework/op.py``),
``decorate``, loss scaling (``GradScaler``) and ``debugging``."""
from . import debugging  # noqa: F401
from .auto_cast import amp_guard, amp_state, auto_cast, decorate  # noqa: F401
from .grad_scaler import AmpScaler, GradScaler, OptimizerState  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler"]
