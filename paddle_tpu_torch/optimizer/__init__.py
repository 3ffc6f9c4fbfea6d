"""paddle.optimizer counterparts: ``Adam`` and ``AdamW`` with Paddle's
update rule."""
from .adam import Adam, AdamW  # noqa: F401
from .optimizer import Optimizer  # noqa: F401

__all__ = ["Adam", "AdamW", "Optimizer"]
