"""paddle.optimizer counterparts: ``SGD``, ``Momentum``, and ``Adam`` /
``AdamW`` with Paddle's update rule."""
from .adam import Adam, AdamW  # noqa: F401
from .optimizer import Momentum, Optimizer, SGD  # noqa: F401

__all__ = ["Adam", "AdamW", "Momentum", "Optimizer", "SGD"]
