"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written kernels live in ``ops/hopper`` and
``csrc``. The JAX package ``paddle_tpu`` is the reference it is tested
against; this package never imports it."""
from . import incubate, inference, nn, ops  # noqa: F401
from .device import resolve_device  # noqa: F401

__all__ = ["incubate", "inference", "nn", "ops", "resolve_device"]
