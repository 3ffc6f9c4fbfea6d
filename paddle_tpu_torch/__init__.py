"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written kernels live in ``ops/hopper`` and
``csrc``. The JAX package ``paddle_tpu`` is the reference it is tested
against; this package never imports it."""
from . import (amp, distributed, flags, framework, incubate,  # noqa: F401
               inference, models, nn, ops, optimizer, quantization)
from .device import resolve_device  # noqa: F401
from .flags import get_flag, set_flags  # noqa: F401

__all__ = ["amp", "distributed", "flags", "framework", "get_flag", "incubate",
           "inference", "models", "nn", "ops", "optimizer", "quantization",
           "resolve_device", "set_flags"]
