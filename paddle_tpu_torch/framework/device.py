"""Places and the default device of creation ops (counterpart of
``paddle_tpu/framework/device.py``).

``set_device`` / ``get_device`` hold the device that ``to_tensor`` and
the creation ops (``zeros``, ``arange``, ``rand``, ...) put new tensors
on. It is ``gpu:0`` (CUDA) until the caller asks for another: on a
machine without a card the first creation raises, it does not drop to
the CPU; ``set_device("cpu")`` runs a Paddle program on the CPU. Ops on
existing tensors run where their inputs are.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "CustomPlace",
           "Place", "TPUPlace", "XPUPlace", "current_device",
           "device_count", "get_device", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "is_compiled_with_xpu", "parse_place",
           "place_of",
           "set_device"]


class Place:
    """A device kind and index (``torch_device()`` resolves it)."""

    kind = "unknown"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __repr__(self):
        return f"Place({self.kind}:{self._device_id})"

    def __eq__(self, other):
        return isinstance(other, Place) and self.kind == other.kind and \
            self._device_id == other._device_id

    def __hash__(self):
        return hash((self.kind, self._device_id))

    def torch_device(self) -> torch.device:
        if self.kind == "cpu":
            return torch.device("cpu")
        if self.kind == "gpu":
            return resolve_device(f"cuda:{self._device_id}")
        raise RuntimeError(f"no {self.kind} device in the PyTorch port")


class TPUPlace(Place):
    kind = "tpu"


class CPUPlace(Place):
    kind = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    kind = "gpu"


class CUDAPinnedPlace(CPUPlace):
    pass


class XPUPlace(Place):
    kind = "xpu"


class CustomPlace(Place):
    def __init__(self, dev_type, device_id=0):
        super().__init__(device_id)
        self.kind = dev_type


_CURRENT_DEVICE = "gpu:0"


def parse_place(device) -> Place:
    """The Place of ``'gpu'``, ``'gpu:1'``, ``'cuda:0'``, ``'cpu'`` or a
    Place."""
    if isinstance(device, Place):
        return device
    name = str(device)
    kind, _, idx = name.partition(":")
    if kind in ("gpu", "cuda"):
        return CUDAPlace(int(idx or 0))
    if kind == "cpu":
        return CPUPlace()
    raise ValueError(f"unsupported device {name!r}: the PyTorch port runs "
                     "on 'gpu' (CUDA) or 'cpu'")


def set_device(device):
    """``paddle.set_device('gpu')`` / ``'gpu:1'`` / ``'cpu'`` (``cuda``
    names the same card as ``gpu``); returns the Place."""
    global _CURRENT_DEVICE
    place = parse_place(device)
    place.torch_device()
    _CURRENT_DEVICE = f"{place.kind}:{place.get_device_id()}"
    return place


def get_device() -> str:
    return "cpu" if _CURRENT_DEVICE.startswith("cpu") else _CURRENT_DEVICE


def current_device() -> torch.device:
    """The torch device new tensors go to (raises on a machine without a
    card until ``set_device("cpu")``)."""
    kind, _, idx = _CURRENT_DEVICE.partition(":")
    return torch.device("cpu") if kind == "cpu" else \
        resolve_device(f"cuda:{idx}")


def place_of(device: torch.device) -> Place:
    """The Place of a torch device."""
    if device.type == "cuda":
        return CUDAPlace(device.index or 0)
    return CPUPlace()


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


def device_count() -> int:
    return torch.cuda.device_count()
