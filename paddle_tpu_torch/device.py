"""Device selection for the port's entry points: ``cuda`` unless the
caller names another device. Without a card, asking for ``cuda`` raises
instead of dropping to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch paths on the CPU")
    return dev


def model_kw(device=None, generator=None):
    """The keywords a model hands its layers: the resolved device and a
    CPU torch.Generator (``torch.Generator().manual_seed(0)`` when
    None) that draws the weights and the dropout seeds."""
    return dict(device=resolve_device(device),
                generator=(torch.Generator().manual_seed(0)
                           if generator is None else generator))
