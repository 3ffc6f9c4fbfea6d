"""``paddle.save`` / ``paddle.load`` (counterpart of paddle_tpu/framework/
io.py:14-56): pickled state dicts whose tensors are written in the JAX
package's layout, ``{"__paddle_tensor__": True, "data": ndarray, "name",
"stop_gradient"}``, so a file written by either package loads in the
other. Nested dicts, lists and tuples round-trip.

bfloat16: numpy has no bfloat16 type of its own (the JAX package's
comes from ``ml_dtypes``, which the port does not need). The port writes
a bfloat16 tensor as its exact float32 values with one more key,
``"dtype": "bfloat16"``, and reads it back as bfloat16 bit for bit; the
JAX package ignores the key and loads the float32 values. A file the
JAX package wrote holds an ``ml_dtypes`` bfloat16 array, which the port
reads through its 16-bit pattern (unpickling it needs ``ml_dtypes``
installed, as it does for the JAX package). A Paddle ``Tensor`` handle
is saved as its torch tensor; ``load`` gives torch tensors.
"""
from __future__ import annotations

import itertools
import os
import pickle

import numpy as np
import torch

from .tensor import Tensor

__all__ = ["load", "save"]

_names = itertools.count()


def tensor_name(t: torch.Tensor) -> str:
    """A tensor's Paddle name: its ``param_name``, else a generated one
    kept on the tensor (the reference's ``generated_tensor_<n>``)."""
    name = getattr(t, "param_name", None)
    if name is None:
        name = f"generated_tensor_{next(_names)}"
        t.param_name = name
    return name


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (bfloat16 as its exact float32 values)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def from_numpy(a, dtype=None) -> torch.Tensor:
    """A CPU tensor of ``a``; an ``ml_dtypes`` bfloat16 array by its bit
    pattern; ``dtype="bfloat16"`` rounds float32 values back (exact for
    values that came from bfloat16)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    return t


def _to_saveable(obj):
    if isinstance(obj, Tensor):
        obj = obj._data
    if isinstance(obj, torch.Tensor):
        out = {"__paddle_tensor__": True, "data": to_numpy(obj),
               "name": tensor_name(obj),
               "stop_gradient": not obj.requires_grad}
        if obj.dtype == torch.bfloat16:
            out["dtype"] = "bfloat16"
        return out
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__paddle_tensor__"):
            if return_numpy:
                return obj["data"]
            t = from_numpy(obj["data"], obj.get("dtype"))
            if t.is_floating_point():
                t.requires_grad_(not obj.get("stop_gradient", True))
            if obj.get("name") is not None:
                t.param_name = obj["name"]
            return t
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` to ``path`` (its directory made), tensors as host
    arrays."""
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, **configs):
    """The object saved at ``path``, tensors as CPU torch tensors (numpy
    arrays with ``return_numpy=True``)."""
    with open(str(path), "rb") as f:
        raw = pickle.load(f)
    return _from_saveable(raw, return_numpy=configs.get("return_numpy",
                                                        False))
