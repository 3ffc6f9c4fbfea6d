"""The training mesh and the serving shards' device lists (counterpart of
paddle_tpu/parallel/mesh.py: ``build_mesh`` .. ``mesh_axis_size``,
:22-62, and ``serving_shard_devices``, :65-94).

The reference's mesh is a ``jax.sharding.Mesh`` whose named axes are the
parallelism axes. The port's is a numpy object array of
``torch.device`` in ``AXIS_ORDER`` (``Mesh``): a rank is a coordinate of
that array, and its device is the entry there. Devices may repeat: such
ranks are LOGICAL, several on one device, and keep their own tensors and
their own collectives (``parallel/collective.py``); numerics and the
collective schedule are those of a mesh of distinct devices. One H100,
and the CPU, train so.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["AXIS_ORDER", "Mesh", "build_mesh", "get_mesh", "mesh_axis_size",
           "on_device", "serving_shard_devices", "set_mesh"]

AXIS_ORDER = ("dp", "pp", "sharding", "sep", "mp")


class Mesh:
    """``devices``: an object array of ``torch.device`` with one dim per
    name of ``AXIS_ORDER``; ``shape`` maps each axis to its size, as a
    jax Mesh's does."""

    def __init__(self, devices, axis_names=AXIS_ORDER):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        types = {d.type for d in self.devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh runs on one kind of device, got "
                             f"{sorted(types)}")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def coords(self):
        """Every rank's coordinate, in row-major (``AXIS_ORDER``) order."""
        return list(np.ndindex(*self.devices.shape))


_global_mesh: Optional[Mesh] = None


def _default_devices() -> List[torch.device]:
    """Every card (``device.resolve_device``: raises without one)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(dp=1, pp=1, sharding=1, sep=1, mp=1, devices=None) -> Mesh:
    """Create and install the global mesh over ``devices`` (default: every
    card), ``mp`` innermost as in the reference. ``dp=-1`` fills the
    devices left; a product above the device count raises. Repeat a
    device in the list to place several ranks on it."""
    global _global_mesh
    devices = [torch.device(d) for d in (
        devices if devices is not None else _default_devices())]
    sizes = {"dp": dp, "pp": pp, "sharding": sharding, "sep": sep, "mp": mp}
    total = int(np.prod(list(sizes.values())))
    if total > len(devices):
        raise ValueError(
            f"mesh needs {total} devices, only {len(devices)} available")
    if total < len(devices) and dp == -1:
        sizes["dp"] = len(devices) // (pp * sharding * sep * mp)
        total = len(devices)
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    _global_mesh = Mesh(arr.reshape([sizes[a] for a in AXIS_ORDER]))
    return _global_mesh


def get_mesh() -> Mesh:
    if _global_mesh is None:
        # default: pure data parallel over every card
        build_mesh(dp=len(_default_devices()))
    return _global_mesh


def set_mesh(mesh: Optional[Mesh]):
    """Install ``mesh`` (None uninstalls: the next ``get_mesh`` builds the
    default)."""
    global _global_mesh
    _global_mesh = mesh


def on_device(device) -> Mesh:
    """The installed mesh's shape with every rank on ``device`` (one
    rank when no mesh is installed): LOGICAL ranks on one device."""
    dev = resolve_device(device)
    shape = (_global_mesh.devices.shape if _global_mesh is not None
             else (1,) * len(AXIS_ORDER))
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [dev] * arr.size
    return Mesh(arr.reshape(shape))


def mesh_axis_size(axis: str) -> int:
    m = get_mesh()
    return m.shape[axis] if axis in m.shape else 1


def serving_shard_devices(mp: int, base_device=None) -> List[torch.device]:
    """Devices for ``mp`` head-sharded SERVING shards
    (inference/serving.py ``ShardedServingCore`` and the sharded
    ``PagedKVCache``):

      1. the installed training mesh's first ``mp`` row (dp = pp = ... =
         0) when its ``mp`` axis is at least ``mp`` wide and no
         ``base_device`` is named;
      2. ``cuda:0`` .. ``cuda:mp-1`` when the base device is CUDA and
         the machine has at least ``mp`` cards (the reference's point 2,
         ``jax.devices()``);
      3. otherwise (and always at mp 1) the base device repeated:
         LOGICAL shards, several on one device (the reference's point
         3). Numerics and the collective schedule are those of distinct
         devices; only the placement is degenerate. One H100, and the
         CPU, serve so.

    ``base_device`` defaults to ``cuda`` (``device.resolve_device``:
    raises without a card unless the caller names ``cpu``)."""
    mp = int(mp)
    if mp < 1:
        raise ValueError(f"mp must be >= 1, got {mp}")
    m = _global_mesh
    if base_device is None and m is not None and m.shape["mp"] >= mp:
        row = m.devices.reshape(-1, m.shape["mp"])[0]
        return [row[i] for i in range(mp)]
    base = resolve_device(base_device)
    if mp > 1 and base.type == "cuda" and torch.cuda.device_count() >= mp:
        return [torch.device("cuda", i) for i in range(mp)]
    return [base] * mp
