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

Every rank has an owning PROCESS (``Mesh.owners``). Without a process
group (``distributed.init_parallel_env``) one process owns them all.
With one of ``W`` processes, ``build_mesh`` in every process gives the
same global mesh: the ranks in row-major order go to process 0's
devices, then process 1's, and so on, each process naming its own
devices (the same number in each). A process holds the tensors of its
own ranks only (``local_coords``), and the collectives fill in the
others (``parallel/collective.py``). The processes share one card, or
the CPU; a world whose processes sit on distinct cards raises
(ROADMAP item 10b: NCCL, which needs one card a rank).
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

    def __init__(self, devices, axis_names=AXIS_ORDER, owners=None):
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
        self.owners = (np.zeros(self.devices.shape, dtype=np.int64)
                       if owners is None else
                       np.asarray(owners, dtype=np.int64).reshape(
                           self.devices.shape))
        self.process = _process_rank()

    @property
    def spans_processes(self) -> bool:
        return int(self.owners.min()) != int(self.owners.max())

    def owner(self, coord) -> int:
        return int(self.owners[tuple(coord)])

    def owned(self, coord) -> bool:
        """Whether this process holds rank ``coord``."""
        return self.owner(coord) == self.process

    def owners_of(self, coords):
        """The owning processes of ``coords`` (a group's ranks), or None
        when this process holds the whole mesh."""
        if not self.spans_processes:
            return None
        return [self.owner(c) for c in coords]

    def local_coords(self):
        """The coordinates of the ranks this process holds."""
        return [c for c in self.coords() if self.owned(c)]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def coords(self):
        """Every rank's coordinate, in row-major (``AXIS_ORDER``) order."""
        return list(np.ndindex(*self.devices.shape))


_global_mesh: Optional[Mesh] = None


def _process_rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _process_count() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _check_one_card(devices):
    """Raise unless every process of the world runs on the same card
    (or the CPU): ranks of distinct cards need NCCL, item 10b."""
    import torch.distributed as dist
    local = sorted({str(torch.cuda.get_device_properties(d).uuid)
                    for d in devices if d.type == "cuda"})
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, local)
    cards = {u for s in seen for u in s}
    if len(cards) > 1:
        raise NotImplementedError(
            f"the processes' ranks sit on {len(cards)} distinct cards: a "
            f"world over distinct cards needs NCCL process groups "
            f"(ROADMAP item 10b), which is not ported; run every process "
            f"on one card")


def _default_devices() -> List[torch.device]:
    """Every card (``device.resolve_device``: raises without one)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(dp=1, pp=1, sharding=1, sep=1, mp=1, devices=None) -> Mesh:
    """Create and install the global mesh over ``devices`` (default: every
    card), ``mp`` innermost as in the reference. ``dp=-1`` fills the
    devices left; a product above the device count raises. Repeat a
    device in the list to place several ranks on it. In a world of
    several processes ``devices`` are this process's (see the module
    docstring), and every process calls ``build_mesh`` alike."""
    global _global_mesh
    devices = [torch.device(d) for d in (
        devices if devices is not None else _default_devices())]
    W = _process_count()
    owners = None
    if W > 1:
        _check_one_card(devices)
        owners = np.repeat(np.arange(W), len(devices))
        devices = devices * W
    sizes = {"dp": dp, "pp": pp, "sharding": sharding, "sep": sep, "mp": mp}
    total = int(np.prod(list(sizes.values())))
    if total > len(devices):
        raise ValueError(
            f"mesh needs {total} devices, only {len(devices)} available")
    if total < len(devices) and dp == -1:
        sizes["dp"] = len(devices) // (pp * sharding * sep * mp)
        total = len(devices)
    if owners is not None and total != len(devices):
        raise ValueError(f"a mesh over {W} processes takes every "
                         f"process's {len(devices) // W} device(s): "
                         f"{len(devices)} ranks, the axes give {total}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    _global_mesh = Mesh(arr.reshape([sizes[a] for a in AXIS_ORDER]),
                        owners=owners)
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
    return Mesh(arr.reshape(shape), owners=None if _global_mesh is None
                else _global_mesh.owners)


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
