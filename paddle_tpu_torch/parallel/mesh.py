"""Device lists for tensor-parallel serving shards (counterpart of
paddle_tpu/parallel/mesh.py ``serving_shard_devices``, :65-110)."""
from __future__ import annotations

from typing import List

import torch

from ..device import resolve_device

__all__ = ["serving_shard_devices"]


def serving_shard_devices(mp: int, base_device=None) -> List[torch.device]:
    """Devices for ``mp`` head-sharded SERVING shards
    (inference/serving.py ``ShardedServingCore`` and the sharded
    ``PagedKVCache``):

      1. ``cuda:0`` .. ``cuda:mp-1`` when the base device is CUDA and
         the machine has at least ``mp`` cards (the reference's point 2,
         ``jax.devices()``);
      2. otherwise (and always at mp 1) the base device repeated:
         LOGICAL shards, several on one device (the reference's point
         3). Numerics and the collective schedule are those of distinct
         devices; only the placement is degenerate. One H100, and the
         CPU, serve so.

    ``base_device`` defaults to ``cuda`` (``device.resolve_device``:
    raises without a card unless the caller names ``cpu``). The
    reference's point 1, the installed training mesh's ``mp`` axis, is
    not ported: it comes with the trainer's tensor parallelism (ROADMAP
    Queue A item 11)."""
    mp = int(mp)
    if mp < 1:
        raise ValueError(f"mp must be >= 1, got {mp}")
    base = resolve_device(base_device)
    if mp > 1 and base.type == "cuda" and torch.cuda.device_count() >= mp:
        return [torch.device("cuda", i) for i in range(mp)]
    return [base] * mp
