"""Distributed checkpointing (counterpart of paddle_tpu/distributed/
checkpoint.py:1-173).

Parameters are GLOBAL logical tensors in the port as in the reference
(logical ranks, ``parallel/mesh.py``; the mpu layers and the ZeRO
wrappers keep the global value reachable), so a checkpoint is one
global-view state dict and resharding it is a placement:
``load_state_dict(path, target_state_dict=...)`` copies each saved value
INTO its target, whatever mesh, device and dtype the target has.

The port writes the JAX package's pickle layout (``framework/io.py``)
at ``<path>/state.pdparams`` (or ``path`` itself when it ends in
``.pdparams``): a checkpoint written by either package's pickle path
loads in the other. The JAX package writes an orbax directory where
orbax is importable; the port cannot read that format without JAX and
raises an ImportError naming it.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Union

import numpy as np
import torch

from ..framework.io import load, save

__all__ = ["PPParallelAdaptor", "load_state_dict", "save_state_dict"]


def _pickle_path(path: str) -> str:
    return path if path.endswith(".pdparams") \
        else os.path.join(path, "state.pdparams")


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    async_save: bool = False):
    """Write ``state_dict`` (global values) in the pickle layout;
    ``async_save`` is accepted and the write is synchronous."""
    save(state_dict, _pickle_path(path))


def load_state_dict(path: str, target_state_dict=None, shardings=None):
    """The saved state dict (CPU tensors); with ``target_state_dict``,
    each saved value copied into the target tensor of its key (keeping
    the target's device, dtype and identity) and the targets returned."""
    file = _pickle_path(path)
    if not os.path.exists(file):
        if os.path.isdir(path):
            raise ImportError(
                f"checkpoint at {path!r} has no {os.path.basename(file)}: "
                f"it is in the orbax format the JAX package writes, which "
                f"this package cannot read (save it with the JAX package's "
                f"pickle path, paddle_tpu.framework.io.save)")
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    state = load(file)
    if target_state_dict is None:
        return state
    with torch.no_grad():
        for k, v in state.items():
            if k in target_state_dict:
                target_state_dict[k].copy_(v)
    return target_state_dict


class PPParallelAdaptor:
    """Remaps checkpoints between pipeline layouts. Per-stage state
    dicts number their ``<layer_key>.<i>.*`` entries stage-locally;
    ``convert`` renumbers through the global layer index over the
    contiguous balanced partition (``np.array_split``). Keys outside the
    layers ride on stage 0."""

    @staticmethod
    def _bounds(n_layers: int, pp: int) -> List[int]:
        bounds = [0]
        for c in np.array_split(np.arange(n_layers), pp):
            bounds.append(bounds[-1] + len(c))
        return bounds

    @classmethod
    def to_global(cls, stage_dicts: List[Dict[str, Any]],
                  layer_key: str = "layers") -> Dict[str, Any]:
        """One global-view dict from per-stage dicts."""
        pat = re.compile(rf"^{re.escape(layer_key)}\.(\d+)\.(.*)$")
        bounds = [0]
        for sd in stage_dicts:
            bounds.append(bounds[-1] + len({int(m.group(1)) for k in sd
                                            if (m := pat.match(k))}))
        out: Dict[str, Any] = {}
        for stage, sd in enumerate(stage_dicts):
            for k, v in sd.items():
                m = pat.match(k)
                if m is None:
                    out.setdefault(k, v)
                else:
                    g = bounds[stage] + int(m.group(1))
                    out[f"{layer_key}.{g}.{m.group(2)}"] = v
        return out

    @classmethod
    def convert(cls, state_dict: Union[Dict[str, Any],
                                       List[Dict[str, Any]]],
                src_pp: int = 1, dst_pp: int = 1,
                layer_key: str = "layers"):
        """``state_dict`` saved under ``src_pp`` stages (a list of
        per-stage dicts; a single dict is the global view, src_pp 1) as
        ``dst_pp`` per-stage dicts, or the global dict at dst_pp 1."""
        if isinstance(state_dict, list):
            if len(state_dict) != src_pp:
                raise ValueError(
                    f"PPParallelAdaptor.convert: got {len(state_dict)} "
                    f"stage dicts but src_pp={src_pp}")
            global_sd = cls.to_global(state_dict, layer_key)
        else:
            if src_pp != 1:
                raise ValueError(
                    "PPParallelAdaptor.convert: a single state dict is "
                    "the global view; pass the per-stage dicts as a list "
                    "when src_pp > 1")
            global_sd = dict(state_dict)
        if dst_pp == 1:
            return global_sd
        pat = re.compile(rf"^{re.escape(layer_key)}\.(\d+)\.(.*)$")
        ids = {int(m.group(1)) for k in global_sd if (m := pat.match(k))}
        bounds = cls._bounds(max(ids) + 1 if ids else 0, dst_pp)
        stages: List[Dict[str, Any]] = [dict() for _ in range(dst_pp)]
        for k, v in global_sd.items():
            m = pat.match(k)
            if m is None:
                stages[0][k] = v
                continue
            g = int(m.group(1))
            stage = int(np.searchsorted(bounds, g, side="right") - 1)
            stages[stage][f"{layer_key}.{g - bounds[stage]}.{m.group(2)}"] \
                = v
        return stages
