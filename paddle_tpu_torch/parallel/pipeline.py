"""SPMD pipeline parallelism over the 'pp' mesh axis — the counterpart of
paddle_tpu/parallel/pipeline.py (:39-201).

The reference compiles a ring schedule in one shard_map: at tick t stage
s runs micro-batch t - s and ppermutes its activation to stage s + 1;
``n_micro + n - 1`` ticks. With ``n_virtual`` = v > 1 each stage owns v
non-adjacent layer chunks (chunk j of stage s is logical stage j n + s),
micro-batches enter in groups of n, and the ring wrap (stage n - 1 -> 0)
carries an activation from chunk j to chunk j + 1: ``(n_micro / n) v n +
n - 1`` ticks, one fill/drain bubble. ``remat_stage`` checkpoints each
(tick, stage) call, so the backward keeps one activation per slot.

The port runs the same schedule tick for tick (``schedule``), each stage
on its mesh devices, the sends through ``collective.ppermute`` (one call
a tick; its backward is the reverse send). Bubble slots, where the
reference runs the stage on a clipped input and drops the result, are
skipped and counted. The reference broadcasts the last stage's outputs
to every pp rank with a psum; the port returns them on the last stage's
devices, where the trainer's head runs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from . import collective
from . import mesh as mesh_mod

__all__ = ["PipelineStats", "interleave_stage_params", "run_schedule",
           "schedule", "spmd_pipeline", "stack_stage_params"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def interleave_stage_params(tree, n_stages: int, n_virtual: int):
    """Rearrange logical-chunk-major params [v*n, ...] into the staged
    layout [n, v, ...] (chunk j of stage s = logical stage j*n + s). Do
    this ONCE at init."""
    def rearrange(a):
        if a.shape[0] != n_virtual * n_stages:
            raise ValueError(
                f"interleaved params need leading dim "
                f"{n_virtual * n_stages}, got {a.shape[0]}")
        b = a.reshape((n_virtual, n_stages) + tuple(a.shape[1:]))
        return b.transpose(0, 1)
    return _tree_map(rearrange, tree)


class Slot(NamedTuple):
    stage: int
    chunk: int
    micro: int
    feed: bool   # stage 0 takes micro-batch ``micro`` fresh
    emit: bool   # the output is micro-batch ``micro``'s result


class PipelineStats(NamedTuple):
    ticks: int
    slots: int     # (tick, stage) calls run
    bubbles: int   # (tick, stage) slots the reference computes and drops
    sends: int     # activations moved to the next stage


def schedule(n_stages: int, n_micro: int, n_virtual: int = 1):
    """The reference's ring schedule: a list over ticks of the active
    slots. Raises ValueError where the reference does (interleave needs
    n_micro % n_stages == 0)."""
    n, v = n_stages, int(n_virtual)
    if v > 1 and n_micro % n != 0:
        raise ValueError(
            f"interleaved schedule needs n_micro ({n_micro}) divisible "
            f"by the stage count ({n})")
    vn = v * n
    groups = n_micro // n if v > 1 else None
    ticks = (groups * vn + n - 1) if v > 1 else (n_micro + n - 1)
    out = []
    for t in range(ticks):
        slots = []
        for s in range(n):
            u = t - s
            if v > 1:
                g, rem = u // vn, u % vn
                if u < 0 or g >= groups:
                    continue
                slots.append(Slot(s, rem // n, g * n + u % n,
                                  s == 0 and rem < n,
                                  s == n - 1 and rem >= vn - n))
            elif 0 <= u < n_micro:
                slots.append(Slot(s, 0, u, s == 0, s == n - 1))
        out.append(slots)
    return out


def run_schedule(stage_call: Callable, inputs: List[Any], n_stages: int,
                 n_virtual: int, send: Callable, remat_stage: bool = False):
    """Drive ``schedule(n_stages, len(inputs), n_virtual)``:
    ``stage_call(stage, chunk, x) -> y`` runs one slot (checkpointed when
    ``remat_stage``), ``send(ys) -> received`` moves one tick's outputs
    (a list over stages, None where nothing is sent) one stage along the
    ring. Returns (the emitted outputs in micro-batch order,
    PipelineStats)."""
    sched = schedule(n_stages, len(inputs), n_virtual)
    state: List[Any] = [None] * n_stages
    outputs: Dict[int, Any] = {}
    n_slots = n_sends = 0
    for slots in sched:
        ys: List[Any] = [None] * n_stages
        for sl in slots:
            x = inputs[sl.micro] if sl.feed else state[sl.stage]
            if remat_stage:
                y = checkpoint(stage_call, sl.stage, sl.chunk, x,
                               use_reentrant=False)
            else:
                y = stage_call(sl.stage, sl.chunk, x)
            n_slots += 1
            if sl.emit:
                outputs[sl.micro] = y
            else:
                ys[sl.stage] = y
                n_sends += 1
        state = (send(ys) if any(y is not None for y in ys)
                 else [None] * n_stages)
    stats = PipelineStats(len(sched), n_slots,
                          len(sched) * n_stages - n_slots, n_sends)
    return [outputs[i] for i in range(len(inputs))], stats


def spmd_pipeline(stage_fn: Callable, stage_params: Any, x_micro,
                  axis: str = "pp", manual_axes=(), x_spec=None,
                  n_virtual: int = 1, remat_stage: bool = False,
                  params_layout: str = "logical"):
    """Run ``stage_fn(params_slice, x_mb) -> y_mb`` as a pipeline over the
    installed mesh's `axis` (stage s on the device at pp = s, every other
    coordinate 0).

    stage_params: a tree (dicts) of tensors whose leaves have leading dim
    n_stages; with n_virtual > 1 either v*n chunks in logical layer order
    (params_layout="logical", rearranged here) or already [n_stages, v,
    ...] (params_layout="staged", from interleave_stage_params).
    x_micro: [n_micro, mb, ...]. Returns [n_micro, mb, ...] on the last
    stage's device. manual_axes and x_spec are the reference's shard_map
    arguments; the port's ranks are explicit, so they must stay at their
    defaults (the trainer drives ``run_schedule`` itself)."""
    if tuple(manual_axes) or x_spec is not None:
        raise NotImplementedError(
            "manual_axes / x_spec: the trainer runs its sep ranks through "
            "run_schedule")
    mesh = mesh_mod.get_mesh()
    n = mesh.shape[axis]
    v = int(n_virtual)
    ax = mesh.axis_names.index(axis)
    devices = [mesh.devices[tuple(s if i == ax else 0
                                  for i in range(mesh.devices.ndim))]
               for s in range(n)]
    if n == 1:
        stage_fn_ = (lambda p, x: checkpoint(stage_fn, p, x,
                                             use_reentrant=False)) \
            if remat_stage else stage_fn
        dev = devices[0]
        params = _tree_map(lambda a: a.to(dev), stage_params)
        outs = []
        for x in x_micro.to(dev):
            if v > 1:
                chunks = (_tree_map(lambda a: a[0], params)
                          if params_layout == "staged" else params)
                for c in range(v):
                    x = stage_fn_(_tree_map(lambda a: a[c], chunks), x)
                outs.append(x)
            else:
                outs.append(stage_fn_(_tree_map(lambda a: a[0], params), x))
        return torch.stack(outs)
    if v > 1 and params_layout != "staged":
        schedule(n, x_micro.shape[0], v)  # the divisibility check first
        stage_params = interleave_stage_params(stage_params, n, v)
    local = [_tree_map(lambda a: a[s].to(devices[s]), stage_params)
             for s in range(n)]
    perm = [(i, (i + 1) % n) for i in range(n)]

    def stage_call(s, chunk, x):
        p = _tree_map(lambda a: a[chunk], local[s]) if v > 1 else local[s]
        return stage_fn(p, x)

    inputs = list(x_micro.to(devices[0]).unbind(0))
    outs, _ = run_schedule(stage_call, inputs, n, v,
                           lambda ys: collective.ppermute(ys, perm, devices),
                           remat_stage)
    return torch.stack(outs)


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage trees along a new leading dim (the stage
    axis)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(list(per_stage_params), 0)
