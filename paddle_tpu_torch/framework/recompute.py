"""Activation recomputation (counterpart of
``paddle_tpu/distributed/fleet/recompute.py:20-51``): ``recompute`` and
``recompute_sequential`` over ``torch.utils.checkpoint``.

The reference replays a recomputed block under the same PRNG key
(``:27``), so its dropout masks in the backward's replay are the
forward's. ``torch.utils.checkpoint``'s ``preserve_rng_state`` restores
only torch's default generators, not the explicit CPU
``torch.Generator`` the port's dropout sites draw seeds from
(``framework/random.py``). So the replay here sets every generator held
by the block's modules (their ``generator`` attributes) back to its
state at the forward, runs, and puts each back where it stood. The amp
state of the forward (``amp.auto_cast``) is restored for the replay too:
the backward runs outside the ``auto_cast`` block, and a replay in other
dtypes would compute another function. Under amp the block's tensor
inputs go through the op-boundary hook as ``recompute`` (the
reference's op name; O2 casts them). The replay is always
non-reentrant; ``use_reentrant`` is accepted and unused, as in the
reference.
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from ..amp.auto_cast import _state as _amp
from .op import op_inputs

__all__ = ["recompute", "recompute_sequential"]

_AMP_FIELDS = ("enabled", "dtype", "level", "white", "black")


def _generators(function):
    if not isinstance(function, torch.nn.Module):
        return []
    found = {}
    for m in function.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator):
            found[id(g)] = g
    return list(found.values())


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              **kwargs):
    """``function(*args, **kwargs)`` whose activations are recomputed in
    the backward instead of kept."""
    args = op_inputs("recompute", *args)
    gens = _generators(function)
    fwd_states = [g.get_state() for g in gens]
    fwd_amp = tuple(getattr(_amp, f) for f in _AMP_FIELDS)
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a, **kwargs)
        now = [g.get_state() for g in gens]
        now_amp = tuple(getattr(_amp, f) for f in _AMP_FIELDS)
        for g, s in zip(gens, fwd_states):
            g.set_state(s)
        for f, v in zip(_AMP_FIELDS, fwd_amp):
            setattr(_amp, f, v)
        try:
            return function(*a, **kwargs)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)
            for f, v in zip(_AMP_FIELDS, now_amp):
                setattr(_amp, f, v)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False,
        preserve_rng_state=preserve_rng_state)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Split ``functions`` (a list of layers or a container) into
    ``ctx["segments"]`` chunks and recompute each."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    if isinstance(functions, torch.nn.Module):
        functions = list(functions.children())
    n = len(functions)
    per = math.ceil(n / segments)
    out = args[0] if len(args) == 1 else args
    for s in range(0, n, per):
        out = recompute(torch.nn.Sequential(*functions[s:s + per]), out,
                        **kwargs)
    return out
