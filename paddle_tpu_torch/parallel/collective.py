"""Collectives over LOGICAL ranks — the port's counterpart of the
``jax.lax`` collectives that the JAX package's SPMD regions use
(``psum``, ``pmax``, ``ppermute``) and of the all-gather / reduce-scatter
that GSPMD inserts for ZeRO.

Each function takes one tensor per rank of a group (a list, in rank
order along one mesh axis or a product of axes) and returns one tensor
per rank, each on its rank's device. Sums run in rank order on the
receiving device, so every receiver gets the same bits whatever the
placement. Between distinct devices the data moves with ``.to(device)``;
ranks on one device share it without a copy. No ``torch.distributed``:
one process holds every rank (a multi-card NCCL step is later work).

``psum``, ``ppermute`` and ``all_to_all`` are differentiable with their
true adjoints: the backward of an all-reduce is an all-reduce of the
output gradients, that of a ring shift the reverse shift, that of an
all-to-all the all-to-all with its two dimensions swapped. ``pmax``,
``all_reduce``, ``reduce_scatter`` and ``all_gather`` act on values
that take no gradient (a detached max, gradients, updated parameters).

Every call adds one to its kind's count and the bytes of the tensors it
was handed (gradients in a backward pass count too): ``counts()``,
``reset_counts()``, as ``ShardedServingCore.allreduce_count`` counts
its all-reduces. A group of one rank moves nothing and is not counted.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["all_gather", "all_reduce", "all_to_all", "counts", "pmax",
           "ppermute", "psum", "reduce_scatter", "reset_counts"]

KINDS = ("all_reduce", "ppermute", "reduce_scatter", "all_gather",
         "all_to_all")
_COUNTS = {k: {"calls": 0, "bytes": 0} for k in KINDS}


def counts() -> Dict[str, Dict[str, int]]:
    """{kind: {"calls": n, "bytes": b}} since the last reset: always the
    first four kinds, ``all_to_all`` only once one was counted (so the
    dict of a step without one is what it was before that kind)."""
    return {k: dict(v) for k, v in _COUNTS.items()
            if k != "all_to_all" or v["calls"]}


def reset_counts() -> None:
    for v in _COUNTS.values():
        v["calls"] = v["bytes"] = 0


def _count(kind, xs):
    _COUNTS[kind]["calls"] += 1
    _COUNTS[kind]["bytes"] += sum(x.numel() * x.element_size()
                                  for x in xs if x is not None)


def _sum_to(xs, device):
    """xs[0] + xs[1] + ... in rank order, on ``device``."""
    acc = xs[0].to(device)
    for x in xs[1:]:
        acc = acc + x.to(device)
    return acc


def _reduce_all(xs):
    """The rank-order sum, once per distinct device, handed to every
    rank on its device."""
    sums = {}
    return [sums.setdefault(x.device, _sum_to(xs, x.device)) for x in xs]


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        _count("all_reduce", xs)
        # distinct outputs: an autograd Function may not return one
        # tensor twice
        return tuple(s.view_as(s) for s in _reduce_all(xs))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        _count("all_reduce", gs)
        return tuple(_reduce_all(gs))


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce (sum) over the group: every rank gets sum(xs)."""
    if len(xs) == 1:
        return list(xs)
    return list(_Psum.apply(*xs))


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce (max) of values that take no gradient."""
    if len(xs) == 1:
        return [xs[0].detach()]
    _count("all_reduce", xs)
    out = {}
    for x in xs:
        if x.device not in out:
            acc = xs[0].detach().to(x.device)
            for y in xs[1:]:
                acc = torch.maximum(acc, y.detach().to(x.device))
            out[x.device] = acc
    return [out[x.device] for x in xs]


def all_reduce(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce (sum) of values that take no gradient."""
    if len(xs) == 1:
        return list(xs)
    _count("all_reduce", xs)
    return _reduce_all([x.detach() for x in xs])


def reduce_scatter(xs: Sequence[torch.Tensor], dim: int,
                   chunk_of: Sequence[int], n_chunks: int
                   ) -> List[torch.Tensor]:
    """Sum over the group, split along ``dim`` into ``n_chunks``; rank i
    gets chunk ``chunk_of[i]`` (ranks may share a chunk: ZeRO's owners
    along 'sharding' replicated over the other axes of the group)."""
    if len(xs) == 1:
        return [xs[0].chunk(n_chunks, dim)[chunk_of[0]].contiguous()]
    _count("reduce_scatter", xs)
    out = {}
    for x, c in zip(xs, chunk_of):
        if (x.device, c) not in out:
            out[x.device, c] = _sum_to(
                [y.detach().chunk(n_chunks, dim)[c] for y in xs],
                x.device).contiguous()
    return [out[x.device, c] for x, c in zip(xs, chunk_of)]


def all_gather(xs: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """Every rank gets the concatenation of xs along ``dim``."""
    if len(xs) == 1:
        return list(xs)
    _count("all_gather", xs)
    out = {}
    for x in xs:
        if x.device not in out:
            out[x.device] = torch.cat([y.to(x.device) for y in xs], dim)
    return [out[x.device] for x in xs]


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, perm, devices, *xs):
        ctx.perm, ctx.src_devices = perm, [x.device for x in xs]
        _count("ppermute", xs)
        # a view: an autograd Function hands out new tensor objects
        return tuple(x.to(devices[dst]).view_as(x)
                     for x, (_, dst) in zip(xs, perm))

    @staticmethod
    def backward(ctx, *gs):
        live = [g for g in gs if g is not None]
        _count("ppermute", live)
        return (None, None) + tuple(
            None if g is None else g.to(dev)
            for g, dev in zip(gs, ctx.src_devices))


def ppermute(xs: Sequence[Optional[torch.Tensor]], perm,
             devices: Sequence[torch.device]
             ) -> List[Optional[torch.Tensor]]:
    """Send xs[src] to rank dst for each (src, dst) of ``perm`` (a
    ``jax.lax.ppermute`` permutation over the group's ranks, whose
    devices are ``devices``); a rank that receives nothing, or whose
    sender holds None (a pipeline bubble), gets None."""
    pairs = [(s, d) for s, d in perm if xs[s] is not None]
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    if not pairs:
        return out
    got = _Ppermute.apply(pairs, list(devices), *[xs[s] for s, _ in pairs])
    for (_, d), y in zip(pairs, got):
        out[d] = y
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, concat_dim, *xs):
        ctx.dims = (split_dim, concat_dim)
        return tuple(_all_to_all(xs, split_dim, concat_dim))

    @staticmethod
    def backward(ctx, *gs):
        split_dim, concat_dim = ctx.dims
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        # rank i's chunk j went to rank j's slot i: send it back
        return (None, None) + tuple(_all_to_all(gs, concat_dim, split_dim))


def _all_to_all(xs, split_dim, concat_dim):
    _count("all_to_all", xs)
    n = len(xs)
    chunks = [x.chunk(n, split_dim) for x in xs]
    return [torch.cat([chunks[i][j].to(xs[j].device) for i in range(n)],
                      concat_dim) for j in range(n)]


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int = 0,
               concat_dim: int = 0) -> List[torch.Tensor]:
    """Rank i splits xs[i] along ``split_dim`` into one chunk per rank;
    rank j gets chunk j of every rank, concatenated in rank order along
    ``concat_dim``."""
    if len(xs) == 1:
        return list(xs)
    return list(_AllToAll.apply(split_dim, concat_dim, *xs))
