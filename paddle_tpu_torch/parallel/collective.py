"""Collectives over LOGICAL ranks — the port's counterpart of the
``jax.lax`` collectives that the JAX package's SPMD regions use
(``psum``, ``pmax``, ``ppermute``) and of the all-gather / reduce-scatter
that GSPMD inserts for ZeRO.

Each function takes one tensor per rank of a group (a list, in rank
order along one mesh axis or a product of axes) and returns one tensor
per rank, each on its rank's device. Sums run in rank order on the
receiving device, so every receiver gets the same bits whatever the
placement. Between distinct devices the data moves with ``.to(device)``;
ranks on one device share it without a copy.

A group may span processes (``parallel/mesh.py``: every rank has an
owning process). The caller then passes ``owners`` (the owning process
of each rank of the group, in rank order) and hands in only the tensors
of the ranks its process owns, in rank order; it gets back the results
of those ranks. Every rank's tensor has the same shape there. The
contributions travel by one ``torch.distributed`` all-gather over the
group's processes (Gloo: one card cannot hold an NCCL group of two
ranks, and a group of distinct cards is item 10b's, which raises), and
each process then computes the result exactly as the one-process path
does, in rank order: every process's bits are equal, and equal to those
of the same ranks held by one process. ``dist.all_reduce`` is never
used, since its summation order is the backend's. A CUDA tensor for a
kind Gloo does not take on the card (``GLOO_CUDA``) is staged through
pinned host memory explicitly and counted under ``host_staged``.

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
A group spread over processes counts, in each process, the calls and
bytes of the whole group, as the one-process path does; a group that
other processes hold whole is theirs to count.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["GLOO_CUDA", "all_gather", "all_reduce", "all_to_all", "counts",
           "exchange", "pmax", "ppermute", "process_group", "psum",
           "reduce_scatter", "reset_counts", "spread"]

# always listed by counts(); the others once one was counted (so the
# dict of a step without one is what it was before that kind existed)
BASE_KINDS = ("all_reduce", "ppermute", "reduce_scatter", "all_gather")
_COUNTS: Dict[str, Dict[str, int]] = {}

# the torch.distributed calls that Gloo takes CUDA tensors for (torch
# 2.11 on an H100: each probed with two processes on one card; Gloo
# copies them through host memory inside the backend). Its send / recv
# on a CUDA tensor abort the process ("writev ... Bad address"), and it
# has no list all_to_all at all: every call not listed here is staged
# through pinned host memory, counted
GLOO_CUDA = frozenset({"all_gather", "all_reduce", "all_to_all_single",
                       "broadcast", "gather", "reduce", "reduce_scatter",
                       "scatter"})


def counts() -> Dict[str, Dict[str, int]]:
    """{kind: {"calls": n, "bytes": b}} since the last reset: always
    ``BASE_KINDS``, any other kind (``all_to_all``, the eager ops'
    kinds, ``host_staged``) only once one was counted."""
    out = {k: {"calls": 0, "bytes": 0} for k in BASE_KINDS}
    out.update({k: dict(v) for k, v in _COUNTS.items() if v["calls"]})
    return out


def reset_counts() -> None:
    _COUNTS.clear()


def count(kind, nbytes, calls=1):
    c = _COUNTS.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += calls
    c["bytes"] += int(nbytes)


def _count(kind, xs, scale=1):
    count(kind, scale * sum(x.numel() * x.element_size()
                            for x in xs if x is not None))


# -- groups that span processes ---------------------------------------
_GROUPS: Dict[tuple, object] = {}


def process_group(procs):
    """The ``torch.distributed`` group of the processes ``procs`` (the
    default group when they are the whole world), made once."""
    import torch.distributed as dist
    procs = tuple(sorted(set(int(p) for p in procs)))
    if len(procs) == dist.get_world_size():
        return dist.group.WORLD
    if procs not in _GROUPS:
        _GROUPS[procs] = dist.new_group(list(procs),
                                        use_local_synchronization=True)
    return _GROUPS[procs]


def forget_groups():
    """Drop the cached groups (after ``destroy_process_group``)."""
    _GROUPS.clear()


class Spread:
    """A group whose ranks span processes: ``owners[i]`` is rank i's
    process, ``mine`` the ranks this process holds, ``procs`` the
    group's processes in order, ``group`` their process group."""

    def __init__(self, owners, me):
        self.owners = [int(o) for o in owners]
        self.n = len(self.owners)
        self.mine = [i for i, o in enumerate(self.owners) if o == me]
        self.procs = sorted(set(self.owners))
        self.slots = max(self.owners.count(p) for p in self.procs)
        self.group = process_group(self.procs)


def spread(owners) -> Optional[Spread]:
    """None when this process holds every rank of the group (the
    one-process path), else the group's ``Spread``."""
    if owners is None:
        return None
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        if len(set(owners)) > 1:
            raise RuntimeError("a group spread over processes needs "
                               "init_parallel_env() first")
        return None
    me = dist.get_rank()
    if all(int(o) == me for o in owners):
        return None
    return Spread(owners, me)


def stage(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` as the backend takes it for ``kind``: a CUDA tensor Gloo
    does not take is copied into pinned host memory (counted)."""
    if t.device.type == "cuda" and kind not in GLOO_CUDA:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        count("host_staged", t.numel() * t.element_size())
        return h
    return t


def unstage(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` back on ``device`` (counted when it crosses from host)."""
    if t.device != torch.device(device):
        count("host_staged", t.numel() * t.element_size(), calls=0)
        return t.to(device)
    return t


def exchange(xs: Sequence[torch.Tensor], sp: Spread) -> List[torch.Tensor]:
    """Every rank's tensor of the group, in rank order, on this
    process's device: ``xs`` are this process's ranks' tensors (equal
    shapes and dtypes over the group), the rest arrive by one all-gather
    over the group's processes."""
    import torch.distributed as dist
    xs = [x.detach() for x in xs]
    x0 = xs[0]
    dev, shape = x0.device, x0.shape
    numel = x0.numel()
    for x in xs:
        if x.shape != shape or x.dtype != x0.dtype:
            raise ValueError(f"ranks of a group spread over processes "
                             f"hand in equal shapes: {tuple(x.shape)} "
                             f"{x.dtype} vs {tuple(shape)} {x0.dtype}")
    buf = torch.zeros(sp.slots * numel, dtype=x0.dtype, device=dev)
    for k, x in enumerate(xs):
        buf[k * numel:(k + 1) * numel] = x.reshape(-1)
    send = stage(buf, "all_gather")
    got = [torch.empty_like(send) for _ in sp.procs]
    dist.all_gather(got, send, group=sp.group)
    got = [unstage(g, dev) for g in got]
    out: List[Optional[torch.Tensor]] = [None] * sp.n
    seen = {p: 0 for p in sp.procs}
    for i, o in enumerate(sp.owners):
        if i in sp.mine:
            out[i] = xs[sp.mine.index(i)]
        else:
            k = seen[o]
            g = got[sp.procs.index(o)]
            out[i] = g[k * numel:(k + 1) * numel].view(shape)
        seen[o] += 1
    return out


def _local(sp, full):
    """The entries of ``full`` (one per rank) that this process holds."""
    return [full[i] for i in sp.mine]


# -- the collectives --------------------------------------------------
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


def _psum_values(xs, sp):
    if sp is None:
        return _reduce_all(xs)
    return _local(sp, _reduce_all(exchange(xs, sp)))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sp, *xs):
        ctx.sp = sp
        _count("all_reduce", xs, _scale(sp, xs))
        # distinct outputs: an autograd Function may not return one
        # tensor twice
        return tuple(s.view_as(s) for s in _psum_values(xs, sp))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        _count("all_reduce", gs, _scale(ctx.sp, gs))
        return (None,) + tuple(_psum_values(gs, ctx.sp))


def _scale(sp, xs):
    """Bytes of the whole group over those handed in (equal shapes)."""
    return 1 if sp is None else sp.n / len(xs)


def _n(xs, owners):
    return len(xs) if owners is None else len(owners)


def psum(xs: Sequence[torch.Tensor], owners=None) -> List[torch.Tensor]:
    """All-reduce (sum) over the group: every rank gets sum(xs)."""
    if _n(xs, owners) == 1:
        return list(xs)
    return list(_Psum.apply(spread(owners), *xs))


def pmax(xs: Sequence[torch.Tensor], owners=None) -> List[torch.Tensor]:
    """All-reduce (max) of values that take no gradient."""
    if _n(xs, owners) == 1:
        return [xs[0].detach()]
    sp = spread(owners)
    _count("all_reduce", xs, _scale(sp, xs))
    full = [x.detach() for x in xs] if sp is None else exchange(xs, sp)
    out = {}
    for x in full:
        if x.device not in out:
            acc = full[0].to(x.device)
            for y in full[1:]:
                acc = torch.maximum(acc, y.to(x.device))
            out[x.device] = acc
    res = [out[x.device] for x in full]
    return res if sp is None else _local(sp, res)


def all_reduce(xs: Sequence[torch.Tensor], owners=None
               ) -> List[torch.Tensor]:
    """All-reduce (sum) of values that take no gradient."""
    if _n(xs, owners) == 1:
        return list(xs)
    sp = spread(owners)
    _count("all_reduce", xs, _scale(sp, xs))
    return _psum_values([x.detach() for x in xs], sp)


def reduce_scatter(xs: Sequence[torch.Tensor], dim: int,
                   chunk_of: Sequence[int], n_chunks: int, owners=None
                   ) -> List[torch.Tensor]:
    """Sum over the group, split along ``dim`` into ``n_chunks``; rank i
    gets chunk ``chunk_of[i]`` (ranks may share a chunk: ZeRO's owners
    along 'sharding' replicated over the other axes of the group).
    Spread over processes, ``chunk_of`` still lists every rank's."""
    if _n(xs, owners) == 1:
        return [xs[0].chunk(n_chunks, dim)[chunk_of[0]].contiguous()]
    sp = spread(owners)
    _count("reduce_scatter", xs, _scale(sp, xs))
    full = [x.detach() for x in xs] if sp is None else exchange(xs, sp)
    out = {}
    for x, c in zip(full, chunk_of):
        if (x.device, c) not in out:
            out[x.device, c] = _sum_to(
                [y.chunk(n_chunks, dim)[c] for y in full],
                x.device).contiguous()
    res = [out[x.device, c] for x, c in zip(full, chunk_of)]
    return res if sp is None else _local(sp, res)


def all_gather(xs: Sequence[torch.Tensor], dim: int, owners=None
               ) -> List[torch.Tensor]:
    """Every rank gets the concatenation of xs along ``dim``."""
    if _n(xs, owners) == 1:
        return list(xs)
    sp = spread(owners)
    _count("all_gather", xs, _scale(sp, xs))
    full = list(xs) if sp is None else exchange(xs, sp)
    out = {}
    for x in full:
        if x.device not in out:
            out[x.device] = torch.cat([y.to(x.device) for y in full], dim)
    res = [out[x.device] for x in full]
    return res if sp is None else _local(sp, res)


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
             devices: Sequence[torch.device], owners=None
             ) -> List[Optional[torch.Tensor]]:
    """Send xs[src] to rank dst for each (src, dst) of ``perm`` (a
    ``jax.lax.ppermute`` permutation over the group's ranks, whose
    devices are ``devices``); a rank that receives nothing, or whose
    sender holds None (a pipeline bubble), gets None. One process holds
    the group: a pipeline's stages stay in one process."""
    if spread(owners) is not None:
        raise NotImplementedError(
            "ppermute over ranks of several processes (pipeline stages "
            "or ring-attention chunks split across processes) is not "
            "ported: keep the pp and sep axes inside one process")
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
    def forward(ctx, sp, split_dim, concat_dim, *xs):
        ctx.dims, ctx.sp = (split_dim, concat_dim), sp
        return tuple(_all_to_all(xs, split_dim, concat_dim, sp))

    @staticmethod
    def backward(ctx, *gs):
        split_dim, concat_dim = ctx.dims
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        # rank i's chunk j went to rank j's slot i: send it back
        return (None, None, None) + tuple(
            _all_to_all(gs, concat_dim, split_dim, ctx.sp))


def _all_to_all(xs, split_dim, concat_dim, sp=None):
    _count("all_to_all", xs, _scale(sp, xs))
    full = list(xs) if sp is None else exchange(xs, sp)
    n = len(full)
    chunks = [x.chunk(n, split_dim) for x in full]
    res = [None if sp is not None and j not in sp.mine else
           torch.cat([chunks[i][j].to(full[j].device) for i in range(n)],
                     concat_dim) for j in range(n)]
    return res if sp is None else _local(sp, res)


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int = 0,
               concat_dim: int = 0, owners=None) -> List[torch.Tensor]:
    """Rank i splits xs[i] along ``split_dim`` into one chunk per rank;
    rank j gets chunk j of every rank, concatenated in rank order along
    ``concat_dim``."""
    if _n(xs, owners) == 1:
        return list(xs)
    return list(_AllToAll.apply(spread(owners), split_dim, concat_dim, *xs))
