"""The eager collectives (counterpart of paddle_tpu/distributed/
communication/ops.py:56-308), under the reference's names and
signatures, on ``torch.Tensor``s, in place where the reference's are.

Two contexts, as in the reference:

1. One process (no process group, or a world of one): the reference's
   global view. A tensor is the value every rank of the group holds
   (replicated), so it is already synchronized: ``all_reduce``,
   ``broadcast``, ``reduce``, ``reduce_scatter`` and ``send`` / ``recv``
   leave it as it is, ``all_gather`` hands back one copy per rank. A
   list or tuple of tensors, one per rank of the group, is the port's
   form of a tensor sharded over the group (its LOGICAL shards, as
   ``parallel/collective.py`` takes them): ``all_reduce`` sums it in
   rank order (or takes the max / min / mean) and writes the result
   into every shard, ``all_gather`` gathers it.
2. Several processes (``init_parallel_env``): the reference's
   ProcessGroup semantic (``:64-128``). Each process's tensor is its
   local value. ``all_reduce`` takes SUM, AVG, MAX and MIN and keeps
   the dtype (an integer AVG is the floor of the mean); its
   contributions arrive by one all-gather and are reduced in process
   order, so every process gets the same bits. A group along one axis
   of a hybrid mesh raises (``:85-95``): its reduce differs per
   coordinate of the other axes. The other kinds are the
   ``torch.distributed`` calls of the same name over the group's
   processes (Gloo).

Every call across processes is counted in ``parallel/collective.py``'s
``counts()`` under its kind, and a CUDA tensor for a call Gloo does not
take on the card (``collective.GLOO_CUDA``) is staged through pinned
host memory, counted under ``host_staged``.
"""
from __future__ import annotations

from typing import List

import torch

from ...parallel import collective
from ...parallel import mesh as mesh_mod
from .group import Group, ReduceOp, get_world_group

__all__ = ["P2POp", "all_gather", "all_gather_object", "all_reduce",
           "all_to_all", "alltoall", "alltoall_single", "barrier",
           "batch_isend_irecv", "broadcast", "irecv", "isend", "recv",
           "reduce", "reduce_scatter", "scatter", "send", "wait"]

_OPS = (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.MAX, ReduceOp.MIN)


def _resolve(group) -> Group:
    return group if group is not None else get_world_group()


def _multi() -> bool:
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _pg(group: Group):
    """The group's process group, refusing a group along one axis of a
    hybrid mesh (the reference's :85-95)."""
    if group.axis is not None:
        m = mesh_mod._global_mesh
        if m is not None and any(v > 1 for k, v in m.shape.items()
                                 if k != group.axis):
            raise NotImplementedError(
                f"multi-process eager collective over axis {group.axis!r} "
                f"of a hybrid mesh {dict(m.shape)}: its result differs per "
                f"coordinate of the other axes; use the trainer's "
                f"collectives (parallel/collective.py) instead")
    return group.process_group


def _nbytes(t):
    return t.numel() * t.element_size()


def _reduce(vals, op):
    acc = vals[0].clone()
    for v in vals[1:]:
        if op == ReduceOp.MAX:
            acc = torch.maximum(acc, v)
        elif op == ReduceOp.MIN:
            acc = torch.minimum(acc, v)
        else:
            acc = acc + v
    if op == ReduceOp.AVG:
        n = len(vals)
        acc = (torch.div(acc, n, rounding_mode="floor")
               if not acc.is_floating_point() else acc / n)
    return acc


def _gather_procs(tensor, group: Group, kind: str) -> List[torch.Tensor]:
    """Every process's ``tensor`` of the group, in group order (one
    all-gather, counted under ``kind``)."""
    _pg(group)
    sp = collective.Spread(group.ranks, _me())
    collective.count(kind, _nbytes(tensor) * sp.n)
    return collective.exchange([tensor], sp)


def _me():
    import torch.distributed as dist
    return dist.get_rank()


def _check_op(op):
    if op not in _OPS:
        raise NotImplementedError(
            f"multi-process all_reduce op {op!r} is not supported")


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    group = _resolve(group)
    if isinstance(tensor, (list, tuple)):
        # the logical shards of one process
        _check_op(op)
        out = _reduce([t.detach() for t in tensor], op)
        for t in tensor:
            t.copy_(out)
        return tensor
    if not _multi():
        return tensor
    _check_op(op)
    if group.nranks == 1:
        return tensor
    vals = _gather_procs(tensor, group, "all_reduce")
    with torch.no_grad():
        tensor.copy_(_reduce(vals, op))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    group = _resolve(group)
    if isinstance(tensor, (list, tuple)):
        parts = [t for t in tensor]
    elif not _multi():
        parts = [tensor.clone() for _ in range(group.nranks)]
    else:
        parts = [p.clone() for p in
                 _gather_procs(tensor, group, "all_gather")]
    if tensor_list is not None:
        tensor_list.extend(parts)
    return parts


def all_gather_object(object_list, obj, group=None):
    group = _resolve(group)
    if not _multi():
        object_list.extend([obj] * group.nranks)
        return object_list
    import torch.distributed as dist
    got = [None] * group.nranks
    dist.all_gather_object(got, obj, group=_pg(group))
    collective.count("all_gather_object", 0)
    object_list.extend(got)
    return object_list


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Across processes: process i gets the reduction over every
    process's ``tensor_list[i]`` (or chunk i of ``tensor`` when no list
    is given)."""
    group = _resolve(group)
    if not _multi():
        return tensor
    _check_op(op)
    src = (torch.stack(list(tensor_list)) if tensor_list is not None
           else torch.stack(tensor.detach().chunk(group.nranks)))
    vals = _gather_procs(src, group, "reduce_scatter")
    mine = group.get_group_rank(_me())
    out = _reduce([v[mine] for v in vals], op)
    with torch.no_grad():
        if tensor_list is not None:
            tensor.copy_(out)
            return tensor
        return out


def _staged_call(kind, tensor, fn, write_back=True):
    """Run ``fn(t)`` on ``tensor`` as Gloo takes it for ``kind``
    (staged through pinned host memory where it does not take a CUDA
    tensor), copying the result back into ``tensor``."""
    collective.count(kind, _nbytes(tensor))
    t = collective.stage(tensor.detach(), kind)
    res = fn(t)
    if write_back and t.device != tensor.device:
        with torch.no_grad():
            tensor.copy_(collective.unstage(t, tensor.device))
    return res


def broadcast(tensor, src=0, group=None, sync_op=True):
    group = _resolve(group)
    if not _multi() or group.nranks == 1:
        return tensor
    import torch.distributed as dist
    _staged_call("broadcast", tensor,
                 lambda t: dist.broadcast(t, src, group=_pg(group)))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Across processes only ``dst`` gets the reduction (the others keep
    their value); in one process the reference's ``all_reduce``."""
    group = _resolve(group)
    if not _multi():
        return all_reduce(tensor, op, group, sync_op)
    _check_op(op)
    vals = _gather_procs(tensor, group, "reduce")
    if _me() == dst:
        with torch.no_grad():
            tensor.copy_(_reduce(vals, op))
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    group = _resolve(group)
    if not _multi():
        if tensor_list:
            idx = group.rank() if group.rank() >= 0 else 0
            with torch.no_grad():
                tensor.copy_(tensor_list[idx])
        return tensor
    import torch.distributed as dist
    me = _me()
    lst = None
    if me == src:
        lst = [collective.stage(t.detach().contiguous(), "scatter")
               for t in tensor_list]
    _staged_call("scatter", tensor, lambda t: dist.scatter(
        t, lst, src=src, group=_pg(group)))
    return tensor


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Across processes process j gets ``in_tensor_list[j]`` of every
    process, in process order."""
    group = _resolve(group)
    if not _multi():
        parts = list(in_tensor_list)
    else:
        mine = group.get_group_rank(_me())
        vals = _gather_procs(torch.stack(list(in_tensor_list)), group,
                             "all_to_all")
        parts = [v[mine].clone() for v in vals]
    if out_tensor_list is not None:
        out_tensor_list.extend(parts)
    return parts


all_to_all = alltoall


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Equal splits along dim 0: process j gets chunk j of every
    process's ``in_tensor``, concatenated in process order."""
    group = _resolve(group)
    if in_split_sizes or out_split_sizes:
        from ...framework.unported import require_defaults
        require_defaults("alltoall_single", in_split_sizes=(
            in_split_sizes, None), out_split_sizes=(out_split_sizes, None))
    with torch.no_grad():
        if not _multi():
            out_tensor.copy_(in_tensor)
            return out_tensor
        parts = alltoall(None, list(in_tensor.chunk(group.nranks)), group)
        out_tensor.copy_(torch.cat(parts))
    return out_tensor


def send(tensor, dst=0, group=None, sync_op=True):
    if not _multi():
        return tensor
    import torch.distributed as dist
    _staged_call("send", tensor, lambda t: dist.send(
        t, dst, group=_pg(_resolve(group))), write_back=False)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    if not _multi():
        return tensor
    import torch.distributed as dist
    _staged_call("recv", tensor, lambda t: dist.recv(
        t, src, group=_pg(_resolve(group))))
    return tensor


class _Work:
    """The handle of an ``isend`` / ``irecv``: ``wait()`` completes it
    (and puts a staged receive back into its tensor)."""

    def __init__(self, work, staged, tensor):
        self.work, self.staged, self.tensor = work, staged, tensor

    def wait(self):
        self.work.wait()
        if self.staged.device != self.tensor.device:
            with torch.no_grad():
                self.tensor.copy_(collective.unstage(self.staged,
                                                     self.tensor.device))
            self.staged = self.tensor
        return True

    def is_completed(self):
        return self.work.is_completed()


class _Done:
    def __init__(self, tensor):
        self.tensor = tensor

    def wait(self):
        return True

    def is_completed(self):
        return True


def _p2p(kind, tensor, peer, group):
    import torch.distributed as dist
    fn = dist.isend if kind == "send" else dist.irecv
    collective.count(kind, _nbytes(tensor))
    t = collective.stage(tensor.detach(), kind)
    return _Work(fn(t, peer, group=_pg(_resolve(group))), t, tensor)


def isend(tensor, dst=0, group=None):
    if not _multi():
        return _Done(tensor)
    return _p2p("send", tensor, dst, group)


def irecv(tensor, src=0, group=None):
    if not _multi():
        return _Done(tensor)
    return _p2p("recv", tensor, src, group)


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Start every ``isend`` / ``irecv`` of the list; returns their
    handles (``wait()`` each)."""
    return [p.op(p.tensor, p.peer, p.group) for p in p2p_op_list]


def barrier(group=None):
    if _multi():
        import torch.distributed as dist
        collective.count("barrier", 0)
        dist.barrier(group=_pg(_resolve(group)))
    return None


def wait(tensor, group=None, use_calc_stream=True):
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor
