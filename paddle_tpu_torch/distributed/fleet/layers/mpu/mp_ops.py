"""Tensor-parallel communication primitives (counterpart of
paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py:21-96), with
Megatron's adjoints over the mp group's LOGICAL ranks.

The reference's mpu layers compute the global view and let GSPMD insert
the collectives its op names stand for. Here one process holds every
rank, and the primitives are those collectives, counted as
``parallel/collective.py`` counts its own (``collective.counts()``: one
call and the bytes handed to it per use, gradients in a backward pass
included; a group of one rank moves and counts nothing). A "per-rank
list" holds one tensor per rank of the group, in rank order; sums run
in rank order.

- ``_c_identity``: a replicated tensor handed to each rank (a list of
  views); backward sums the ranks' gradients (all-reduce).
- ``_mp_allreduce``: the ranks' partials summed (all-reduce); backward
  hands every rank the output's gradient.
- ``_c_concat``: the ranks' last-dim chunks side by side (all-gather);
  backward slices the gradient.
- ``_c_split``: a replicated tensor's last dim cut into the ranks'
  chunks; backward gathers their gradients (all-gather).

The ranks of a group share one device: a group over distinct devices is
refused where the layers find their group (``mp_layers.py``).
"""
from __future__ import annotations

import torch

from .....framework.op import op_inputs
from .....parallel import collective
from .....parallel.collective import _count, _sum_to
from ...topology import get_hybrid_communicate_group

__all__ = ["_c_concat", "_c_identity", "_c_lookup_table",
           "_c_softmax_with_cross_entropy", "_c_split", "_mp_allreduce",
           "split"]


def _nranks(group):
    if group is not None:
        return group.nranks
    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_world_size() if hcg is not None else 1


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, x):
        # distinct outputs: an autograd Function may not return one
        # tensor twice
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        gs = [g for g in gs if g is not None]
        _count("all_reduce", gs)
        return None, _sum_to(gs, gs[0].device)


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.n = len(xs)
        _count("all_reduce", xs)
        return _sum_to(xs, xs[0].device)

    @staticmethod
    def backward(ctx, g):
        return (g,) * ctx.n


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.sizes = [x.shape[-1] for x in xs]
        _count("all_gather", xs)
        return torch.cat(xs, -1)

    @staticmethod
    def backward(ctx, g):
        return g.split(ctx.sizes, -1)


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, x):
        return tuple(c.view_as(c) for c in x.chunk(n, -1))

    @staticmethod
    def backward(ctx, *gs):
        _count("all_gather", gs)
        return None, torch.cat(gs, -1)


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    """``tensor`` handed to each rank of the mp group: a per-rank list of
    views. Backward: an all-reduce of the ranks' gradients."""
    n = _nranks(group)
    return [tensor] if n == 1 else list(_CIdentity.apply(n, tensor))


def _mp_allreduce(tensor, op=None, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    """The sum of a per-rank list of partials (an all-reduce; ``op`` SUM
    only). Backward: every rank gets the output's gradient."""
    if op not in (None, "sum"):
        raise NotImplementedError(f"_mp_allreduce: op={op!r} is not "
                                  f"ported (only the sum)")
    xs = list(tensor)
    return xs[0] if len(xs) == 1 else _MpAllreduce.apply(*xs)


def _c_concat(tensor, group=None):
    """A per-rank list of last-dim chunks gathered side by side (an
    all-gather). Backward: each rank's slice of the gradient."""
    xs = list(tensor)
    return xs[0] if len(xs) == 1 else _CConcat.apply(*xs)


def _c_split(tensor, group=None):
    """``tensor``'s last dim cut into the mp group's chunks (a per-rank
    list; rank r keeps chunk r). Backward: an all-gather."""
    n = _nranks(group)
    return [tensor] if n == 1 else list(_CSplit.apply(n, tensor))


def _c_lookup_table(table, index, start_index=0, name=None):
    """One rank's part of a vocab-parallel lookup: rows of ``table`` (the
    vocab rows from ``start_index``) for the ids in its range, zeros for
    the others."""
    index, table = op_inputs("embedding", index, table)
    local = index - start_index
    inside = (local >= 0) & (local < table.shape[0])
    # torch's embedding: its backward reduces the ids that fall outside
    # (all sent to row 0) as one segment, where an indexing backward
    # serializes them
    out = torch.nn.functional.embedding(torch.where(inside, local, 0), table)
    return torch.where(inside[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  return_softmax=False, ignore_index=-100):
    """Softmax cross entropy of vocab-parallel ``logits`` [..., V] (the
    ranks' vocab chunks side by side) against ``label`` [...] or
    [..., 1]: Megatron's three reductions over the group (the max, the
    sum of exponentials, the target logit), float32 under amp; [..., 1]
    losses, 0 where the label is ``ignore_index``."""
    n = _nranks(group)
    logits, label = op_inputs("c_softmax_with_cross_entropy", logits, label)
    lab = (label.squeeze(-1) if label.ndim == logits.ndim else label).long()
    xs = logits.chunk(n, -1)
    per = xs[0].shape[-1]
    maxes = collective.pmax([x.detach().amax(-1, keepdim=True) for x in xs])
    shifted = [x - m for x, m in zip(xs, maxes)]
    sumexp = _mp_allreduce([s.exp().sum(-1, keepdim=True) for s in shifted])
    targets = []
    for r, s in enumerate(shifted):
        local = (lab - r * per)[..., None]
        inside = (local >= 0) & (local < s.shape[-1])
        picked = s.gather(-1, torch.where(inside, local, 0))
        targets.append(torch.where(inside, picked, 0.0))
    loss = sumexp.log() - _mp_allreduce(targets)
    loss = torch.where(lab[..., None] == ignore_index, 0.0, loss)
    if return_softmax:
        return loss, torch.cat([s.exp() for s in shifted], -1) / sumexp
    return loss


def _parallel_linear(x, num_rows, num_cols, axis, param_attr, bias_attr,
                     gather_out, inner_rank, nranks, split_tensor, name,
                     group=None):
    from . import mp_layers
    if axis == 0:
        layer = mp_layers.RowParallelLinear(
            num_rows, num_cols, param_attr, bias_attr is not False,
            input_is_parallel=split_tensor, device=x.device)
    else:
        layer = mp_layers.ColumnParallelLinear(
            num_rows, num_cols, param_attr, bias_attr is not False,
            gather_output=gather_out, device=x.device)
    return layer(x)


def _parallel_embedding(x, per_part_embeddings, origin_size, param_attr,
                        inner_rank, num_partitions, name, group=None):
    from . import mp_layers
    layer = mp_layers.VocabParallelEmbedding(
        origin_size[0], origin_size[1], param_attr, device=x.device)
    return layer(x)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Paddle's auto-split API: a new parallel layer of ``size`` applied
    to ``x`` (its weights drawn by torch's default generator on
    ``x``'s device)."""
    if operation == "linear":
        return _parallel_linear(x, size[0], size[1], axis, weight_attr,
                                bias_attr, gather_out, 0, num_partitions,
                                axis == 0, name)
    if operation == "embedding":
        return _parallel_embedding(x, size[0] // num_partitions, size,
                                   weight_attr, 0, num_partitions, name)
    raise ValueError(f"unsupported operation {operation}")
