"""Tensor-parallel layers (counterpart of paddle_tpu/distributed/fleet/
layers/mpu/mp_layers.py: ``VocabParallelEmbedding`` :43,
``ColumnParallelLinear`` :73, ``RowParallelLinear`` :111,
``ParallelCrossEntropy`` :151).

The reference's global view, computed rank by rank. Each layer holds
its FULL logical weight as one parameter (``state_dict``, gradient
shapes and checkpoints are the reference's); rank r's shard is a view,
``chunk(mp)[r]`` along the sharded dim (``local_shape``). The forward
runs the Megatron pairing over the mp group's logical ranks with the
counted collectives of ``mp_ops.py``, and returns the reference's
global value:

- ``ColumnParallelLinear``: one product per rank on its column shard;
  the ranks' outputs side by side along the last dim (an all-gather
  with ``gather_output``); the input's ``_c_identity`` all-reduces the
  ranks' input gradients in the backward.
- ``RowParallelLinear``: each rank's slice of the input's last dim
  against its row shard, the partial products summed in rank order (an
  all-reduce), the bias added once after it.
- ``VocabParallelEmbedding``: each rank looks up the ids of its vocab
  range (zeros elsewhere); the all-reduce adds one non-zero term to
  zeros, so the result is the plain lookup exactly.
- ``ParallelCrossEntropy``: Megatron's three reductions on
  vocab-parallel logits, [N, 1] losses.

The group is the installed HybridCommunicateGroup's mp row of the mesh
(``fleet.init``); one rank, and no group, without it. Its ranks must
share one device: an mp row over distinct cards raises
NotImplementedError (ROADMAP Queue A item 10b's machine, two or more
cards, is where that path would be written and checked). Parameters are
drawn by ``generator`` (a CPU torch.Generator; torch's default one when
None) on the group's device.
"""
from __future__ import annotations

import torch

from .....device import resolve_device
from .....nn import functional as F
from .....nn import initializer as I
from .....nn.layer.layers import Layer
from .....parallel import mesh as mesh_mod
from ...topology import get_hybrid_communicate_group
from .mp_ops import (_c_concat, _c_identity, _c_lookup_table,
                     _c_softmax_with_cross_entropy, _c_split, _mp_allreduce)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


def _same_device(a, b):
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _mp_group(device=None):
    """(mp ranks, their device): the installed topology's mp row of the
    mesh, or one rank on ``device`` (``cuda`` unless named)."""
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_model_parallel_world_size() == 1:
        return 1, resolve_device(device)
    coord = (hcg.get_data_parallel_rank(), hcg.get_pipe_parallel_rank(),
             hcg.get_sharding_parallel_rank(), hcg.get_sep_parallel_rank())
    row = list(mesh_mod.get_mesh().devices[coord])
    if any(not _same_device(d, row[0]) for d in row):
        raise NotImplementedError(
            f"an mp group over distinct devices {row} is not ported: the "
            "mpu layers run the mp ranks as logical ranks of one device "
            "(ROADMAP Queue A item 10b's machine, two or more cards)")
    if device is not None and not _same_device(resolve_device(device),
                                               row[0]):
        raise ValueError(f"device {device} is not the mp group's "
                         f"device {row[0]}")
    return len(row), row[0]


class VocabParallelEmbedding(Layer):
    """Embedding with the vocab dim sharded over 'mp' (Xavier-normal
    weight [num_embeddings, embedding_dim], as the reference's)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, generator=None):
        world_size, dev = _mp_group(device)
        super().__init__(device=dev, generator=generator)
        self.world_size = world_size
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        assert num_embeddings % self.world_size == 0, \
            "vocab size must divide mp degree"
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal())

    @property
    def local_shape(self):
        return [self._num_embeddings // self.world_size, self._embedding_dim]

    def forward(self, x):
        per = self._num_embeddings // self.world_size
        return _mp_allreduce([
            _c_lookup_table(w, x, start_index=r * per)
            for r, w in enumerate(self.weight.chunk(self.world_size, 0))])


class ColumnParallelLinear(Layer):
    """Linear with ``out_features`` sharded over 'mp'. With
    ``gather_output=False`` the output is the ranks' column blocks side
    by side, what a following ``RowParallelLinear(input_is_parallel=
    True)`` takes (the Megatron pairing)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, generator=None):
        world_size, dev = _mp_group(device)
        super().__init__(device=dev, generator=generator)
        self.world_size = world_size
        self._in_features = in_features
        self._out_features = out_features
        self.gather_output = gather_output
        assert out_features % self.world_size == 0
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = None
        if has_bias or has_bias is None:
            self.bias = self.create_parameter([out_features], attr=None,
                                              is_bias=True)

    @property
    def local_shape(self):
        return [self._in_features, self._out_features // self.world_size]

    def forward(self, x):
        n = self.world_size
        ws = self.weight.chunk(n, 1)
        bs = self.bias.chunk(n) if self.bias is not None else [None] * n
        ys = [F.linear(xr, w, b) for xr, w, b in zip(_c_identity(x), ws, bs)]
        return _c_concat(ys) if self.gather_output else torch.cat(ys, -1)


class RowParallelLinear(Layer):
    """Linear with ``in_features`` sharded over 'mp'; the partial
    products meet in an all-reduce. With ``input_is_parallel=False``
    the replicated input is split first (``_c_split``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, generator=None):
        world_size, dev = _mp_group(device)
        super().__init__(device=dev, generator=generator)
        self.world_size = world_size
        self._in_features = in_features
        self._out_features = out_features
        self.input_is_parallel = input_is_parallel
        assert in_features % self.world_size == 0
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter([out_features], attr=None,
                                              is_bias=True)

    @property
    def local_shape(self):
        return [self._in_features // self.world_size, self._out_features]

    def forward(self, x):
        n = self.world_size
        xs = x.chunk(n, -1) if self.input_is_parallel else _c_split(x)
        out = _mp_allreduce([F.linear(xr, w) for xr, w in
                             zip(xs, self.weight.chunk(n, 0))])
        return out if self.bias is None else out + self.bias.to(out.dtype)


class ParallelCrossEntropy(Layer):
    """Softmax cross entropy over vocab-parallel logits, [N, 1] losses
    (``mp_ops._c_softmax_with_cross_entropy``)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return _c_softmax_with_cross_entropy(input, label,
                                             ignore_index=self.ignore_index)
