"""``PipelineLayer`` (counterpart of paddle_tpu/distributed/fleet/
meta_parallel/pp_layers.py:21-163): ``LayerDesc``, ``SharedLayerDesc``
and the layer list split into stages by ``seg_method`` (``uniform``, or
``layer:<ClassName>`` balancing the layers of that class), with the
reference's ``segment_parts``.

One process builds every stage (LOGICAL pipeline ranks, as the
reference's single controller does): ``forward`` runs the stages in
order, handing one tensor from layer to layer. A ``SharedLayerDesc``
key builds one layer that every entry of that key reuses (tied weights
are one parameter).
"""
from __future__ import annotations

from typing import Any, List

import torch

from ....nn.layer.container import LayerList
from ....nn.layer.layers import Layer
from ..topology import get_hybrid_communicate_group

__all__ = ["LayerDesc", "PipelineLayer", "SharedLayerDesc"]


class LayerDesc:
    """A layer class and its constructor arguments (the port's
    ``device=`` / ``generator=`` among them), built by the
    ``PipelineLayer``."""

    def __init__(self, layer_func, *inputs, **kwargs):
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, torch.nn.Module)):
            raise TypeError("LayerDesc expects a Layer subclass")
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared by every entry of ``key`` (an embedding tied to
    the head); ``forward_func(layer, x)`` replaces the layer's forward
    where given."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _FnLayer(Layer):
    """A plain callable in the layer list."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


class PipelineLayer(Layer):
    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        hcg = get_hybrid_communicate_group()
        if num_stages is None:
            num_stages = hcg.get_pipe_parallel_world_size() if hcg else 1
        self._num_stages = num_stages
        self._stage_id = hcg.get_stage_id() if hcg else 0
        self._recompute_interval = recompute_interval
        self._descs = list(layers)
        shared = {}
        built: List[Any] = []
        for d in self._descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in shared:
                    shared[d.layer_name] = (d.build_layer(), d)
                built.append(shared[d.layer_name])
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            elif callable(d):
                built.append(d)
            else:
                raise TypeError(f"bad pipeline entry {d!r}")
        self._built = built
        self.shared_layers = {k: v[0] for k, v in shared.items()}
        self.run_function = LayerList(
            [l if isinstance(l, torch.nn.Module) else _FnLayer(l)
             for l in self._unwrap_built()])
        self.segment_parts = self._segment(seg_method)

    def _unwrap_built(self):
        return [b[0] if isinstance(b, tuple) else b for b in self._built]

    def _segment(self, seg_method):
        """Stage boundaries: ``uniform`` splits the entries evenly (the
        first stages take one more); ``layer:Cls`` splits the ``Cls``
        layers evenly, the entries before the first going to stage 0 and
        those after the last to the last stage."""
        n, S = len(self._built), self._num_stages
        if seg_method.startswith("layer:"):
            cls_name = seg_method.split(":")[1]
            block_idx = [i for i, l in enumerate(self._unwrap_built())
                         if type(l).__name__ == cls_name]
            per, rem = divmod(len(block_idx), S)
            parts, cursor = [0], 0
            for s in range(S):
                cursor += per + (1 if s < rem else 0)
                end = block_idx[cursor - 1] + 1 if cursor > 0 else 0
                parts.append(n if s == S - 1 else end)
            return parts
        per, rem = divmod(n, S)
        parts = [0]
        for s in range(S):
            parts.append(parts[-1] + per + (1 if s < rem else 0))
        return parts

    def get_stage_from_index(self, layer_idx):
        for s in range(self._num_stages):
            if self.segment_parts[s] <= layer_idx < \
                    self.segment_parts[s + 1]:
                return s
        return self._num_stages - 1

    def stage_layers(self, stage_id):
        lo, hi = self.segment_parts[stage_id], \
            self.segment_parts[stage_id + 1]
        return list(self.run_function)[lo:hi]

    def forward_stage(self, x, stage_id):
        lo, hi = self.segment_parts[stage_id], \
            self.segment_parts[stage_id + 1]
        for item, layer in zip(self._built[lo:hi],
                               list(self.run_function)[lo:hi]):
            if isinstance(item, tuple) and item[1].forward_func is not None:
                x = item[1].forward_func(item[0], x)
            else:
                x = layer(x)
        return x

    def forward(self, x):
        for s in range(self._num_stages):
            x = self.forward_stage(x, s)
        return x

    def loss(self, output, label):
        if self._loss_fn is None:
            return output
        return self._loss_fn(output, label)
