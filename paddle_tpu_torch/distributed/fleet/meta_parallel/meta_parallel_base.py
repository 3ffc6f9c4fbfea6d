"""MetaParallelBase and the tensor- and sharding-parallel wrappers
(counterpart of paddle_tpu/distributed/fleet/meta_parallel/
meta_parallel_base.py:1-53).

A wrapper holds the user's model and hands its calls, parameters and
state dict through unchanged. The mpu layers place nothing (each holds
its full logical weight and computes the reference's global value), so
``TensorParallel`` has nothing to broadcast or re-place either.
"""
from __future__ import annotations

from ....nn.layer.layers import Layer


class MetaParallelBase(Layer):
    def __init__(self, layers, hcg, strategy):
        super().__init__()
        self._layers_holder = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *args, **kwargs):
        return self._layers_holder(*args, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self._layers_holder.named_parameters(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers_holder.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        return self._layers_holder.load_state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers_holder.set_state_dict(*args, **kwargs)

    set_dict = set_state_dict
    load_dict = set_state_dict


class TensorParallel(MetaParallelBase):
    pass


class ShardingParallel(MetaParallelBase):
    pass
