"""fp32 main-grad accumulation for bf16 training (counterpart of
paddle_tpu/distributed/fleet/utils/mix_precision_utils.py).

``MixPrecisionLayer`` casts the wrapped layer's floating parameters to
``dtype`` and hooks each one so every backward adds its gradient, in
float32, into ``param.main_grad`` (``.grad`` keeps torch's own
accumulation). ``MixPrecisionOptimizer`` turns on the wrapped
optimizer's fp32 masters and has it update from ``main_grad``.
"""
from __future__ import annotations

import torch

from ....framework.dtype import convert_dtype
from ....nn.layer.layers import Layer

__all__ = ["MixPrecisionLayer", "MixPrecisionOptimizer"]


class MixPrecisionLayer(Layer):
    def __init__(self, layers, dtype="bfloat16"):
        super().__init__()
        self._layers = layers
        self._dtype = convert_dtype(dtype)
        for p in layers.parameters():
            if p.is_floating_point() and p.dtype != self._dtype:
                p.data = p.data.to(self._dtype)
            p.main_grad = None
            p.register_hook(lambda grad, param=p: _accumulate(param, grad))

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)


def _accumulate(param, grad):
    g32 = grad.detach().float()
    if param.main_grad is None:
        param.main_grad = g32
    else:
        param.main_grad.add_(g32)
    return grad


class MixPrecisionOptimizer:
    def __init__(self, optimizer):
        self._inner_opt = optimizer
        optimizer._multi_precision = True
        optimizer._use_main_grad = True

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)
        for p in self._inner_opt._parameter_list:
            p.main_grad = None

    clear_gradients = clear_grad
