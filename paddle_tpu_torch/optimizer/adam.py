"""Adam and AdamW with Paddle's update (counterpart of
paddle_tpu/optimizer/adam.py), not torch's: the bias corrections fold
into the step size, ``step_size = lr * sqrt(1 - b2^t) / (1 - b1^t)``,
and ``p -= step_size * m / (sqrt(v) + eps)``; the scalars are float32,
as the JAX package computes them."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.unported import require_defaults
from .optimizer import Optimizer


class Adam(Optimizer):
    _accum_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        # lazy_mode (sparse gradients only) and use_multi_tensor (the port
        # always updates through torch._foreach ops) change nothing here,
        # as in the reference
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update(self, ps, gs, states, lr, step):
        b1, b2 = np.float32(self._beta1), np.float32(self._beta2)
        ms = [st["moment1"] for st in states]
        vs = [st["moment2"] for st in states]
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        torch._foreach_mul_(ms, float(b1))
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - self._beta1))
        torch._foreach_mul_(vs, float(b2))
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - self._beta2))
        one = np.float32(1)
        step_size = lr * np.sqrt(one - b2 ** step) / (one - b1 ** step)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, float(np.float32(self._epsilon)))
        upd = torch._foreach_mul(ms, float(step_size))
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ps, upd)


class AdamW(Adam):
    """Decoupled weight decay (Paddle's AdamW: weight_decay 0.01 on every
    parameter by default)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        # per-parameter learning-rate ratios and decay filters are not
        # ported: decay applies to every parameter
        require_defaults("AdamW", lr_ratio=(lr_ratio, None),
                         apply_decay_param_fun=(apply_decay_param_fun, None))
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         False, name)

    def _wd_mode(self):
        return "decoupled"
