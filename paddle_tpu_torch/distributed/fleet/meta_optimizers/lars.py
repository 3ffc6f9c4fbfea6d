"""LARS (counterpart of paddle_tpu/distributed/fleet/meta_optimizers/
lars.py): Layer-wise Adaptive Rate Scaling momentum,
``local_lr = lr * coeff * ||w|| / (||g|| + wd ||w|| + eps)`` (1 where a
norm is 0), ``v = mu v + local_lr (g + wd w)``, ``w -= v``, in float32,
per parameter (its norms read the whole parameter)."""
from __future__ import annotations

import numpy as np
import torch

from ....framework.io import tensor_name
from ....optimizer.optimizer import Momentum


class LarsMomentum(Momentum):
    _elementwise = False

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, exclude_from_weight_decay=None,
                 epsilon=1e-9, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, momentum, parameters,
                         grad_clip=grad_clip,
                         multi_precision=multi_precision, name=name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._exclude = exclude_from_weight_decay or []
        self._eps = epsilon

    def _wd_for_param(self, p):
        name = tensor_name(p)
        if any(tag in name for tag in self._exclude):
            return 0.0
        return self._lars_wd

    def _update_lists(self, params, ps, gs, states):
        f32 = np.float32
        lr, mu = f32(self._lr), f32(self._momentum)
        coeff, eps = f32(self._lars_coeff), f32(self._eps)
        for p, q, g, st in zip(params, ps, gs, states):
            wd = f32(self._wd_for_param(p))
            g32, p32 = g.float(), q.float()
            p_norm = p32.square().sum().sqrt()
            g_norm = g32.square().sum().sqrt()
            trust = torch.where((p_norm > 0) & (g_norm > 0),
                                coeff * p_norm / (g_norm + wd * p_norm + eps),
                                torch.ones_like(p_norm))
            v = st["velocity"]
            v.mul_(float(mu)).add_(lr * trust * (g32 + float(wd) * p32))
            q.copy_(p32 - v)


class LarsOptimizer:
    """Turns a user ``Momentum`` into ``LarsMomentum`` with its
    hyperparameters and the strategy's ``lars_configs``; any other
    optimizer passes through, as in the reference."""

    def __init__(self, optimizer, strategy=None):
        self._user_opt = optimizer
        self._cfg = getattr(strategy, "lars_configs", None) or {}

    def target_optimizer(self):
        opt = self._user_opt
        if isinstance(opt, LarsMomentum) or not isinstance(opt, Momentum):
            return opt
        return LarsMomentum(
            learning_rate=opt._lr, momentum=opt._momentum,
            parameters=opt._parameter_list,
            lars_coeff=self._cfg.get("lars_coeff", 0.001),
            lars_weight_decay=self._cfg.get("lars_weight_decay", 0.0005),
            exclude_from_weight_decay=self._cfg.get(
                "exclude_from_weight_decay", None),
            epsilon=self._cfg.get("epsilon", 1e-9))
