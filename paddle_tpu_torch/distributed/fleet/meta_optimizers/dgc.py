"""Deep Gradient Compression (counterpart of paddle_tpu/distributed/
fleet/meta_optimizers/dgc.py): momentum correction ``u = mu u + g``,
residual accumulation ``v += u``, and the top-k of ``|v|`` (sparsity by
the reference's ramp-up schedule) applied, ``w -= lr * v * mask``, the
applied entries cleared from ``u`` and ``v``. The algorithm, not the
compressed exchange: the port's ranks share one global gradient."""
from __future__ import annotations

import numpy as np
import torch

from ....optimizer.optimizer import Momentum


class DGCMomentum(Momentum):
    _accum_names = ["u", "v"]
    _elementwise = False

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 rampup_begin_step=0, rampup_step=1,
                 sparsity=(0.999,), grad_clip=None, name=None):
        super().__init__(learning_rate, momentum, parameters,
                         grad_clip=grad_clip, name=name)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(int(rampup_step), 1)
        self._sparsity = tuple(sparsity)

    def _current_sparsity(self):
        s = self._step_count - self._rampup_begin
        if s < 0:
            return 0.0
        idx = min(int(s * len(self._sparsity) / self._rampup_step),
                  len(self._sparsity) - 1)
        return float(self._sparsity[idx])

    def _update(self, ps, gs, states, lr, step):
        sparsity = self._current_sparsity()
        mu = float(np.float32(self._momentum))
        for q, g, st in zip(ps, gs, states):
            u, v = st["u"], st["v"]
            u.mul_(mu).add_(g.float())
            v.add_(u)
            if sparsity <= 0.0:
                q.sub_((float(lr) * v).to(q.dtype))
                v.zero_()
                continue
            k = max(int(v.numel() * (1.0 - sparsity)), 1)
            thr = torch.sort(v.abs().reshape(-1)).values[-k]
            mask = (v.abs() >= thr).float()
            q.sub_((float(lr) * (v * mask)).to(q.dtype))
            keep = 1.0 - mask
            u.mul_(keep)
            v.mul_(keep)


class DGCOptimizer:
    """Turns a user ``Momentum`` into ``DGCMomentum`` with the strategy's
    ``dgc_configs``; any other optimizer passes through."""

    def __init__(self, optimizer, strategy=None):
        self._user_opt = optimizer
        self._cfg = getattr(strategy, "dgc_configs", None) or {}

    def target_optimizer(self):
        opt = self._user_opt
        if isinstance(opt, DGCMomentum) or not isinstance(opt, Momentum):
            return opt
        return DGCMomentum(
            learning_rate=opt._lr, momentum=opt._momentum,
            parameters=opt._parameter_list,
            rampup_begin_step=self._cfg.get("rampup_begin_step", 0),
            rampup_step=self._cfg.get("rampup_step", 1),
            sparsity=self._cfg.get("sparsity", (0.999,)))
