"""Gradient merge (counterpart of paddle_tpu/distributed/fleet/
meta_optimizers/gradient_merge.py): gradients accumulate in ``.grad``
over ``k_steps`` calls (torch adds each backward into it); the k-th
``step`` divides them by k when ``avg`` and steps the inner optimizer,
and only then does ``clear_grad`` clear them."""
from __future__ import annotations

import torch


class GradientMergeOptimizer:
    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self._inner_opt = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg
        self._count = 0

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)

    def _is_boundary(self):
        return self._count % self.k_steps == 0

    @torch.no_grad()
    def step(self):
        self._count += 1
        if not self._is_boundary():
            return
        if self.avg and self.k_steps > 1:
            for p in self._inner_opt._parameter_list:
                if p.grad is not None:
                    p.grad.mul_(1.0 / self.k_steps)
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        if self._is_boundary():
            self._inner_opt.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
