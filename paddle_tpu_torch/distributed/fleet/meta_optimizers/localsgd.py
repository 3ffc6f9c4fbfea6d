"""Local SGD (counterpart of paddle_tpu/distributed/fleet/
meta_optimizers/localsgd.py): the inner optimizer steps, and every
``k_steps`` steps the parameters are averaged over the data-parallel
ranks. The port's ranks are logical ranks of one process holding one
value of each parameter (as the reference's single controller does),
so the average is the parameter itself and moves nothing."""
from __future__ import annotations


class LocalSGDOptimizer:
    def __init__(self, inner_optimizer, k_steps=1, begin_step=1):
        self._inner_opt = inner_optimizer
        self.k_steps = int(k_steps)
        self._begin = int(begin_step)
        self._count = 0

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)

    def step(self):
        # every k_steps from begin_step the dp ranks would average: the
        # one logical value is its own average
        self._inner_opt.step()
        self._count += 1

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
