"""``TrainStep`` (counterpart of paddle_tpu/parallel/train_step.py:24-158):
forward, loss, backward and the optimizer's update as one call over a
layer and a port optimizer.

A call runs ``loss_fn(layer, *batch)`` (or ``layer(*batch)``, its first
output when it returns several), back-propagates the loss and, every
``grad_accum_steps`` calls, applies the optimizer's update rule to the
accumulated gradients (divided by the count when ``grad_accum_avg``),
as the reference's compiled step and its accumulate/apply pair do. The
update runs on the parameters themselves, in their dtype, with the
optimizer's states (the reference's step hands its fused update the
parameter arrays, no fp32 masters). The step runs eagerly on the
layer's device; the parameters are the layer's own tensors, so
``sync_to_layer`` has nothing to copy (it keeps the optimizer's step
count). ``batch_spec``, ``donate`` and ``remat`` shape the reference's
compiled program and are accepted.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, layer, optimizer, loss_fn: Optional[Callable] = None,
                 batch_spec: Optional[list] = None, donate: bool = True,
                 remat: bool = False, grad_accum_steps: int = 1,
                 grad_accum_avg: bool = True):
        self.layer = layer
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.batch_spec = batch_spec
        self.donate = donate
        self.remat = remat
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        self.grad_accum_avg = bool(grad_accum_avg)
        self._params = [p for _, p in layer.named_parameters()
                        if p.requires_grad]
        # the optimizer's states for these parameters (no masters: the
        # update runs on the parameters)
        self._states = []
        for p in self._params:
            st = optimizer._accumulators.get(p)
            if st is None:
                st = optimizer._accumulators[p] = optimizer._init_state(p)
            self._states.append(st)
        self._stepno = 0
        self._opt_steps = 0

    def _loss(self, batch):
        out = (self.loss_fn(self.layer, *batch) if self.loss_fn is not None
               else self.layer(*batch))
        if isinstance(out, (tuple, list)):
            out = out[0]
        return out

    @torch.no_grad()
    def _apply(self):
        opt = self.optimizer
        k = self.grad_accum_steps
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in self._params]
        if self.grad_accum_avg and k > 1:
            gs = torch._foreach_div(gs, float(k))
        self._opt_steps += 1
        step_count = opt._step_count
        opt._step_count = self._opt_steps
        opt._update_lists(self._params, list(self._params), gs,
                          self._states)
        opt._step_count = step_count
        for p in self._params:
            p.grad = None

    def __call__(self, *batch):
        loss = self._loss(batch)
        loss.backward()
        self._stepno += 1
        if self._stepno % self.grad_accum_steps == 0:
            self._apply()
        return loss.detach()

    def sync_to_layer(self):
        """The layer already holds the trained tensors; the optimizer
        takes the step count."""
        self.optimizer._step_count = self._opt_steps
