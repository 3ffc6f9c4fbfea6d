"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

``step()`` updates every parameter that requires a gradient and has one
(a parameter without a gradient is skipped, its state untouched), in
place, through ``_update`` over the lists of parameters, gradients and
states (``torch._foreach_*`` ops: a few launches per step, not a few per
parameter). Decay: ``grad`` mode adds ``wd * p`` to the gradient;
``decoupled`` mode (AdamW) subtracts ``lr * wd * p_old`` after the
update. With ``multi_precision`` a low-precision parameter is updated
through an fp32 master copy and then rounded into place.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..framework.unported import require_defaults


class Optimizer:
    _accum_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        # gradient clipping is not ported; ``name`` is accepted and unused
        require_defaults(type(self).__name__, grad_clip=(grad_clip, None))
        self._lr = float(learning_rate)
        self._parameter_list = list(parameters) if parameters is not None \
            else []
        self._wd = 0.0 if weight_decay is None else float(weight_decay)
        self._multi_precision = multi_precision
        self._accumulators: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        self._master_weights: Dict[torch.Tensor, torch.Tensor] = {}
        self._step_count = 0

    def get_lr(self) -> float:
        return self._lr

    def _wd_mode(self):
        return "grad"

    def _state(self, p):
        st = self._accumulators.get(p)
        if st is None:
            st = {name: torch.zeros_like(p, dtype=torch.float32)
                  for name in self._accum_names}
            self._accumulators[p] = st
            if self._multi_precision and p.dtype != torch.float32:
                self._master_weights[p] = p.detach().float()
        return st

    def _update(self, ps, gs, states, lr, step):
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        if not params:
            return
        self._step_count += 1
        states = [self._state(p) for p in params]
        ps = [self._master_weights.get(p, p) for p in params]
        gs = [p.grad if p.grad.dtype == q.dtype else p.grad.to(q.dtype)
              for p, q in zip(params, ps)]
        lr = np.float32(self._lr)
        wd = np.float32(self._wd)
        mode = self._wd_mode()
        if wd and mode == "grad":
            gs = torch._foreach_add(gs, ps, alpha=float(wd))
        decay = (torch._foreach_mul(ps, float(lr * wd))
                 if wd and mode == "decoupled" else None)
        self._update(ps, gs, states, lr, np.float32(self._step_count))
        if decay is not None:
            torch._foreach_sub_(ps, decay)
        for p, q in zip(params, ps):
            if q is not p:
                p.copy_(q)

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None
