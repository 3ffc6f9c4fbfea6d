"""Dynamic loss scaling (the port's copy of
``paddle_tpu/amp/grad_scaler.py``).

The scale, the ``incr``/``decr`` counting, ``minimize``/``step``/
``update`` and the ``state_dict`` keys are the reference's. The
reference reads ``found_inf`` once per parameter (``:62-66``); here one
``unscale_`` divides every gradient by the scale with ``torch._foreach``
ops and reads one device flag, so the same gradients give the same
sequence of scales and skipped steps.
"""
from __future__ import annotations

import enum

import torch

__all__ = ["AmpScaler", "GradScaler", "OptimizerState"]


class OptimizerState(enum.Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._optimizer_states = {}

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _unscale(self, optimizer):
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        found = False
        if grads:
            with torch.no_grad():
                torch._foreach_div_(grads, self._scale)
                peaks = torch._foreach_norm(grads, float("inf"))
                found = not bool(torch.stack(
                    [t.float() for t in peaks]).isfinite().all())
        self._found_inf = found
        self._optimizer_states[id(optimizer)] = OptimizerState.UNSCALED

    def unscale_(self, optimizer):
        return self._unscale(optimizer)

    def minimize(self, optimizer, loss, *args, **kwargs):
        if not self._enable:
            # the reference's optimizer.minimize(loss): backward, then step
            loss.backward()
            optimizer.step()
            return
        if self._optimizer_states.get(id(optimizer)) != \
                OptimizerState.UNSCALED:
            self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update()
        self._optimizer_states[id(optimizer)] = OptimizerState.INIT
        optimizer.clear_grad()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._optimizer_states.get(id(optimizer)) != \
                OptimizerState.UNSCALED:
            self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._optimizer_states[id(optimizer)] = OptimizerState.STEPPED

    def update(self):
        if not self._enable:
            return
        self._update()
        self._optimizer_states = {}

    def _update(self):
        if not self._use_dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
            "use_dynamic_loss_scaling": self._use_dynamic,
        }

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


class GradScaler(AmpScaler):
    """The public name (``paddle.amp.GradScaler``)."""

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)
