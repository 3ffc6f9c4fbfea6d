"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py),
``SGD`` and ``Momentum``.

``step()`` updates every parameter that requires a gradient and has one
(a parameter without a gradient is skipped, its state untouched), in
place, through ``_update`` over the lists of parameters, gradients and
states (``torch._foreach_*`` ops: a few launches per step, not a few per
parameter). Decay: ``grad`` mode adds ``wd * p`` to the gradient;
``decoupled`` mode (AdamW) subtracts ``lr * wd * p_old`` after the
update. With ``multi_precision`` a low-precision parameter is updated
through an fp32 master copy and then rounded into place.

States are keyed by the parameter object; ``state_dict()`` names them as
the reference does, ``<param name>_<accumulator>`` with the masters
under ``master_weights`` and the step under ``global_step``, where a
parameter's name is its ``param_name`` (a generated
``generated_tensor_<n>`` when it has none, ``framework/io.py``). So a
state dict crosses between the packages once the parameters carry the
same names (``weights.carry_param_names``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..framework.io import tensor_name
from ..framework.unported import require_defaults

__all__ = ["Momentum", "Optimizer", "SGD"]


def _as_tensor(v):
    """A state-dict value as a torch tensor (torch, numpy, or anything
    with ``.numpy()``, such as a JAX package Tensor)."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    from ..framework.io import from_numpy
    return from_numpy(v.numpy() if hasattr(v, "numpy") else v)


class Optimizer:
    _accum_names: List[str] = []
    # the update reads each element alone, so it runs on chunks of a
    # parameter (ZeRO shards); LARS and DGC read whole parameters
    _elementwise = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        # gradient clipping is not ported; ``name`` is accepted and unused
        require_defaults(type(self).__name__, grad_clip=(grad_clip, None))
        self._lr = float(learning_rate)
        self._grad_clip = grad_clip
        self._parameter_list = list(parameters) if parameters is not None \
            else []
        self._wd = 0.0 if weight_decay is None else float(weight_decay)
        self._multi_precision = multi_precision
        self._accumulators: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        self._master_weights: Dict[torch.Tensor, torch.Tensor] = {}
        self._step_count = 0
        # MixPrecisionOptimizer: update from each parameter's fp32
        # ``main_grad`` where it has one
        self._use_main_grad = False

    # -- learning rate -------------------------------------------------------
    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value):
        self._lr = float(value)

    def _wd_mode(self):
        return "grad"

    # -- states --------------------------------------------------------------
    def _init_state(self, p) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros_like(p, dtype=torch.float32)
                for name in self._accum_names}

    def _needs_master(self, p) -> bool:
        return self._multi_precision and p.dtype != torch.float32

    def _state(self, p):
        st = self._accumulators.get(p)
        if st is None:
            st = self._init_state(p)
            self._accumulators[p] = st
            if self._needs_master(p):
                self._master_weights[p] = p.detach().float()
        return st

    def _grad(self, p):
        if self._use_main_grad:
            mg = getattr(p, "main_grad", None)
            if mg is not None:
                return mg
        return p.grad

    # -- the update ----------------------------------------------------------
    def _update(self, ps, gs, states, lr, step):
        raise NotImplementedError

    def _prepare_step(self):
        """The parameters this step updates (the step counted), or None
        when none has a gradient."""
        params = [p for p in self._parameter_list
                  if p.requires_grad and self._grad(p) is not None]
        if not params:
            return None
        self._step_count += 1
        return params

    def _update_lists(self, params, ps, gs, states):
        """One update of the values ``ps`` (fp32 masters or the
        parameters, or shards of them) from ``gs`` in place, decay
        included; ``params`` are the parameters they belong to."""
        lr = np.float32(self._lr)
        wd = np.float32(self._wd)
        mode = self._wd_mode()
        gs = [g if g.dtype == q.dtype else g.to(q.dtype)
              for g, q in zip(gs, ps)]
        if wd and mode == "grad":
            gs = torch._foreach_add(gs, ps, alpha=float(wd))
        decay = (torch._foreach_mul(ps, float(lr * wd))
                 if wd and mode == "decoupled" else None)
        self._update(ps, gs, states, lr, np.float32(self._step_count))
        if decay is not None:
            torch._foreach_sub_(ps, decay)

    @torch.no_grad()
    def step(self):
        params = self._prepare_step()
        if params is None:
            return
        states = [self._state(p) for p in params]
        ps = [self._master_weights.get(p, p) for p in params]
        self._update_lists(params, ps, [self._grad(p) for p in params],
                           states)
        for p, q in zip(params, ps):
            if q is not p:
                p.copy_(q)

    def prebuild_fused(self):
        """Make every trainable parameter's states (and masters) now, so
        the first step allocates none. The reference compiles its fused
        update here; the port's update is eager."""
        for p in self._parameter_list:
            if p.requires_grad:
                self._state(p)

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()`` (dygraph's minimize)."""
        require_defaults(f"{type(self).__name__}.minimize",
                         startup_program=(startup_program, None),
                         parameters=(parameters, None),
                         no_grad_set=(no_grad_set, None))
        loss.backward()
        self.step()
        return [], []

    def backward(self, loss, **kw):
        loss.backward()

    def apply_gradients(self, params_grads):
        """Set each parameter's gradient, then ``step()``."""
        for p, g in params_grads:
            p.grad = g
        self.step()

    # -- checkpoint ----------------------------------------------------------
    def state_dict(self):
        """Copies of the states under the reference's keys."""
        out = {}
        for p, st in self._accumulators.items():
            for k, v in st.items():
                out[f"{tensor_name(p)}_{k}"] = v.detach().clone()
        out["global_step"] = self._step_count
        if self._master_weights:
            out["master_weights"] = {
                tensor_name(p): v.detach().clone()
                for p, v in self._master_weights.items()}
        return out

    def set_state_dict(self, state):
        """Load ``state`` (this package's or the JAX package's
        ``state_dict()``) onto the parameters by name, each state on its
        parameter's device."""
        state = dict(state)
        self._step_count = int(state.pop("global_step", 0))
        state.pop("LR_Scheduler", None)
        masters = state.pop("master_weights", None) or {}
        for p in self._parameter_list:
            name = tensor_name(p)
            st = {}
            for acc in self._accum_names:
                key = f"{name}_{acc}"
                if key in state:
                    st[acc] = _as_tensor(state[key]).to(
                        p.device, torch.float32).clone()
            if st:
                self._accumulators[p] = st
            if name in masters:
                self._master_weights[p] = _as_tensor(masters[name]).to(
                    p.device, torch.float32).clone()

    set_dict = set_state_dict


class SGD(Optimizer):
    """``p -= lr * g``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update(self, ps, gs, states, lr, step):
        torch._foreach_sub_(ps, torch._foreach_mul(gs, float(lr)))


class Momentum(Optimizer):
    """``v = mu v + g``; ``p -= lr * v`` (Nesterov: ``lr * (g + mu v)``),
    the velocity in float32."""

    _accum_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, ps, gs, states, lr, step):
        vs = [st["velocity"] for st in states]
        g32 = [g.float() for g in gs]
        torch._foreach_mul_(vs, float(np.float32(self._momentum)))
        torch._foreach_add_(vs, g32)
        upd = (torch._foreach_add(g32, torch._foreach_mul(
            vs, float(np.float32(self._momentum))))
            if self._nesterov else vs)
        torch._foreach_sub_(ps, torch._foreach_mul(upd, float(lr)))
