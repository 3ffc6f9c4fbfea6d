"""Mixture-of-Experts training layer (the port's own copy of
``paddle_tpu/incubate/moe.py``): the capacity utilities, the naive,
GShard and Switch gates with their aux losses, ``ExpertFFN`` and
``MoELayer`` with the GShard dense dispatch (per-slot capacity offsets,
``:191-214``), the generic-experts path (``:251-266``) and ``gate``
given as a dict.

On one device: the reference's expert-parallel axis (``ep_axis``) and
``moe_group`` need a mesh and are not ported (a value other than the
defaults raises). The expert products are plain ``einsum`` over stacked
weights, as the JAX package computes them outside any Pallas kernel
(``:290-302``). The routing equals the reference's exactly: its
``jax.lax.top_k`` breaks ties toward the lower expert index, which a
stable descending sort gives here (``torch.topk`` promises no order
among ties). The gates' aux losses and the layer go through the
op-boundary hook as ``gshard_aux_loss``/``switch_aux_loss``,
``moe_combine`` and ``moe``: under O2 their inputs are bf16, as in the
reference. One difference: the routing's softmax runs in float32 over
the (bf16) logits, where the reference's ``jax.nn.softmax`` rounds the
probabilities to bf16. Distinct bf16 logits then never tie, and the
routing is the same on the card and on the CPU from the same logits
(exp differs between the two by an ulp of float32, far below the gap
between two bf16 logits); with float32 logits it is the reference's.
"""
from __future__ import annotations

import torch

from .. import nn
from ..device import model_kw
from ..framework.op import add, multiply, op_inputs
from ..framework.unported import require_defaults
from ..nn import functional as F

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate",
           "number_count", "limit_by_capacity", "prune_gate_by_capacity",
           "assign_pos"]


# -- capacity utilities ------------------------------------------------------

def number_count(numbers, upper_range):
    """Tokens per expert: int64 [upper_range]."""
    return torch.bincount(numbers.reshape(-1).long(),
                          minlength=upper_range)[:upper_range]


def limit_by_capacity(expert_count, capacity, n_worker):
    return torch.minimum(expert_count, torch.as_tensor(
        capacity, dtype=expert_count.dtype, device=expert_count.device))


def prune_gate_by_capacity(gate_idx, expert_count, n_expert, n_worker):
    """``gate_idx`` with -1 where a token's 1-based position among its
    expert's tokens exceeds that expert's count in ``expert_count``."""
    gi = gate_idx.long()
    one_hot = (gi[:, None] == torch.arange(n_expert, device=gi.device)).long()
    pos = (one_hot.cumsum(0) * one_hot).max(-1).values
    cap = expert_count[gi]
    return torch.where(pos <= cap, gate_idx,
                       torch.full_like(gate_idx, -1))


def assign_pos(x, cum_count):
    """The token order that groups tokens by expert (stable): int64."""
    return torch.sort(x.reshape(-1), stable=True).indices.long()


def _top_k(probs, k):
    """``jax.lax.top_k``: the k largest per row, ties to the lower
    index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n, dtype):
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


# -- gates -------------------------------------------------------------------


class BaseGate(nn.Layer):
    def __init__(self, d_model, num_expert, topk=2, *, device=None,
                 generator=None):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert
        self.topk = topk
        self.gate = nn.Linear(d_model, num_expert,
                              **model_kw(device, generator))
        self.loss = None


class NaiveGate(BaseGate):
    """Top-k softmax gate, no aux loss."""

    def forward(self, x):
        return self.gate(x), None


def _gshard_aux(lg):
    lg, = op_inputs("gshard_aux_loss", lg)
    probs = torch.softmax(lg, -1)
    ce = _one_hot(lg.argmax(-1), lg.shape[-1], torch.float32).mean(0)
    return (probs.mean(0) * ce).sum() * lg.shape[-1]


def _switch_aux(lg):
    lg, = op_inputs("switch_aux_loss", lg)
    probs = torch.softmax(lg, -1)
    density = _one_hot(lg.argmax(-1), lg.shape[-1], torch.float32).mean(0)
    return (density * probs.mean(0)).sum() * lg.shape[-1]


class GShardGate(BaseGate):
    """Top-2 gate with the load-balancing aux loss."""

    def __init__(self, d_model, num_expert, topk=2, capacity=(1.2, 2.4),
                 group=None, *, device=None, generator=None):
        require_defaults("GShardGate", group=(group, None))
        super().__init__(d_model, num_expert, topk, device=device,
                         generator=generator)
        self.capacity_factor = capacity

    def forward(self, x):
        logits = self.gate(x)
        self.loss = _gshard_aux(logits)
        return logits, self.loss


class SwitchGate(BaseGate):
    """Top-1 switch gate."""

    def __init__(self, d_model, num_expert, topk=1, capacity=(1.2, 2.4),
                 group=None, *, device=None, generator=None):
        require_defaults("SwitchGate", group=(group, None))
        super().__init__(d_model, num_expert, 1, device=device,
                         generator=generator)

    def forward(self, x):
        logits = self.gate(x)
        self.loss = _switch_aux(logits)
        return logits, self.loss


# -- the MoE layer -----------------------------------------------------------

# the activations of the stacked path (exact-erf GELU, as the reference)
_ACTS = {"gelu": torch.nn.functional.gelu, "relu": torch.relu,
         "silu": torch.nn.functional.silu, "tanh": torch.tanh}


class ExpertFFN(nn.Layer):
    def __init__(self, d_model, d_hidden, activation="gelu", *, device=None,
                 generator=None):
        super().__init__()
        kw = model_kw(device, generator)
        self.fc1 = nn.Linear(d_model, d_hidden, **kw)
        self.fc2 = nn.Linear(d_hidden, d_model, **kw)
        self.act_name = activation
        self.act = getattr(F, activation)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class MoELayer(nn.Layer):
    """``experts``: a list of layers (stacked for the dense expert
    products when all are ``ExpertFFN`` with one activation; otherwise
    each runs on every token and the outputs mix by the combine
    weights), or an int expert count with ``d_hidden``."""

    def __init__(self, d_model, experts=None, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, num_expert=None,
                 d_hidden=None, top_k=2, capacity_factor=1.25,
                 ep_axis="dp", *, device=None, generator=None, **kwargs):
        require_defaults("MoELayer", moe_group=(moe_group, None),
                         mp_group=(mp_group, None),
                         recompute_interval=(recompute_interval, 0),
                         ep_axis=(ep_axis, "dp"))
        super().__init__()
        kw = model_kw(device, generator)
        self.d_model = d_model
        if isinstance(experts, int):
            num_expert, experts = experts, None
        if experts is None:
            if num_expert is None or d_hidden is None:
                raise ValueError("MoELayer needs experts, or num_expert "
                                 "and d_hidden")
            experts = [ExpertFFN(d_model, d_hidden, **kw)
                       for _ in range(num_expert)]
        self.experts = nn.LayerList(experts)
        self.num_expert = len(self.experts)
        self.capacity_factor = capacity_factor
        # the reference's ep_axis is None on a single-device mesh
        self.ep_axis = None
        kind = gate.get("type", "gshard") if isinstance(gate, dict) \
            else None
        if gate is None or kind == "gshard":
            self.gate = GShardGate(d_model, self.num_expert, top_k, **kw)
        elif kind == "switch":
            self.gate = SwitchGate(d_model, self.num_expert, **kw)
        elif kind == "naive":
            self.gate = NaiveGate(d_model, self.num_expert, top_k, **kw)
        else:
            self.gate = gate
        self.top_k = self.gate.topk

    def _stacked_expert_params(self):
        w1 = [e.fc1.weight for e in self.experts]
        b1 = [e.fc1.bias for e in self.experts]
        w2 = [e.fc2.weight for e in self.experts]
        b2 = [e.fc2.bias for e in self.experts]
        return w1, b1, w2, b2

    @staticmethod
    def _gshard_routing(lg, k, E, cap):
        """Per top-k slot: (expert one-hot [N, E] int32, capacity
        position [N], kept [N], kept weight [N]). Slot s's positions are
        offset by the per-expert token counts of slots < s."""
        probs = torch.softmax(lg.float(), dim=-1)
        topv, topi = _top_k(probs, k)
        topv = (topv / topv.sum(-1, keepdim=True)).to(lg.dtype)
        offset = torch.zeros(E, dtype=torch.int32, device=lg.device)
        for slot in range(k):
            onehot = _one_hot(topi[:, slot], E, torch.int32)
            pos = ((onehot.cumsum(0, dtype=torch.int32) - 1 + offset[None])
                   * onehot).sum(-1, dtype=torch.int32)
            keep = pos < cap
            val = torch.where(keep, topv[:, slot],
                              torch.zeros((), dtype=topv.dtype,
                                          device=topv.device))
            yield onehot, pos, keep, val
            offset = offset + onehot.sum(0, dtype=torch.int32)

    @staticmethod
    def _gshard_combine(lg, k, E, cap, dtype):
        """Dense GShard combine tensor [N, E, cap]."""
        combine = torch.zeros(lg.shape[0], E, cap, dtype=dtype,
                              device=lg.device)
        for onehot, pos, keep, val in MoELayer._gshard_routing(lg, k, E,
                                                               cap):
            slot = _one_hot(torch.where(keep, pos, 0), cap, dtype)
            combine = combine + (onehot.to(dtype)[:, :, None]
                                 * slot[:, None, :] * val[:, None, None])
        return combine

    @staticmethod
    def _gshard_weights(lg, k, E, cap):
        """Per-(token, expert) combine weight [N, E]."""
        w = torch.zeros(lg.shape[0], E, dtype=lg.dtype, device=lg.device)
        for onehot, pos, keep, val in MoELayer._gshard_routing(lg, k, E,
                                                               cap):
            w = w + onehot.to(lg.dtype) * val[:, None]
        return w

    def forward(self, x):
        orig_shape = x.shape
        x2 = x.reshape(-1, orig_shape[-1])
        logits, aux_loss = self.gate(x2)
        self.l_aux = aux_loss
        n_tokens = x2.shape[0]
        E, k = self.num_expert, self.top_k
        cap = max(int(self.capacity_factor * n_tokens * k / E), k)

        fused = all(type(e) is ExpertFFN for e in self.experts) and len(
            {e.act_name for e in self.experts}) == 1 and \
            self.experts[0].act_name in _ACTS
        if not fused:
            lg, = op_inputs("moe_combine", logits)
            w = self._gshard_weights(lg, k, E, cap)
            out = None
            for e_idx, expert in enumerate(self.experts):
                contrib = multiply(expert(x2), w[:, e_idx:e_idx + 1])
                out = contrib if out is None else add(out, contrib)
            return out.reshape(orig_shape)

        act = _ACTS[self.experts[0].act_name]
        w1s, b1s, w2s, b2s = self._stacked_expert_params()
        xa, lg, *flat = op_inputs("moe", x2, logits, *w1s, *b1s, *w2s,
                                  *b2s)
        w1 = torch.stack(flat[:E])
        b1 = torch.stack(flat[E:2 * E])
        w2 = torch.stack(flat[2 * E:3 * E])
        b2 = torch.stack(flat[3 * E:])
        combine = self._gshard_combine(lg, k, E, cap, xa.dtype)
        dispatch = (combine > 0).to(xa.dtype)
        exp_in = torch.einsum("nec,nd->ecd", dispatch, xa)
        h = act(torch.einsum("ecd,edf->ecf", exp_in, w1) + b1[:, None, :])
        exp_out = torch.einsum("ecf,efd->ecd", h, w2) + b2[:, None, :]
        out = torch.einsum("nec,ecd->nd", combine, exp_out)
        return out.reshape(orig_shape)
