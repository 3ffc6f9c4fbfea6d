"""MoE decode serving: routed expert FFN behind the FusedMultiTransformer
cache protocol (counterpart of paddle_tpu/inference/moe_serving.py).

``MoeServingCore`` subclasses FusedMultiTransformer and overrides one
seam, ``_ffn_block``, so the attention schedule and every paged-cache
branch are inherited: a MoE ``TokenServingModel`` serves in every engine
mode (paged, prefix-cached, token-budget mixed steps, speculative).

Per layer the FFN is GShard token-choice routing (arXiv 2006.16668):

    gate logits -> softmax -> top-k -> capacity-position assignment
    -> dispatch to experts -> grouped expert FFN -> weighted combine

Two dispatch paths compute the same function:

* the FOLD (default on the CPU): every expert runs over all N rows and
  its output is scaled by the capacity-respecting combine weight column,
  an exact zero for every (token, expert) pair that is not routed or
  that overflowed; ``out += y_e * w[:, e]`` in ascending expert order.
* the KERNEL path (default on CUDA, ``use_kernel=True`` anywhere): tokens
  are scattered into a static capacity layout ``[E * cap_pad, d]``
  (expert e's rows at ``e * cap_pad + pos``) and the expert FFN runs as
  two ``ops.hopper.grouped_gemm.gmm`` calls over the expert-stacked
  weights — the hand-written CUDA kernel on the card, its plain version
  on the CPU. The combine gathers each token's k rows back and folds
  them in ascending expert order, the fold's association.

**Capacity overflow = residual bypass.** ``cap = max(int(cf * N * k /
E), k)`` per forward call, N being that call's row count (a packed mixed
step routes with its packed total). An overflowed slot keeps combine
weight 0, so the token rides the residual unchanged. Engines feed zero
rows for inactive slots; those route by top-k tie order (lowest expert
id first, as ``jax.lax.top_k``; here a stable descending sort) and take
capacity like any row.

**Expert parallelism.** ``shard_experts(ep)`` splits the stacked expert
weights into ``ep`` contiguous expert ranges — logical shards on the one
card (views, no copy). Dispatch then runs the fold shard by shard with
ONE running accumulator in expert order, so every bit of the output
equals the unsharded fold.

Per-expert load and overflow accumulate as device tensors on the hot
path (no host sync); ``moe_metrics()`` is the cold scrape the engine
attaches to its MetricsRegistry under ``moe.*``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..incubate.nn.fused_transformer import FusedMultiTransformer
from ..nn import functional as F
from ..nn.layer import Linear
from ..ops.hopper.grouped_gemm import gmm

__all__ = ["MoeServingCore", "moe_capacity"]


def moe_capacity(capacity_factor, n_tokens, top_k, num_experts):
    """Per-call expert capacity (GShard): ``max(int(cf*N*k/E), k)``."""
    return max(int(capacity_factor * n_tokens * top_k / num_experts), top_k)


def _act_fn(name):
    # exact-erf gelu, as the JAX package's F.gelu
    return getattr(F, name)


def _route_impl(lg, k: int, E: int, cap: int):
    """GShard top-k routing with capacity positions over gate logits
    ``lg`` [N, E]. Returns ``(w, expert, pos, keep, val, load,
    dropped)``:

      w       [N, E] capacity-respecting combine weights (exact 0 for
              non-routed and overflowed pairs)
      expert  [k, N] int32 expert id per top-k slot
      pos     [k, N] int32 capacity position within the expert
      keep    [k, N] bool, pos < cap
      val     [k, N] combine weight per slot (0 where dropped)
      load    [E] int32 kept assignments per expert (this call)
      dropped [E] int32 overflowed assignments per expert (this call)
    """
    probs = torch.softmax(lg, dim=-1)
    # torch.topk promises no order among ties; a stable descending sort
    # keeps the lowest index first, jax.lax.top_k's rule
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv = srt[:, :k] / srt[:, :k].sum(-1, keepdim=True)
    e64 = idx[:, :k].t().contiguous()                       # [k, N]
    n = lg.shape[0]
    # [k, N, E] one-hot by comparison (F.one_hot checks its index range
    # on the host, a sync per call)
    onehot = (e64[:, :, None] == torch.arange(E, device=lg.device)).to(
        torch.int32)
    # slot-major running count: slot s's position in expert e counts
    # every slot-0..s-1 assignment to e first (GShard's slot priority)
    flat = onehot.view(k * n, E)
    pos = ((torch.cumsum(flat, dim=0, dtype=torch.int32) - 1) * flat).sum(
        -1, dtype=torch.int32).view(k, n)
    keep = pos < cap
    val = torch.where(keep, topv.t(), torch.zeros((), dtype=lg.dtype,
                                                  device=lg.device))
    # at most one slot names a given expert per row: an exact sum
    w = (onehot.to(lg.dtype) * val[:, :, None]).sum(0)
    load = (onehot * keep[:, :, None]).sum((0, 1), dtype=torch.int32)
    dropped = onehot.sum((0, 1), dtype=torch.int32) - load
    return w, e64.to(torch.int32), pos, keep, val, load, dropped


def _expert_contrib_impl(x, we, w1, b1, w2, b2, act):
    """One expert's weighted residual contribution ``act(x@w1+b1)@w2+b2``
    scaled by its combine-weight column (exact 0 for non-routed rows).
    The unsharded fold and every shard run this same code on the same
    shapes, which is what keeps them bitwise equal."""
    h = _act_fn(act)(x @ w1 + b1)
    y = h @ w2 + b2
    return y * we[:, None]


def _grouped_ffn_impl(x, expert, pos, keep, val, w1, b1, w2, b2, E: int,
                      cap_pad: int, block_m: int, act: str,
                      block_expert: torch.Tensor):
    """Kernel-path dispatch and combine around two grouped GEMMs.

    Row ``e * cap_pad + pos`` of the static capacity layout holds the
    token assigned to expert e at capacity position pos; overflowed
    slots scatter to a spill row past the layout and are dropped.
    ``cap_pad`` is the capacity rounded up to ``block_m`` so every gmm
    m-block belongs to one expert (``block_expert``). Unfilled rows run
    through the FFN and are never gathered back. The combine folds each
    token's k contributions in ascending expert order."""
    k, n = expert.shape
    rows = E * cap_pad
    slot_row = (expert * cap_pad + pos).long()                 # [k, N]
    plhs = torch.zeros((rows + 1, x.shape[1]), dtype=x.dtype,
                       device=x.device)
    plhs[torch.where(keep, slot_row, rows).view(-1)] = x.repeat(k, 1)
    plhs = plhs[:rows]
    # each expert's bias over its cap_pad rows (a broadcast add)
    h = (gmm(plhs, w1, block_expert, block_m=block_m).view(E, cap_pad, -1)
         + b1[:, None]).view(rows, -1)
    h = _act_fn(act)(h)
    y = (gmm(h, w2, block_expert, block_m=block_m).view(E, cap_pad, -1)
         + b2[:, None]).view(rows, -1)

    g = y[slot_row.clamp(0, rows - 1)] * val[:, :, None]     # [k, N, d]
    order = torch.argsort(expert, dim=0, stable=True)   # slots by expert
    g = torch.gather(g, 0, order[:, :, None].expand_as(g))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + g[j]
    return out


class MoeServingCore(FusedMultiTransformer):
    """Token-choice MoE decoder stack speaking the serving cache protocol.

    Each block's dense ``ffn1``/``ffn2`` become a router (``blk.gate``)
    and expert-stacked parameters ``moe_w1 [E, d, f]``, ``moe_b1 [E,
    f]``, ``moe_w2 [E, f, d]``, ``moe_b2 [E, d]`` — drawn as E
    independent Linears and stacked — under the JAX class's state_dict
    names, so ``weights.moe_serving_core`` carries them across by name.

    ``use_kernel``: None = the grouped-GEMM path on CUDA and the
    per-expert fold on the CPU; True/False force a path (True on the CPU
    runs the grouped path through gmm's plain version).
    """

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 num_experts=4, top_k=2, capacity_factor=1.25,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 epsilon=1e-5, num_layers=1, use_kernel=None, block_m=8, *,
                 device=None, dtype=torch.float32, generator=None):
        if num_experts < top_k:
            raise ValueError(f"num_experts={num_experts} < top_k={top_k}")
        super().__init__(embed_dim, num_heads, dim_feedforward,
                         dropout_rate=dropout_rate, activation=activation,
                         normalize_before=normalize_before, epsilon=epsilon,
                         num_layers=num_layers, device=device, dtype=dtype,
                         generator=generator)
        self.num_experts = int(num_experts)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.moe_ffn_dim = int(dim_feedforward)
        self._use_kernel = use_kernel
        self._block_m = int(block_m)
        kw = dict(device=self.device, dtype=dtype, generator=generator)
        for blk in self.layers:
            del blk.ffn1
            del blk.ffn2
            fc1 = [Linear(embed_dim, dim_feedforward, **kw)
                   for _ in range(num_experts)]
            fc2 = [Linear(dim_feedforward, embed_dim, **kw)
                   for _ in range(num_experts)]
            blk.gate = Linear(embed_dim, num_experts, **kw)
            P = torch.nn.Parameter
            blk.moe_w1 = P(torch.stack([l.weight.detach() for l in fc1]))
            blk.moe_b1 = P(torch.stack([l.bias.detach() for l in fc1]))
            blk.moe_w2 = P(torch.stack([l.weight.detach() for l in fc2]))
            blk.moe_b2 = P(torch.stack([l.bias.detach() for l in fc2]))
            del fc1, fc2
        self._ep = None
        self._ep_weights = None
        self._block_experts: Dict[Tuple[int, int], torch.Tensor] = {}
        self._reset_counters()

    def _reset_counters(self):
        self._calls = 0
        self._rows = 0
        shape = (self.num_layers, self.num_experts)
        self._load = list(torch.zeros(shape, dtype=torch.int32,
                                      device=self.device))
        self._dropped = list(torch.zeros(shape, dtype=torch.int32,
                                         device=self.device))

    # ---- configuration surface --------------------------------------

    @property
    def moe_spec(self):
        """Static routing spec."""
        return {"num_experts": self.num_experts, "top_k": self.top_k,
                "capacity_factor": self.capacity_factor,
                "ffn_dim": self.moe_ffn_dim}

    def _kernel_on(self):
        if self._use_kernel is None:
            return self.device.type == "cuda"
        return bool(self._use_kernel)

    def shard_experts(self, ep):
        """Split the expert-stacked weights into ``ep`` contiguous expert
        ranges (logical shards on the one card: views, no copy) and
        dispatch through the shard-by-shard fold. Returns self."""
        ep = int(ep)
        if ep < 1 or self.num_experts % ep:
            raise ValueError(
                f"ep={ep} must divide num_experts={self.num_experts}")
        per = self.num_experts // ep
        self._ep_weights = [
            [tuple(p[s * per:(s + 1) * per] for p in
                   (blk.moe_w1, blk.moe_b1, blk.moe_w2, blk.moe_b2))
             for s in range(ep)]
            for blk in self.layers]
        self._ep = ep
        return self

    def truncated(self, num_layers):
        """First-``num_layers`` weight-SHARING twin (the same block
        modules, so the same Parameters) — the MoE draft of speculative
        decoding. It routes unsharded and keeps counters of its own."""
        twin = super().truncated(num_layers)
        twin._reset_counters()
        return twin

    def _empty_twin(self):
        return MoeServingCore(
            self.embed_dim, self.num_heads, self.moe_ffn_dim,
            num_experts=self.num_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            activation=self._act_name,
            normalize_before=self.normalize_before, num_layers=0,
            use_kernel=self._use_kernel, block_m=self._block_m,
            device=self.device)

    # ---- metrics ----------------------------------------------------

    def moe_metrics(self):
        """Cold scrape for MetricsRegistry.attach("moe", ...): pulls the
        device-side per-expert accumulators to the host. Flattens to
        ``moe.load.<e>``, ``moe.overflow.<e>``, ``moe.routed_tokens``,
        ``moe.dropped_tokens``, ``moe.overflow_rate`` ..."""
        load = torch.stack(self._load).sum(0).cpu().numpy().astype(
            np.int64) if self._load else np.zeros(self.num_experts,
                                                  np.int64)
        drop = torch.stack(self._dropped).sum(0).cpu().numpy().astype(
            np.int64) if self._dropped else np.zeros(self.num_experts,
                                                     np.int64)
        routed = int(load.sum())
        dropped = int(drop.sum())
        total = routed + dropped
        return {
            "experts": self.num_experts,
            "top_k": self.top_k,
            "ep": self._ep or 0,
            "calls": self._calls,
            "rows": self._rows,
            "routed_tokens": routed,
            "dropped_tokens": dropped,
            "overflow_rate": (dropped / total) if total else 0.0,
            "load": {str(e): int(load[e]) for e in range(self.num_experts)},
            "overflow": {str(e): int(drop[e])
                         for e in range(self.num_experts)},
        }

    # ---- snapshot / restore -----------------------------------------

    def snapshot(self):
        """Routing config + per-expert counters (JSON-clean). Weights ride
        state_dict(); this is the serving-side state."""
        return {
            "kind": "moe_serving_core",
            "config": {
                "num_experts": self.num_experts,
                "top_k": self.top_k,
                "capacity_factor": self.capacity_factor,
                "ffn_dim": self.moe_ffn_dim,
                "block_m": self._block_m,
                "use_kernel": self._use_kernel,
                "ep": self._ep,
            },
            "counters": {
                "calls": self._calls,
                "rows": self._rows,
                "load": [a.cpu().tolist() for a in self._load],
                "overflow": [a.cpu().tolist() for a in self._dropped],
            },
        }

    def restore(self, snap):
        cfg = snap["config"]
        if (cfg["num_experts"] != self.num_experts
                or cfg["top_k"] != self.top_k
                or cfg["capacity_factor"] != self.capacity_factor
                or cfg["ffn_dim"] != self.moe_ffn_dim
                or cfg["block_m"] != self._block_m):
            raise ValueError("snapshot routing config mismatch")
        self._use_kernel = cfg["use_kernel"]
        if cfg["ep"] and cfg["ep"] != self._ep:
            self.shard_experts(cfg["ep"])
        cnt = snap["counters"]
        self._calls = int(cnt["calls"])
        self._rows = int(cnt["rows"])
        t = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                   device=self.device)
        self._load = [t(v) for v in cnt["load"]]
        self._dropped = [t(v) for v in cnt["overflow"]]

    # ---- dispatch ---------------------------------------------------

    def _ffn_block(self, i, blk, x):
        residual = x
        h = blk.ffn_ln(x) if self.normalize_before else x
        h = self._moe_ffn(i, blk, h)
        x = residual + h
        if not self.normalize_before:
            x = blk.ffn_ln(x)
        return x

    def _block_expert(self, cap_pad: int) -> torch.Tensor:
        """int32 [E * cap_pad / block_m] expert id per m-block of the
        capacity layout, on the core's device (built once per cap_pad)."""
        key = (cap_pad, self._block_m)
        be = self._block_experts.get(key)
        if be is None:
            per = cap_pad // self._block_m
            be = (torch.arange(self.num_experts * per, dtype=torch.int32,
                               device=self.device) // per)
            self._block_experts[key] = be
        return be

    def _moe_ffn(self, i, blk, h):
        shape = h.shape
        x2 = h.reshape(-1, shape[-1])
        n = x2.shape[0]
        cap = moe_capacity(self.capacity_factor, n, self.top_k,
                           self.num_experts)
        logits = blk.gate(x2)
        w, expert, pos, keep, val, load, dropped = _route_impl(
            logits, self.top_k, self.num_experts, cap)
        # device-side accumulate: no host sync on the hot path
        self._load[i] += load
        self._dropped[i] += dropped
        if i == 0:
            self._calls += 1
            self._rows += n
        if self._ep is None and self._kernel_on():
            cap_pad = -(-cap // self._block_m) * self._block_m
            out = _grouped_ffn_impl(
                x2, expert, pos, keep, val, blk.moe_w1, blk.moe_b1,
                blk.moe_w2, blk.moe_b2, self.num_experts, cap_pad,
                self._block_m, self._act_name, self._block_expert(cap_pad))
        else:
            out = self._combine_fold(i, blk, x2, w)
        return out.reshape(shape)

    def _combine_fold(self, i, blk, x2, w):
        """Left-fold of per-expert contributions in ascending expert
        order with ONE running accumulator, sharded or not, so the
        addition sequence is the same for any ``ep``."""
        if self._ep is None:
            groups = [((blk.moe_w1, blk.moe_b1, blk.moe_w2, blk.moe_b2),
                       0)]
        else:
            per = self.num_experts // self._ep
            groups = [(self._ep_weights[i][s], s * per)
                      for s in range(self._ep)]
        out = None
        for (w1, b1, w2, b2), lo in groups:
            for e in range(w1.shape[0]):
                contrib = _expert_contrib_impl(
                    x2, w[:, lo + e], w1[e], b1[e], w2[e], b2[e],
                    self._act_name)
                out = contrib if out is None else out + contrib
        return out
