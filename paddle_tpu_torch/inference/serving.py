"""Continuous-batching serving over the fused decoder stack, and the
serving stats classes (counterpart of paddle_tpu/inference/serving.py).

``ContinuousBatchingEngine`` keeps a fixed pool of dense cache SLOTS
([2, B, H, max_len, D] per layer), each an independent sequence at its
own position; one fused decode step advances every active slot through
the decode-attention kernel (per-row lengths), and finished slots are
freed and refilled without stopping the batch. It is the dense oracle
the paged engine is held against.

``ShardedServingCore`` is the head-sharded (tensor-parallel) twin of a
float FusedMultiTransformer core over the sharded ``PagedKVCache``: each
mp shard projects (or slices) its heads' q/k/v, appends to and attends
over its own pool slice through one ragged-kernel launch per layer, and
the layer closes with ONE all-reduce of the shards' zero-padded outputs.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .telemetry import StatsBase

__all__ = ["ContinuousBatchingEngine", "ParallelStats",
           "PrefillStats", "PrefixCacheStats", "ResilienceStats",
           "ShardedServingCore", "SpecDecodeStats", "TenantStats"]

# The stats siblings below share ONE declarative base
# (telemetry.StatsBase): each lists its counter FIELDS, the DERIVED
# properties to export next to them (with rounding), and the REPR
# headline subset.

class PrefixCacheStats(StatsBase):
    """Serving-surface accounting for the cross-request prefix cache
    (PagedServingEngine(prefix_cache=True)): block-level hit rate and
    the prefill work the cache saved. One instance per engine, read by
    benches/dashboards; counters only ever grow.

      lookups         admissions that probed the index
      lookup_blocks   full prompt blocks eligible to hit
      hit_blocks      blocks shared instead of allocated
      tokens_skipped  prompt tokens whose prefill was skipped
      tokens_computed prompt tokens actually prefilled
    """

    __slots__ = FIELDS = ("lookups", "lookup_blocks", "hit_blocks",
                          "tokens_skipped", "tokens_computed")
    DERIVED = {"blocks_saved": None, "hit_rate": 4}
    REPR = ("hit_rate", "blocks_saved", "tokens_skipped")

    @property
    def blocks_saved(self) -> int:
        """Pages neither allocated nor prefilled thanks to sharing."""
        return self.hit_blocks

    @property
    def hit_rate(self) -> float:
        if self.lookup_blocks == 0:
            return 0.0
        return self.hit_blocks / self.lookup_blocks


class PrefillStats(StatsBase):
    """Serving-surface accounting for CHUNKED PAGED PREFILL
    (scheduler.chunked_prefill / PagedServingEngine), sibling of
    PrefixCacheStats and SpecDecodeStats; counters only grow.

      chunks          chunk model calls run (each writes its K/V
                      straight into pages — no dense scratch)
      prefill_tokens  prompt tokens streamed through those chunks
      prefill_steps   engine steps that advanced at least one pending
                      prefill (token-budget mixed-step mode)
      decode_steps    engine steps that ran the fused decode call
      mixed_steps     steps that did BOTH — the Sarathi-style packing
                      signal (prefill riding along instead of
                      stalling the running batch)
      peak_blocks     high-water pool blocks in use (sampled after
                      every chunk AND every decode step's growth) —
                      with the dense scratch retired this IS the peak
                      KV footprint
    """

    __slots__ = FIELDS = ("chunks", "prefill_tokens", "prefill_steps",
                          "decode_steps", "mixed_steps", "peak_blocks")
    DERIVED = {"tokens_per_chunk": 2, "mixed_step_rate": 4,
               "prefill_tokens_per_step": 2}
    REPR = ("chunks", "prefill_tokens", "mixed_step_rate",
            "peak_blocks")

    @property
    def tokens_per_chunk(self) -> float:
        if self.chunks == 0:
            return 0.0
        return self.prefill_tokens / self.chunks

    @property
    def prefill_tokens_per_step(self) -> float:
        """Mean prompt tokens advanced per prefill-carrying step (the
        token-budget utilization signal)."""
        if self.prefill_steps == 0:
            return 0.0
        return self.prefill_tokens / self.prefill_steps

    @property
    def mixed_step_rate(self) -> float:
        """Fraction of steps that packed prefill chunks alongside
        decode rows."""
        total = self.decode_steps + self.prefill_steps \
            - self.mixed_steps
        if total == 0:
            return 0.0
        return self.mixed_steps / total


class ResilienceStats(StatsBase):
    """Serving-surface accounting for the resilience layer
    (inference/resilience.py + the per-request failure isolation in
    scheduler.py), sibling of PrefixCacheStats / PrefillStats /
    SpecDecodeStats; counters only grow.

      shed             requests FAILED_OOM: pool dry even after
                       preempting every other request, or the
                       re-prefill retry budget (max_preemptions)
                       exhausted — the request is failed and its
                       blocks freed, the step completes for everyone
                       else
      retried          re-admissions of previously preempted requests
                       (each one replays its history bit-identically)
      deadline_failed  requests FAILED_DEADLINE (per-request
                       deadline_steps / deadline_s blown, admitted or
                       still queued)
      nan_failed       requests FAILED_NUMERIC (non-finite hidden in
                       the slot's fused-step output row)
      rejected         requests REJECTED_ADMISSION (health-based
                       admission control refused them at submit:
                       quota- or pool-impossible, or the deadline
                       below the prefill-step lower bound)
      cancelled        requests CANCELLED — deliberate early stop
                       (best-of-n loser pruning, beam cuts, caller
                       cancel); NOT counted as a failure
      audits           check_invariants() passes run through the
                       engine surface
    """

    __slots__ = FIELDS = ("shed", "retried", "deadline_failed",
                          "nan_failed", "rejected", "cancelled",
                          "audits")
    DERIVED = {"failed": None}
    REPR = ("shed", "retried", "deadline_failed", "nan_failed",
            "rejected")

    @property
    def failed(self) -> int:
        """Total requests that ended in a failure outcome."""
        return (self.shed + self.deadline_failed + self.nan_failed
                + self.rejected)


class TenantStats(StatsBase):
    """Per-tenant serving accounting (multi-tenant isolation,
    scheduler.py): one instance per tenant in
    ``PagedServingEngine.tenant_stats``, the attribution surface that
    makes a noisy neighbor VISIBLE — which tenant sheds, which tenant
    gets rejected, which tenant holds the pool. Counters only grow
    except ``blocks_held``, a live gauge refreshed at every step top.

      admitted       requests of this tenant granted a slot (including
                     re-admissions after preemption)
      sheds          requests FAILED_OOM — pool or tenant quota dry
      rejections     requests REJECTED_ADMISSION at submit
      quota_hits     growth/admission attempts that ran into THIS
                     tenant's block quota (each may preempt or shed
                     within the tenant, never a neighbor)
      preemptions    evictions charged to this tenant's requests
      deadline_failed / nan_failed / cancelled   per-tenant split of
                     the engine ResilienceStats counters
      blocks_held    pool blocks currently charged to the tenant (one
                     charge per block-table reference its slots hold)
      tokens_served  decode tokens consumed by this tenant's slots
                     through fused steps
    """

    __slots__ = FIELDS = ("admitted", "sheds", "rejections",
                          "quota_hits", "preemptions",
                          "deadline_failed", "nan_failed", "cancelled",
                          "blocks_held", "tokens_served")
    DERIVED = {"failed": None}
    REPR = ("blocks_held", "tokens_served", "sheds", "rejections",
            "quota_hits")

    @property
    def failed(self) -> int:
        return (self.sheds + self.rejections + self.deadline_failed
                + self.nan_failed)


class ParallelStats(StatsBase):
    """Serving-surface accounting for fork-shared parallel decoding
    (branch groups, scheduler.py): one ``submit(n=k)`` prefills the
    prompt ONCE and COW-forks k branch slots over the same prompt
    pages. Sibling of the other stats classes; counters only grow.

      groups                branch groups admitted (submit(n>1) that
                            passed the health gate, plus on-demand
                            groups minted by ``fork_stream``)
      branches              branch slots forked (excludes the lead:
                            a group of n adds n-1 here; every
                            ``fork_stream`` clone adds 1)
      prefill_tokens_saved  prompt tokens whose prefill the fork
                            skipped (branch length at fork time,
                            summed over branches) — the work the
                            shared prefill amortized
      shared_blocks         block-table references the forks added to
                            already-resident pages (each one a page
                            NOT allocated; charged per reference
                            under the PR 7 quota policy)
    """

    __slots__ = FIELDS = ("groups", "branches",
                          "prefill_tokens_saved", "shared_blocks")
    DERIVED = {"branches_per_group": 2}
    REPR = ("groups", "branches", "prefill_tokens_saved")

    @property
    def branches_per_group(self) -> float:
        if self.groups == 0:
            return 0.0
        return self.branches / self.groups


class SpecDecodeStats(StatsBase):
    """Serving-surface accounting for speculative decoding
    (inference/speculative.py), the sibling of PrefixCacheStats. One
    counter bump per (slot, verification step); counters only grow.

      proposed          draft tokens offered to verification
      accepted          draft tokens the target model agreed with
      emitted           tokens actually emitted (accepted + the one
                        bonus/correction token per step)
      target_steps      per-slot target verification steps — the cost
                        unit speculation amortizes
      draft_steps       per-slot draft model forward steps
      rolled_back       rejected tokens rolled back via page-table
                        truncation
      draft_oom_rolls   draft rolls aborted by a draft-pool BlockOOM
                        (the partial roll is rolled back page-wise and
                        the round serves without speculation)
    """

    __slots__ = FIELDS = ("proposed", "accepted", "emitted",
                          "target_steps", "draft_steps", "rolled_back",
                          "draft_oom_rolls")
    DERIVED = {"acceptance_rate": 4, "tokens_per_target_step": 4}
    REPR = ("acceptance_rate", "tokens_per_target_step", "emitted")

    @property
    def acceptance_rate(self) -> float:
        if self.proposed == 0:
            return 0.0
        return self.accepted / self.proposed

    @property
    def tokens_per_target_step(self) -> float:
        """Mean tokens emitted per target-model step — the speculative
        speedup signal (1.0 == plain decode; K+1 == every proposal
        accepted)."""
        if self.target_steps == 0:
            return 0.0
        return self.emitted / self.target_steps


class ContinuousBatchingEngine:
    """Dense-cache continuous batching: ``add_request`` prefills a prompt
    batch-1 against a single-row scratch cache and copies it into a free
    slot; ``step`` advances every active slot by one token. The caches
    are updated in place."""

    def __init__(self, model, max_batch: int, max_len: int,
                 dtype=torch.float32):
        self.model = model
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.dtype = dtype
        self.caches: List[torch.Tensor] = model.gen_cache(
            self.max_batch, self.max_len, dtype=dtype)
        self.lens = np.zeros(self.max_batch, np.int32)
        self.active = np.zeros(self.max_batch, bool)
        # persistent single-row prefill scratch, reused across
        # admissions (stale tail positions are masked by the time step)
        self._scratch: Optional[List[torch.Tensor]] = None
        # slots auto-released by step() on reaching max_len
        self.finished: List[int] = []

    @property
    def free_slots(self) -> int:
        return int((~self.active).sum())

    def add_request(self, prompt) -> Tuple[int, torch.Tensor]:
        """Admit a prompt ([T, d_model] embeddings, tensor or array).
        Returns (slot, last_hidden [1, d_model])."""
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            raise RuntimeError(
                "ContinuousBatchingEngine: no free slots "
                f"(max_batch={self.max_batch}); release() one first")
        slot = int(free[0])
        x = torch.as_tensor(np.asarray(prompt, np.float32)
                            if not isinstance(prompt, torch.Tensor)
                            else prompt, device=self.model.device)
        T = x.shape[0]
        if T > self.max_len:
            raise ValueError(f"prompt length {T} > max_len {self.max_len}")
        if self._scratch is None:
            self._scratch = self.model.gen_cache(1, self.max_len,
                                                 dtype=self.dtype)
        # a tensor time step attends over the scratch's FULL extent with
        # a validity mask: one reduction extent for every prompt length
        with torch.no_grad():
            out, row_caches = self.model(
                x[None], caches=self._scratch,
                time_step=torch.zeros((), dtype=torch.int32))
        for c, row in zip(self.caches, row_caches):
            c[:, slot] = row[:, 0]
        self.lens[slot] = T
        self.active[slot] = True
        return slot, out[:, -1]

    def release(self, slot: int):
        self.active[slot] = False
        self.lens[slot] = 0

    def step(self, x) -> Optional[torch.Tensor]:
        """One fused decode step for ALL slots. x: [max_batch, 1,
        d_model] next-token embeddings (inactive rows: any values).
        Returns hidden [max_batch, 1, d_model]; only active rows are
        meaningful. Slots already at max_len are auto-released into
        ``finished``; if that empties the batch, returns None."""
        if int(self.active.sum()) == 0:
            raise RuntimeError("step() with no active slots")
        for slot in np.flatnonzero(self.active &
                                   (self.lens >= self.max_len)):
            self.finished.append(int(slot))
            self.release(int(slot))
        if int(self.active.sum()) == 0:
            return None
        with torch.no_grad():
            out, self.caches = self.model(
                x, caches=self.caches,
                time_step=np.asarray(self.lens, np.int32))
        self.lens[self.active] += 1
        return out


def _pad_heads(a: torch.Tensor, shard: int, heads_per_shard: int,
               num_heads: int) -> torch.Tensor:
    """a [b, l, H/mp, D] -> [b, l, H, D], zeros outside shard ``shard``'s
    head slice: the shard's contribution to the layer's all-reduce (the
    JAX package's serving.py:281-295). The contributions' supports are
    disjoint, so their sum is the full-head output exactly (x + 0.0 is
    exact)."""
    out = a.new_zeros(a.shape[:2] + (num_heads,) + a.shape[3:])
    lo = shard * heads_per_shard
    out[:, :, lo:lo + heads_per_shard] = a
    return out


class ShardedServingCore(torch.nn.Module):
    """Tensor-parallel (head-sharded) serving twin of a float
    FusedMultiTransformer core (the JAX package's
    inference/serving.py:317-682); the pool half is
    ``PagedKVCache(mp=N)``, which ``PagedKVCache.for_model`` builds from
    this core's ``mp`` and ``shard_devices``.

      * qkv: ``qkv_shard="activations"`` runs the base's replicated
        projection once per layer and hands each shard its head slice of
        the result (the single-card GEMM, so hidden states are bitwise
        the unsharded core's); ``"weights"`` gives each shard its own
        column slice of ``qkv.weight`` / ``qkv.bias`` (columns
        ``arange(s*Hs*hd, (s+1)*Hs*hd) + j*E``, j = 0..2, the q, k and v
        groups of its heads, :433-438), copied once at wrap time onto the
        shard's device. ``"auto"`` picks ``"weights"`` on a CUDA device
        and ``"activations"`` on the CPU (the reference's TPU/CPU split,
        :411-420).
      * attention: shard s appends to and attends over its own pool
        slice through its views' ``shard(s)``: one
        ``paged_attention_ragged`` launch per layer per shard with H/mp
        heads, all shards reusing the model call's route and plan.
      * the layer closes with ONE all-reduce (``_allreduce``): the
        shards' outputs zero-padded to the full heads are summed in shard
        order, exactly, and out_proj, the FFN and the LayerNorms run
        replicated on the sum. ``allreduce_count`` grows by one per layer
        per model call when mp > 1.

    ``devices`` (default ``parallel.mesh.serving_shard_devices(mp,
    base.device)``): on one card, or the CPU, the shards are LOGICAL (the
    same device repeated). On distinct cards each shard's q/k/v (or its
    input, in "weights" mode) is copied to its card and each output back
    to shard 0's before the sum, the reference's reduce-to-shard-0; that
    host-staged distinct-card path is UNVERIFIED (no machine with two
    cards has run it). The compiled step the reference engages on
    distinct devices (``compiled_step``, :473-483; its
    compiled_step.py) is not ported (ROADMAP item 10b): ``"auto"``
    resolves to False on logical shards, and a value that would engage
    it raises NotImplementedError rather than change path.
    ``out_shard`` is parsed and recorded (:461-471); the eager path
    always closes replicated, as the reference's does.

    Paged caches only (decode, verify, chunked prefill and the packed
    ragged step); int8 cores and MoE cores are refused (:380-390).
    Weights are read at wrap time: shard after they are final."""

    def __init__(self, base, mp: int, devices=None,
                 qkv_shard: str = "auto", compiled_step="auto",
                 out_shard: str = "auto"):
        if getattr(base, "_quantized", False):
            raise ValueError(
                "int8 cores drop their float weights at quantize "
                "time — shard the float core first (int8 core "
                "projections are a ROADMAP follow-up)")
        if hasattr(base, "moe_spec"):
            raise ValueError(
                "MoE cores shard over EXPERTS, not attention heads — "
                "use MoeServingCore.shard_experts(ep) "
                "(inference/moe_serving.py); composing ep x mp is a "
                "ROADMAP follow-up")
        super().__init__()
        self.base = base
        self.mp = int(mp)
        if self.mp < 1:
            raise ValueError(f"mp must be >= 1, got {mp}")
        if base.num_heads % self.mp:
            raise ValueError(
                f"num_heads {base.num_heads} must divide evenly over "
                f"mp={self.mp} shards")
        if devices is None:
            from ..parallel.mesh import serving_shard_devices
            devices = serving_shard_devices(self.mp, base.device)
        if len(devices) < self.mp:
            raise ValueError(f"need {self.mp} shard devices, got "
                             f"{len(devices)}")
        self.shard_devices = [torch.device(d) for d in devices[:self.mp]]
        on_cuda = self.shard_devices[0].type == "cuda"
        if qkv_shard == "auto":
            qkv_shard = "weights" if on_cuda else "activations"
        if qkv_shard not in ("weights", "activations"):
            raise ValueError(f"qkv_shard must be 'auto' | 'weights' |"
                             f" 'activations', got {qkv_shard!r}")
        self.qkv_shard = qkv_shard
        if out_shard == "auto":
            out_shard = "rows" if on_cuda else "replicated"
        if out_shard not in ("rows", "replicated"):
            raise ValueError(f"out_shard must be 'auto' | 'rows' | "
                             f"'replicated', got {out_shard!r}")
        self.out_shard = out_shard
        fully_distinct = len(set(self.shard_devices)) == self.mp
        if compiled_step == "auto":
            compiled_step = self.mp > 1 and fully_distinct
        if compiled_step not in (True, False):
            raise ValueError(f"compiled_step must be 'auto' | True | "
                             f"False, got {compiled_step!r}")
        if compiled_step and (self.mp < 2 or not fully_distinct):
            raise ValueError(
                "compiled_step=True needs mp >= 2 distinct shard "
                "devices; logical same-device shards serve on the "
                "host-staged path")
        if compiled_step:
            raise NotImplementedError(
                f"the compiled sharded step over {self.mp} distinct "
                f"devices is not ported (ROADMAP item 10b); pass "
                f"compiled_step=False to serve on the host-staged path")
        self.compiled_step = False
        # per-(layer, shard) qkv column slices ("weights" mode only)
        self._qkv_w: List[List[torch.Tensor]] = []
        self._qkv_b: List[List[Optional[torch.Tensor]]] = []
        if qkv_shard == "weights":
            E, Hs, hd = base.embed_dim, self.heads_per_shard, base.head_dim
            for blk in base.layers:
                w = blk.qkv.weight.detach()
                b = None if blk.qkv.bias is None else blk.qkv.bias.detach()
                ws, bs = [], []
                for s, dev in enumerate(self.shard_devices):
                    cols = torch.cat([
                        torch.arange(s * Hs * hd, (s + 1) * Hs * hd)
                        + j * E for j in range(3)]).to(w.device)
                    ws.append(w[:, cols].to(dev).contiguous())
                    bs.append(None if b is None
                              else b[cols].to(dev).contiguous())
                self._qkv_w.append(ws)
                self._qkv_b.append(bs)
        # one all-reduce per layer per model call when mp > 1
        self.allreduce_count = 0

    # -- geometry, delegated to the base (the reference's :489-535) ----
    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def num_layers(self):
        return self.base.num_layers

    @property
    def num_heads(self):
        return self.base.num_heads

    @property
    def head_dim(self):
        return self.base.head_dim

    @property
    def embed_dim(self):
        return self.base.embed_dim

    @property
    def heads_per_shard(self) -> int:
        return self.base.num_heads // self.mp

    @property
    def layers(self):
        return self.base.layers

    @property
    def normalize_before(self):
        return self.base.normalize_before

    @property
    def _act_name(self):
        return self.base._act_name

    @property
    def activation(self):
        return self.base.activation

    def truncated(self, num_layers):
        """The base's first-``num_layers`` twin, UNSHARDED (a speculative
        draft is small by construction; the reference builds it from the
        base layers too, its speculative.py:305-310)."""
        return self.base.truncated(num_layers)

    def gen_paged_cache(self, block_size, num_blocks, max_seqs,
                        max_blocks_per_seq=None, dtype="float32",
                        prefix_cache=False):
        """A sharded pool matching this core's width and devices."""
        from .paged_cache import PagedKVCache
        return PagedKVCache.for_model(
            self, block_size, num_blocks, max_seqs,
            max_blocks_per_seq=max_blocks_per_seq, dtype=dtype,
            prefix_cache=prefix_cache)

    def reset_allreduce_count(self) -> None:
        self.allreduce_count = 0

    @property
    def prefers_packed_step(self) -> bool:
        """Scheduler hint of a compiled core (take the packed ragged
        step whenever it is legal); False: nothing is compiled here."""
        return False

    def sharded_metrics(self) -> dict:
        """MetricsRegistry source (``sharded.*``): the all-reduce
        counter beside the compiled step's dispatch counters, which are
        0 with nothing compiled (the reference's :548-561)."""
        return {"allreduce_count": self.allreduce_count, "mp": self.mp,
                "compiled": 0, "jit_calls": 0, "retraces": 0,
                "dispatches_per_step": 0, "psums_per_call": 0}

    def _allreduce(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """THE one collective per layer: the shards' zero-padded
        contributions summed in shard order on shard 0's device (each
        copied there first on distinct cards, the reference's
        reduce-to-shard-0, :563-594). Counted only when mp > 1."""
        if len(parts) == 1:
            return parts[0]
        self.allreduce_count += 1
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        return total

    def forward(self, src, attn_mask=None, caches=None, time_step=None):
        if caches is None or time_step is None or \
                not getattr(caches[0], "is_paged", False):
            raise NotImplementedError(
                "ShardedServingCore serves the PAGED cache protocol "
                "only (caches=PagedKVCache views + time_step) — "
                "dense caches have no sharded pool to win")
        cache = getattr(caches[0], "_cache", None)
        if cache is None or cache.mp != self.mp:
            raise ValueError(
                f"cache mesh width {getattr(cache, 'mp', '?')} != "
                f"model mp {self.mp} — build the pool via "
                f"PagedKVCache.for_model(sharded_core, ...)")
        x = src
        b, l = x.shape[0], x.shape[1]
        E, H, hd = self.embed_dim, self.num_heads, self.head_dim
        Hs = self.heads_per_shard
        for i, blk in enumerate(self.base.layers):
            residual = x
            h = blk.ln(x) if self.normalize_before else x
            if self.qkv_shard == "activations":
                # the replicated projection, the single-card GEMM; each
                # shard takes a head slice of it (stride(-1) stays 1)
                qf, kf, vf = (t.reshape(b, l, H, hd)
                              for t in blk.qkv(h).split(E, dim=-1))
            parts = []
            for s, dev in enumerate(self.shard_devices):
                if self.qkv_shard == "weights":
                    y = torch.nn.functional.linear(
                        h.to(dev), self._qkv_w[i][s].t(),
                        self._qkv_b[i][s])
                    q, k, v = (t.reshape(b, l, Hs, hd)
                               for t in y.split(Hs * hd, dim=-1))
                else:
                    heads = slice(s * Hs, (s + 1) * Hs)
                    q, k, v = (t[:, :, heads].to(dev)
                               for t in (qf, kf, vf))
                view = caches[i] if self.mp == 1 else caches[i].shard(s)
                a = view.decode(q, k, v, time_step)
                parts.append(a if self.mp == 1 else
                             _pad_heads(a, s, Hs, H))
            attn = self._allreduce(parts).to(x.device)
            x = residual + blk.out_proj(attn.reshape(b, l, E))
            if not self.normalize_before:
                x = blk.ln(x)
            residual = x
            hh = blk.ffn_ln(x) if self.normalize_before else x
            x = residual + blk.ffn2(self.activation(blk.ffn1(hh)))
            if not self.normalize_before:
                x = blk.ffn_ln(x)
        return x, list(caches)
