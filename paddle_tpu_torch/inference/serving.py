"""Continuous-batching serving over the fused decoder stack, and the
serving stats classes (counterpart of paddle_tpu/inference/serving.py).

``ContinuousBatchingEngine`` keeps a fixed pool of dense cache SLOTS
([2, B, H, max_len, D] per layer), each an independent sequence at its
own position; one fused decode step advances every active slot through
the decode-attention kernel (per-row lengths), and finished slots are
freed and refilled without stopping the batch. It is the dense oracle
the paged engine is held against. ``ShardedServingCore`` comes in a
later slice.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .telemetry import StatsBase

__all__ = ["ContinuousBatchingEngine", "ParallelStats",
           "PrefillStats", "PrefixCacheStats", "ResilienceStats",
           "SpecDecodeStats", "TenantStats"]

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
