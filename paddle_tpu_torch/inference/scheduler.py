"""Paged serving engine: block-budget admission, chunked prefill, the
token-budget ragged mixed step, preemption by block eviction, continuous
slot refill, failure isolation, tenants and snapshots (counterpart of
paddle_tpu/inference/scheduler.py).

Same model contract as ContinuousBatchingEngine (``model(x, caches=...,
time_step=...)``), but the cache is a PagedKVCache, so the concurrency
limit is the BLOCK BUDGET, not slots * max_len:

  * admission: a queued request is admitted when a slot is free and the
    pool can cover its admission horizon plus a watermark; prompts
    stream straight into the slot's pages in causal chunks (no dense
    scratch).
  * growth: before each fused step every active row crossing a block
    boundary allocates its next page (allocate-on-write).
  * preemption: when the pool is exhausted the YOUNGEST eligible
    request is evicted — all its pages freed — and goes back to the
    queue, ahead of never-admitted requests, for re-prefill from its
    recorded history (prompt + every decode input).
  * mixed steps (``prefill_token_budget=N``): admission only grants the
    slot; each step spends up to N prompt tokens on pending prefills.
    With ``ragged_step`` True or "force" the chunks run PACKED with the
    decode rows as ONE model call through ``PagedKVCache.ragged_views``
    (one ragged paged-attention launch per layer); the JAX engine packs
    only on its kernel path, the port packs whenever a budget is set, on
    the CPU and on CUDA alike. ``ragged_step=False`` runs per-phase
    launches: one model call per prefill chunk and one for the decode.
  * without a budget, admission prefills synchronously chunk by chunk
    (``chunked_prefill``) and each step is one fused decode call.
  * prefix caching (``prefix_cache=True``): admission matches the
    prompt's chained block hashes against the pool's index, shares the
    hit pages and prefills only the uncached suffix. Completed prompt
    blocks are registered chunk by chunk, so a request preempted
    mid-prefill re-adopts its own finished pages when it returns.
  * ``dtype="int8"`` serves from int8 KV pages; scheduling is dtype-blind.
  * speculative verify: ``step_multi`` appends and scores L = k+1 rows
    per slot in one call, and ``rollback`` trims a rejected tail.
  * branch groups (``submit(..., n=4)``): the prompt prefills once and
    n-1 branch slots fork over its pages; ``fork_stream`` clones a
    running stream, ``cancel`` stops one.
  * failure isolation (``resilience.py``): a request ends in a terminal
    ``RequestOutcome`` in ``outcomes``; a BlockOOM that survives
    preemption sheds ONE request instead of raising,
    ``max_preemptions`` bounds the re-prefill retries, per-request
    deadlines (steps or wall clock) are enforced at each step top, and
    the numeric guard fails a slot whose hidden goes non-finite (its
    pages are quarantined). A ``FaultInjector`` drives all of it
    deterministically. The guard is one [B] reduction on the device and
    one small host read a step, on by default only with an injector.
  * tenants (``tenants=``, ``set_tenant``, ``submit(tenant_id=)``):
    every request belongs to a tenant (the implicit unlimited
    ``default`` one without an id). A tenant carries a block QUOTA (a
    cap on the table references its slots hold), a RESERVED floor
    (headroom other tenants may not take while it is below it) and a
    WEIGHT: admission is weighted fair queuing over per-tenant FIFO
    sub-queues, and preemption and shedding stay inside the tenant that
    caused the pressure. Provably unservable requests are
    REJECTED_ADMISSION at submit.
  * snapshots (``snapshot``/``restore``): a plain picklable dict with
    the JAX engine's keys; a snapshot taken by either package restores
    in the other. ``export_request_slice``/``import_slice`` move a
    request's finished prefix pages between pools.

  * telemetry (``collector=``, ``telemetry.TraceCollector``), health
    monitoring (``monitor=``, ``monitor.HealthMonitor``) and cost
    accounting (``ledger=``, ``accounting.CostLedger``): opt-in and
    passive. With none installed every hook site is one ``is not None``
    check (no clock read, no allocation); none of them is part of a
    snapshot, and ``restore`` wires the caller's fresh. The ledger binds
    before the monitor and the monitor binds last. The collector stamps
    the host clock: a step's ``model`` phase records launch time, and the
    device time lands at the first readback (telemetry.py's docstring).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .paged_cache import BlockOOM, PagedKVCache, chain_block_hashes
from .resilience import RequestOutcome
from .serving import (ParallelStats, PrefillStats, PrefixCacheStats,
                      ResilienceStats, TenantStats)
from .telemetry import MetricsRegistry

__all__ = ["PagedRequest", "PagedServingEngine", "Tenant",
           "chunked_prefill", "DEFAULT_TENANT", "MIN_PREFILL_SUFFIX_ROWS"]

# the implicit tenant of every request without a tenant_id: unlimited
# quota, no floor, weight 1, so a single-tenant engine schedules as one
# without tenants (WFQ over one tenant is FIFO)
DEFAULT_TENANT = "default"


class Tenant:
    """One tenant's isolation contract and accounting.

      quota_blocks     cap on the pool blocks charged to the tenant (one
                       per table reference its slots hold); None =
                       unlimited
      reserved_blocks  floor: while the tenant's charge is below it,
                       other tenants may not dip the free pool below the
                       unmet remainder
      weight           WFQ share: the virtual time advances by 1/weight
                       per admission
      vtime            the WFQ virtual-time tag (snapshots carry it)
      fifo             the tenant's FIFO sub-queue (preempted requests
                       by rid ahead of never-admitted ones by enqueue
                       order)
      queued           len(fifo), kept at every queue mutation
      stats            TenantStats
    """

    __slots__ = ("tid", "quota_blocks", "reserved_blocks", "weight",
                 "vtime", "fifo", "queued", "stats")

    def __init__(self, tid: str, quota_blocks: Optional[int] = None,
                 reserved_blocks: int = 0, weight: float = 1.0):
        self.tid = str(tid)
        if weight <= 0:
            raise ValueError(f"tenant {tid!r}: weight must be > 0")
        if reserved_blocks < 0:
            raise ValueError(
                f"tenant {tid!r}: reserved_blocks must be >= 0")
        if quota_blocks is not None and quota_blocks < reserved_blocks:
            raise ValueError(
                f"tenant {tid!r}: quota_blocks ({quota_blocks}) < "
                f"reserved_blocks ({reserved_blocks})")
        self.quota_blocks = (None if quota_blocks is None
                             else int(quota_blocks))
        self.reserved_blocks = int(reserved_blocks)
        self.weight = float(weight)
        self.vtime = 0.0
        self.fifo: Deque[PagedRequest] = deque()
        self.queued = 0
        self.stats = TenantStats()


# Every prefill chunk, and the recomputed suffix of a prefix-cache hit,
# keeps >= this many rows: the JAX package's CPU bit-identity rule (a
# 1-row chunk lowers to a GEMV with a different accumulation order than
# the same row inside a multi-row call), and a fully cached prompt still
# needs its last hidden for the admission event. The port keeps the same
# boundaries so its schedules match the reference step for step.
MIN_PREFILL_SUFFIX_ROWS = 2


def _chunk_len(total: int, pos: int, chunk_tokens: int,
               budget: Optional[int] = None) -> int:
    """Next chunk length for a prefill at ``pos`` of ``total`` rows:
    ``chunk_tokens`` capped by the remaining prompt (and the remaining
    step budget, floored at the 2-row minimum), then adjusted so the
    REMAINING tail is never a single row."""
    c = min(chunk_tokens, total - pos)
    if budget is not None:
        c = min(c, max(MIN_PREFILL_SUFFIX_ROWS, budget))
    if total - (pos + c) == 1:
        c = c - 1 if c > MIN_PREFILL_SUFFIX_ROWS else c + 1
    return c


def chunked_prefill(model, cache: PagedKVCache, slot: int, rows,
                    *, pos: int = 0, target: Optional[int] = None,
                    chunk_tokens: int = 64, start_block: int = 0,
                    write_start: int = 0,
                    stats: Optional[PrefillStats] = None, on_chunk=None):
    """Stream ``rows[pos:target]`` ([T, d_model] array) into ``slot``'s
    pages in causal chunks: each chunk is one batch-1 model call through
    ``cache.prefill_views``. ``start_block``/``write_start``: adopted
    prefix-cache pages, which the chunks attend over but never rewrite
    or COW-split. Ensures page coverage per chunk (BlockOOM propagates);
    ``on_chunk(new_pos)`` fires after every chunk lands. Returns
    ``(new_pos, last_hidden)`` — the final chunk's trailing row
    [1, d_model], or None when no chunk ran."""
    T = rows.shape[0] if target is None else int(target)
    out = None
    views = cache.prefill_views(slot, write_start=write_start)
    while pos < T:
        c = _chunk_len(T, pos, chunk_tokens)
        cache.ensure(slot, pos + c, start_block=start_block,
                     write_from=pos)
        x = torch.from_numpy(np.ascontiguousarray(
            rows[pos:pos + c], np.float32)[None]).to(cache.device)
        with torch.no_grad():
            out, _ = model(x, caches=views,
                           time_step=np.asarray([pos], np.int32))
        pos += c
        if stats is not None:
            stats.chunks += 1
            stats.prefill_tokens += c
            stats.peak_blocks = max(stats.peak_blocks,
                                    cache.blocks_in_use)
        if on_chunk is not None:
            on_chunk(pos)
    return pos, (out[:, -1] if out is not None else None)


class PagedRequest:
    """One sequence. ``history`` is every embedding row the model has
    consumed for it (prompt rows + each decode-step input row): exactly
    what a re-prefill needs to rebuild the evicted cache. One growable
    [T, d_model] array with amortized append."""

    def __init__(self, rid: int, history: np.ndarray):
        self.rid = rid
        arr = np.array(history, np.float32, copy=True)
        if arr.ndim != 2:
            raise ValueError("history must be [T, d_model] rows")
        self._hist = arr
        self._len = arr.shape[0]
        # chain hashes are append-only like the history: memoized and
        # extended, never recomputed across re-admissions
        self._hashes: List[bytes] = []
        self.slot: Optional[int] = None
        self.admit_seq = -1
        self.enqueue_seq = -1
        self.preemptions = 0
        self.tenant: str = DEFAULT_TENANT
        # the retry budget and deadlines (None = unbounded)
        self.max_preemptions: Optional[int] = None
        self.deadline_steps: Optional[int] = None
        self.deadline_time: Optional[float] = None   # monotonic clock
        self.submit_step = 0
        # branch groups: ``gid`` is the lead's rid for every member,
        # ``branch`` the member's index; ``group_n`` > 1 marks a lead
        # whose branches have not forked yet (the fork resets it, so a
        # later preemption re-prefills it alone)
        self.gid: Optional[int] = None
        self.branch = 0
        self.group_n = 1

    @property
    def history(self) -> np.ndarray:
        """[T, d_model] view of every consumed row (no copy)."""
        return self._hist[:self._len]

    def append_history(self, row) -> None:
        if self._len == self._hist.shape[0]:
            grown = np.empty((max(8, 2 * self._hist.shape[0]),
                              self._hist.shape[1]), np.float32)
            grown[:self._len] = self._hist[:self._len]
            self._hist = grown
        self._hist[self._len] = row
        self._len += 1

    def block_hashes(self, block_size: int) -> List[bytes]:
        """Chained hashes of every FULL block of the history (the
        identity the prefix cache indexes by)."""
        n_full = self._len // block_size
        have = len(self._hashes)
        if have < n_full:
            self._hashes.extend(chain_block_hashes(
                self._hist[have * block_size:n_full * block_size],
                block_size,
                parent=self._hashes[-1] if self._hashes else b""))
        return self._hashes[:n_full]

    def truncate_history(self, length: int, block_size: int) -> None:
        """Roll the recorded history back to ``length`` rows (speculative
        rejection): rows past it were consumed speculatively and
        rejected, so a re-prefill must not replay them. Memoized chain
        hashes past the new last full block go with them."""
        if length < 0 or length > self._len:
            raise ValueError(
                f"truncate to {length} outside [0, {self._len}]")
        self._len = length
        del self._hashes[length // block_size:]

    def __len__(self):
        return self._len


class _GroupTable:
    """The engine's branch groups, one record per live group:

      n         branch count the group was admitted for
      rids      member rids in branch order (rids[0] == gid, the lead's
                rid; branch rids are minted at fork time)
      live      members without a terminal outcome yet (the record
                drops when this empties)
      reserved  slots held for the pending branches while the lead's
                prompt streams (token-budget mode): ``prefilling`` with
                no request and no prefill state; emptied by the fork or
                by the lead leaving its slot
      forked    whether the fork has run

    Plain host dicts, as in the reference (``snapshot``/``restore``)."""

    def __init__(self):
        self.groups: Dict[int, dict] = {}
        self._by_rid: Dict[int, int] = {}

    def create(self, gid: int, n: int) -> dict:
        g = {"n": int(n), "rids": [gid], "live": [gid],
             "reserved": [], "forked": False}
        self.groups[gid] = g
        self._by_rid[gid] = gid
        return g

    def add_branch(self, gid: int, rid: int) -> None:
        g = self.groups[gid]
        g["rids"].append(rid)
        g["live"].append(rid)
        self._by_rid[rid] = gid

    def gid_of(self, rid: int) -> Optional[int]:
        return self._by_rid.get(rid)

    def reserved_slots(self) -> set:
        return {s for g in self.groups.values() for s in g["reserved"]}

    def on_terminal(self, rid: int) -> Optional[dict]:
        """Retire a member; drop the record once every member is
        terminal. Returns the record, or None for a non-member."""
        gid = self._by_rid.get(rid)
        if gid is None:
            return None
        g = self.groups[gid]
        if rid in g["live"]:
            g["live"].remove(rid)
        if not g["live"]:
            for r in g["rids"]:
                self._by_rid.pop(r, None)
            del self.groups[gid]
        return g

    def snapshot(self) -> dict:
        return {"groups": [dict(g, gid=gid, rids=list(g["rids"]),
                                live=list(g["live"]),
                                reserved=list(g["reserved"]))
                           for gid, g in self.groups.items()],
                "by_rid": dict(self._by_rid)}

    def restore(self, rec: dict) -> None:
        self.groups = {}
        for g in rec.get("groups", []):
            self.groups[int(g["gid"])] = {
                "n": int(g["n"]), "rids": list(g["rids"]),
                "live": list(g["live"]),
                "reserved": [int(s) for s in g["reserved"]],
                "forked": bool(g["forked"])}
        self._by_rid = {int(r): int(gid)
                        for r, gid in rec.get("by_rid", {}).items()}


class PagedServingEngine:
    def __init__(self, model, max_batch: int, block_size: int,
                 num_blocks: int, max_blocks_per_seq: Optional[int] = None,
                 dtype="float32", watermark_blocks: int = 0,
                 prefix_cache: bool = False,
                 chunk_tokens: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 injector=None, max_preemptions: Optional[int] = None,
                 numeric_guard: Optional[bool] = None,
                 tenants: Optional[Dict[str, dict]] = None,
                 collector=None, monitor=None, ledger=None,
                 ragged_step=True, tile_q: Optional[int] = None,
                 tile_kv: Optional[int] = None):
        self.model = model
        # token-budget mode: True and "force" plan the step's prefill
        # chunks and launch them packed with the decode rows (one ragged
        # launch per layer), on the CPU too; False runs one model call
        # per chunk plus one for the decode. tile_q / tile_kv pass
        # through to paged_attention_ragged (None: the kernel's
        # defaults).
        self.ragged_step = ragged_step
        self.tile_q = tile_q
        self.tile_kv = tile_kv
        self._ragged_plan: Optional[List[dict]] = None
        self.max_batch = int(max_batch)
        self.dtype = dtype
        self.watermark_blocks = int(watermark_blocks)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_stats = PrefixCacheStats()
        self.prefill_stats = PrefillStats()
        # tenants: registration order is the WFQ tie-break (snapshots
        # keep it); the implicit default tenant always exists
        self.tenants: Dict[str, Tenant] = {
            DEFAULT_TENANT: Tenant(DEFAULT_TENANT)}
        self._vclock = 0.0
        self.injector = injector
        self.max_preemptions = max_preemptions
        self.numeric_guard = (injector is not None
                              if numeric_guard is None
                              else bool(numeric_guard))
        self.resilience_stats = ResilienceStats()
        self.parallel_stats = ParallelStats()
        self.outcomes: List[RequestOutcome] = []
        self._step_count = 0
        self._has_deadlines = False
        # opt-in, passive observers: never consulted for control flow,
        # never part of a snapshot (restore wires the caller's fresh)
        self.collector = collector
        self.ledger = ledger
        self.monitor = monitor
        # the unified metric surface: live sources read at export time
        self.registry = MetricsRegistry()
        self.registry.attach("prefix_cache", self.prefix_stats)
        self.registry.attach("prefill", self.prefill_stats)
        self.registry.attach("resilience", self.resilience_stats)
        self.registry.attach("parallel", self.parallel_stats)
        self.registry.attach("tenants", self.tenant_report)
        self.registry.attach(
            "pool",
            lambda: dict(self.cache.pool_occupancy(tiers_only=True),
                         peak=self.cache.peak_blocks_used))
        self.registry.attach("queue", self._queue_gauges)
        # sharded cores export the all-reduce counter and the compiled
        # step's dispatch counters (0 here: nothing is compiled)
        if hasattr(model, "sharded_metrics"):
            self.registry.attach("sharded", model.sharded_metrics)
        # MoE cores export per-expert load / overflow / routing totals;
        # dense models leave the namespace absent
        if hasattr(model, "moe_metrics"):
            self.registry.attach("moe", model.moe_metrics)
        self.cache = PagedKVCache.for_model(
            model, block_size, num_blocks, max_seqs=max_batch,
            max_blocks_per_seq=max_blocks_per_seq, dtype=dtype,
            prefix_cache=prefix_cache)
        if injector is not None:
            self.cache.allocator.fault_hook = \
                lambda n: injector.on_alloc("target", n)
        self.max_len = self.cache.capacity_per_seq
        for tid, cfg in (tenants or {}).items():
            self.set_tenant(tid, **cfg)
        # prompt chunk size: a multiple of the block size by default
        if chunk_tokens is None:
            chunk_tokens = 4 * self.cache.block_size
        if chunk_tokens < MIN_PREFILL_SUFFIX_ROWS:
            raise ValueError(
                f"chunk_tokens must be >= {MIN_PREFILL_SUFFIX_ROWS}")
        self.chunk_tokens = int(chunk_tokens)
        if prefill_token_budget is not None and \
                prefill_token_budget < MIN_PREFILL_SUFFIX_ROWS:
            raise ValueError(
                f"prefill_token_budget must be >= "
                f"{MIN_PREFILL_SUFFIX_ROWS}")
        self.prefill_token_budget = prefill_token_budget
        self.lens = np.zeros(self.max_batch, np.int32)
        self.active = np.zeros(self.max_batch, bool)
        # slots granted but still streaming their prompt (mixed-step
        # mode): they own pages but must not ride the decode call
        self.prefilling = np.zeros(self.max_batch, bool)
        self._prefills: Dict[int, dict] = {}
        self._requests: List[Optional[PagedRequest]] = \
            [None] * self.max_batch
        # the queue lives in the tenants' FIFO sub-queues; ``queue``
        # merges them, _queue_len is the depth gauge
        self._queue_len = 0
        self._next_enqueue_seq = 0
        # decode inputs not yet attributed to request histories: (x,
        # stepping mask) per step, copied to the host lazily
        self._pending_history: List[Tuple[torch.Tensor, np.ndarray]] = []
        self._next_rid = 0
        self._next_admit_seq = 0
        self.groups = _GroupTable()
        # event queues the caller drains
        self.admitted: List[Tuple[int, int, torch.Tensor]] = []
        self.finished: List[Tuple[int, int, int]] = []
        self.preempted: List[int] = []
        # the ledger binds before the monitor, so the monitor's baseline
        # registry snapshot already carries the work.* keys; the monitor
        # binds last (its baseline reads the fully built engine's
        # sources) and rebases at the current step
        if ledger is not None:
            ledger.bind(self.registry, model=model,
                        kv_token_bytes=self.cache.kv_bytes_per_token())
        if monitor is not None:
            monitor.bind(self.registry, collector=collector)
            monitor.rebase(self._step_count)

    # -- introspection ------------------------------------------------
    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    @property
    def num_prefilling(self) -> int:
        return int(self.prefilling.sum())

    @property
    def free_slots(self) -> int:
        return int((~self.active & ~self.prefilling).sum())

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: the free list plus the cached-free tier."""
        return self.cache.allocator.num_free

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_stats.hit_rate

    def _queue_gauges(self) -> dict:
        return {"depth": self._queue_len, "active": self.num_active,
                "prefilling": self.num_prefilling}

    # -- tenants ------------------------------------------------------
    @property
    def tenant_stats(self) -> Dict[str, TenantStats]:
        """{tenant_id: TenantStats} (blocks_held refreshes at every
        step top)."""
        return {tid: t.stats for tid, t in self.tenants.items()}

    def set_tenant(self, tenant_id: str, *,
                   quota_blocks: Optional[int] = None,
                   reserved_blocks: int = 0,
                   weight: float = 1.0) -> Tenant:
        """Register or reconfigure a tenant. ValueError when the quota
        would fall below the tenant's current charge, or when the
        reserved floors together exceed the usable pool. Stats, the
        sub-queue and the virtual time survive reconfiguration."""
        held = self.cache.tenant_charge(tenant_id)
        if quota_blocks is not None and quota_blocks < held:
            raise ValueError(
                f"tenant {tenant_id!r} already holds {held} block(s); "
                f"a quota of {quota_blocks} would be violated on "
                f"arrival — drain the tenant first")
        existing = self.tenants.get(tenant_id)
        ten = Tenant(tenant_id, quota_blocks=quota_blocks,
                     reserved_blocks=reserved_blocks, weight=weight)
        if existing is not None:
            ten.vtime = existing.vtime
            ten.fifo = existing.fifo
            ten.queued = existing.queued
            ten.stats = existing.stats
        total_reserved = ten.reserved_blocks + sum(
            t.reserved_blocks for tid, t in self.tenants.items()
            if tid != tenant_id)
        usable = self.cache.num_blocks - 1 - self.watermark_blocks
        if total_reserved > usable:
            raise ValueError(
                f"reserved floors total {total_reserved} block(s) but "
                f"only {usable} are usable (pool {self.cache.num_blocks}"
                f" minus trash and watermark) — the guarantee would be "
                f"unkeepable")
        self.tenants[tenant_id] = ten
        return ten

    def _tenant_of(self, req: PagedRequest) -> Tenant:
        return self.tenants[req.tenant]

    @staticmethod
    def _queue_key(req: PagedRequest):
        """Queue order: preempted requests (sunk compute) ahead of
        never-admitted ones, each by original submission age."""
        if req.preemptions > 0:
            return (0, req.rid)
        return (1, req.enqueue_seq)

    @property
    def queue(self) -> List[PagedRequest]:
        """Queued requests in admission-contract order (the sub-queues
        merged by ``_queue_key``)."""
        out: List[PagedRequest] = []
        for ten in self.tenants.values():
            out.extend(ten.fifo)
        out.sort(key=self._queue_key)
        return out

    def _enqueue(self, req: PagedRequest) -> None:
        """Queue a never-admitted request at its tenant's tail."""
        req.enqueue_seq = self._next_enqueue_seq
        self._next_enqueue_seq += 1
        ten = self.tenants[req.tenant]
        ten.fifo.append(req)
        ten.queued += 1
        self._queue_len += 1

    def _dequeue(self, req: PagedRequest) -> None:
        """The one way off the queue; ValueError if not queued."""
        ten = self.tenants[req.tenant]
        if ten.fifo and ten.fifo[0] is req:
            ten.fifo.popleft()
        else:
            ten.fifo.remove(req)
        ten.queued -= 1
        self._queue_len -= 1

    def _resolve_tenant(self, tenant_id: Optional[str]) -> Tenant:
        tid = DEFAULT_TENANT if tenant_id is None else str(tenant_id)
        ten = self.tenants.get(tid)
        if ten is None:
            ten = self.set_tenant(tid)   # unlimited defaults
        return ten

    def _unmet_floors(self, exclude: str) -> int:
        """Free-pool headroom reserved for OTHER tenants still below
        their floors."""
        return sum(
            max(0, t.reserved_blocks - self.cache.tenant_charge(tid))
            for tid, t in self.tenants.items()
            if tid != exclude and t.reserved_blocks)

    def _bump_vtime(self, tid: str) -> None:
        """Start-time fairness: a tenant enqueueing from idle starts at
        the virtual clock instead of replaying credit banked idle."""
        ten = self.tenants[tid]
        if ten.queued == 0 and ten.vtime < self._vclock:
            ten.vtime = self._vclock

    def tenant_report(self) -> Dict[str, dict]:
        """Per-tenant config, live occupancy and queue, and stats (and
        the ledger's cost bill when a ledger is installed)."""
        active: Dict[str, int] = {}
        for s in np.flatnonzero(self.active | self.prefilling):
            req = self._requests[int(s)]
            if req is not None:
                active[req.tenant] = active.get(req.tenant, 0) + 1
        cost = (self.ledger.tenant_cost()
                if self.ledger is not None else None)
        return {tid: dict({
            "quota_blocks": t.quota_blocks,
            "reserved_blocks": t.reserved_blocks,
            "weight": t.weight,
            "vtime": round(t.vtime, 6),
            "blocks_held": self.cache.tenant_charge(tid),
            "active": active.get(tid, 0),
            "queued": t.queued,
            "stats": t.stats.as_dict(),
        }, **({"cost": cost[tid]} if cost and tid in cost else {}))
            for tid, t in self.tenants.items()}

    # -- admission ----------------------------------------------------
    def submit(self, prompt, *, max_preemptions: Optional[int] = None,
               deadline_steps: Optional[int] = None,
               deadline_s: Optional[float] = None,
               tenant_id: Optional[str] = None, n: int = 1) -> int:
        """Queue a prompt ([T, d_model] embeddings) and try to admit.
        Returns the request id; when admission succeeded an ``(rid,
        slot, last_hidden)`` event is in ``admitted``. With
        ``prefill_token_budget`` set, admission only grants a slot and
        the admitted event fires when the last chunk lands.

        ``tenant_id`` names the request's tenant (None: the default
        tenant; an unknown id registers with unlimited defaults). A
        request that provably can never be served — its prompt needs
        more blocks than its tenant's quota, or than the pool minus
        other tenants' floors, or (token-budget mode) its
        ``deadline_steps`` is below the prefill-step lower bound — ends
        REJECTED_ADMISSION in ``outcomes``, never an exception.

        ``max_preemptions`` caps this request's re-prefill retries.
        ``deadline_steps`` / ``deadline_s`` fail it (FAILED_DEADLINE)
        once that many steps / seconds have passed since submission,
        running, mid-prefill or queued.

        ``n`` > 1 queues a branch group: the prompt prefills once, then
        n-1 branch slots fork over its pages, each with a fresh rid
        and its own admitted event carrying the lead's prefill hidden.
        Admission waits for n free slots. Returns the lead's rid, the
        group id."""
        arr = np.asarray(prompt.cpu().numpy() if isinstance(
            prompt, torch.Tensor) else prompt, np.float32)
        if arr.shape[0] == 0:
            raise ValueError("empty prompt")
        if arr.shape[0] > self.max_len:
            raise ValueError(
                f"prompt length {arr.shape[0]} > per-seq page capacity "
                f"{self.max_len}")
        n = int(n)
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if n > self.max_batch:
            raise ValueError(
                f"n={n} branches exceed max_batch={self.max_batch}")
        ten = self._resolve_tenant(tenant_id)
        req = PagedRequest(self._next_rid, arr)
        self._next_rid += 1
        req.tenant = ten.tid
        if n > 1:
            req.gid = req.rid
            req.group_n = n
        req.max_preemptions = (self.max_preemptions
                               if max_preemptions is None
                               else int(max_preemptions))
        req.submit_step = self._step_count
        if deadline_steps is not None:
            req.deadline_steps = int(deadline_steps)
        if deadline_s is not None:
            req.deadline_time = time.monotonic() + float(deadline_s)
        if self.collector is not None:
            self.collector.on_submit(req.rid, ten.tid, arr.shape[0],
                                     gid=req.gid)
        if self.ledger is not None:
            self.ledger.on_submit(req.rid, ten.tid, arr.shape[0])
        reject = self._admission_health(req, ten)
        if reject:
            self._record(req, RequestOutcome.REJECTED_ADMISSION, reject)
            return req.rid
        if deadline_steps is not None or deadline_s is not None:
            self._has_deadlines = True
        if n > 1:
            self.groups.create(req.rid, n)
            self.parallel_stats.groups += 1
        self._bump_vtime(ten.tid)
        self._enqueue(req)
        self._try_admit()
        return req.rid

    def _admission_health(self, req: PagedRequest, ten: Tenant) -> str:
        """Reason string when the request provably cannot be served
        under the current tenant and pool contracts, else ''."""
        # the prompt plus the first decode token's page; a group charges
        # its tenant per reference but holds the prompt once plus each
        # extra branch's first COW-split page
        need = self.cache.blocks_needed(min(len(req) + 1, self.max_len))
        charge_need = need * req.group_n
        phys_need = need + max(0, req.group_n - 1)
        if ten.quota_blocks is not None and \
                charge_need > ten.quota_blocks:
            return (f"prompt needs {charge_need} charged block(s) "
                    f"through its first decode token "
                    f"(x{req.group_n} branch references) but tenant "
                    f"{ten.tid!r} quota is {ten.quota_blocks} — can "
                    f"never be admitted")
        # other tenants' FULL floors (the momentary unmet remainder
        # would queue a request that floor-skips forever)
        reserved_others = sum(
            t.reserved_blocks for tid, t in self.tenants.items()
            if tid != ten.tid)
        room = self.cache.num_blocks - 1 - self.watermark_blocks \
            - reserved_others
        if phys_need > room:
            return (f"prompt needs {phys_need} block(s) through its "
                    f"first decode token but only {room} can ever be "
                    f"available past other tenants' reserved floors "
                    f"and the watermark")
        if req.deadline_steps is not None and \
                self.prefill_token_budget is not None:
            # a mixed step advances at most budget + 1 prompt tokens
            floor_steps = -(-len(req) // (self.prefill_token_budget + 1))
            if req.deadline_steps < floor_steps:
                return (f"prefill alone needs >= {floor_steps} "
                        f"step(s) at prefill_token_budget="
                        f"{self.prefill_token_budget} but the "
                        f"deadline is {req.deadline_steps} — cannot "
                        f"be met at any pool pressure")
        return ""

    def _try_admit(self) -> None:
        """One admission pass, then the ``post_admission`` crash point."""
        self._admit_pass()
        self._crash("post_admission")

    def _admit_pass(self) -> None:
        """Weighted fair admission: while a slot is free, the queued
        tenant with the lowest virtual time (ties: registration order)
        offers its oldest request. The pool must cover the admission
        horizon plus the watermark: the whole prompt (plus the first
        decode token's page) in synchronous mode, only the first chunk
        in token-budget mode. A tenant blocked by its own quota, or by
        other tenants' unmet floors, is skipped for the pass; true pool
        pressure stops the pass head-of-line, and so does a branch group
        without n free slots."""
        skipped: set = set()
        order = {tid: i for i, tid in enumerate(self.tenants)}
        while self._queue_len and self.free_slots > 0:
            cands = [tid for tid, t in self.tenants.items()
                     if t.fifo and tid not in skipped]
            if not cands:
                return
            tid = min(cands, key=lambda t: (self.tenants[t].vtime,
                                            order.get(t, len(order))))
            ten = self.tenants[tid]
            req = ten.fifo[0]
            if req.group_n > self.free_slots:
                return
            if self.prefill_token_budget is None:
                horizon = min(len(req) + 1, self.max_len)
            else:
                horizon = min(len(req), self.chunk_tokens)
            need = self.cache.blocks_needed(horizon)
            # the quota gates every reference (a fork multiplies the
            # prompt's by n), unlike the pool draw below
            quota_need = need * req.group_n
            if ten.quota_blocks is not None and \
                    self.cache.tenant_charge(tid) + quota_need \
                    > ten.quota_blocks:
                ten.stats.quota_hits += 1
                skipped.add(tid)
                continue
            if self.prefix_cache:
                # actively shared prefix hits cost no pool draw;
                # cached-free hits come out of free_blocks (a resurrect
                # takes one free unit, like an alloc)
                matched = self.cache.match_prefix(
                    req.block_hashes(self.cache.block_size))
                rc = self.cache.allocator.refcount
                need -= sum(1 for b in matched if rc[b] > 0)
            # the prompt's pages land once however many branches will
            # reference them; each extra branch needs its first split
            draw = max(need, 0) + max(0, req.group_n - 1) \
                + self.watermark_blocks
            if draw > self.free_blocks:
                return
            if draw > self.free_blocks - self._unmet_floors(tid):
                skipped.add(tid)
                continue
            self._dequeue(req)
            self._vclock = ten.vtime
            ten.vtime += 1.0 / ten.weight
            if self.prefill_token_budget is None:
                try:
                    self._prefill(req)
                except BlockOOM as e:
                    if self.collector is not None:
                        self.collector.on_event("block_oom", dict(
                            e.details, rid=req.rid, tenant=req.tenant,
                            step=self._step_count))
                    # the budget check said the prompt fits (an injected
                    # fault): un-admit and retry on a later pass,
                    # against the retry budget
                    if req.slot is not None:
                        self._drop(req.slot)
                        req.slot = None
                    if self._over_retry_budget(req):
                        self._fail(req, RequestOutcome.FAILED_OOM,
                                   f"admission prefill OOM and retry "
                                   f"budget exhausted: {e}")
                    else:
                        req.preemptions += 1
                        self._tenant_of(req).stats.preemptions += 1
                        self._requeue_preempted(req)
                        self.preempted.append(req.rid)
                    return
            else:
                self._start_prefill(req)

    def _start_prefill(self, req: PagedRequest) -> int:
        """Grant a slot and set up the chunked-prefill state: adopt any
        cached prefix pages and compute the recompute start P (the
        suffix keeps at least MIN_PREFILL_SUFFIX_ROWS rows)."""
        slot = int(np.flatnonzero(~self.active & ~self.prefilling)[0])
        # attribute the slot before any page lands in it
        self.cache.set_seq_tenant(slot, req.tenant)
        T = len(req)
        bs = self.cache.block_size
        hashes: List[bytes] = []
        n_cached = 0
        if self.prefix_cache:
            hashes = req.block_hashes(bs)
            n_cached = self.cache.adopt_prefix(slot, hashes)
            self.prefix_stats.lookups += 1
            self.prefix_stats.lookup_blocks += len(hashes)
            self.prefix_stats.hit_blocks += n_cached
        P = max(0, min(n_cached * bs, T - MIN_PREFILL_SUFFIX_ROWS)) \
            if n_cached else 0
        if self.ledger is not None and P:
            # rows [0, P) adopted, never computed
            self.ledger.on_prefill_skip(req.rid, P)
        self._prefills[slot] = {"pos": P, "start": P,
                                "n_cached": n_cached, "hashes": hashes}
        self.prefilling[slot] = True
        self._requests[slot] = req
        req.slot = slot
        req.admit_seq = self._next_admit_seq
        self._next_admit_seq += 1
        self._tenant_of(req).stats.admitted += 1
        if req.preemptions > 0:
            self.resilience_stats.retried += 1
        if self.collector is not None:
            self.collector.on_admitted(req.rid, slot,
                                       retry=req.preemptions > 0)
        if req.group_n > 1 and self.prefill_token_budget is not None:
            # the prompt streams over many steps while admission goes
            # on: hold the branch slots now (the admission gate saw
            # group_n free slots)
            g = self.groups.groups[req.gid]
            for _ in range(req.group_n - 1):
                rs = int(np.flatnonzero(~self.active
                                        & ~self.prefilling)[0])
                self.prefilling[rs] = True
                g["reserved"].append(rs)
        return slot

    def _register_prefill(self, slot: int, st: dict) -> None:
        """Prompt fully in the pages: index its blocks and account the
        prefill the cache saved."""
        if self.prefix_cache:
            T = len(self._requests[slot])
            self.cache.register_prefix(slot, st["hashes"])
            self.prefix_stats.tokens_computed += T - st["start"]
            self.prefix_stats.tokens_skipped += st["start"]

    def _complete_prefill(self, slot: int, last_hidden) -> None:
        """Last chunk landed: the slot turns decodable, the admission
        event fires, a group lead forks, then the ``post_prefill`` crash
        point."""
        st = self._prefills.pop(slot)
        req = self._requests[slot]
        self._register_prefill(slot, st)
        self.prefilling[slot] = False
        self.lens[slot] = len(req)
        self.active[slot] = True
        self.admitted.append((req.rid, slot, last_hidden))
        if self.collector is not None:
            # the caller samples the first token from this hidden
            self.collector.on_first_token(req.rid)
        self._fork_group(slot, last_hidden)
        self._crash("post_prefill")

    def _finish_planned_prefill(self, slot: int, last_hidden) -> None:
        """Post-launch half of a packed step's prefill completion (the
        state changed at plan time): register, admitted event, fork,
        then the ``post_prefill`` crash point."""
        st = self._prefills.pop(slot)
        self._register_prefill(slot, st)
        rid = self._requests[slot].rid
        self.admitted.append((rid, slot, last_hidden))
        if self.collector is not None:
            self.collector.on_first_token(rid)
        self._fork_group(slot, last_hidden)
        self._crash("post_prefill")

    def _fork_group(self, slot: int, last_hidden) -> None:
        """Fork the branch slots of a group lead whose prompt has just
        landed (after the launch that wrote its last chunk): each branch
        gets a fresh rid, a copy of the history, a table referencing
        the lead's prompt pages (``PagedKVCache.fork``) and an admitted
        event carrying the lead's prefill hidden."""
        req = self._requests[slot]
        if req is None or req.group_n <= 1:
            return
        g = self.groups.groups.get(req.gid)
        if g is None or g["forked"]:
            return
        T = len(req)
        reserved = list(g["reserved"])
        del g["reserved"][:]
        for i in range(1, req.group_n):
            if reserved:
                bslot = reserved.pop(0)
                self.prefilling[bslot] = False
            else:
                bslot = int(np.flatnonzero(~self.active
                                           & ~self.prefilling)[0])
            breq = self._branch_request(req, i)
            self.groups.add_branch(req.gid, breq.rid)
            self._attach_fork(slot, bslot, breq, T)
            self.admitted.append((breq.rid, bslot, last_hidden))
            if self.collector is not None:
                self.collector.on_first_token(breq.rid)
        g["forked"] = True
        # the lead is a normal slot from here: a later preemption
        # re-prefills it alone
        req.group_n = 1

    def _branch_request(self, req: PagedRequest,
                        branch: int) -> PagedRequest:
        breq = PagedRequest(self._next_rid, req.history)
        self._next_rid += 1
        breq.tenant = req.tenant
        breq.gid = req.gid
        breq.branch = branch
        breq.max_preemptions = req.max_preemptions
        breq.deadline_steps = req.deadline_steps
        breq.deadline_time = req.deadline_time
        breq.submit_step = req.submit_step
        return breq

    def _attach_fork(self, src: int, bslot: int, breq: PagedRequest,
                     length: int) -> None:
        """Seat ``breq`` in ``bslot`` over ``src``'s pages up to
        ``length`` tokens (charged to the branch's tenant from the first
        reference) and count the fork. The ledger's ``on_fork`` raises the
        branch's high-water mark to the fork length without pending
        rows: the shared prefill is priced once, under the lead."""
        if self.collector is not None:
            self.collector.on_submit(breq.rid, breq.tenant, length,
                                     gid=breq.gid)
        if self.ledger is not None:
            self.ledger.on_submit(breq.rid, breq.tenant, length)
            self.ledger.on_fork(breq.rid, length)
        self.cache.set_seq_tenant(bslot, breq.tenant)
        self.cache.fork(src, bslot, length)
        self._requests[bslot] = breq
        breq.slot = bslot
        breq.admit_seq = self._next_admit_seq
        self._next_admit_seq += 1
        self.lens[bslot] = length
        self.active[bslot] = True
        self._tenant_of(breq).stats.admitted += 1
        if self.collector is not None:
            self.collector.on_admitted(breq.rid, bslot, retry=False)
        self.parallel_stats.branches += 1
        self.parallel_stats.prefill_tokens_saved += length
        self.parallel_stats.shared_blocks += \
            self.cache.blocks_needed(length)

    def fork_stream(self, rid: int) -> int:
        """Clone the running stream ``rid`` into a free slot: history
        copied, pages shared at the current length (the clone's next
        write splits), fresh rid returned. The source's group grows by
        the clone (a lone stream gets a group on demand). ValueError
        when ``rid`` is not active or no slot is free."""
        slot = next((s for s, r in enumerate(self._requests)
                     if r is not None and r.rid == rid), None)
        if slot is None or not self.active[slot]:
            raise ValueError(f"rid {rid} is not an active stream")
        # reserved branch slots are prefilling, so never free here
        free = np.flatnonzero(~self.active & ~self.prefilling)
        if not free.size:
            raise ValueError("no free slot to fork into")
        # buffered decode inputs reach the history before it is copied
        self._flush_history()
        req = self._requests[slot]
        if req.gid is None:
            req.gid = req.rid
            self.groups.create(req.rid, 1)["forked"] = True
            self.parallel_stats.groups += 1
        g = self.groups.groups[req.gid]
        breq = self._branch_request(req, len(g["rids"]))
        g["n"] += 1
        self.groups.add_branch(req.gid, breq.rid)
        self._attach_fork(slot, int(free[0]), breq, int(self.lens[slot]))
        return breq.rid

    def cancel(self, rid: int) -> bool:
        """Stop one stream early (best-of losers, beam cuts, the
        caller): its pages are freed, its outcome is CANCELLED. Works on
        running, mid-prefill and queued requests. False for an unknown
        or already terminal rid."""
        req = next((r for r in self._requests
                    if r is not None and r.rid == rid), None)
        if req is None:
            req = next((r for r in self.queue if r.rid == rid), None)
        if req is None:
            return False
        self._fail(req, RequestOutcome.CANCELLED, "cancelled (early stop)")
        self._try_admit()
        return True

    def _chunk_registrar(self, slot: int, st: dict):
        """``on_chunk`` hook: index every COMPLETED prompt block under
        its chain hash as the stream advances, so a request preempted
        mid-prefill re-adopts its finished pages on re-admission (they
        park cached-free when its slot is dropped). Only full blocks
        below the write frontier are registered: later chunks write
        strictly past them."""
        if not self.prefix_cache:
            return None
        last = [0]      # blocks this registrar has indexed so far

        def register(pos: int) -> None:
            done = pos // self.cache.block_size
            if done > last[0]:
                self.cache.register_prefix(slot, st["hashes"][:done],
                                           start=last[0])
                last[0] = done
        return register

    def _chunk_hook(self, slot: int, st: dict, req: PagedRequest):
        """``on_chunk`` for engine prefills: the prefix registrar
        composed with the collector's chunk event and the ledger's
        [prev, pos) row span, built only when a consumer exists."""
        reg = self._chunk_registrar(slot, st)
        col = self.collector
        led = self.ledger
        if col is None and led is None:
            return reg
        rid = req.rid
        prev = [st["pos"]]

        def hook(pos: int) -> None:
            if reg is not None:
                reg(pos)
            if led is not None:
                led.on_prefill(rid, prev[0], pos)
                prev[0] = pos
            if col is not None:
                col.on_prefill_chunk(rid, pos)
        return hook

    def _prefill(self, req: PagedRequest) -> None:
        """Synchronous admission: stream every chunk now. It runs
        outside the step timeline (at submit), so it records its own
        ``prefill`` span, closed flagged when a fault unwinds it."""
        slot = self._start_prefill(req)
        st = self._prefills[slot]
        col = self.collector
        depth = col.span_depth if col is not None else 0
        if col is not None:
            col.span_begin("prefill", rid=req.rid,
                           tokens=len(req) - st["pos"])
        try:
            _, h = chunked_prefill(
                self.model, self.cache, slot, req.history,
                pos=st["pos"], target=len(req),
                chunk_tokens=self.chunk_tokens,
                start_block=st["n_cached"],
                write_start=st["n_cached"] * self.cache.block_size,
                stats=self.prefill_stats,
                on_chunk=self._chunk_hook(slot, st, req))
            self._complete_prefill(slot, h)
        except BaseException:
            if col is not None:
                col.span_unwind(depth, aborted=True)
            raise
        if col is not None:
            col.span_unwind(depth)

    def _next_prefill_chunk(self, budget: int):
        """The oldest pending prefill's next chunk under ``budget``,
        with its pages grown under the preemption rules: (slot, req, st,
        c), or None when no prefill is pending; c is 0 when growing
        evicted or shed the slot."""
        # reserved branch slots (prefilling, no prefill state) hold no
        # prompt to advance
        slots = [int(s) for s in np.flatnonzero(self.prefilling)
                 if int(s) in self._prefills]
        if not slots:
            return None
        slot = min(slots, key=lambda s: self._requests[s].admit_seq)
        req = self._requests[slot]
        st = self._prefills[slot]
        c = _chunk_len(len(req), st["pos"], self.chunk_tokens,
                       budget=budget)
        if not self._grow_or_shed(slot, req, st["pos"] + c,
                                  start_block=st["n_cached"],
                                  write_from=st["pos"]):
            c = 0
        return slot, req, st, c

    def _advance_prefills(self) -> Tuple[bool, List[int]]:
        """Per-phase token-budget mode (``ragged_step=False``): spend
        ``prefill_token_budget`` prompt tokens on pending prefills,
        oldest first, each chunk its own model call
        (``chunked_prefill``). The cap is soft by one token (a chunk
        never leaves a 1-row tail). Returns (ran, fresh): whether any
        chunk ran, and the slots whose prefill completed — they sit
        this step's decode out (their admitted event is undrained)."""
        if self.prefill_token_budget is None or \
                self.num_prefilling == 0:
            return False, []
        budget = self.prefill_token_budget
        ran = False
        fresh: List[int] = []
        while budget >= MIN_PREFILL_SUFFIX_ROWS:
            nxt = self._next_prefill_chunk(budget)
            if nxt is None:
                break
            slot, req, st, c = nxt
            if not c:
                continue  # the slot was evicted (or shed) growing
            pos, h = chunked_prefill(
                self.model, self.cache, slot, req.history,
                pos=st["pos"], target=st["pos"] + c,
                chunk_tokens=self.chunk_tokens,
                start_block=st["n_cached"],
                write_start=st["n_cached"] * self.cache.block_size,
                stats=self.prefill_stats,
                on_chunk=self._chunk_hook(slot, st, req))
            st["pos"] = pos
            budget -= c
            ran = True
            if pos >= len(req):
                self._complete_prefill(slot, h)
                fresh.append(slot)
        if ran:
            self.prefill_stats.prefill_steps += 1
        return ran, fresh

    def _plan_prefills(self) -> Tuple[bool, List[int]]:
        """Packed token-budget mode: spend the budget exactly as
        ``_advance_prefills`` does (same chunks, growth, preemptions and
        stats) but RECORD the chunks in ``self._ragged_plan``; the
        step's single packed launch (``_flush_ragged_plan``) runs them
        with the decode rows. Completed prefills change slot state here;
        their admitted event fires post-launch."""
        if self.prefill_token_budget is None or \
                self.num_prefilling == 0:
            return False, []
        plan = self._ragged_plan
        budget = self.prefill_token_budget
        ran = False
        fresh: List[int] = []
        while budget >= MIN_PREFILL_SUFFIX_ROWS:
            nxt = self._next_prefill_chunk(budget)
            if nxt is None:
                break
            slot, req, st, c = nxt
            if not c:
                continue  # the slot was evicted (or shed) growing
            seg = plan[-1] if plan and plan[-1]["slot"] == slot else None
            if seg is None:
                seg = {"slot": slot, "req": req, "from": st["pos"],
                       "to": st["pos"],
                       "ws": st["n_cached"] * self.cache.block_size,
                       "bounds": [],
                       "hook": self._chunk_hook(slot, st, req),
                       "complete": False}
                plan.append(seg)
            st["pos"] += c
            seg["to"] = st["pos"]
            seg["bounds"].append(st["pos"])
            self.prefill_stats.chunks += 1
            self.prefill_stats.prefill_tokens += c
            self.prefill_stats.peak_blocks = max(
                self.prefill_stats.peak_blocks, self.cache.blocks_in_use)
            budget -= c
            ran = True
            if st["pos"] >= len(req):
                seg["complete"] = True
                self.prefilling[slot] = False
                self.lens[slot] = len(req)
                self.active[slot] = True
                fresh.append(slot)
        if ran:
            self.prefill_stats.prefill_steps += 1
        return ran, fresh

    def _flush_ragged_plan(self, x: Optional[torch.Tensor] = None,
                           L: int = 1):
        """Run the pending planned prefill segments — plus, at the step's
        model point, the fused decode rows x [max_batch, L, d] — as ONE
        ragged model call (one paged-attention launch per layer).
        Returns the decode hidden [max_batch, L, d] when ``x`` rode
        along, else None."""
        plan = self._ragged_plan
        segs = [s for s in plan if s["to"] > s["from"]]
        del plan[:]
        if not segs and x is None:
            return None
        desc: List[tuple] = [("prefill", s["slot"], s["from"],
                              s["to"] - s["from"], s["ws"]) for s in segs]
        if x is not None:
            desc.append(("decode", self.lens.copy(), L))
        views = self.cache.ragged_views(desc, tile_q=self.tile_q,
                                        tile_kv=self.tile_kv)
        dev = self.cache.device
        parts = []
        if segs:
            rows = np.concatenate([s["req"].history[s["from"]:s["to"]]
                                   for s in segs])
            parts.append(torch.from_numpy(
                np.ascontiguousarray(rows, np.float32)).to(dev))
        if x is not None:
            parts.append(x.reshape(self.max_batch * L, x.shape[-1]))
        xp = torch.cat(parts, dim=0)[None] if len(parts) > 1 \
            else parts[0][None]
        with torch.no_grad():
            out, _ = self.model(xp, caches=views, time_step=0)
        lo = 0
        for s in segs:
            n = s["to"] - s["from"]
            # the pages exist now: per-chunk registration, then the
            # completion (registration, admitted event)
            if s["hook"] is not None:
                for b in s["bounds"]:
                    s["hook"](b)
            if s["complete"]:
                self._finish_planned_prefill(
                    s["slot"], out[0, lo + n - 1:lo + n])
            lo += n
        if x is not None:
            return out[0, lo:lo + self.max_batch * L].reshape(
                self.max_batch, L, out.shape[-1])
        return None

    # -- release / preemption / failure -------------------------------
    def release(self, slot: int) -> None:
        """Caller-side finish (e.g. EOS): free the pages, record a
        FINISHED outcome, refill."""
        req = self._requests[slot]
        self._drop(slot)
        if req is not None:
            self._record(req, RequestOutcome.FINISHED, "released")
        self._try_admit()

    def _record(self, req: PagedRequest, status: str, reason: str) -> None:
        self.outcomes.append(RequestOutcome(
            req.rid, status, reason=reason, tokens=len(req),
            preemptions=req.preemptions, step=self._step_count))
        st = self.resilience_stats
        ts = self._tenant_of(req).stats
        if status == RequestOutcome.FAILED_OOM:
            st.shed += 1
            ts.sheds += 1
        elif status == RequestOutcome.FAILED_NUMERIC:
            st.nan_failed += 1
            ts.nan_failed += 1
        elif status == RequestOutcome.FAILED_DEADLINE:
            st.deadline_failed += 1
            ts.deadline_failed += 1
        elif status == RequestOutcome.REJECTED_ADMISSION:
            st.rejected += 1
            ts.rejections += 1
        elif status == RequestOutcome.CANCELLED:
            st.cancelled += 1
            ts.cancelled += 1
        self.groups.on_terminal(req.rid)
        col = self.collector
        if self.ledger is not None:
            # the verdict resolves the request's pending work (goodput on
            # FINISHED, waste of the failure's cause otherwise)
            self.ledger.on_outcome(req.rid, status)
        if col is not None:
            col.on_outcome(req.rid, status, self._step_count,
                           reason=reason)
            if status == RequestOutcome.FAILED_OOM:
                # every shed carries who held the pool when it fired
                col.on_event("oom_shed", dict(
                    self.cache.pool_occupancy(), rid=req.rid,
                    tenant=req.tenant, step=self._step_count))

    def _fail(self, req: PagedRequest, status: str, reason: str) -> None:
        """Terminal failure of ONE request: free its pages (quarantined
        after a numeric failure: no cached-free second chance), detach
        it from slot or queue, record the outcome."""
        if req.slot is not None:
            self._drop(req.slot,
                       quarantine=status == RequestOutcome.FAILED_NUMERIC)
            req.slot = None
        else:
            try:
                self._dequeue(req)
            except ValueError:
                pass
        self._record(req, status, reason)

    def _over_retry_budget(self, req: PagedRequest) -> bool:
        return req.max_preemptions is not None and \
            req.preemptions >= req.max_preemptions

    def _requeue_preempted(self, req: PagedRequest) -> None:
        """Preempted requests re-enter their tenant's sub-queue ahead of
        never-admitted ones, ordered among themselves by original
        submission age."""
        self._bump_vtime(req.tenant)
        ten = self.tenants[req.tenant]
        key = self._queue_key(req)
        i = 0
        for r in ten.fifo:
            if self._queue_key(r) < key:
                i += 1
            else:
                break
        ten.fifo.insert(i, req)
        ten.queued += 1
        self._queue_len += 1

    def _check_deadlines(self) -> None:
        """Fail every request (active, mid-prefill or queued) past its
        deadline. Free unless some submit() set a deadline."""
        if not self._has_deadlines:
            return
        now = None
        held = [self._requests[int(s)] for s in
                np.flatnonzero(self.active | self.prefilling)]
        queued = [r for t in self.tenants.values() for r in t.fifo]
        for req in held + queued:
            if req is None:
                continue
            expired = ""
            if req.deadline_steps is not None and \
                    self._step_count - req.submit_step > \
                    req.deadline_steps:
                expired = (f"deadline of {req.deadline_steps} steps "
                           f"exceeded")
            elif req.deadline_time is not None:
                now = time.monotonic() if now is None else now
                if now >= req.deadline_time:
                    expired = "wall-clock deadline exceeded"
            if expired:
                self._fail(req, RequestOutcome.FAILED_DEADLINE, expired)

    def _flush_history(self) -> None:
        """Attribute buffered decode inputs to their requests' histories
        (must run before any slot -> request mapping change)."""
        if not self._pending_history:
            return
        pending, self._pending_history = self._pending_history, []
        for xt, mask in pending:
            xv = xt.cpu().numpy()
            for slot in np.flatnonzero(mask):
                req = self._requests[int(slot)]
                if req is not None:
                    for row in xv[int(slot)]:
                        req.append_history(row)

    def _drop(self, slot: int, quarantine: bool = False) -> None:
        plan = self._ragged_plan
        if plan and any(s["slot"] == slot for s in plan):
            # the slot's planned chunks must land (and its completed
            # state settle) before its pages are freed
            self._flush_ragged_plan()
        self._flush_history()
        req = self._requests[slot]
        if req is not None and req.group_n > 1:
            # an unforked lead leaving its slot gives up its branch-slot
            # reservation; a re-admission reserves afresh
            g = self.groups.groups.get(req.gid)
            if g is not None:
                for rs in g["reserved"]:
                    self.prefilling[rs] = False
                del g["reserved"][:]
        if quarantine:
            self.cache.quarantine_seq(slot)
        else:
            self.cache.free_seq(slot)
        self.active[slot] = False
        self.prefilling[slot] = False
        self._prefills.pop(slot, None)
        self.lens[slot] = 0
        self._requests[slot] = None

    def preempt(self, slot: int) -> None:
        """Evict a running (or mid-prefill) request: free ALL its pages
        and requeue it for re-prefill from its history; past its
        ``max_preemptions`` budget it FAILS (FAILED_OOM) instead."""
        req = self._requests[slot]
        if req is None:
            raise ValueError(f"slot {slot} not active")
        if self._over_retry_budget(req):
            self._fail(req, RequestOutcome.FAILED_OOM,
                       f"preemption retry budget ({req.max_preemptions})"
                       f" exhausted")
            return
        self._drop(slot)
        req.slot = None
        req.preemptions += 1
        self._tenant_of(req).stats.preemptions += 1
        self._requeue_preempted(req)
        self.preempted.append(req.rid)
        if self.collector is not None:
            self.collector.on_preempted(req.rid)

    def _held_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.active | self.prefilling)
                if self._requests[int(s)] is not None]

    def _oom_victims(self, req: PagedRequest) -> List[int]:
        """Eviction candidates for a POOL OOM while growing ``req``: the
        grower's own tenant's slots; a grower still below its reserved
        floor may take the slots of tenants borrowing above theirs. With
        one tenant both are every held slot (youngest first)."""
        held = self._held_slots()
        ten = self._tenant_of(req)
        if ten.reserved_blocks and \
                self.cache.tenant_charge(ten.tid) < ten.reserved_blocks:
            over = [s for s in held
                    if self._over_floor(self._requests[s].tenant)]
            if over:
                return over
        return [s for s in held if self._requests[s].tenant == ten.tid]

    def _over_floor(self, tid: str) -> bool:
        return self.cache.tenant_charge(tid) > \
            self.tenants[tid].reserved_blocks

    def _preempt_youngest(self, cands: Optional[List[int]] = None) -> int:
        if cands is None:
            cands = self._held_slots()
        victim = max(cands, key=lambda s: self._requests[s].admit_seq)
        self.preempt(victim)
        return victim

    def _grow_or_shed(self, slot: int, req: PagedRequest, length: int,
                      *, start_block: int = 0,
                      write_from: Optional[int] = None) -> bool:
        """Cover ``length`` tokens for ``slot`` (allocate-on-write and
        COW split), evicting on pressure — possibly the grower itself
        (it then re-queues). Returns True when the slot is still alive.
        In order:

          1. tenant quota: growth past the cap evicts the tenant's own
             youngest; with nothing else of its own the grower is SHED
             (FAILED_OOM naming the quota);
          2. reserved floors: a tenant at or over its own floor may not
             dip the free pool below other tenants' unmet floors; it
             evicts within itself (or self-evicts and waits queued);
          3. pool OOM: victims from ``_oom_victims``; with no victim but
             the grower, the grower is SHED."""
        if not (self.active[slot] or self.prefilling[slot]):
            return False    # already evicted growing an earlier slot
        ten = self._tenant_of(req)
        while self.active[slot] or self.prefilling[slot]:
            need_new = self.cache.blocks_needed(length) \
                - len(self.cache.seq_blocks[slot])
            if need_new > 0 and ten.quota_blocks is not None and \
                    self.cache.tenant_charge(ten.tid) + need_new \
                    > ten.quota_blocks:
                ten.stats.quota_hits += 1
                own = [s for s in self._held_slots()
                       if self._requests[s].tenant == ten.tid]
                if len(own) <= 1:
                    self._fail(req, RequestOutcome.FAILED_OOM,
                               f"tenant {ten.tid!r} block quota "
                               f"({ten.quota_blocks}) exhausted: "
                               f"{self.cache.tenant_charge(ten.tid)} "
                               f"held + {need_new} needed")
                else:
                    self._preempt_youngest(own)
                continue
            if need_new > 0 and \
                    self.cache.tenant_charge(ten.tid) \
                    >= ten.reserved_blocks:
                unmet = self._unmet_floors(exclude=ten.tid)
                if unmet and self.free_blocks - need_new < unmet:
                    own = [s for s in self._held_slots()
                           if self._requests[s].tenant == ten.tid]
                    self._preempt_youngest(own)
                    continue
            try:
                self.cache.ensure(slot, length, start_block=start_block,
                                  write_from=write_from)
                return True
            except BlockOOM as e:
                if self.collector is not None:
                    self.collector.on_event("block_oom", dict(
                        e.details, rid=req.rid, tenant=req.tenant,
                        step=self._step_count))
                cands = self._oom_victims(req)
                if not any(s != slot for s in cands):
                    self._fail(req, RequestOutcome.FAILED_OOM,
                               f"pool exhausted even after preempting "
                               f"every eligible request: {e}")
                else:
                    self._preempt_youngest(cands)
        return False

    def _sanitize_masked_rows(self, x: torch.Tensor,
                              stepping: np.ndarray) -> torch.Tensor:
        """Zero the rows of x that are NOT stepping (on device): their
        trash-block writes stay finite, so a caller's NaN row can never
        poison another sequence's masked attention tail."""
        mask = torch.from_numpy(stepping.reshape(-1, 1, 1)).to(x.device)
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

    def _guard_numeric(self, out: torch.Tensor,
                       stepping: np.ndarray) -> None:
        """Per-slot numeric guard: one [B] bool reduction on the device,
        one small host read. A non-finite value in a stepping slot's
        output row fails THAT request (FAILED_NUMERIC, pages
        quarantined); the step stands for every other slot."""
        finite = torch.isfinite(out).reshape(out.shape[0], -1) \
            .all(dim=1).cpu().numpy()
        bad = stepping & ~finite
        for slot in np.flatnonzero(bad):
            req = self._requests[int(slot)]
            if req is None:
                continue
            self._fail(req, RequestOutcome.FAILED_NUMERIC,
                       f"non-finite hidden in slot {int(slot)} at "
                       f"step {self._step_count}")

    # -- decode -------------------------------------------------------
    def step(self, x):
        """One fused decode step for every active slot. x: [max_batch, 1,
        d_model] next-token embeddings (inactive rows: any values).
        Slots at page capacity are auto-released first (``finished``);
        rows crossing a block boundary allocate their next page,
        preempting on pool pressure. In token-budget mode the step first
        spends the budget on prefill chunks (packed with the decode rows
        unless ``ragged_step`` is False), and may run with no active
        slot while prompts stream (returns None). A request that cannot
        be served (pool dry after every eviction, deadline blown,
        non-finite hidden) fails alone; no BlockOOM leaves this call.
        Returns hidden [max_batch, 1, d_model] (only rows active during
        this step are meaningful), or None."""
        return self._run_step(x, 1, retire=True)

    def step_multi(self, x):
        """One fused MULTI-TOKEN step for every active slot — the
        speculative verify: row b's L tokens (x [max_batch, L, d_model])
        are appended at positions lens[b] .. lens[b]+L-1 and scored
        causally in ONE model call. The caller guarantees lens + L <=
        capacity for every active slot (slots at capacity are not
        auto-released here; the caller retires them). Page growth covers
        all L positions, preempting as ``step`` does; ``rollback`` drops
        a rejected tail. In token-budget mode the step first spends the
        budget on pending prefill chunks; slots mid-prefill or completed
        in this step sit the verify out. Returns hidden [max_batch, L,
        d_model], or None while prompts stream with no verifiable
        slot."""
        return self._run_step(x, int(x.shape[1]), retire=False)

    def rollback(self, slot: int, new_len: int) -> None:
        """Roll an active slot back to ``new_len`` consumed tokens
        (speculative rejection): the history is trimmed first, so a
        later preempt -> re-prefill replays only ACCEPTED tokens, then
        the pages past the boundary are released table-tail first
        (``PagedKVCache.truncate``); the slot decodes on from
        ``new_len``."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} not active")
        new_len = int(new_len)
        if new_len < 1 or new_len > int(self.lens[slot]):
            raise ValueError(
                f"rollback of slot {slot} to {new_len} outside "
                f"[1, {int(self.lens[slot])}]")
        old_len = int(self.lens[slot])
        # buffered inputs must reach the history BEFORE trimming it
        self._flush_history()
        self._requests[slot].truncate_history(new_len,
                                              self.cache.block_size)
        self.cache.truncate(slot, new_len)
        self.lens[slot] = new_len
        if old_len > new_len:
            rid = self._requests[slot].rid
            if self.collector is not None:
                self.collector.on_rollback(rid, old_len - new_len)
            if self.ledger is not None:
                self.ledger.on_rollback(rid, new_len, old_len)

    # -- resilience ---------------------------------------------------
    def _crash(self, phase: str) -> None:
        """Consult the injector's crash schedule (a no-op without a
        CrashInjector)."""
        if self.injector is not None:
            self.injector.crash_point(phase)

    def _begin_step(self, kind: str = "step") -> bool:
        """Step-top bookkeeping: advance the step clock (the injector's
        too, then the ``begin`` crash point), enforce deadlines, refresh
        the tenants' blocks_held, and open the collector's step span
        last (a step that dies at its top leaves no dangling span).
        Returns whether the engine was empty on entry."""
        self._step_count += 1
        if self.injector is not None:
            self.injector.begin_step(self._step_count)
            self.injector.crash_point("begin")
        idle = self.num_active == 0 and self.num_prefilling == 0 \
            and not self._queue_len
        self._check_deadlines()
        for tid, ten in self.tenants.items():
            ten.stats.blocks_held = self.cache.tenant_charge(tid)
        if self.collector is not None:
            self.collector.begin_step(self._step_count, kind)
        return idle

    def _end_step_telemetry(self, aborted: bool = False) -> None:
        """Close the step span with the per-step gauges (pool tiers,
        queue depths, per-tenant charge), bill the step in the ledger
        and hand it to the monitor. Called from the step's ``finally``:
        a step torn down by a fault or an injected crash closes flagged
        (``aborted``), bills nothing and is not sampled."""
        col = self.collector
        charges = None
        if not aborted and (col is not None or self.ledger is not None):
            # one per-tenant charge walk for the gauge track and the
            # block-step bill; every registered tenant, zeros included
            charges = {tid: self.cache.tenant_charge(tid)
                       for tid in self.tenants}
        if col is not None:
            if aborted:
                col.end_step(aborted=True)
            else:
                occ = self.cache.pool_occupancy(tiers_only=True)
                col.end_step({
                    "pool": {"active": occ["active"],
                             "cached_free": occ["cached_free"],
                             "free": occ["free"]},
                    "queue": self._queue_gauges(),
                    "tenant_blocks": charges,
                })
        if self.ledger is not None:
            if aborted:
                self.ledger.on_step_abort()
            else:
                # the collector's registry lets the ledger pair the
                # step's work with its measured model-span duration
                self.ledger.on_step(
                    self._step_count, charges,
                    span_src=(col.registry if col is not None
                              else None))
        if self.monitor is not None and not aborted:
            self.monitor.on_step(self._step_count)

    def _count_tokens_served(self, stepping: np.ndarray, n: int) -> None:
        for slot in np.flatnonzero(stepping):
            req = self._requests[int(slot)]
            if req is not None:
                self._tenant_of(req).stats.tokens_served += n

    def _ragged_active(self) -> bool:
        """Pack this step? ``ragged_step`` (True or "force") with a
        token budget. The port packs whenever that is legal, on the CPU
        and on CUDA alike, which already is all a core's
        ``prefers_packed_step`` asks for (the reference's
        scheduler.py:1917-1920, where packing otherwise waits for the
        kernel path)."""
        return bool(self.ragged_step) and \
            self.prefill_token_budget is not None

    def _run_step(self, x, L: int, retire: bool):
        idle = self._begin_step(kind="step" if retire else "verify")
        ok = False
        try:
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x, np.float32))
            x = x.to(self.cache.device)
            if not self._ragged_active():
                out = self._step_body(idle, x, L, retire)
            else:
                self._ragged_plan = []
                try:
                    out = self._step_body(idle, x, L, retire)
                finally:
                    self._ragged_plan = None
            ok = True
            return out
        finally:
            # balanced even when an injected crash unwinds the step; a
            # no-op (no clock read) with nothing installed
            self._end_step_telemetry(aborted=not ok)

    def _step_body(self, idle: bool, x: torch.Tensor, L: int,
                   retire: bool):
        plan = self._ragged_plan
        col = self.collector
        if col is not None:
            col.phase("prefill")
        if plan is None:
            ran_prefill, fresh = self._advance_prefills()
        else:
            ran_prefill, fresh = self._plan_prefills()
        if col is not None:
            col.phase("bookkeeping")
        if self.num_active == 0:
            if ran_prefill or self.num_prefilling > 0 \
                    or self._queue_len or not idle:
                if plan:
                    self._flush_ragged_plan()
                self._try_admit()
                return None
            raise RuntimeError("step() with no active slots")
        if retire:
            # capacity-finished slots: report + release
            for slot in np.flatnonzero(self.active &
                                       (self.lens >= self.max_len)):
                req = self._requests[int(slot)]
                self.finished.append((req.rid, int(slot),
                                      int(self.lens[slot])))
                self._drop(int(slot))
                self._record(req, RequestOutcome.FINISHED,
                             "page capacity reached")
        stepping = self.active.copy()
        for slot in fresh:
            stepping[slot] = False
        if not stepping.any():
            if plan:
                self._flush_ragged_plan()
            self._try_admit()
            return None
        over = stepping & (self.lens + L > self.max_len)
        if over.any():
            if plan:
                self._flush_ragged_plan()
            raise ValueError(
                f"slots {np.flatnonzero(over).tolist()} cannot take {L} "
                f"token(s) within capacity {self.max_len}; release them "
                f"first")
        # grow pages (allocate-on-write), oldest first: under pressure
        # the young yield to the old
        for slot in sorted(np.flatnonzero(stepping),
                           key=lambda s: self._requests[s].admit_seq):
            slot = int(slot)
            self._grow_or_shed(slot, self._requests[slot],
                               int(self.lens[slot]) + L,
                               write_from=int(self.lens[slot]))
        stepping &= self.active     # growth may have evicted some
        if not stepping.any():
            if plan:
                self._flush_ragged_plan()
            self._try_admit()
            return None
        if len(self._pending_history) >= 32:
            self._flush_history()
        x = self._sanitize_masked_rows(x, stepping)
        self._pending_history.append((x, stepping.copy()))
        # mid-prefill and freshly admitted slots present all-trash
        # tables so the decode append cannot touch their pages
        masked = self.prefilling | (self.active & ~stepping)
        self.cache.set_decode_mask(masked if masked.any() else None)
        if col is not None:
            # launch time only: the device time lands at the first
            # readback (the numeric guard below, or the caller's)
            col.phase("model")
        if plan is not None:
            out = self._flush_ragged_plan(x=x, L=L)
        else:
            with torch.no_grad():
                out, _ = self.model(x, caches=self.cache.views,
                                    time_step=self.lens.copy())
        if self.injector is not None:
            out = self.injector.corrupt_hidden(out)
        if col is not None:
            col.phase("bookkeeping")
        self.lens[stepping] += L
        self._count_tokens_served(stepping, L)
        if col is not None or self.ledger is not None:
            rows = [(self._requests[int(s)].rid, int(self.lens[s]) - L)
                    for s in np.flatnonzero(stepping)
                    if self._requests[int(s)] is not None]
            if col is not None:
                col.on_decode([r for r, _ in rows], L)
            if self.ledger is not None:
                # L consumed rows per slot at positions [len-L, len)
                self.ledger.on_decode(rows, L)
        self.prefill_stats.decode_steps += 1
        if ran_prefill:
            self.prefill_stats.mixed_steps += 1
        self.prefill_stats.peak_blocks = max(
            self.prefill_stats.peak_blocks, self.cache.peak_blocks_used)
        if self.numeric_guard:
            self._guard_numeric(out, stepping)
        if col is not None:
            col.phase("admission")
        self._try_admit()
        return out

    # -- audit ----------------------------------------------------------
    def check_invariants(self) -> bool:
        """Audit engine + pool bookkeeping (PagedKVCache.check_invariants
        for the pool list); raises AssertionError on violation: every
        active or prefilling slot maps to a request that points back at
        it (a reserved branch slot: to none), queued requests hold no
        slot and sit in queue order, every live request's tenant is
        registered and matches the pool's attribution, each tenant's
        queued gauge equals its sub-queue and no tenant is over its
        quota, every active slot's table covers its length, and the
        group records and their shared pages agree."""
        reserved = self.groups.reserved_slots()
        for slot in np.flatnonzero(self.active | self.prefilling):
            if int(slot) in reserved:
                assert self.prefilling[int(slot)] and \
                    self._requests[int(slot)] is None and \
                    int(slot) not in self._prefills and \
                    self.lens[int(slot)] == 0, \
                    f"reserved branch slot {int(slot)} inconsistent"
                continue
            req = self._requests[int(slot)]
            assert req is not None and req.slot == int(slot), \
                f"slot {int(slot)} active without a matching request"
        queue = self.queue
        for req in queue:
            assert req.slot is None, \
                f"queued request {req.rid} still holds slot {req.slot}"
        assert not (self.active & self.prefilling).any(), \
            "slot both active and prefilling"
        for slot in self._prefills:
            assert self.prefilling[slot], \
                f"prefill state for non-prefilling slot {slot}"
        for slot in np.flatnonzero(self.active | self.prefilling):
            req = self._requests[int(slot)]
            if req is None:        # reserved branch slot (audited above)
                continue
            assert req.tenant in self.tenants, \
                f"slot {int(slot)} request of unknown tenant " \
                f"{req.tenant!r}"
            assert self.cache.seq_tenant[int(slot)] == req.tenant, \
                (f"slot {int(slot)} cache attribution "
                 f"{self.cache.seq_tenant[int(slot)]!r} != request "
                 f"tenant {req.tenant!r}")
        queued_by_tenant: Dict[str, int] = {}
        for r in queue:
            assert r.tenant in self.tenants, \
                f"queued request {r.rid} of unknown tenant {r.tenant!r}"
            queued_by_tenant[r.tenant] = \
                queued_by_tenant.get(r.tenant, 0) + 1
        total_q = 0
        for tid, ten in self.tenants.items():
            assert ten.queued == queued_by_tenant.get(tid, 0) \
                == len(ten.fifo), \
                (f"tenant {tid!r} queued gauge {ten.queued} != "
                 f"{queued_by_tenant.get(tid, 0)} request(s) actually "
                 f"queued (sub-queue holds {len(ten.fifo)})")
            total_q += len(ten.fifo)
            keys = [self._queue_key(r) for r in ten.fifo]
            assert keys == sorted(keys), \
                (f"tenant {tid!r} sub-queue out of admission order: "
                 f"{[r.rid for r in ten.fifo]}")
            assert all(r.tenant == tid for r in ten.fifo), \
                f"foreign request in tenant {tid!r} sub-queue"
            if ten.quota_blocks is not None:
                held = self.cache.tenant_charge(tid)
                assert held <= ten.quota_blocks, \
                    (f"tenant {tid!r} holds {held} block(s) over its "
                     f"quota {ten.quota_blocks}")
        assert self._queue_len == total_q, \
            (f"queue depth gauge {self._queue_len} != {total_q} "
             f"request(s) across the sub-queues")
        self._audit_groups()
        self.cache.check_invariants(lens=self.lens, active=self.active)
        self.resilience_stats.audits += 1
        return True

    def _audit_groups(self) -> None:
        """Per live group: the lead heads its members, the live set is
        a subset of them, only an unforked group reserves slots, and
        each pool block's multiplicity across the members' tables is
        covered by its refcount (the prefix cache may hold more)."""
        by_slot = {r.rid: s for s, r in enumerate(self._requests)
                   if r is not None}
        for gid, g in self.groups.groups.items():
            assert g["rids"][0] == gid, \
                f"group {gid} lead rid mismatch: {g['rids']}"
            assert set(g["live"]) <= set(g["rids"]), \
                f"group {gid} live set exceeds its members"
            if g["forked"]:
                assert not g["reserved"], \
                    f"forked group {gid} still holds reserved slots"
            slots = [by_slot[r] for r in g["rids"] if r in by_slot]
            if not slots:
                continue
            rep = self.cache.share_report(slots)
            for b, m in rep["multiplicity"].items():
                assert rep["refcount"][b] >= m, \
                    (f"group {gid}: block {b} referenced by {m} member "
                     f"table(s) but refcount is {rep['refcount'][b]}")

    # -- page migration -------------------------------------------------
    def export_request_slice(self, rid: int) -> Optional[dict]:
        """The wire-format slice of ``rid``'s finished prefix pages
        (``PagedKVCache.export_slice``): full blocks the slot has
        computed (an active slot's length, a mid-prefill slot's chunk
        frontier). None when the request is unknown, queued, or holds no
        full block yet. A pure read."""
        self._flush_history()
        req = next((r for r in self._requests
                    if r is not None and r.rid == rid), None)
        if req is None or req.slot is None:
            return None
        slot = int(req.slot)
        if self.prefilling[slot]:
            covered = int(self._prefills[slot]["pos"])
        else:
            covered = int(self.lens[slot])
        n_full = covered // self.cache.block_size
        if n_full <= 0:
            return None
        hashes = req.block_hashes(self.cache.block_size)[:n_full]
        if not hashes:
            return None
        return self.cache.export_slice(slot, hashes)

    def import_slice(self, slc: dict) -> int:
        """Adopt a migrated slice into this engine's pool (cached-free,
        hash-indexed): the request's resubmission hits it through the
        normal prefix-cache admission."""
        return self.cache.import_slice(slc)

    # -- checkpoint / restore -----------------------------------------
    @staticmethod
    def _stats_rec(st) -> dict:
        return {name: getattr(st, name) for name in st.__slots__}

    @staticmethod
    def _stats_set(st, rec: dict) -> None:
        for name, v in rec.items():
            setattr(st, name, v)

    def _req_rec(self, req: PagedRequest, now: float) -> dict:
        """Picklable record of one request (a wall-clock deadline as the
        seconds remaining at snapshot time)."""
        return {
            "rid": req.rid,
            "history": np.array(req.history, np.float32, copy=True),
            "hashes": list(req._hashes),
            "slot": req.slot,
            "admit_seq": req.admit_seq,
            "preemptions": req.preemptions,
            "max_preemptions": req.max_preemptions,
            "deadline_steps": req.deadline_steps,
            "deadline_remaining": (None if req.deadline_time is None
                                   else req.deadline_time - now),
            "submit_step": req.submit_step,
            "tenant": req.tenant,
            "gid": req.gid,
            "branch": req.branch,
            "group_n": req.group_n,
        }

    def snapshot(self) -> dict:
        """Checkpoint everything a restored engine needs to continue as
        this one would: the pool (``PagedKVCache.snapshot``), every live
        request (queued, mid-prefill and running), queue order, slot
        state and prefill frontiers, the step clock and sequencers, the
        groups, the tenants and the virtual clock, every stats sibling,
        and the undrained events. Buffered decode inputs are flushed to
        the histories first. A plain picklable dict with the JAX
        engine's keys."""
        self._flush_history()
        now = time.monotonic()
        queue = self.queue
        reqs: Dict[int, PagedRequest] = {
            r.rid: r for r in list(queue)
            + [q for q in self._requests if q is not None]}
        return {
            "kind": "paged_engine",
            "config": {
                "max_batch": self.max_batch,
                "block_size": self.cache.block_size,
                "num_blocks": self.cache.num_blocks,
                "max_blocks_per_seq": self.cache.max_blocks_per_seq,
                "dtype": self.cache.dtype_name,
                "watermark_blocks": self.watermark_blocks,
                "prefix_cache": self.prefix_cache,
                "chunk_tokens": self.chunk_tokens,
                "prefill_token_budget": self.prefill_token_budget,
                "max_preemptions": self.max_preemptions,
                "numeric_guard": self.numeric_guard,
                "ragged_step": self.ragged_step,
                "tile_q": self.tile_q,
                "tile_kv": self.tile_kv,
            },
            "cache": self.cache.snapshot(),
            "requests": [self._req_rec(r, now) for r in reqs.values()],
            "queue": [r.rid for r in queue],
            "slot_rids": [None if r is None else r.rid
                          for r in self._requests],
            "lens": self.lens.copy(),
            "active": self.active.copy(),
            "prefilling": self.prefilling.copy(),
            "prefills": {int(s): {"pos": st["pos"], "start": st["start"],
                                  "n_cached": st["n_cached"],
                                  "hashes": list(st["hashes"])}
                         for s, st in self._prefills.items()},
            "counters": {"next_rid": self._next_rid,
                         "next_admit_seq": self._next_admit_seq,
                         "step_count": self._step_count,
                         "has_deadlines": self._has_deadlines},
            "groups": self.groups.snapshot(),
            "tenants": [{"id": t.tid,
                         "quota_blocks": t.quota_blocks,
                         "reserved_blocks": t.reserved_blocks,
                         "weight": t.weight,
                         "vtime": t.vtime,
                         "stats": self._stats_rec(t.stats)}
                        for t in self.tenants.values()],
            "vclock": self._vclock,
            "stats": {"prefix": self._stats_rec(self.prefix_stats),
                      "prefill": self._stats_rec(self.prefill_stats),
                      "resilience":
                          self._stats_rec(self.resilience_stats),
                      "parallel":
                          self._stats_rec(self.parallel_stats)},
            "events": {
                "admitted": [(rid, slot,
                              None if h is None
                              else h.detach().cpu().numpy())
                             for rid, slot, h in self.admitted],
                "finished": list(self.finished),
                "preempted": list(self.preempted),
            },
            "outcomes": [oc.as_dict() for oc in self.outcomes],
        }

    @classmethod
    def restore(cls, model, snap: dict, *, injector=None,
                collector=None, monitor=None, ledger=None,
                num_blocks: Optional[int] = None) -> "PagedServingEngine":
        """Rebuild an engine from a ``snapshot`` (either package's)
        around the caller's model, on the model's device. ``num_blocks``
        rehomes the pool into another size (``PagedKVCache.restore``).
        The injector is wired fresh; its schedules stay keyed by the
        restored step clock. The collector, monitor and ledger are the
        caller's, wired fresh (a snapshot carries none of their state);
        the monitor rebases at the restored step. Ends with the engine
        and deep pool audit."""
        cfg = snap["config"]
        nb = cfg["num_blocks"] if num_blocks is None else int(num_blocks)
        # a 2-block placeholder pool: the restored one replaces it below,
        # so recovery never holds two full pools
        eng = cls(model, cfg["max_batch"], cfg["block_size"], 2,
                  max_blocks_per_seq=cfg["max_blocks_per_seq"],
                  dtype=cfg["dtype"],
                  watermark_blocks=cfg["watermark_blocks"],
                  prefix_cache=cfg["prefix_cache"],
                  chunk_tokens=cfg["chunk_tokens"],
                  prefill_token_budget=cfg["prefill_token_budget"],
                  injector=injector, collector=collector,
                  monitor=monitor, ledger=ledger,
                  max_preemptions=cfg["max_preemptions"],
                  numeric_guard=cfg["numeric_guard"],
                  ragged_step=cfg.get("ragged_step", True),
                  tile_q=cfg.get("tile_q"),
                  tile_kv=cfg.get("tile_kv"))
        # the pool's tensor-parallel width is the CALLER'S model's, not
        # the snapshot's: the payload is canonical (full-head pages), so
        # an mp=N snapshot restores behind an mp=1 model and the other
        # way round (the reference's scheduler.py:2774-2779)
        eng.cache = PagedKVCache.restore(
            snap["cache"], num_blocks=nb, mp=getattr(model, "mp", 1),
            shard_devices=getattr(model, "shard_devices", None),
            device=model.device)
        if injector is not None:
            eng.cache.allocator.fault_hook = \
                lambda n: injector.on_alloc("target", n)
        eng.max_len = eng.cache.capacity_per_seq
        now = time.monotonic()
        for trec in snap.get("tenants", []):
            ten = Tenant(trec["id"],
                         quota_blocks=trec["quota_blocks"],
                         reserved_blocks=trec["reserved_blocks"],
                         weight=trec["weight"])
            ten.vtime = trec["vtime"]
            cls._stats_set(ten.stats, trec["stats"])
            eng.tenants[ten.tid] = ten
        eng._vclock = snap.get("vclock", 0.0)
        reqs: Dict[int, PagedRequest] = {}
        for rec in snap["requests"]:
            req = PagedRequest(rec["rid"], rec["history"])
            req._hashes = list(rec["hashes"])
            req.tenant = rec.get("tenant", DEFAULT_TENANT)
            req.slot = rec["slot"]
            req.admit_seq = rec["admit_seq"]
            req.preemptions = rec["preemptions"]
            req.max_preemptions = rec["max_preemptions"]
            req.deadline_steps = rec["deadline_steps"]
            if rec["deadline_remaining"] is not None:
                req.deadline_time = now + rec["deadline_remaining"]
            req.submit_step = rec["submit_step"]
            req.gid = rec.get("gid")
            req.branch = rec.get("branch", 0)
            req.group_n = rec.get("group_n", 1)
            reqs[req.rid] = req
        eng._requests = [None if rid is None else reqs[rid]
                         for rid in snap["slot_rids"]]
        for slot, r in enumerate(eng._requests):
            if r is not None:
                eng.cache.set_seq_tenant(slot, r.tenant)
        # the saved order is the merged order, so appending in sequence
        # keeps each tenant's sub-order (enqueue seqs are renumbered;
        # only their relative order matters)
        for rid in snap["queue"]:
            r = reqs[rid]
            eng._resolve_tenant(r.tenant)
            eng._enqueue(r)
        eng.lens = np.array(snap["lens"], np.int32)
        eng.active = np.array(snap["active"], bool)
        eng.prefilling = np.array(snap["prefilling"], bool)
        eng._prefills = {int(s): dict(st)
                         for s, st in snap["prefills"].items()}
        c = snap["counters"]
        eng._next_rid = c["next_rid"]
        eng._next_admit_seq = c["next_admit_seq"]
        eng._step_count = c["step_count"]
        eng._has_deadlines = c["has_deadlines"]
        eng.groups.restore(snap.get("groups", {}))
        cls._stats_set(eng.prefix_stats, snap["stats"]["prefix"])
        cls._stats_set(eng.prefill_stats, snap["stats"]["prefill"])
        cls._stats_set(eng.resilience_stats,
                       snap["stats"]["resilience"])
        cls._stats_set(eng.parallel_stats,
                       snap["stats"].get("parallel", {}))
        ev = snap["events"]
        dev = eng.cache.device
        eng.admitted = [(rid, slot, None if h is None else
                         torch.from_numpy(np.array(h, np.float32)).to(dev))
                        for rid, slot, h in ev["admitted"]]
        eng.finished = list(ev["finished"])
        eng.preempted = list(ev["preempted"])
        eng.outcomes = [RequestOutcome(**oc) for oc in snap["outcomes"]]
        eng.check_invariants()
        if monitor is not None:
            # monitor state is derived: re-baseline its interval deltas
            # at the restored step (a no-op for a monitor that lived
            # through the crash)
            monitor.rebase(eng._step_count)
        return eng
