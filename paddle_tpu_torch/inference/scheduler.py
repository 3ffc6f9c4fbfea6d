"""Paged serving engine: block-budget admission, chunked prefill, the
token-budget ragged mixed step, preemption by block eviction and
continuous slot refill (counterpart of paddle_tpu/inference/scheduler.py).

Same model contract as ContinuousBatchingEngine (``model(x, caches=...,
time_step=...)``), but the cache is a PagedKVCache, so the concurrency
limit is the BLOCK BUDGET, not slots * max_len:

  * admission: a queued request is admitted when a slot is free and the
    pool can cover its admission horizon plus a watermark; prompts
    stream straight into the slot's pages in causal chunks (no dense
    scratch).
  * growth: before each fused step every active row crossing a block
    boundary allocates its next page (allocate-on-write).
  * preemption: when the pool is exhausted the YOUNGEST request is
    evicted — all its pages freed — and goes back to the queue, ahead of
    never-admitted requests, for re-prefill from its recorded history
    (prompt + every decode input). ``max_preemptions`` bounds the
    retries (then FAILED_OOM); a BlockOOM that survives every eviction
    sheds the grower with a FAILED_OOM outcome instead of raising.
  * mixed steps (``prefill_token_budget=N``): admission only grants the
    slot; each step spends up to N prompt tokens on pending prefills and
    runs them PACKED with the decode rows as ONE model call through
    ``PagedKVCache.ragged_views`` — one ragged paged-attention launch
    per layer. Unlike the JAX engine, which packs only on its kernel
    path, the port always packs when a budget is set, on the CPU and on
    CUDA alike, so the CPU tests run the same control flow as the card.
  * without a budget, admission prefills synchronously chunk by chunk
    (``chunked_prefill``) and each step is one fused decode call.
  * prefix caching (``prefix_cache=True``): admission matches the
    prompt's chained block hashes against the pool's index
    (``PagedKVCache.adopt_prefix``), shares the hit pages and prefills
    only the uncached suffix (at least MIN_PREFILL_SUFFIX_ROWS rows).
    Completed prompt blocks are registered chunk by chunk, so a request
    preempted mid-prefill re-adopts its own finished pages when it
    returns. Accounting rides in ``prefix_stats``.
  * ``dtype="int8"`` serves from int8 KV pages; the engine itself is
    dtype-blind.
  * speculative verify: ``step_multi`` appends and scores L = k+1 rows
    per slot in one call (packed beside prefill chunks in token-budget
    mode), and ``rollback`` trims a rejected tail from the history, then
    from the pages.

Ported later: tenants and weighted fair queuing, branch groups,
deadlines, fault injection, telemetry collectors and snapshot/restore.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .paged_cache import BlockOOM, PagedKVCache, chain_block_hashes
from .resilience import RequestOutcome
from .serving import PrefillStats, PrefixCacheStats, ResilienceStats
from .telemetry import MetricsRegistry

__all__ = ["PagedRequest", "PagedServingEngine", "chunked_prefill",
           "MIN_PREFILL_SUFFIX_ROWS"]

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
        self.max_preemptions: Optional[int] = None

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


class PagedServingEngine:
    def __init__(self, model, max_batch: int, block_size: int,
                 num_blocks: int, max_blocks_per_seq: Optional[int] = None,
                 dtype="float32", watermark_blocks: int = 0,
                 prefix_cache: bool = False,
                 chunk_tokens: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 max_preemptions: Optional[int] = None):
        self.model = model
        self._ragged_plan: Optional[List[dict]] = None
        self.max_batch = int(max_batch)
        self.dtype = dtype
        self.watermark_blocks = int(watermark_blocks)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_stats = PrefixCacheStats()
        self.prefill_stats = PrefillStats()
        self.max_preemptions = max_preemptions
        self.resilience_stats = ResilienceStats()
        self.outcomes: List[RequestOutcome] = []
        self._step_count = 0
        self.cache = PagedKVCache.for_model(
            model, block_size, num_blocks, max_seqs=max_batch,
            max_blocks_per_seq=max_blocks_per_seq, dtype=dtype,
            prefix_cache=prefix_cache)
        self.max_len = self.cache.capacity_per_seq
        # the unified metric surface: live sources read at export time
        self.registry = MetricsRegistry()
        self.registry.attach("prefill", self.prefill_stats)
        self.registry.attach("prefix_cache", self.prefix_stats)
        self.registry.attach("resilience", self.resilience_stats)
        self.registry.attach(
            "pool",
            lambda: dict(self.cache.pool_occupancy(tiers_only=True),
                         peak=self.cache.peak_blocks_used))
        self.registry.attach("queue", self._queue_gauges)
        # MoE cores export per-expert load / overflow / routing totals;
        # dense models leave the namespace absent
        if hasattr(model, "moe_metrics"):
            self.registry.attach("moe", model.moe_metrics)
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
        # preempted requests (by rid) ride ahead of never-admitted ones
        # (by enqueue order): see _queue_key
        self._queue: Deque[PagedRequest] = deque()
        self._next_enqueue_seq = 0
        # decode inputs not yet attributed to request histories: (x,
        # stepping mask) per step, copied to the host lazily
        self._pending_history: List[Tuple[torch.Tensor, np.ndarray]] = []
        self._next_rid = 0
        self._next_admit_seq = 0
        # event queues the caller drains
        self.admitted: List[Tuple[int, int, torch.Tensor]] = []
        self.finished: List[Tuple[int, int, int]] = []
        self.preempted: List[int] = []

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

    @property
    def queue(self) -> List[PagedRequest]:
        """Queued requests in admission order."""
        return list(self._queue)

    def _queue_gauges(self) -> dict:
        return {"depth": len(self._queue), "active": self.num_active,
                "prefilling": self.num_prefilling}

    @staticmethod
    def _queue_key(req: PagedRequest):
        """Queue order: preempted requests (sunk compute) ahead of
        never-admitted ones, each by original submission age."""
        if req.preemptions > 0:
            return (0, req.rid)
        return (1, req.enqueue_seq)

    # -- admission ----------------------------------------------------
    def submit(self, prompt, *,
               max_preemptions: Optional[int] = None) -> int:
        """Queue a prompt ([T, d_model] embeddings) and try to admit.
        Returns the request id; when admission succeeded an ``(rid,
        slot, last_hidden)`` event is in ``admitted``. With
        ``prefill_token_budget`` set, admission only grants a slot and
        the admitted event fires when the last chunk lands. A prompt
        that can never fit the pool is REJECTED_ADMISSION in
        ``outcomes``. ``max_preemptions`` caps this request's
        re-prefill retries (overriding the engine default)."""
        arr = np.asarray(prompt.cpu().numpy() if isinstance(
            prompt, torch.Tensor) else prompt, np.float32)
        if arr.shape[0] == 0:
            raise ValueError("empty prompt")
        if arr.shape[0] > self.max_len:
            raise ValueError(
                f"prompt length {arr.shape[0]} > per-seq page capacity "
                f"{self.max_len}")
        req = PagedRequest(self._next_rid, arr)
        self._next_rid += 1
        req.max_preemptions = (self.max_preemptions
                               if max_preemptions is None
                               else int(max_preemptions))
        # the horizon every serving path must eventually cover: the
        # prompt plus the first decode token's page
        need = self.cache.blocks_needed(min(len(req) + 1, self.max_len))
        room = self.cache.num_blocks - 1 - self.watermark_blocks
        if need > room:
            self._record(req, RequestOutcome.REJECTED_ADMISSION,
                         f"prompt needs {need} block(s) through its "
                         f"first decode token but only {room} can ever "
                         f"be available past the watermark")
            return req.rid
        req.enqueue_seq = self._next_enqueue_seq
        self._next_enqueue_seq += 1
        self._queue.append(req)
        self._try_admit()
        return req.rid

    def _try_admit(self) -> None:
        """Admit queue heads while a slot is free and the pool covers the
        admission horizon plus the watermark: the whole prompt (plus the
        first decode token's page) in synchronous mode, only the FIRST
        chunk in token-budget mode. Pool pressure stops the pass
        head-of-line."""
        while self._queue and self.free_slots > 0:
            req = self._queue[0]
            if self.prefill_token_budget is None:
                horizon = min(len(req) + 1, self.max_len)
            else:
                horizon = min(len(req), self.chunk_tokens)
            need = self.cache.blocks_needed(horizon)
            if self.prefix_cache:
                # actively shared prefix hits cost no pool draw;
                # cached-free hits come out of free_blocks (a resurrect
                # takes one free unit, like an alloc)
                matched = self.cache.match_prefix(
                    req.block_hashes(self.cache.block_size))
                rc = self.cache.allocator.refcount
                need -= sum(1 for b in matched if rc[b] > 0)
            draw = max(need, 0) + self.watermark_blocks
            if draw > self.free_blocks:
                return
            self._queue.popleft()
            if self.prefill_token_budget is not None:
                self._start_prefill(req)
                continue
            try:
                self._prefill(req)
            except BlockOOM as e:
                # the budget check said the prompt fits: un-admit and
                # retry on a later pass, against the retry budget
                if req.slot is not None:
                    self._drop(req.slot)
                    req.slot = None
                if self._over_retry_budget(req):
                    self._record(req, RequestOutcome.FAILED_OOM,
                                 f"admission prefill OOM and retry "
                                 f"budget exhausted: {e}")
                else:
                    req.preemptions += 1
                    self._requeue_preempted(req)
                    self.preempted.append(req.rid)
                return

    def _start_prefill(self, req: PagedRequest) -> int:
        """Grant a slot and set up the chunked-prefill state: adopt any
        cached prefix pages and compute the recompute start P (the
        suffix keeps at least MIN_PREFILL_SUFFIX_ROWS rows)."""
        slot = int(np.flatnonzero(~self.active & ~self.prefilling)[0])
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
        self._prefills[slot] = {"pos": P, "start": P,
                                "n_cached": n_cached, "hashes": hashes}
        self.prefilling[slot] = True
        self._requests[slot] = req
        req.slot = slot
        req.admit_seq = self._next_admit_seq
        self._next_admit_seq += 1
        if req.preemptions > 0:
            self.resilience_stats.retried += 1
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
        """Last chunk landed: the slot turns decodable and the admission
        event fires."""
        st = self._prefills.pop(slot)
        req = self._requests[slot]
        self._register_prefill(slot, st)
        self.prefilling[slot] = False
        self.lens[slot] = len(req)
        self.active[slot] = True
        self.admitted.append((req.rid, slot, last_hidden))

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

    def _prefill(self, req: PagedRequest) -> None:
        """Synchronous admission: stream every chunk now."""
        slot = self._start_prefill(req)
        st = self._prefills[slot]
        _, h = chunked_prefill(
            self.model, self.cache, slot, req.history,
            pos=st["pos"], target=len(req), chunk_tokens=self.chunk_tokens,
            start_block=st["n_cached"],
            write_start=st["n_cached"] * self.cache.block_size,
            stats=self.prefill_stats,
            on_chunk=self._chunk_registrar(slot, st))
        self._complete_prefill(slot, h)

    def _plan_prefills(self) -> Tuple[bool, List[int]]:
        """Token-budget mode: spend ``prefill_token_budget`` prompt tokens
        on pending prefills, oldest first, growing pages under the
        normal preemption rules, and RECORD the chunks in
        ``self._ragged_plan``; the step's single packed launch
        (``_flush_ragged_plan``) runs them with the decode rows. The cap
        is soft by one token (a chunk never leaves a 1-row tail).
        Completed prefills transition slot state here; their admitted
        event fires post-launch. Returns (ran, fresh): whether any chunk
        was planned, and the slots whose prefill completed — they sit
        this step's decode out (their admitted event is undrained)."""
        if self.prefill_token_budget is None or \
                self.num_prefilling == 0:
            return False, []
        plan = self._ragged_plan
        budget = self.prefill_token_budget
        ran = False
        fresh: List[int] = []
        while budget >= MIN_PREFILL_SUFFIX_ROWS:
            slots = [int(s) for s in np.flatnonzero(self.prefilling)
                     if int(s) in self._prefills]
            if not slots:
                break
            slot = min(slots, key=lambda s: self._requests[s].admit_seq)
            req = self._requests[slot]
            st = self._prefills[slot]
            T = len(req)
            c = _chunk_len(T, st["pos"], self.chunk_tokens, budget=budget)
            if not self._grow_or_shed(slot, req, st["pos"] + c,
                                      start_block=st["n_cached"],
                                      write_from=st["pos"]):
                continue  # the slot was evicted (or shed) growing
            seg = plan[-1] if plan and plan[-1]["slot"] == slot else None
            if seg is None:
                seg = {"slot": slot, "req": req, "from": st["pos"],
                       "to": st["pos"],
                       "ws": st["n_cached"] * self.cache.block_size,
                       "bounds": [],
                       "hook": self._chunk_registrar(slot, st),
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
            if st["pos"] >= T:
                seg["complete"] = True
                self.prefilling[slot] = False
                self.lens[slot] = T
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
        views = self.cache.ragged_views(desc)
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
                st = self._prefills.pop(s["slot"])
                self._register_prefill(s["slot"], st)
                self.admitted.append((s["req"].rid, s["slot"],
                                      out[0, lo + n - 1:lo + n]))
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
        if status == RequestOutcome.FAILED_OOM:
            self.resilience_stats.shed += 1
        elif status == RequestOutcome.REJECTED_ADMISSION:
            self.resilience_stats.rejected += 1

    def _fail(self, req: PagedRequest, status: str, reason: str) -> None:
        """Terminal failure of ONE request: free its pages, detach it
        from slot/queue, record the outcome; everyone else goes on."""
        if req.slot is not None:
            self._drop(req.slot)
            req.slot = None
        elif req in self._queue:
            self._queue.remove(req)
        self._record(req, status, reason)

    def _over_retry_budget(self, req: PagedRequest) -> bool:
        return req.max_preemptions is not None and \
            req.preemptions >= req.max_preemptions

    def _requeue_preempted(self, req: PagedRequest) -> None:
        """Preempted requests re-enter the queue ahead of never-admitted
        ones, ordered among themselves by original submission age."""
        key = self._queue_key(req)
        i = 0
        for r in self._queue:
            if self._queue_key(r) < key:
                i += 1
            else:
                break
        self._queue.insert(i, req)

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

    def _drop(self, slot: int) -> None:
        plan = self._ragged_plan
        if plan and any(s["slot"] == slot for s in plan):
            # the slot's planned chunks must land (and its completed
            # state settle) before its pages are freed
            self._flush_ragged_plan()
        self._flush_history()
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
        self._requeue_preempted(req)
        self.preempted.append(req.rid)

    def _held_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.active | self.prefilling)
                if self._requests[int(s)] is not None]

    def _preempt_youngest(self, cands: List[int]) -> int:
        victim = max(cands, key=lambda s: self._requests[s].admit_seq)
        self.preempt(victim)
        return victim

    def _grow_or_shed(self, slot: int, req: PagedRequest, length: int,
                      *, start_block: int = 0,
                      write_from: Optional[int] = None) -> bool:
        """Cover ``length`` tokens for ``slot``, preempting the youngest
        request on pool pressure — possibly the grower itself (it then
        re-queues). With no victim but the grower left, the grower is
        SHED (FAILED_OOM). Returns True when the slot is still alive."""
        while self.active[slot] or self.prefilling[slot]:
            try:
                self.cache.ensure(slot, length, start_block=start_block,
                                  write_from=write_from)
                return True
            except BlockOOM as e:
                cands = self._held_slots()
                if not any(s != slot for s in cands):
                    self._fail(req, RequestOutcome.FAILED_OOM,
                               f"pool exhausted even after preempting "
                               f"every other request: {e}")
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

    # -- decode -------------------------------------------------------
    def step(self, x):
        """One fused decode step for every active slot. x: [max_batch, 1,
        d_model] next-token embeddings (inactive rows: any values).
        Slots at page capacity are auto-released first (``finished``);
        rows crossing a block boundary allocate their next page,
        preempting the youngest request if the pool is dry. In
        token-budget mode the step first plans the budget's prefill
        chunks and runs them packed with the decode rows, and may run
        with no active slot while prompts stream (returns None).
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
        budget on pending prefill chunks, packed WITH the L verify rows
        per slot into one ragged call; slots mid-prefill or completed in
        this step sit the verify out. Returns hidden [max_batch, L,
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
        # buffered inputs must reach the history BEFORE trimming it
        self._flush_history()
        self._requests[slot].truncate_history(new_len,
                                              self.cache.block_size)
        self.cache.truncate(slot, new_len)
        self.lens[slot] = new_len

    def _run_step(self, x, L: int, retire: bool):
        self._step_count += 1
        idle = self.num_active == 0 and self.num_prefilling == 0 \
            and not self._queue
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        x = x.to(self.cache.device)
        self._ragged_plan = [] if self.prefill_token_budget is not None \
            else None
        try:
            return self._step_body(idle, x, L, retire)
        finally:
            self._ragged_plan = None

    def _step_body(self, idle: bool, x: torch.Tensor, L: int,
                   retire: bool):
        plan = self._ragged_plan
        ran_prefill, fresh = (self._plan_prefills() if plan is not None
                              else (False, []))
        if self.num_active == 0:
            if ran_prefill or self.num_prefilling > 0 \
                    or self._queue or not idle:
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
        if plan is not None:
            out = self._flush_ragged_plan(x=x, L=L)
        else:
            with torch.no_grad():
                out, _ = self.model(x, caches=self.cache.views,
                                    time_step=self.lens.copy())
        self.lens[stepping] += L
        self.prefill_stats.decode_steps += 1
        if ran_prefill:
            self.prefill_stats.mixed_steps += 1
        self.prefill_stats.peak_blocks = max(
            self.prefill_stats.peak_blocks, self.cache.peak_blocks_used)
        self._try_admit()
        return out

    # -- audit ----------------------------------------------------------
    def check_invariants(self) -> bool:
        """Audit engine + pool bookkeeping (PagedKVCache.check_invariants
        for the pool list); raises AssertionError on violation: every
        active or prefilling slot maps to a request that points back at
        it, queued requests hold no slot and sit in queue order, and
        every active slot's table covers its length."""
        for slot in np.flatnonzero(self.active | self.prefilling):
            req = self._requests[int(slot)]
            assert req is not None and req.slot == int(slot), \
                f"slot {int(slot)} active without a matching request"
        for req in self._queue:
            assert req.slot is None, \
                f"queued request {req.rid} still holds slot {req.slot}"
        keys = [self._queue_key(r) for r in self._queue]
        assert keys == sorted(keys), \
            f"queue out of admission order: {[r.rid for r in self._queue]}"
        assert not (self.active & self.prefilling).any(), \
            "slot both active and prefilling"
        for slot in self._prefills:
            assert self.prefilling[slot], \
                f"prefill state for non-prefilling slot {slot}"
        self.cache.check_invariants(lens=self.lens, active=self.active)
        self.resilience_stats.audits += 1
        return True
