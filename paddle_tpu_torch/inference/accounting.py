"""Serving cost accounting (counterpart of
paddle_tpu/inference/accounting.py, host-only stdlib, kept AST-equal to
it apart from imports and docstrings): an analytic per-row work model, a
goodput-vs-waste ledger with per-cause attribution, and per-tenant
block-step billing.

* ``WorkModel`` — the analytic FLOPs and HBM bytes of one token-row
  through a FusedMultiTransformer-protocol core, as a function of the
  model dims and the row's absolute position:

      flops(row @ p) = L * (8 d^2 + 4 d f) + L * 4 d (p + 1)
      kv bytes(row @ p) = (p + 2) * kv_token_bytes

  Spans [a, b) close in closed form, so a rollback re-derives the same
  integers the original event added (exact conservation). MoE cores
  (``moe_spec``) price k routed experts a row and count all E tables
  resident. The port's ``Linear`` keeps the ``[in, out]`` weight
  layout, so ``layers[0].ffn1.weight.shape[1]`` is the FFN width on the
  float and the int8 cores alike; an int8-weight (w8a16) engine passes
  its own ``WorkModel(..., weight_itemsize=1)``.
* ``CostLedger`` — the opt-in ledger (``ledger=`` on the engines). Every
  accounted token-row is PENDING, GOODPUT (a FINISHED request's stream)
  or WASTE of exactly one cause (``spec_rejected``, ``replay``,
  ``draft_oom``, ``shed``, ``numeric``, ``deadline``,
  ``bestof_pruned``), and

      total_rows == goodput_rows + sum(waste_rows) + pending_rows

  holds after every event, with the same identity on FLOPs. Per-tenant
  buckets ride the same events plus block-step billing (the per-tenant
  block charge integrated over completed steps).

Contracts (tests/test_torch_accounting.py): every engine hook sits
behind ``if self.ledger is not None``; the ledger never reads a clock
(this module does not import ``time``); it only counts, so streams and
outcomes are the same with it on and off; engine snapshots carry no
ledger state, and during journal replay (``set_replay``) records the
dead incarnation observed stay frozen. The ledger counts from the
schedule, not from the device: its totals are exact functions of the
rows the engine computed, the same in both packages.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

__all__ = ["WorkModel", "CostLedger", "WASTE_CAUSES"]


# the exhaustive waste taxonomy: every wasted row names exactly one
WASTE_CAUSES = ("spec_rejected", "replay", "draft_oom", "shed",
                "numeric", "deadline", "bestof_pruned")

# RequestOutcome status -> retroactive waste cause for a failed
# request's pending work (FINISHED resolves to goodput; a rejected
# request never did any work). CANCELLED is a deliberate early stop
# (best-of-n loser pruning / beam cuts): the pruned branch's pending
# rows were real work that will never reach a delivered stream, so
# they resolve to their own cause instead of inflating "shed".
_FAIL_CAUSE = {"failed_oom": "shed", "failed_numeric": "numeric",
               "failed_deadline": "deadline",
               "cancelled": "bestof_pruned"}


class WorkModel:
    """Analytic FLOPs / HBM-bytes of one FusedMultiTransformer-protocol
    core (see the module docstring for the formulas). All outputs are
    exact python ints — additive over rows and therefore exactly
    subtractable on rollback."""

    __slots__ = ("num_layers", "d_model", "ffn_dim", "itemsize",
                 "weight_itemsize", "kv_token_bytes", "weight_bytes",
                 "_row_linear", "num_experts", "top_k")

    def __init__(self, num_layers: int, d_model: int, ffn_dim: int,
                 kv_token_bytes: Optional[int] = None,
                 itemsize: int = 4,
                 weight_itemsize: Optional[int] = None,
                 num_experts: int = 0, top_k: int = 0):
        self.num_layers = int(num_layers)
        self.d_model = int(d_model)
        self.ffn_dim = int(ffn_dim)
        self.itemsize = int(itemsize)
        # MoE routing spec (moe_serving.MoeServingCore.moe_spec):
        # num_experts=0 means dense. A routed row PRICES k experts'
        # FFN — what it computes — while weight RESIDENCY counts all E
        # expert tables: the gap between the two is exactly the
        # serving argument for MoE (capacity decoupled from per-token
        # FLOPs), and pricing E here would erase it.
        self.num_experts = int(num_experts)
        self.top_k = int(top_k)
        if self.num_experts and not (0 < self.top_k <= self.num_experts):
            raise ValueError(f"top_k={top_k} must be in "
                             f"[1, {num_experts}]")
        # int8-weight serving streams 1-byte weights (w8a16): a
        # distinct weight itemsize keeps MBU honest there — pricing an
        # int8 pass at 4-byte traffic would overstate MBU ~4x, the
        # same lie a stale bf16 KV byte model tells on int8 pools
        self.weight_itemsize = (self.itemsize if weight_itemsize is None
                                else int(weight_itemsize))
        L, d, f = self.num_layers, self.d_model, self.ffn_dim
        # K + V, all heads (num_heads * head_dim == d), every layer.
        # Callers with a real pool pass kv_token_bytes from
        # PagedKVCache.kv_bytes_per_token() — which on int8 pools
        # counts 1-byte payload + per-row scale bytes, so the analytic
        # KV traffic follows the pool's actual density
        self.kv_token_bytes = (int(kv_token_bytes)
                               if kv_token_bytes is not None
                               else 2 * d * self.itemsize * L)
        if self.num_experts:
            E, k = self.num_experts, self.top_k
            # qkv [d,3d]+[3d], out [d,d]+[d], gate [d,E]+[E], E expert
            # FFN pairs ([d,f]+[f], [f,d]+[d]), two LayerNorms [2d]
            # each — RESIDENCY streams every expert table (they all
            # must be HBM-resident for the router to pick any)
            self.weight_bytes = L * self.weight_itemsize * (
                4 * d * d + E * (2 * d * f + f + d) + d * E + E
                + 8 * d)
            # a routed row computes the gate projection plus its k
            # ROUTED experts' FFNs — not E (routed-FLOPs; overflow
            # bypass rows still get priced at k, the capacity they
            # were admitted to spend)
            self._row_linear = L * (8 * d * d + 2 * d * E
                                    + k * 4 * d * f)
        else:
            # qkv [d,3d]+[3d], out [d,d]+[d], ffn1 [d,f]+[f], ffn2
            # [f,d]+[d], two LayerNorms [2d] each — the bytes one
            # model call streams through the weights once
            self.weight_bytes = L * self.weight_itemsize * (
                4 * d * d + 2 * d * f + 9 * d + f)
            # position-independent FLOPs of one row: the four
            # projections (2*m*n per matmul row)
            self._row_linear = L * (8 * d * d + 4 * d * f)

    @classmethod
    def for_model(cls, model, itemsize: int = 4,
                  kv_token_bytes: Optional[int] = None,
                  weight_itemsize: Optional[int] = None) -> "WorkModel":
        """Build from a FusedMultiTransformer-protocol core (or a
        TokenServingModel wrapping one). MoE cores advertise their
        routing spec via ``moe_spec`` (they have no dense ffn1)."""
        core = getattr(model, "core", model)
        spec = getattr(core, "moe_spec", None)
        if spec is not None:
            return cls(core.num_layers, core.embed_dim,
                       int(spec["ffn_dim"]),
                       kv_token_bytes=kv_token_bytes, itemsize=itemsize,
                       weight_itemsize=weight_itemsize,
                       num_experts=int(spec["num_experts"]),
                       top_k=int(spec["top_k"]))
        return cls(core.num_layers, core.embed_dim,
                   int(core.layers[0].ffn1.weight.shape[1]),
                   kv_token_bytes=kv_token_bytes, itemsize=itemsize,
                   weight_itemsize=weight_itemsize)

    # -- FLOPs --------------------------------------------------------
    def row_flops(self, pos: int) -> int:
        """One token-row at absolute position ``pos`` (attends pos+1
        keys, itself included)."""
        return self._row_linear + self.num_layers * 4 * self.d_model \
            * (int(pos) + 1)

    def span_flops(self, start: int, end: int) -> int:
        """Rows at positions [start, end) in closed form:
        sum(p+1 for p in [start, end)) = (end(end+1)-start(start+1))/2."""
        a, b = int(start), int(end)
        if b <= a:
            return 0
        n = b - a
        keys = (b * (b + 1) - a * (a + 1)) // 2
        return n * self._row_linear + self.num_layers * 4 \
            * self.d_model * keys

    # -- HBM bytes ----------------------------------------------------
    def span_kv_bytes(self, start: int, end: int) -> int:
        """KV traffic of rows [start, end): each row READS its causal
        extent (pos+1 tokens) and WRITES its own K/V."""
        a, b = int(start), int(end)
        if b <= a:
            return 0
        keys = (b * (b + 1) - a * (a + 1)) // 2
        return self.kv_token_bytes * (keys + (b - a))

    def resident_kv_bytes(self, tokens: int) -> int:
        """KV footprint of ``tokens`` STORED rows — pages at rest, not
        traffic. This is the slice-transfer payload a fleet migration
        ships (export_slices -> import_slices), i.e. the cost side of
        ``MigrationPolicy``'s move/stay inequality
        (inference/fleet.py)."""
        return self.kv_token_bytes * max(0, int(tokens))

    def as_dict(self) -> dict:
        return {"num_layers": self.num_layers, "d_model": self.d_model,
                "ffn_dim": self.ffn_dim,
                "num_experts": self.num_experts, "top_k": self.top_k,
                "kv_token_bytes": self.kv_token_bytes,
                "weight_bytes": self.weight_bytes,
                "weight_itemsize": self.weight_itemsize,
                "row_linear_flops": self._row_linear}


class _Side:
    """One accounting domain (target or draft pool) of one request:
    rows pending a verdict, their exact FLOPs, and the high-water
    mark of computed stream positions (the replay-vs-fresh split)."""

    __slots__ = ("rows", "flops", "hwm")

    def __init__(self):
        self.rows = 0
        self.flops = 0
        self.hwm = 0


class _LedgerRec:
    """Ledger-internal record of one request (the collector's _ReqTrace
    pattern: created at submit or not at all; frozen during replay
    when the dead incarnation observed it live)."""

    __slots__ = ("rid", "tenant", "replayed", "outcome",
                 "target", "draft")

    def __init__(self, rid: int, tenant: str, replayed: bool):
        self.rid = rid
        self.tenant = tenant
        self.replayed = replayed
        self.outcome: Optional[str] = None
        self.target = _Side()
        self.draft = _Side()


class _Bucket:
    """Row/FLOP tallies for one scope (global, or one tenant):
    goodput, per-cause waste, and the running totals the conservation
    identity is checked against."""

    __slots__ = ("rows", "flops", "goodput_rows", "goodput_flops",
                 "waste_rows", "waste_flops", "block_steps")

    def __init__(self):
        self.rows = 0
        self.flops = 0
        self.goodput_rows = 0
        self.goodput_flops = 0
        self.waste_rows = {c: 0 for c in WASTE_CAUSES}
        self.waste_flops = {c: 0 for c in WASTE_CAUSES}
        self.block_steps = 0

    def add(self, rows: int, flops: int) -> None:
        self.rows += rows
        self.flops += flops

    def waste(self, cause: str, rows: int, flops: int) -> None:
        self.waste_rows[cause] += rows
        self.waste_flops[cause] += flops

    def good(self, rows: int, flops: int) -> None:
        self.goodput_rows += rows
        self.goodput_flops += flops

    @property
    def wasted_rows(self) -> int:
        return sum(self.waste_rows.values())

    @property
    def wasted_flops(self) -> int:
        return sum(self.waste_flops.values())

    def as_dict(self) -> dict:
        return {"rows": self.rows, "flops": self.flops,
                "goodput_rows": self.goodput_rows,
                "goodput_flops": self.goodput_flops,
                "waste_rows": dict(self.waste_rows),
                "waste_flops": dict(self.waste_flops),
                "wasted_rows": self.wasted_rows,
                "block_steps": self.block_steps}


class CostLedger:
    """See the module docstring. Every hook is cheap integer
    arithmetic; the ledger never reaches back into the engine and
    never reads a clock."""

    # bounded per-step work log (kind, rows, flops, bytes, model_s) —
    # the offline MFU/MBU percentile source for tools/cost_report.py.
    # TARGET-model scoped: span.model times the target call only, so
    # draft-pool work (priced in the conservation totals) is excluded
    # from the paired numerator too.
    STEP_LOG = 4096

    # long-lived-server bound on per-request records (the collector's
    # max_requests pattern): past it, the OLDEST TERMINAL record is
    # evicted — terminal records hold no pending work, so eviction
    # never touches the conservation identity; live records are never
    # evicted
    MAX_REQUESTS = 100_000

    def __init__(self, work_model: Optional[WorkModel] = None,
                 draft_work_model: Optional[WorkModel] = None,
                 peak_flops_per_s: Optional[float] = None,
                 peak_bytes_per_s: Optional[float] = None,
                 max_requests: Optional[int] = None):
        self.work = work_model
        self.draft_work = draft_work_model
        self.peak_flops_per_s = peak_flops_per_s
        self.peak_bytes_per_s = peak_bytes_per_s
        self.max_requests = (self.MAX_REQUESTS if max_requests is None
                             else int(max_requests))
        self.evicted_records = 0
        self._registry = None
        self._recs: Dict[int, _LedgerRec] = {}
        self.totals = _Bucket()
        self.tenants: Dict[str, _Bucket] = {}
        # pending maintained as counters (O(1) conservation check)
        self.pending_rows = 0
        self.pending_flops = 0
        # split visibility: how much of the row total each pool did
        self.target_rows = 0
        self.draft_rows = 0
        # prefill work AVOIDED (never entered the ledger): first-touch
        # prefix hits vs warm-resume hits on a re-prefill
        self.prefix_saved_tokens = 0
        self.replay_saved_tokens = 0
        self.steps = 0
        self._last_step = -1          # replay freeze gate (monitor's)
        self._replay = False
        # per-step accumulators (reset by on_step)
        self._step_flops = 0
        self._step_bytes = 0
        self._step_prefill_rows = 0
        self._step_decode_rows = 0
        self._step_max_l = 0
        self._span_mark = 0           # span.model observations consumed
        self.step_log: List[tuple] = []
        self.step_log_dropped = 0

    # -- wiring (engine-side) -----------------------------------------
    def bind(self, registry, model=None,
             kv_token_bytes: Optional[int] = None) -> None:
        """Wire onto an engine: build the target WorkModel from the
        engine's core (kept if already built — a ledger riding through
        an engine restore keeps its accumulated state, like the
        monitor), and attach the live ``work`` source to the always-on
        MetricsRegistry."""
        self._registry = registry
        if self.work is None and model is not None:
            self.work = WorkModel.for_model(
                model, kv_token_bytes=kv_token_bytes)
        registry.attach("work", self.registry_view)

    def bind_draft(self, model) -> None:
        if self.draft_work is None and model is not None:
            self.draft_work = WorkModel.for_model(model)

    def set_replay(self, on: bool) -> None:
        """Journal-replay bracket (RecoverableServer.recover): records
        the dead incarnation observed live freeze, replay-born records
        accumulate — the collector's exact semantics."""
        self._replay = bool(on)

    # -- internals ----------------------------------------------------
    def _rec(self, rid: int) -> Optional[_LedgerRec]:
        rec = self._recs.get(rid)
        if rec is None or (self._replay and not rec.replayed):
            return None
        return rec

    def _tb(self, tenant: str) -> _Bucket:
        b = self.tenants.get(tenant)
        if b is None:
            b = self.tenants[tenant] = _Bucket()
        return b

    def _add(self, rec: _LedgerRec, side: _Side, rows: int,
             flops: int) -> None:
        side.rows += rows
        side.flops += flops
        self.pending_rows += rows
        self.pending_flops += flops
        self.totals.add(rows, flops)
        self._tb(rec.tenant).add(rows, flops)

    def _waste_now(self, rec: _LedgerRec, cause: str, rows: int,
                   flops: int) -> None:
        """Account rows that are waste at the moment they are computed
        (replay recomputation): total grows AND the waste bucket grows
        — they never pass through pending."""
        self.totals.add(rows, flops)
        self.totals.waste(cause, rows, flops)
        tb = self._tb(rec.tenant)
        tb.add(rows, flops)
        tb.waste(cause, rows, flops)

    def _resolve(self, rec: _LedgerRec, side: _Side, cause: str,
                 rows: int, flops: int) -> None:
        """Move rows out of pending into a waste cause."""
        side.rows -= rows
        side.flops -= flops
        self.pending_rows -= rows
        self.pending_flops -= flops
        self.totals.waste(cause, rows, flops)
        self._tb(rec.tenant).waste(cause, rows, flops)

    def _span(self, wm: Optional[WorkModel], a: int, b: int
              ) -> Tuple[int, int]:
        """(flops, kv_bytes) of rows [a, b) — zeros without a model."""
        if wm is None:
            return 0, 0
        return wm.span_flops(a, b), wm.span_kv_bytes(a, b)

    def _prefill_rows(self, rec: _LedgerRec, side: _Side,
                      wm: Optional[WorkModel], start: int,
                      end: int) -> int:
        """Prefill rows [start, end): the part below the request's
        computed high-water mark is recomputation (replay waste, NOW);
        the rest is fresh pending work. Returns the rows computed.
        Conservation accounting only — the caller owns the per-step
        (MFU-pairing) accumulators, because they are TARGET-model
        scoped (``span.model`` never times the draft pool)."""
        if end <= start:
            return 0
        cut = max(start, min(end, side.hwm))
        if cut > start:     # recomputed span [start, cut)
            self._waste_now(rec, "replay", cut - start,
                            self._span(wm, start, cut)[0])
        if end > cut:       # fresh span [cut, end)
            self._add(rec, side, end - cut,
                      self._span(wm, cut, end)[0])
        side.hwm = max(side.hwm, end)
        return end - start

    # -- hooks: target engine -----------------------------------------
    def on_submit(self, rid: int, tenant: str,
                  prompt_tokens: int) -> None:
        if rid in self._recs:       # replayed submit of a live record
            return
        if len(self._recs) >= self.max_requests:
            # dict order == submission order: evict the oldest
            # TERMINAL record (its work is fully resolved into the
            # cumulative buckets; the record itself is only identity)
            victim = next((k for k, r in self._recs.items()
                           if r.outcome is not None), None)
            if victim is not None:
                del self._recs[victim]
                self.evicted_records += 1
        self._recs[rid] = _LedgerRec(rid, tenant,
                                     replayed=self._replay)

    def on_fork(self, rid: int, tokens: int) -> None:
        """Branch ``rid`` was COW-forked at stream length ``tokens``:
        its prompt rows were computed ONCE under the group lead and
        are already in the ledger there — raising the branch's target
        high-water mark to ``tokens`` WITHOUT adding pending rows is
        what keeps the shared prefill priced exactly once no matter
        how many branches finish. A later re-prefill of the branch
        (post-preemption, when the COW sharing is lost) then honestly
        lands below the mark and counts as replay waste."""
        rec = self._rec(rid)
        if rec is None:
            return
        rec.target.hwm = max(rec.target.hwm, int(tokens))

    def on_prefill_skip(self, rid: int, n: int) -> None:
        """``n`` prompt rows adopted from the prefix cache instead of
        computed. Below the high-water mark they are warm-resume
        savings (a re-prefill that did NOT replay); above it,
        first-touch prefix-cache savings."""
        rec = self._rec(rid)
        if rec is None or n <= 0:
            return
        warm = min(int(n), rec.target.hwm)
        self.replay_saved_tokens += warm
        self.prefix_saved_tokens += int(n) - warm

    def on_prefill(self, rid: int, start: int, end: int) -> None:
        """Target prefill rows [start, end) computed (one chunk)."""
        rec = self._rec(rid)
        if rec is None:
            return
        n = self._prefill_rows(rec, rec.target, self.work,
                               int(start), int(end))
        if n:
            f, kv = self._span(self.work, int(start), int(end))
            self.target_rows += n
            self._step_flops += f
            self._step_bytes += kv
            self._step_prefill_rows += n

    def on_decode(self, pairs, n: int) -> None:
        """One fused step consumed ``n`` rows per (rid, start_pos) —
        decode (n=1) or multi-token verify (n=K+1)."""
        for rid, start in pairs:
            rec = self._rec(rid)
            if rec is None:
                continue
            a = int(start)
            f, kv = self._span(self.work, a, a + n)
            self._add(rec, rec.target, n, f)
            rec.target.hwm = max(rec.target.hwm, a + n)
            self.target_rows += n
            self._step_flops += f
            self._step_bytes += kv
            self._step_decode_rows += n
        self._step_max_l = max(self._step_max_l, int(n))

    def on_rollback(self, rid: int, new_len: int,
                    old_len: int) -> None:
        """Speculative rejection: verified rows [new_len, old_len)
        are discarded — exactly the FLOPs they were priced at move
        from pending to spec_rejected waste."""
        rec = self._rec(rid)
        if rec is None or old_len <= new_len:
            return
        f, _ = self._span(self.work, int(new_len), int(old_len))
        self._resolve(rec, rec.target, "spec_rejected",
                      int(old_len) - int(new_len), f)
        rec.target.hwm = min(rec.target.hwm, int(new_len))

    def on_outcome(self, rid: int, status: str) -> None:
        """Terminal verdict: ALL the request's pending work (both
        pools) resolves — goodput on FINISHED, the matching waste
        cause on failure. Exactly once per record."""
        rec = self._rec(rid)
        if rec is None or rec.outcome is not None:
            return
        rec.outcome = status
        cause = _FAIL_CAUSE.get(status)
        for side in (rec.target, rec.draft):
            rows, flops = side.rows, side.flops
            if rows == 0 and flops == 0:
                continue
            side.rows = 0
            side.flops = 0
            self.pending_rows -= rows
            self.pending_flops -= flops
            if cause is None:
                self.totals.good(rows, flops)
                self._tb(rec.tenant).good(rows, flops)
            else:
                self.totals.waste(cause, rows, flops)
                self._tb(rec.tenant).waste(cause, rows, flops)

    def on_step(self, step: int, tenant_charges: Dict[str, int],
                span_src=None) -> None:
        """End of one COMPLETED engine step: integrate the per-tenant
        block charge (the block-step bill), flush the step's work
        accumulators into the log, and — when a collector measured
        this step's model phase (``span_src`` is its registry) — pair
        work with duration into MFU/MBU observations on the engine
        registry. Steps at or below the last seen step are journal
        replay of already-counted steps: frozen."""
        if step <= self._last_step:
            self._reset_step()
            return
        self._last_step = int(step)
        self.steps += 1
        for tid, charge in tenant_charges.items():
            if charge:
                self._tb(tid).block_steps += int(charge)
                self.totals.block_steps += int(charge)
        rows = self._step_prefill_rows + self._step_decode_rows
        flops, byts = self._step_flops, self._step_bytes
        model_s = None
        if rows and self.work is not None:
            # one pass through the weights per model-carrying step
            # (the packed/fused call's dominant read; legacy multi-
            # call steps under-count — documented approximation)
            byts += self.work.weight_bytes
        if span_src is not None and rows:
            total = span_src.hist_total("span.model")
            if total < self._span_mark:
                # a FRESH collector replaced the one the mark was
                # taken against (engine recovery wires collectors
                # fresh): its series restarts from zero — rebase, or
                # MFU pairing would stay dark for a whole pre-crash
                # run's worth of steps
                self._span_mark = 0
            if total > self._span_mark:
                self._span_mark = total
                model_s = span_src.last_value("span.model")
        if model_s is not None and model_s > 0 and \
                self._registry is not None:
            self._registry.observe("work.model_flops_per_s",
                                   flops / model_s)
            self._registry.observe("work.model_bytes_per_s",
                                   byts / model_s)
            if self.peak_flops_per_s:
                self._registry.observe(
                    "work.mfu", flops / model_s / self.peak_flops_per_s)
            if self.peak_bytes_per_s:
                self._registry.observe(
                    "work.mbu", byts / model_s / self.peak_bytes_per_s)
        if rows:
            if self._step_max_l > 1:
                kind = "verify"
            elif self._step_prefill_rows and self._step_decode_rows:
                kind = "mixed"
            elif self._step_prefill_rows:
                kind = "prefill"
            else:
                kind = "decode"
            if len(self.step_log) >= self.STEP_LOG:
                del self.step_log[:self.STEP_LOG // 2]
                self.step_log_dropped += self.STEP_LOG // 2
            self.step_log.append((int(step), kind, rows, flops, byts,
                                  model_s))
        self._reset_step()

    def on_step_abort(self) -> None:
        """A crash tore the step down mid-flight: drop the step's
        work-log accumulators (the partial EVENT tallies stand — they
        are real computed work and conservation covers them; only the
        per-step MFU/log sample is discarded, mirroring the monitor's
        aborted-step skip)."""
        self._reset_step()

    def _reset_step(self) -> None:
        self._step_flops = 0
        self._step_bytes = 0
        self._step_prefill_rows = 0
        self._step_decode_rows = 0
        self._step_max_l = 0

    # -- hooks: draft pool (SpeculativeEngine) ------------------------
    def on_draft_prefill(self, rid: int, start: int,
                         end: int) -> None:
        """Draft-cache (re)build rows [start, end): split replay vs
        fresh on the draft high-water mark, same as target prefill."""
        rec = self._rec(rid)
        if rec is None:
            return
        # conservation only: draft work never enters the per-step
        # MFU accumulators (span.model times the TARGET call; pairing
        # draft FLOPs with it would overstate utilization)
        self.draft_rows += self._prefill_rows(
            rec, rec.draft, self.draft_work, int(start), int(end))

    def on_draft_rows(self, pairs) -> None:
        """One draft forward consumed one row per (rid, pos).
        Conservation only — see ``on_draft_prefill`` for why draft
        work stays out of the MFU-paired step accumulators."""
        for rid, pos in pairs:
            rec = self._rec(rid)
            if rec is None:
                continue
            p = int(pos)
            f, _ = self._span(self.draft_work, p, p + 1)
            self._add(rec, rec.draft, 1, f)
            rec.draft.hwm = max(rec.draft.hwm, p + 1)
            self.draft_rows += 1

    def on_draft_truncate(self, rid: int, new_len: int, old_len: int,
                          cause: str = "spec_rejected") -> None:
        """Draft rows [new_len, old_len) discarded: the rejected tail
        of a verified roll (``spec_rejected``) or a partial roll torn
        down by a draft-pool OOM (``draft_oom``)."""
        rec = self._rec(rid)
        if rec is None or old_len <= new_len:
            return
        f, _ = self._span(self.draft_work, int(new_len), int(old_len))
        self._resolve(rec, rec.draft, cause,
                      int(old_len) - int(new_len), f)
        rec.draft.hwm = min(rec.draft.hwm, int(new_len))

    # -- reads --------------------------------------------------------
    def conservation(self) -> dict:
        """The exact identity the whole design defends:
        total == goodput + sum(waste) + pending, rows and FLOPs."""
        t = self.totals
        rows_ok = t.rows == t.goodput_rows + t.wasted_rows \
            + self.pending_rows
        flops_ok = t.flops == t.goodput_flops + t.wasted_flops \
            + self.pending_flops
        return {"rows": {"total": t.rows, "goodput": t.goodput_rows,
                         "waste": t.wasted_rows,
                         "pending": self.pending_rows},
                "flops": {"total": t.flops, "goodput": t.goodput_flops,
                          "waste": t.wasted_flops,
                          "pending": self.pending_flops},
                "ok": bool(rows_ok and flops_ok)}

    def waste_breakdown(self) -> dict:
        """{cause: rows} over every accounted row (the determinism
        currency: two identical seeded runs produce the identical
        dict), plus the goodput/pending balance."""
        t = self.totals
        return {"goodput": t.goodput_rows,
                "pending": self.pending_rows,
                "waste": {c: t.waste_rows[c] for c in WASTE_CAUSES},
                "total": t.rows}

    def goodput_fraction(self) -> Optional[float]:
        """Goodput share of RESOLVED work (pending excluded) — None
        until any work resolved."""
        t = self.totals
        resolved = t.goodput_rows + t.wasted_rows
        if resolved == 0:
            return None
        return t.goodput_rows / resolved

    def tenant_cost(self) -> Dict[str, dict]:
        """The per-tenant bill: block-steps, attributed rows/FLOPs,
        goodput and per-cause waste."""
        return {tid: b.as_dict()
                for tid, b in sorted(self.tenants.items())}

    def registry_view(self) -> dict:
        """The live ``work.*`` source on the engine registry — flat
        counters the HealthMonitor deltas into goodput/waste rates
        (``goodput_tokens_per_step`` next to raw throughput)."""
        t = self.totals
        out = {"total_tokens": t.rows,
               "goodput_tokens": t.goodput_rows,
               "waste_tokens": t.wasted_rows,
               "pending_tokens": self.pending_rows,
               "target_tokens": self.target_rows,
               "draft_tokens": self.draft_rows,
               "flops": t.flops,
               "goodput_flops": t.goodput_flops,
               "prefix_saved_tokens": self.prefix_saved_tokens,
               "replay_saved_tokens": self.replay_saved_tokens,
               "block_steps": t.block_steps}
        for c in WASTE_CAUSES:
            out[f"waste.{c}"] = t.waste_rows[c]
        return out

    def as_dict(self) -> dict:
        """Machine-readable dump — what ``tools/cost_report.py``
        renders and gates on."""
        return {"kind": "cost_ledger",
                "steps": self.steps,
                "work_model": (self.work.as_dict()
                               if self.work is not None else None),
                "draft_work_model": (self.draft_work.as_dict()
                                     if self.draft_work is not None
                                     else None),
                "peak_flops_per_s": self.peak_flops_per_s,
                "peak_bytes_per_s": self.peak_bytes_per_s,
                "conservation": self.conservation(),
                "breakdown": self.waste_breakdown(),
                "goodput_fraction": self.goodput_fraction(),
                "totals": self.totals.as_dict(),
                "tenants": self.tenant_cost(),
                "savings": {
                    "prefix_saved_tokens": self.prefix_saved_tokens,
                    "replay_saved_tokens": self.replay_saved_tokens},
                "step_log": [list(rec) for rec in self.step_log],
                "step_log_dropped": self.step_log_dropped,
                "requests": len(self._recs),
                "evicted_records": self.evicted_records}

    def save(self, path: str) -> int:
        blob = json.dumps(self.as_dict(), indent=1)
        with open(path, "w") as f:
            f.write(blob)
        return len(blob)
