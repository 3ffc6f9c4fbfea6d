"""Serving telemetry (counterpart of paddle_tpu/inference/telemetry.py,
host-only numpy and stdlib, kept AST-equal to it apart from imports and
docstrings): per-request lifecycle tracing, an engine step-phase
timeline and a unified metrics registry with Chrome-trace export.

* ``StatsBase`` — the declarative base of the serving stats siblings
  (``FIELDS``, ``DERIVED``, ``REPR``; ``as_dict``/``__repr__``
  generated).
* ``MetricsRegistry`` — counters, gauges, windowed histograms and live
  ``attach``ed sources behind one flat ``as_dict()``; ``delta_since``,
  ``values_since`` and ``percentiles_since`` are the interval views the
  health monitor and the cost ledger read.
* ``TraceCollector`` — the opt-in tracing hub the engines call into
  (``collector=``): request lifecycles (TTFT, TPOT, queue wait,
  preemption stall, rolled up per tenant by ``request_summary``), the
  step timeline (``begin_step``/``phase``/``end_step`` and nested
  ``span_begin``/``span_end``) and ``chrome_trace()``.

Contracts (tests/test_torch_telemetry.py): with no collector the engines
make no clock read and no telemetry allocation; the collector only
observes, so streams and outcomes are the same with tracing on and off;
snapshots carry no collector state, and during journal replay
(``set_replay``) spans are flagged and records the dead incarnation saw
stay frozen. ``clock`` is injectable (default ``time.perf_counter``).

Where device time lands: every stamp is the HOST clock. The port's
engines launch CUDA work asynchronously and return device tensors
without a sync, so a step's ``model`` phase records launch time only.
The device time lands in whichever later phase or span first reads a
result back to the host: the numeric guard's one [B] read in the step's
``bookkeeping`` phase when the guard is on, else the caller's readout
(the speculative engine's sampling, inside ``sample_verify`` /
``spec_round``, or the next step's first host read). No hook site adds
a ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["StatsBase", "MetricsRegistry", "NetStats",
           "TraceCollector", "percentiles"]


# ---------------------------------------------------------------------
# stats base (the five serving.py siblings subclass this)
# ---------------------------------------------------------------------

class StatsBase:
    """Declarative counter/gauge bundle: subclasses list ``FIELDS``
    (instance slots, zero-initialized), ``DERIVED`` ({property name:
    rounding digits or None}) and optionally ``REPR`` (the headline
    fields/properties; defaults to FIELDS). ``as_dict`` exports every
    field AND every derived property — a stat that exists is a stat
    that exports, by construction."""

    FIELDS: Tuple[str, ...] = ()
    DERIVED: Dict[str, Optional[int]] = {}
    REPR: Tuple[str, ...] = ()

    __slots__ = ()

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, 0)

    def as_dict(self) -> dict:
        out = {f: getattr(self, f) for f in self.FIELDS}
        for name, nd in self.DERIVED.items():
            v = getattr(self, name)
            out[name] = round(v, nd) if nd is not None else v
        return out

    def __repr__(self):
        parts = []
        for name in (self.REPR or self.FIELDS):
            v = getattr(self, name)
            parts.append(f"{name}={v:.4g}" if isinstance(v, float)
                         else f"{name}={v}")
        return f"{type(self).__name__}({', '.join(parts)})"


class NetStats(StatsBase):
    """Session-transport accounting (inference/net.py), one instance
    per ``ResilientTransport``. A fleet supervisor sums these across
    its workers under the ``net.*`` registry namespace — the series
    the monitor's ``network-flapping`` detector watches. Every field
    is deterministic under a seeded ``NetworkFaultInjector`` storm:
    two identical runs report identical counters.

      sessions          session hellos answered (1 + reconnects,
                        counting the initial adoption)
      reconnects        successful reconnect+hello sequences after a
                        transient fault (EOF / torn frame / CRC /
                        op timeout)
      probes            liveness probe attempts (each reconnect try
                        IS a probe: connect + hello; a failed probe
                        escalates to WorkerDied)
      retried_ops       ops resent on a resumed session after a fault
      reply_cache_hits  retried ops the worker answered from its
                        bounded reply cache instead of re-executing
                        (the transport-level idempotency contract)
      frames_rejected   reply frames discarded as torn or
                        CRC-corrupt (never surfaced as data)
      stale_frames      late/duplicate frames for an already-resolved
                        op seq, discarded by the want-seq check
      blackholes        op deadlines that expired with the connection
                        open (a silent peer, recovered via probe)
    """

    __slots__ = FIELDS = (
        "sessions", "reconnects", "probes", "retried_ops",
        "reply_cache_hits", "frames_rejected", "stale_frames",
        "blackholes")
    REPR = ("sessions", "reconnects", "retried_ops",
            "reply_cache_hits", "frames_rejected")


# ---------------------------------------------------------------------
# unified metrics registry
# ---------------------------------------------------------------------

def percentiles(values, qs=(50, 90, 99)) -> dict:
    """{'count', 'mean', 'p50', 'p90', 'p99', 'max'} of a value list
    (empty input -> {'count': 0})."""
    vals = np.asarray([v for v in values if v is not None], np.float64)
    if vals.size == 0:
        return {"count": 0}
    out = {"count": int(vals.size), "mean": float(vals.mean()),
           "max": float(vals.max())}
    for q in qs:
        out[f"p{q}"] = float(np.percentile(vals, q))
    return out


def _flatten(prefix: str, value, out: dict) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    else:
        out[prefix] = value


class MetricsRegistry:
    """One namespace for every serving metric: explicit counters /
    gauges / histograms plus live ``attach``ed sources read at
    snapshot time. ``as_dict()`` is flat ({'a.b.c': value}) so two
    snapshots diff into interval deltas with ``delta_since`` — the
    sampling loop a router or dashboard runs."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}
        # observations trimmed off each series so far: the absolute
        # index of _hists[name][0] — what lets values_since address a
        # window by TOTAL observation count across trims
        self._hist_dropped: Dict[str, int] = {}
        self._sources: Dict[str, Any] = {}

    # -- writes -------------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    # histogram observations are WINDOWED: a long-lived server must
    # not grow O(total requests) — when a series hits 2x the window
    # the older half is dropped, so percentiles reflect the most
    # recent <= 2*window samples (totals belong in counters)
    HIST_WINDOW = 4096

    def observe(self, name: str, value: float) -> None:
        lst = self._hists.setdefault(name, [])
        if len(lst) >= 2 * self.HIST_WINDOW:
            del lst[:self.HIST_WINDOW]
            self._hist_dropped[name] = \
                self._hist_dropped.get(name, 0) + self.HIST_WINDOW
        lst.append(float(value))

    def attach(self, prefix: str, source) -> None:
        """Register a live source exported under ``prefix``: an object
        with ``as_dict()`` (a stats sibling) or a zero-arg callable
        returning a dict (``tenant_report``, pool occupancy)."""
        self._sources[prefix] = source

    # -- reads --------------------------------------------------------
    def histogram(self, name: str) -> dict:
        return percentiles(self._hists.get(name, ()))

    # -- windowed histogram views -------------------------------------
    # ``as_dict``/``histogram`` report percentiles since boot (well,
    # since the retention window) — useless to an SLO tracker or a
    # router scrape that wants "the last interval". These views
    # address observations by their TOTAL count, the histogram
    # equivalent of ``delta_since``: mark now, serve, then ask for
    # everything after the mark.

    def hist_names(self) -> List[str]:
        return list(self._hists)

    def hist_total(self, name: str) -> int:
        """Observations EVER made on ``name`` (monotonic across the
        retention trim — the mark currency of values_since)."""
        return self._hist_dropped.get(name, 0) + \
            len(self._hists.get(name, ()))

    def hist_marks(self) -> Dict[str, int]:
        """{name: hist_total} for every histogram — snapshot before an
        interval, pass to ``percentiles_since`` after it."""
        return {name: self.hist_total(name) for name in self._hists}

    def last_value(self, name: str) -> Optional[float]:
        """Most recent observation on ``name`` (None when empty) —
        how the cost ledger pairs a step's analytic work with the
        step's just-closed ``span.model`` duration."""
        lst = self._hists.get(name)
        return lst[-1] if lst else None

    def values_since(self, name: str, start: int) -> List[float]:
        """Observations on ``name`` from absolute index ``start``
        (a previous ``hist_total``). Observations already trimmed by
        the retention window are gone — the view clamps to what is
        retained rather than failing."""
        lst = self._hists.get(name)
        if not lst:
            return []
        i = max(0, int(start) - self._hist_dropped.get(name, 0))
        return lst[i:]

    def percentiles_since(self, prev: Optional[Dict[str, int]] = None,
                          qs=(50, 90, 99)) -> Dict[str, dict]:
        """Windowed percentiles: for every histogram, the percentile
        dict over observations made AFTER the ``prev`` marks (a
        ``hist_marks()`` snapshot; names absent there count from 0).
        The interval view ``SloTracker`` and a router scrape consume —
        p50/p90/p99 over the last window, not since boot."""
        prev = prev or {}
        return {name: percentiles(
                    self.values_since(name, prev.get(name, 0)), qs)
                for name in self._hists}

    def as_dict(self) -> dict:
        out: Dict[str, Any] = {}
        for name, v in self.counters.items():
            _flatten(name, v, out)
        for name, v in self.gauges.items():
            _flatten(name, v, out)
        for name, vals in self._hists.items():
            _flatten(name, percentiles(vals), out)
        for prefix, src in self._sources.items():
            d = src() if callable(src) else src.as_dict()
            _flatten(prefix, d, out)
        return out

    def scrape(self, prefixes) -> dict:
        """``as_dict()`` filtered to keys under any of ``prefixes`` —
        the per-worker WIRE payload a fleet router samples
        (inference/router.py): the full flat dict drags along
        per-request latency histograms and tenant detail a placement
        decision has no use for, and scrape payloads cross a pipe
        every tick."""
        pref = tuple(str(p) for p in prefixes)
        return {k: v for k, v in self.as_dict().items()
                if k.startswith(pref)}

    def delta_since(self, prev: dict) -> dict:
        """Numeric differences between the current snapshot and a
        previous ``as_dict()`` (keys absent before count from 0);
        non-numeric entries are skipped."""
        cur = self.as_dict()
        out = {}
        for k, v in cur.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            p = prev.get(k, 0)
            if isinstance(p, bool) or not isinstance(p, (int, float)):
                p = 0
            out[k] = v - p
        return out


# ---------------------------------------------------------------------
# trace collector
# ---------------------------------------------------------------------

class _ReqTrace:
    """Lifecycle record of one request (collector-internal; exported
    via ``as_dict``). Timestamps are collector-relative seconds."""

    __slots__ = ("rid", "tenant", "gid", "submit_ts", "admit_ts",
                 "first_ts", "last_ts", "tokens", "chunks",
                 "preemptions", "stall_s", "_preempt_ts", "outcome",
                 "outcome_step", "events", "replayed")

    def __init__(self, rid: int, tenant, ts, replayed: bool = False,
                 gid=None):
        self.rid = rid
        self.tenant = tenant
        self.gid = gid             # fork-shared branch group, or None
        self.submit_ts = ts
        self.admit_ts = None
        self.first_ts = None
        self.last_ts = None
        self.tokens = 0            # decode tokens consumed (rollbacks
                                   # subtracted -> emitted tokens)
        self.chunks = 0
        self.preemptions = 0
        self.stall_s = 0.0         # preempted -> re-admitted wall time
        self._preempt_ts = None
        self.outcome = None
        self.outcome_step = None
        self.events: List[tuple] = []   # (ts, name, args or None)
        self.replayed = replayed

    # -- derived latencies (None until the defining events happened) --
    @property
    def queue_wait_s(self):
        if self.submit_ts is None or self.admit_ts is None:
            return None
        return self.admit_ts - self.submit_ts

    @property
    def ttft_s(self):
        if self.submit_ts is None or self.first_ts is None:
            return None
        return self.first_ts - self.submit_ts

    @property
    def tpot_s(self):
        if self.first_ts is None or self.last_ts is None or \
                self.tokens < 2:
            return None
        return (self.last_ts - self.first_ts) / (self.tokens - 1)

    def as_dict(self) -> dict:
        r = lambda v: None if v is None else round(v, 6)  # noqa: E731
        return {"rid": self.rid, "tenant": self.tenant,
                "gid": self.gid,
                "tokens": self.tokens, "chunks": self.chunks,
                "preemptions": self.preemptions,
                "outcome": self.outcome,
                "outcome_step": self.outcome_step,
                "queue_wait_s": r(self.queue_wait_s),
                "ttft_s": r(self.ttft_s),
                "tpot_s": r(self.tpot_s),
                "stall_s": r(self.stall_s),
                "replayed": self.replayed,
                "events": [(round(ts, 6), name, args)
                           for ts, name, args in self.events]}


class TraceCollector:
    """See the module docstring. Every method is a cheap append — the
    engines call them only when a collector is installed, and the
    collector never reaches back into the engine."""

    LATENCIES = ("ttft_s", "tpot_s", "queue_wait_s", "stall_s")

    # per-request event-log cap (a preemption storm must not grow one
    # record without bound; counters keep counting past it)
    MAX_REQ_EVENTS = 512

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_events: int = 500_000,
                 max_requests: int = 100_000):
        self._clock = time.perf_counter if clock is None else clock
        self._t0 = self._clock()
        self.max_events = int(max_events)
        self.max_requests = int(max_requests)
        self.dropped = 0
        self.evicted_requests = 0
        self.events: List[dict] = []       # timeline (chrome-ish dicts,
                                           # ts in relative seconds)
        self.requests: Dict[int, _ReqTrace] = {}
        self.registry = MetricsRegistry()
        self.steps = 0
        self.replayed_steps = 0
        self._replay = False
        self._step: Optional[tuple] = None     # (t, step_id, kind)
        self._phase: Optional[tuple] = None    # (t, name)
        self._spans: List[tuple] = []          # (t, name, args)

    def now(self) -> float:
        return self._clock() - self._t0

    # -- low-level emit -----------------------------------------------
    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        if self._replay and ev.get("ph") != "C":
            # counter events' args IS the {series: value} map — a
            # replay flag there would chart as a bogus series
            ev.setdefault("args", {})["replay"] = True
        self.events.append(ev)

    def _span_event(self, name: str, t0: float, t1: float,
                    args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "X", "ts": t0, "dur": t1 - t0}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)
        # every span duration also lands in a windowed registry
        # histogram (``span.<name>``): percentiles_since over these is
        # the windowed per-phase step-timing view the health monitor
        # samples (and kernel tile sizing reads). Replayed spans are
        # replay-time, not serving-time — timeline-flagged only.
        if not self._replay:
            self.registry.observe(f"span.{name}", t1 - t0)

    # -- step timeline ------------------------------------------------
    def begin_step(self, step: int, kind: str = "step") -> None:
        """Open the span for one engine step (auto-closing a step a
        crash left dangling) and its first phase."""
        t = self.now()
        if self._step is not None:
            self._close_step(t, aborted=True)
        self._step = (t, int(step), kind)
        self._phase = (t, "bookkeeping")

    def phase(self, name: str) -> None:
        """Close the current phase span, open the next. No-op outside
        a step (a crash may have torn one down)."""
        if self._step is None:
            return
        t = self.now()
        if self._phase is not None:
            self._span_event(self._phase[1], self._phase[0], t,
                             {"step": self._step[1]})
        self._phase = (t, name)

    def end_step(self, gauges: Optional[dict] = None,
                 aborted: bool = False) -> None:
        """Close the step span; ``gauges`` ({track: {series: value}})
        are emitted as Chrome counter events and mirrored into the
        registry. ``aborted`` closes a step a crash tore down: the
        span is flagged, counted separately (``steps.aborted``), and
        its gauges are NOT emitted — mid-crash state is not a
        step-boundary sample."""
        if self._step is None:
            return
        t = self.now()
        self._close_step(t, aborted=aborted)
        if aborted:
            return
        if gauges:
            for track, series in gauges.items():
                self._emit({"name": track, "ph": "C", "ts": t,
                            "args": dict(series)})
                for k, v in series.items():
                    self.registry.gauge(f"{track}.{k}", v)

    def _close_step(self, t: float, aborted: bool = False) -> None:
        t0, step, kind = self._step
        if self._phase is not None:
            self._span_event(self._phase[1], self._phase[0], t,
                             {"step": step})
            self._phase = None
        args = {"step": step}
        if aborted:
            args["aborted"] = True
        self._span_event(kind, t0, t, args)
        self._step = None
        if aborted:
            # a torn step is not a completed step: it either replays
            # after recovery (counted then) or the engine is abandoned
            self.registry.count("steps.aborted")
        elif self._replay:
            self.replayed_steps += 1
            self.registry.count("steps.replayed")
        else:
            self.steps += 1
            self.registry.count("steps.live")

    # -- free-form spans (spec rounds, journal, snapshots) ------------
    @property
    def span_depth(self) -> int:
        return len(self._spans)

    def span_begin(self, name: str, **args) -> None:
        self._spans.append((self.now(), name, args))

    def span_end(self, **extra) -> None:
        if not self._spans:
            return
        t0, name, args = self._spans.pop()
        if extra:
            args = dict(args, **extra)
        self._span_event(name, t0, self.now(), args or None)

    def span_unwind(self, depth: int, aborted: bool = False) -> None:
        """Close every span above ``depth``. ``aborted=True`` is for
        exception unwinding (an ``EngineCrash`` mid-round must not
        skew the stack, but the trace should say the span was torn
        down); the default closes normally, so a success path may
        unwind instead of matching every ``span_end`` by hand."""
        while len(self._spans) > depth:
            if aborted:
                self.span_end(aborted=True)
            else:
                self.span_end()

    def on_event(self, name: str, args: Optional[dict] = None) -> None:
        """Instant event on the engine track (OOM/shed occupancy
        dumps ride this)."""
        ev = {"name": name, "ph": "i", "ts": self.now(), "s": "t"}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)
        if not self._replay:       # replayed instants are flagged in
            self.registry.count(f"events.{name}")   # the timeline only

    # -- request lifecycle --------------------------------------------
    def _rec_event(self, rec: _ReqTrace, ts: float, name: str,
                   args: Optional[dict] = None) -> None:
        """Bounded per-record event log (counters keep counting past
        the cap — only the log truncates)."""
        if len(rec.events) < self.MAX_REQ_EVENTS:
            rec.events.append((ts, name, args))

    def _req(self, rid: int) -> Optional[_ReqTrace]:
        """The record for ``rid``, or None when this collector never
        saw it submitted (wired onto a restored engine with in-flight
        requests): a request is traced from its submit or not at all —
        synthesizing a half-record here would put tenant-less entries
        (and, via rollback, NEGATIVE token tallies) in the summary."""
        rec = self.requests.get(rid)
        if rec is None or self._frozen(rec):
            return None
        return rec

    def _frozen(self, rec: _ReqTrace) -> bool:
        # during replay, records the dead incarnation observed live
        # hold the truth already — only replay-born records accumulate
        return self._replay and not rec.replayed

    def on_submit(self, rid: int, tenant: str,
                  prompt_tokens: int, gid=None) -> None:
        if rid in self.requests:        # replayed submit of a known
            return                      # rid: the live record stands
        if len(self.requests) >= self.max_requests:
            # long-lived servers: evict the OLDEST terminal record
            # (dict order == submission order) so memory stays
            # bounded; live records are never evicted
            victim = next((k for k, r in self.requests.items()
                           if r.outcome is not None), None)
            if victim is not None:
                del self.requests[victim]
                self.evicted_requests += 1
        ts = self.now()
        rec = _ReqTrace(rid, tenant, ts, replayed=self._replay,
                        gid=None if gid is None else int(gid))
        rec.events.append((ts, "submitted",
                           {"prompt_tokens": int(prompt_tokens)}))
        self.requests[rid] = rec
        self.registry.count("requests.submitted")

    def on_admitted(self, rid: int, slot: int, retry: bool) -> None:
        rec = self._req(rid)
        if rec is None:
            return
        ts = self.now()
        if rec.admit_ts is None:
            rec.admit_ts = ts
        if rec._preempt_ts is not None:
            rec.stall_s += ts - rec._preempt_ts
            rec._preempt_ts = None
        self._rec_event(rec, ts, "readmitted" if retry else "admitted",
                        {"slot": int(slot)})

    def on_prefill_chunk(self, rid: int, pos: int) -> None:
        rec = self._req(rid)
        if rec is None:
            return
        rec.chunks += 1
        self._rec_event(rec, self.now(), "prefill_chunk",
                        {"pos": int(pos)})

    def on_first_token(self, rid: int) -> None:
        rec = self._req(rid)
        if rec is None:
            return
        if rec.first_ts is None:
            rec.first_ts = self.now()
            self._rec_event(rec, rec.first_ts, "first_token")

    def on_decode(self, rids, n: int) -> None:
        """One fused step consumed ``n`` decode tokens for each rid —
        counted, not evented (the hot path of the hot path). Frozen
        (replayed) records count nowhere: neither their per-request
        tally nor the registry counter — replay must not inflate
        either."""
        ts = self.now()
        counted = 0
        for rid in rids:
            rec = self._req(rid)
            if rec is None:
                continue
            rec.tokens += n
            rec.last_ts = ts
            counted += 1
        if counted:
            self.registry.count("tokens.decoded", n * counted)

    def on_rollback(self, rid: int, rejected: int) -> None:
        rec = self._req(rid)
        if rec is None:
            return
        rec.tokens -= rejected      # consumed-but-rejected rows leave
        self._rec_event(rec, self.now(), "rolled_back",
                        {"rejected": int(rejected)})

    def on_preempted(self, rid: int) -> None:
        rec = self._req(rid)
        if rec is None:
            return
        rec.preemptions += 1
        rec._preempt_ts = self.now()
        self._rec_event(rec, rec._preempt_ts, "preempted")

    def on_outcome(self, rid: int, status: str, step: int,
                   reason: str = "") -> None:
        rec = self._req(rid)
        if rec is None or rec.outcome is not None:
            return                  # terminal exactly once per record
        ts = self.now()
        rec.outcome = status
        rec.outcome_step = int(step)
        # terminal event rides even past the cap: drop a middle entry
        # rather than lose the verdict from the log
        if len(rec.events) >= self.MAX_REQ_EVENTS:
            del rec.events[self.MAX_REQ_EVENTS // 2]
        rec.events.append((ts, status,
                           {"reason": reason[:120]} if reason else None))
        self.registry.count(f"outcomes.{status}")
        if not rec.replayed:
            for name in self.LATENCIES:
                v = getattr(rec, name)
                if v is not None:
                    self.registry.observe(f"latency.{name}", v)
                    # the per-tenant split the SLO tracker windows
                    # over (values_since / percentiles_since)
                    self.registry.observe(
                        f"latency.{name}.tenant.{rec.tenant}", v)

    # -- replay mode --------------------------------------------------
    def set_replay(self, on: bool) -> None:
        """Journal replay bracket (RecoverableServer.recover): spans
        record flagged, live-observed request records freeze — replay
        neither diverges the trace nor double-counts it."""
        self._replay = bool(on)

    # -- summaries / export -------------------------------------------
    def request_summary(self) -> dict:
        """Per-tenant (+ overall) percentiles of TTFT / TPOT /
        queue-wait / preemption-stall over TERMINAL, non-replayed
        requests (a replay-born record's stamps are replay times, not
        serving latencies — excluded)."""
        done = [r for r in self.requests.values()
                if r.outcome is not None and not r.replayed]
        by_tenant: Dict[str, list] = {}
        for r in done:
            by_tenant.setdefault(r.tenant, []).append(r)

        def roll(recs):
            out = {"requests": len(recs),
                   "tokens": sum(r.tokens for r in recs),
                   "preemptions": sum(r.preemptions for r in recs)}
            for name in self.LATENCIES:
                out[name] = percentiles(getattr(r, name)
                                        for r in recs)
            return out

        return {"overall": roll(done),
                "per_tenant": {t: roll(rs)
                               for t, rs in by_tenant.items()}}

    def group_summary(self) -> dict:
        """Per fork-shared branch group (scheduler ``submit(n>1)`` /
        ``fork_stream``): branch count, total tokens, and GROUP TTFT —
        the wall time from the group's earliest submit (the lead's;
        branches are forked later, at prefill completion) to the
        earliest first token emitted by ANY member. That is the
        latency the caller of one n-way request observes, which
        per-branch ``ttft_s`` (tiny for forked branches) does not
        measure. Non-replayed records only, keyed by str(gid) for
        JSON round-tripping."""
        by_gid: Dict[int, list] = {}
        for r in self.requests.values():
            if r.gid is not None and not r.replayed:
                by_gid.setdefault(r.gid, []).append(r)
        out = {}
        for gid, recs in by_gid.items():
            firsts = [r.first_ts for r in recs if r.first_ts is not None]
            submit = min(r.submit_ts for r in recs)
            out[str(gid)] = {
                "branches": len(recs),
                "tokens": sum(r.tokens for r in recs),
                "group_ttft_s": None if not firsts
                else round(min(firsts) - submit, 6),
                "outcomes": sorted(r.outcome for r in recs
                                   if r.outcome is not None)}
        return out

    def as_dict(self) -> dict:
        return {"steps": self.steps,
                "replayed_steps": self.replayed_steps,
                "timeline_events": len(self.events),
                "dropped_events": self.dropped,
                "requests": len(self.requests),
                "evicted_requests": self.evicted_requests,
                "registry": self.registry.as_dict(),
                "summary": self.request_summary(),
                "groups": self.group_summary()}

    def chrome_trace(self) -> dict:
        """The ``trace_events`` JSON object (Chrome/Perfetto): engine
        timeline on pid 1, request lifecycles as async events on
        pid 2, request/summary/registry dumps in ``metadata``."""
        evs: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "engine"}},
            {"name": "process_name", "ph": "M", "pid": 2, "tid": 0,
             "args": {"name": "requests"}},
        ]
        for ev in self.events:
            out = dict(ev)
            out["ts"] = round(out["ts"] * 1e6, 1)
            if "dur" in out:
                out["dur"] = round(out["dur"] * 1e6, 1)
            out.setdefault("pid", 1)
            out.setdefault("tid", 0)
            evs.append(out)
        for rec in self.requests.values():
            if not rec.events:
                continue
            rid = str(rec.rid)
            name = f"req {rec.rid}"
            args = {"tenant": rec.tenant, "replayed": rec.replayed}
            t_first = rec.events[0][0]
            evs.append({"name": name, "cat": "request", "ph": "b",
                        "id": rid, "ts": round(t_first * 1e6, 1),
                        "pid": 2, "tid": 0, "args": args})
            for ts, ev_name, ev_args in rec.events:
                e = {"name": ev_name, "cat": "request", "ph": "n",
                     "id": rid, "ts": round(ts * 1e6, 1),
                     "pid": 2, "tid": 0}
                if ev_args:
                    e["args"] = dict(ev_args)
                evs.append(e)
            t_last = rec.events[-1][0]
            evs.append({"name": name, "cat": "request", "ph": "e",
                        "id": rid, "ts": round(t_last * 1e6, 1),
                        "pid": 2, "tid": 0})
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "metadata": {
                    "requests": {r.rid: r.as_dict()
                                 for r in self.requests.values()},
                    "summary": self.request_summary(),
                    "registry": self.registry.as_dict(),
                    "steps": self.steps,
                    "replayed_steps": self.replayed_steps,
                    "dropped_events": self.dropped}}

    def save_chrome_trace(self, path: str) -> int:
        """Write ``chrome_trace()`` as JSON; returns bytes written."""
        blob = json.dumps(self.chrome_trace(), default=_json_default)
        with open(path, "w") as f:
            f.write(blob)
        return len(blob)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")
