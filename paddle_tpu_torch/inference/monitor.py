"""Continuous health monitoring (counterpart of
paddle_tpu/inference/monitor.py, host-only numpy, kept AST-equal to it
apart from imports and docstrings): windowed time-series over the
always-on metrics registry, per-tenant SLO tracking and deterministic
threshold alerting.

* ``SeriesBuffer`` — a ring of (step, value) samples with windowed
  last/mean/max/min/sum/rate queries, keyed to the engine step counter,
  never the wall clock.
* ``SloPolicy`` / ``SloTracker`` — per-tenant TTFT / TPOT / queue-wait
  targets with a compliance objective; the tracker reads the
  collector's per-tenant latency histograms through the registry's
  windowed views and reports compliance and error-budget burn rate.
* ``HealthMonitor`` — samples the registry at the end of every
  completed engine step, keeps the series, and emits edge-triggered
  ``Alert``s with hysteresis through a bounded stream:
  pool-pressure-high, shed-spike, acceptance-collapse, queue-growth,
  journal-lag, capacity-degraded, network-flapping, expert-collapse,
  goodput-collapse, waste-spike and slo-burn. Detectors whose registry
  namespace never appears (``moe.*``, ``net.*``, ``fleet.*``,
  ``work.*``) stay dark. ``report()`` is the ``HealthReport``.

Contracts (tests/test_torch_monitor.py): no monitor work at all with
``monitor=None``, and no clock read even when on (this module does not
import ``time``); the monitor only reads, so streams and outcomes are
the same with it on and off; engine snapshots carry no monitor state,
and after a restore the series rebuild by resampling (``rebase``,
``set_replay``: steps sampled live stay frozen, alerts first derived
during replay are flagged ``replayed``).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .telemetry import MetricsRegistry

__all__ = ["SeriesBuffer", "SloPolicy", "SloTracker", "Alert",
           "HealthReport", "HealthMonitor"]


# ---------------------------------------------------------------------
# windowed time-series
# ---------------------------------------------------------------------

class SeriesBuffer:
    """Fixed-capacity ring buffer of (step, value) samples with
    windowed queries. ``window=None`` queries span every retained
    sample; ``window=n`` the most recent n. Appends are O(1) into
    preallocated arrays — a long-lived server's series cost is fixed
    at construction, never O(steps served)."""

    __slots__ = ("name", "capacity", "_steps", "_vals", "_n")

    def __init__(self, name: str, capacity: int = 512):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.capacity = int(capacity)
        self._steps = np.zeros(self.capacity, np.int64)
        self._vals = np.zeros(self.capacity, np.float64)
        self._n = 0             # total samples ever appended

    def append(self, step: int, value: float) -> None:
        i = self._n % self.capacity
        self._steps[i] = int(step)
        self._vals[i] = float(value)
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total(self) -> int:
        """Samples ever appended (>= len once the ring wrapped)."""
        return self._n

    def window(self, n: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(steps, values) of the last ``n`` samples in chronological
        order (everything retained when n is None)."""
        have = len(self)
        if have == 0:
            return (np.empty(0, np.int64), np.empty(0, np.float64))
        take = have if n is None else min(int(n), have)
        end = self._n % self.capacity
        idx = (np.arange(end - take, end)) % self.capacity
        return self._steps[idx].copy(), self._vals[idx].copy()

    # -- windowed scalar queries --------------------------------------
    def last(self) -> Optional[float]:
        if self._n == 0:
            return None
        return float(self._vals[(self._n - 1) % self.capacity])

    def last_step(self) -> Optional[int]:
        if self._n == 0:
            return None
        return int(self._steps[(self._n - 1) % self.capacity])

    def mean(self, n: Optional[int] = None) -> Optional[float]:
        _, v = self.window(n)
        return float(v.mean()) if v.size else None

    def max(self, n: Optional[int] = None) -> Optional[float]:
        _, v = self.window(n)
        return float(v.max()) if v.size else None

    def min(self, n: Optional[int] = None) -> Optional[float]:
        _, v = self.window(n)
        return float(v.min()) if v.size else None

    def sum(self, n: Optional[int] = None) -> float:
        _, v = self.window(n)
        return float(v.sum())

    def rate(self, n: Optional[int] = None) -> Optional[float]:
        """Per-step slope over the window: (last - first) / step span.
        For GAUGE series this is the growth rate (queue-growth's
        signal); delta-fed series are already per-step rates — query
        ``mean`` there instead."""
        s, v = self.window(n)
        if v.size < 2 or s[-1] == s[0]:
            return None
        return float((v[-1] - v[0]) / (s[-1] - s[0]))

    def as_dict(self, n: Optional[int] = None) -> dict:
        r = lambda v: None if v is None else round(v, 6)  # noqa: E731
        return {"samples": len(self), "total": self._n,
                "last": r(self.last()), "mean": r(self.mean(n)),
                "max": r(self.max(n)), "min": r(self.min(n))}


# ---------------------------------------------------------------------
# per-tenant SLO tracking
# ---------------------------------------------------------------------

class SloPolicy:
    """Latency targets for one tenant: any subset of TTFT / TPOT /
    queue-wait (seconds), plus the compliance ``objective`` — the
    fraction of requests that must meet each target (0.99 = a 1%
    error budget). ``objective`` must sit strictly inside (0, 1):
    1.0 would make the burn rate undefined (zero budget)."""

    METRICS = ("ttft_s", "tpot_s", "queue_wait_s")

    __slots__ = METRICS + ("objective",)

    def __init__(self, *, ttft_s: Optional[float] = None,
                 tpot_s: Optional[float] = None,
                 queue_wait_s: Optional[float] = None,
                 objective: float = 0.99):
        if not (0.0 < objective < 1.0):
            raise ValueError(
                f"objective must be in (0, 1), got {objective} (an "
                f"objective of 1.0 leaves no error budget to burn)")
        if ttft_s is None and tpot_s is None and queue_wait_s is None:
            raise ValueError("at least one latency target must be set")
        for name, v in (("ttft_s", ttft_s), ("tpot_s", tpot_s),
                        ("queue_wait_s", queue_wait_s)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} target must be > 0")
        self.ttft_s = ttft_s
        self.tpot_s = tpot_s
        self.queue_wait_s = queue_wait_s
        self.objective = float(objective)

    def as_dict(self) -> dict:
        out = {m: getattr(self, m) for m in self.METRICS
               if getattr(self, m) is not None}
        out["objective"] = self.objective
        return out


class SloTracker:
    """Rolling per-tenant SLO compliance over the TraceCollector's
    per-tenant latency histograms (``latency.<metric>.tenant.<tid>``
    in the collector's registry). ``policies`` maps tenant id ->
    SloPolicy; the ``"*"`` entry (or a bare SloPolicy) is the default
    for tenants not listed — tenants with no applicable policy are
    not tracked. ``update`` pulls only the observations since the
    last pull (the registry's windowed ``values_since`` view) into
    bounded per-(tenant, metric) windows; ``status`` reports
    compliance fraction and burn rate per window."""

    def __init__(self, policies, window: int = 128):
        if isinstance(policies, SloPolicy):
            policies = {"*": policies}
        if not policies:
            raise ValueError("at least one SloPolicy is required")
        for tid, pol in policies.items():
            if not isinstance(pol, SloPolicy):
                raise TypeError(
                    f"policies[{tid!r}] must be an SloPolicy")
        self.policies: Dict[str, SloPolicy] = dict(policies)
        self.window = int(window)
        self._marks: Dict[str, int] = {}
        self._vals: Dict[Tuple[str, str], deque] = {}

    def policy_for(self, tenant: str) -> Optional[SloPolicy]:
        return self.policies.get(tenant, self.policies.get("*"))

    def update(self, registry: MetricsRegistry) -> None:
        """Pull new per-tenant latency observations from a collector's
        registry into the rolling windows (idempotent between new
        observations — the marks remember what was consumed)."""
        for name in registry.hist_names():
            if not name.startswith("latency.") or ".tenant." not in name:
                continue
            metric, _, tid = \
                name[len("latency."):].partition(".tenant.")
            pol = self.policy_for(tid)
            if pol is None or metric not in SloPolicy.METRICS or \
                    getattr(pol, metric) is None:
                continue
            total = registry.hist_total(name)
            start = self._marks.get(name, 0)
            if total <= start:
                continue
            vals = registry.values_since(name, start)
            self._marks[name] = total
            dq = self._vals.setdefault(
                (tid, metric), deque(maxlen=self.window))
            dq.extend(vals)

    def status(self) -> Dict[str, dict]:
        """{tenant: {metric: {target_s, objective, window, compliance,
        burn, ok}}} over each rolling window. ``burn`` is the
        error-budget burn rate: 1.0 = exactly on budget, above 1 =
        burning faster than the objective allows."""
        out: Dict[str, dict] = {}
        for (tid, metric) in sorted(self._vals):
            dq = self._vals[(tid, metric)]
            if not dq:
                continue
            pol = self.policy_for(tid)
            target = getattr(pol, metric)
            n = len(dq)
            good = sum(1 for v in dq if v <= target)
            comp = good / n
            burn = (1.0 - comp) / (1.0 - pol.objective)
            out.setdefault(tid, {})[metric] = {
                "target_s": target, "objective": pol.objective,
                "window": n, "compliance": round(comp, 6),
                "burn": round(burn, 6), "ok": comp >= pol.objective}
        return out


# ---------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------

class Alert:
    """One deterministic threshold crossing. ``step`` is the engine
    step the detector fired at; ``replayed`` flags alerts re-derived
    during journal replay (mirroring the collector's replay-flagged
    spans — same verdict, but not a fresh incident)."""

    __slots__ = ("step", "kind", "signal", "value", "threshold",
                 "tenant", "replayed")

    def __init__(self, step: int, kind: str, signal: str, value: float,
                 threshold: float, tenant: Optional[str] = None,
                 replayed: bool = False):
        self.step = int(step)
        self.kind = kind
        self.signal = signal
        self.value = float(value)
        self.threshold = float(threshold)
        self.tenant = tenant
        self.replayed = bool(replayed)

    def sig(self) -> tuple:
        """Identity tuple WITHOUT the replay flag — two derivations of
        the same incident (live vs replayed) share a sig."""
        return (self.step, self.kind, self.signal,
                round(self.value, 9), round(self.threshold, 9),
                self.tenant)

    def as_dict(self) -> dict:
        return {"step": self.step, "kind": self.kind,
                "signal": self.signal, "value": round(self.value, 6),
                "threshold": round(self.threshold, 6),
                "tenant": self.tenant, "replayed": self.replayed}

    def __eq__(self, other):
        return isinstance(other, Alert) and \
            self.sig() == other.sig() and \
            self.replayed == other.replayed

    def __hash__(self):
        return hash((self.sig(), self.replayed))

    def __repr__(self):
        t = f", tenant={self.tenant!r}" if self.tenant else ""
        r = ", replayed" if self.replayed else ""
        return (f"Alert(step={self.step}, {self.kind}: "
                f"{self.signal}={self.value:.4g} vs "
                f"{self.threshold:.4g}{t}{r})")


class HealthReport:
    """Structured verdict over the monitored engine: an overall score
    in [0, 1] with a worst-of verdict, per-signal windowed stats +
    verdicts, per-tenant SLO status, and the alert tallies. A pure
    function of the sampled step sequence (plus the SLO windows) —
    the placement input a router scrapes per host."""

    __slots__ = ("step", "samples", "score", "verdict", "signals",
                 "tenants", "alerts")

    def __init__(self, step, samples, score, verdict, signals,
                 tenants, alerts):
        self.step = step
        self.samples = samples
        self.score = score
        self.verdict = verdict
        self.signals = signals
        self.tenants = tenants
        self.alerts = alerts

    def as_dict(self) -> dict:
        return {"kind": "health_report", "step": self.step,
                "samples": self.samples, "score": self.score,
                "verdict": self.verdict, "signals": self.signals,
                "tenants": self.tenants, "alerts": self.alerts}

    def placement(self) -> dict:
        """Compact placement view — the handful of numbers a
        disaggregated router (inference/router.py) needs from each
        worker's scrape: overall verdict/score plus the last windowed
        value of the load-bearing signals. Small enough to cross a
        pipe every tick; the full report stays host-side."""
        def last(name):
            s = self.signals.get(name)
            return None if not s else s.get("last")
        return {"verdict": self.verdict, "score": self.score,
                "step": self.step,
                "pool_pressure": last("pool.pressure"),
                "queue_depth": last("queue.depth"),
                "shed_rate": last("shed_rate"),
                "tokens_per_step": last("tokens_per_step")}

    def __repr__(self):
        return (f"HealthReport(step={self.step}, "
                f"score={self.score:.2f}, {self.verdict}, "
                f"{len(self.signals)} signal(s))")


# ---------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------

class HealthMonitor:
    """See the module docstring. Construction is engine-free; an
    engine ``bind``s its registry (and optional collector) at wiring
    time and calls ``on_step(step_count)`` from its telemetry path.
    One monitor watches one engine."""

    # detector thresholds (override any subset via ``thresholds=``)
    DEFAULTS = {
        # pool occupancy fraction that fires / re-arms the pressure
        # alert (hysteresis: stays active until it falls below clear)
        "pool_pressure_high": 0.9,
        "pool_pressure_clear": 0.8,
        # shed-spike: windowed shed rate > factor x its EWMA baseline
        # (alpha is the per-sample EWMA weight)
        "shed_spike_factor": 4.0,
        "shed_ewma_alpha": 0.2,
        # speculative acceptance collapse floor (windowed mean)
        "acceptance_floor": 0.2,
        # queue-growth: depth non-decreasing across this many samples
        # with at least this much total growth
        "queue_growth_samples": 4,
        "queue_growth_min": 3,
        # journal records appended since the last snapshot
        "journal_lag_high": 256,
        # fleet capacity: live-worker fraction under the floor fires;
        # hysteresis: stays active until back above clear (a respawned
        # fleet must actually rejoin before the alert re-arms)
        "capacity_degraded_floor": 0.75,
        "capacity_degraded_clear": 0.99,
        # goodput-collapse: the share of the window's TOTAL ledger
        # work not known-wasted ((work - waste) / work) fell through
        # the floor (CostLedger-fed; dark without a ledger)
        "goodput_floor": 0.5,
        # waste-spike: windowed waste rate > factor x its EWMA
        # baseline (the shed-spike pattern on wasted token-rows)
        "waste_spike_factor": 4.0,
        "waste_ewma_alpha": 0.2,
        # SLO error-budget burn rate that fires, and the minimum
        # window occupancy before burn is judged at all
        "slo_burn_high": 2.0,
        "slo_min_samples": 8,
        # expert-collapse (MoE-fed, dark for dense models — the moe.*
        # registry namespace never appears): the top expert's share of
        # the interval's routed assignments at/above the fraction
        # fires; hysteresis: re-arms below _clear. Intervals routing
        # fewer than _min_routed assignments are not judged (a 2-row
        # step trivially routes 100% to one expert).
        "expert_collapse_frac": 0.8,
        "expert_collapse_clear": 0.5,
        "expert_collapse_min_routed": 8,
        # network-flapping (session-transport-fed, inference/net.py;
        # dark when no worker runs the session layer — the net.*
        # namespace never appears): reconnects within the detection
        # window at/above _min fires; hysteresis: re-arms only after
        # a window with at most _clear reconnects (a settled network)
        "network_flapping_min": 3,
        "network_flapping_clear": 0,
    }

    def __init__(self, slo=None, *, sample_every: int = 1,
                 capacity: int = 512, window: int = 16,
                 slo_window: int = 128, max_alerts: int = 4096,
                 thresholds: Optional[dict] = None):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.sample_every = int(sample_every)
        self.capacity = int(capacity)
        self.window = int(window)
        self.max_alerts = int(max_alerts)
        self.thresholds = dict(self.DEFAULTS)
        for k, v in (thresholds or {}).items():
            if k not in self.DEFAULTS:
                raise ValueError(f"unknown threshold {k!r} (have: "
                                 f"{sorted(self.DEFAULTS)})")
            self.thresholds[k] = v
        self.slo = None
        if slo is not None:
            self.slo = slo if isinstance(slo, SloTracker) \
                else SloTracker(slo, window=slo_window)
        self._registry: Optional[MetricsRegistry] = None
        self._collector = None
        self._series: Dict[str, SeriesBuffer] = {}
        self._prev: Optional[dict] = None
        self._prev_step = 0
        self._last_step = -1          # last SAMPLED step (frozen gate)
        self._span_marks: Dict[str, int] = {}
        self._ewma: Dict[str, float] = {}
        self._active: set = set()     # (kind, tenant) currently firing
        self._replay = False
        self.samples = 0
        self.alerts: List[Alert] = []
        self.alerts_dropped = 0
        self.alert_counts: Dict[str, int] = {}

    # -- wiring (engine-side) -----------------------------------------
    def bind(self, registry: MetricsRegistry, collector=None) -> None:
        """Wire the monitor onto an engine's always-on registry (and
        its optional TraceCollector, the SLO latency source). Called
        by the engine constructor; re-binding (engine restore) keeps
        every accumulated series and alert — derived state survives
        the engine object it was derived from."""
        self._registry = registry
        self._collector = collector

    def set_replay(self, on: bool) -> None:
        """Journal-replay bracket (RecoverableServer.recover), the
        mirror of TraceCollector.set_replay: steps already sampled
        live stay frozen, newly seen steps sample with their alerts
        flagged ``replayed`` and kept out of ``alert_counts``."""
        self._replay = bool(on)

    def rebase(self, step: int) -> None:
        """Re-baseline after an engine restore: snapshot the restored
        registry at ``step`` so the NEXT sample's interval deltas span
        exactly one interval (counters are snapshot-restored to their
        step-``step`` values, so a fresh monitor resampling the replay
        computes the same deltas the dead incarnation's monitor did).
        A monitor that already holds samples past ``step`` (the same
        object riding through recovery) is left untouched — its live
        history IS the baseline."""
        if self._registry is None or int(step) < self._last_step:
            return
        self._prev = self._registry.as_dict()
        self._prev_step = int(step)
        self._last_step = int(step)

    # -- sampling -----------------------------------------------------
    def on_step(self, step: int) -> None:
        """Engine hook, called at the end of every step with the step
        counter. Samples at the configured cadence; non-monotonic
        steps (journal replay of steps already sampled live) are
        frozen — the live samples stand, nothing double-counts."""
        if self._registry is None or step <= self._last_step:
            return
        if step % self.sample_every:
            return
        self._last_step = int(step)
        self._sample(int(step))

    def series(self, name: str) -> Optional[SeriesBuffer]:
        return self._series.get(name)

    def _push(self, name: str, step: int, value: float) -> None:
        sb = self._series.get(name)
        if sb is None:
            sb = self._series[name] = SeriesBuffer(
                name, capacity=self.capacity)
        sb.append(step, value)

    def _sample(self, step: int) -> None:
        cur = self._registry.as_dict()
        prev, pstep = self._prev, self._prev_step
        self._prev, self._prev_step = cur, step
        self.samples += 1

        def num(d, key, default=0.0):
            v = d.get(key, default)
            return float(v) if isinstance(v, (int, float)) and \
                not isinstance(v, bool) else float(default)

        # gauges — step-boundary ground truth
        active = num(cur, "pool.active")
        usable = num(cur, "pool.usable") or 1.0
        self._push("pool.active", step, active)
        self._push("pool.cached_free", step,
                   num(cur, "pool.cached_free"))
        self._push("pool.free", step, num(cur, "pool.free"))
        self._push("pool.pressure", step, active / usable)
        self._push("queue.depth", step, num(cur, "queue.depth"))
        self._push("queue.active", step, num(cur, "queue.active"))
        for key, v in cur.items():
            # the live gauge is tenants.<tid>.blocks_held; the
            # .stats.blocks_held sibling is the same number through
            # TenantStats — one series per tenant, not two
            if key.startswith("tenants.") and \
                    key.endswith(".blocks_held") and \
                    ".stats." not in key:
                tid = key[len("tenants."):-len(".blocks_held")]
                self._push(f"tenant.{tid}.charge", step, float(v))
        if "journal.lag_records" in cur:
            self._push("journal.lag", step,
                       num(cur, "journal.lag_records"))
            self._push("journal.bytes", step, num(cur, "journal.bytes"))
        if "snapshot.age_steps" in cur:
            self._push("snapshot.age", step,
                       num(cur, "snapshot.age_steps"))
        if "fleet.workers_total" in cur:
            total = num(cur, "fleet.workers_total") or 1.0
            self._push("fleet.capacity", step,
                       num(cur, "fleet.workers_live") / total)
            self._push("fleet.respawns", step,
                       num(cur, "fleet.respawns"))
        # session-transport counters (inference/net.py — dark when no
        # worker runs the session layer: the net.* namespace never
        # appears and the network-flapping detector stays off)
        if "net.reconnects" in cur:
            self._push("net.reconnects", step,
                       num(cur, "net.reconnects"))
            self._push("net.retried_ops", step,
                       num(cur, "net.retried_ops"))
        if "moe.routed_tokens" in cur:
            self._push("moe.overflow_rate", step,
                       num(cur, "moe.overflow_rate"))
        # fork-shared parallel decoding gauges (dark until the first
        # submit(n>1)/fork_stream — the parallel.* namespace stays all
        # zero for plain serving and the series are never pushed)
        if num(cur, "parallel.groups") > 0:
            self._push("parallel.branches_per_group", step,
                       num(cur, "parallel.branches_per_group"))
            self._push("parallel.shared_blocks", step,
                       num(cur, "parallel.shared_blocks"))

        # interval deltas — the first sample is baseline only
        if prev is not None:
            dstep = max(1, step - pstep)
            tok = sum(v - num(prev, k)
                      for k, v in cur.items()
                      if k.endswith(".stats.tokens_served")
                      and isinstance(v, (int, float)))
            self._push("tokens_per_step", step, tok / dstep)
            shed = num(cur, "resilience.shed") \
                - num(prev, "resilience.shed")
            self._push("shed_rate", step, shed / dstep)
            prop = num(cur, "spec.proposed") \
                - num(prev, "spec.proposed")
            if prop > 0:
                acc = num(cur, "spec.accepted") \
                    - num(prev, "spec.accepted")
                self._push("spec.acceptance", step, acc / prop)
            # cost-ledger work signals (present only with a ledger
            # wired — inference/accounting.py): work and goodput vs
            # waste per step, and the share of the interval's work
            # NOT known-wasted. Goodput itself resolves only at
            # request FINISH (lumpy at request granularity), so the
            # collapse fraction is judged against TOTAL work done —
            # a long generation with no completions in the window
            # must not read as a collapse
            if "work.total_tokens" in cur:
                tot = num(cur, "work.total_tokens") \
                    - num(prev, "work.total_tokens")
                good = num(cur, "work.goodput_tokens") \
                    - num(prev, "work.goodput_tokens")
                waste = num(cur, "work.waste_tokens") \
                    - num(prev, "work.waste_tokens")
                self._push("work_per_step", step, tot / dstep)
                self._push("goodput_per_step", step, good / dstep)
                self._push("waste_rate", step, waste / dstep)
                if tot > 0:
                    self._push("goodput_fraction", step,
                               max(0.0, (tot - waste) / tot))
            # MoE per-expert load skew over the interval (MoE-fed;
            # dense models never surface moe.* keys and the series
            # stays dark). Thin intervals (fewer routed assignments
            # than the judging floor) are NOT pushed — a near-empty
            # step trivially routes everything to one expert and must
            # not read as a collapse or a recovery.
            if "moe.routed_tokens" in cur:
                E = int(num(cur, "moe.experts"))
                loads = [num(cur, f"moe.load.{e}")
                         - num(prev, f"moe.load.{e}") for e in range(E)]
                routed = sum(loads)
                if routed >= self.thresholds[
                        "expert_collapse_min_routed"]:
                    self._push("moe.top_frac", step,
                               max(loads) / routed)
                    self._push("moe.routed_per_step", step,
                               routed / dstep)

        # per-phase step-span durations (collector-side wall clock —
        # observational, feeds kernel tile sizing, never a detector)
        col = self._collector
        if col is not None:
            for name in col.registry.hist_names():
                if not name.startswith("span."):
                    continue
                total = col.registry.hist_total(name)
                start = self._span_marks.get(name, 0)
                if total <= start:
                    continue
                vals = col.registry.values_since(name, start)
                self._span_marks[name] = total
                self._push(name, step, float(np.mean(vals)))
            if self.slo is not None:
                self.slo.update(col.registry)
        self._detect(step)

    # -- detectors ----------------------------------------------------
    def _fire(self, kind: str, firing: bool, step: int, signal: str,
              value, threshold: float,
              tenant: Optional[str] = None) -> None:
        """Edge-triggered alert with hysteresis folded into ``firing``
        by the caller: an alert fires once per crossing and re-arms
        when the condition clears."""
        key = (kind, tenant)
        if firing and key not in self._active:
            self._active.add(key)
            a = Alert(step, kind, signal, float(value),
                      float(threshold), tenant=tenant,
                      replayed=self._replay)
            if len(self.alerts) < self.max_alerts:
                self.alerts.append(a)
            else:
                self.alerts_dropped += 1
            if not self._replay:
                self.alert_counts[kind] = \
                    self.alert_counts.get(kind, 0) + 1
        elif not firing:
            self._active.discard(key)

    def _detect(self, step: int) -> None:
        th = self.thresholds
        # 1. pool-pressure-high (hysteresis: clears below _clear)
        sb = self._series.get("pool.pressure")
        if sb is not None:
            v = sb.last()
            bound = th["pool_pressure_clear"] \
                if ("pool-pressure-high", None) in self._active \
                else th["pool_pressure_high"]
            self._fire("pool-pressure-high", v >= bound, step,
                       "pool.pressure", v, th["pool_pressure_high"])
        # 2. shed-spike (EWMA baseline; clears when the rate decays
        #    back to the baseline)
        sb = self._series.get("shed_rate")
        if sb is not None and sb.total > 0:
            v = sb.last()
            base = self._ewma.get("shed_rate")
            b = 0.0 if base is None else base
            if ("shed-spike", None) in self._active:
                firing = v > b
            else:
                firing = v > 0 and v > th["shed_spike_factor"] * b
            self._fire("shed-spike", firing, step, "shed_rate", v,
                       th["shed_spike_factor"] * b)
            a = th["shed_ewma_alpha"]
            self._ewma["shed_rate"] = v if base is None \
                else a * v + (1 - a) * base
        # 3. acceptance-collapse (windowed mean under the floor)
        sb = self._series.get("spec.acceptance")
        if sb is not None and sb.total > 0:
            m = sb.mean(self.window)
            self._fire("acceptance-collapse",
                       m < th["acceptance_floor"], step,
                       "spec.acceptance", m, th["acceptance_floor"])
        # 4. queue-growth (monotone growth across the window)
        sb = self._series.get("queue.depth")
        if sb is not None:
            g = int(th["queue_growth_samples"])
            _, v = sb.window(g)
            firing = v.size >= g and bool(np.all(np.diff(v) >= 0)) \
                and v[-1] - v[0] >= th["queue_growth_min"]
            self._fire("queue-growth", firing, step, "queue.depth",
                       sb.last(), th["queue_growth_min"])
        # 4b. goodput-collapse (CostLedger-fed: the share of the
        #     window's TOTAL work not known-wasted fell through the
        #     floor — judged against work done, not work resolved,
        #     because goodput lands in one lump when a request
        #     finishes: a long generation mid-flight has zero
        #     resolved goodput and must not read as a collapse)
        sbt = self._series.get("work_per_step")
        sbw = self._series.get("waste_rate")
        if sbt is not None and sbw is not None:
            t_sum = sbt.sum(self.window)
            w = sbw.sum(self.window)
            frac = max(0.0, (t_sum - w) / t_sum) if t_sum > 0 else None
            self._fire("goodput-collapse",
                       frac is not None and frac < th["goodput_floor"],
                       step, "goodput_fraction",
                       frac if frac is not None else 1.0,
                       th["goodput_floor"])
            # 4c. waste-spike (EWMA baseline, the shed-spike pattern —
            #     except the FIRST NONZERO waste sample only SEEDS the
            #     baseline: speculative rejection makes routine waste,
            #     so "any waste at all" must not read as a spike the
            #     way a first shed legitimately does. Zero-waste
            #     intervals before that leave the baseline UNSEEDED —
            #     a 0.0-seeded EWMA would turn the first routine
            #     rejection into a division-free infinite spike.)
            v = sbw.last()
            base = self._ewma.get("waste_rate")
            b = 0.0 if base is None else base
            if ("waste-spike", None) in self._active:
                firing = v > b
            else:
                firing = base is not None and v > 0 and \
                    v > th["waste_spike_factor"] * b
            self._fire("waste-spike", firing, step, "waste_rate", v,
                       th["waste_spike_factor"] * b)
            if v > 0 or base is not None:
                a = th["waste_ewma_alpha"]
                self._ewma["waste_rate"] = v if base is None \
                    else a * v + (1 - a) * base
        # 5. journal-lag (clears below half the bound)
        sb = self._series.get("journal.lag")
        if sb is not None:
            v = sb.last()
            bound = th["journal_lag_high"] / 2 \
                if ("journal-lag", None) in self._active \
                else th["journal_lag_high"]
            self._fire("journal-lag", v >= bound, step, "journal.lag",
                       v, th["journal_lag_high"])
        # 5b. capacity-degraded (FleetSupervisor-fed: the live-worker
        #     fraction fell under the floor. Dark without a fleet —
        #     the series simply never appears. Hysteresis: a storm's
        #     respawns must carry capacity back above _clear before
        #     the alert re-arms, so one kill storm is one alert.)
        sb = self._series.get("fleet.capacity")
        if sb is not None:
            v = sb.last()
            bound = th["capacity_degraded_clear"] \
                if ("capacity-degraded", None) in self._active \
                else th["capacity_degraded_floor"]
            self._fire("capacity-degraded", v < bound, step,
                       "fleet.capacity", v,
                       th["capacity_degraded_floor"])
        # 5c. expert-collapse (MoE-fed: the top expert's share of the
        #     interval's routed assignments pinned high — the router
        #     has stopped spreading and E-1 expert tables are dead
        #     HBM. Dark for dense models: the moe.* namespace never
        #     appears, so the series is never pushed. Hysteresis: the
        #     alert re-arms only after the share falls under _clear.)
        sb = self._series.get("moe.top_frac")
        if sb is not None and sb.total > 0:
            v = sb.last()
            bound = th["expert_collapse_clear"] \
                if ("expert-collapse", None) in self._active \
                else th["expert_collapse_frac"]
            self._fire("expert-collapse", v >= bound, step,
                       "moe.top_frac", v, th["expert_collapse_frac"])
        # 5d. network-flapping (session-transport-fed: reconnects
        #     within the detection window crossed the bound — the
        #     fleet is riding out repeated drops rather than a single
        #     blip. Dark without the session layer: the net.* series
        #     is never pushed. Hysteresis: the alert re-arms only
        #     after a window with at most _clear NEW reconnects, so
        #     one storm is one alert however many drops it lands.)
        sb = self._series.get("net.reconnects")
        if sb is not None:
            _, vals = sb.window(self.window)
            delta = float(vals[-1] - vals[0]) if vals.size >= 2 \
                else 0.0
            active = ("network-flapping", None) in self._active
            firing = (delta > th["network_flapping_clear"] if active
                      else delta >= th["network_flapping_min"])
            self._fire("network-flapping", firing, step,
                       "net.reconnects", delta,
                       th["network_flapping_min"])
        # 6. slo-burn (per tenant, deterministic order)
        if self.slo is not None:
            status = self.slo.status()
            for tid in sorted(status):
                worst_m, worst = None, None
                for metric, rec in sorted(status[tid].items()):
                    if rec["window"] < th["slo_min_samples"]:
                        continue
                    if worst is None or rec["burn"] > worst:
                        worst_m, worst = metric, rec["burn"]
                firing = worst is not None and \
                    worst >= th["slo_burn_high"]
                self._fire("slo-burn", firing, step,
                           worst_m or "slo", worst or 0.0,
                           th["slo_burn_high"], tenant=tid)

    def drain_alerts(self) -> List[Alert]:
        out, self.alerts = self.alerts, []
        return out

    # -- the report -----------------------------------------------------
    _VERDICT_RANK = {"ok": 0, "warn": 1, "critical": 2}

    def _signal_verdict(self, name: str, sb: SeriesBuffer) -> str:
        th = self.thresholds
        if name == "pool.pressure":
            if ("pool-pressure-high", None) in self._active:
                return "critical"
            if (sb.last() or 0.0) >= th["pool_pressure_clear"]:
                return "warn"
        elif name == "shed_rate":
            if ("shed-spike", None) in self._active:
                return "critical"
            if sb.sum(self.window) > 0:
                return "warn"
        elif name == "spec.acceptance":
            if ("acceptance-collapse", None) in self._active:
                return "critical"
        elif name == "queue.depth":
            if ("queue-growth", None) in self._active:
                return "warn"
        elif name == "goodput_fraction":
            if ("goodput-collapse", None) in self._active:
                return "critical"
        elif name == "waste_rate":
            # routine speculative rejection IS waste — only a spike
            # over the run's own baseline degrades the verdict
            if ("waste-spike", None) in self._active:
                return "critical"
        elif name == "journal.lag":
            if ("journal-lag", None) in self._active:
                return "critical"
            if (sb.last() or 0.0) >= th["journal_lag_high"] / 2:
                return "warn"
        elif name == "fleet.capacity":
            # 0.0 is a REAL capacity reading (every worker dead) —
            # never `or`-default this one
            if ("capacity-degraded", None) in self._active:
                return "critical"
            last = sb.last()
            if last is not None and \
                    last < th["capacity_degraded_clear"]:
                return "warn"
        elif name == "moe.top_frac":
            if ("expert-collapse", None) in self._active:
                return "critical"
            if (sb.last() or 0.0) >= th["expert_collapse_clear"]:
                return "warn"
        elif name == "net.reconnects":
            if ("network-flapping", None) in self._active:
                return "critical"
            _, vals = sb.window(self.window)
            if vals.size >= 2 and vals[-1] > vals[0]:
                return "warn"          # reconnecting, under the bound
        return "ok"

    def report(self) -> HealthReport:
        """The structured health verdict — a pure function of the
        sampled series, the SLO windows and the active-alert state
        (all of it step-derived)."""
        th = self.thresholds
        signals = {}
        worst = 0
        n_warn = n_crit = 0
        for name in sorted(self._series):
            sb = self._series[name]
            verdict = self._signal_verdict(name, sb)
            rank = self._VERDICT_RANK[verdict]
            worst = max(worst, rank)
            n_warn += rank == 1
            n_crit += rank == 2
            signals[name] = dict(sb.as_dict(self.window),
                                 verdict=verdict)
        tenants: Dict[str, dict] = {}
        for name in self._series:
            if name.startswith("tenant.") and name.endswith(".charge"):
                tid = name[len("tenant."):-len(".charge")]
                tenants.setdefault(tid, {})["charge"] = \
                    self._series[name].last()
        slo_status = self.slo.status() if self.slo is not None else {}
        for tid, metrics in slo_status.items():
            burns = [r["burn"] for r in metrics.values()
                     if r["window"] >= th["slo_min_samples"]]
            burn = max(burns) if burns else 0.0
            if burn >= th["slo_burn_high"]:
                v = "critical"
            elif burn > 1.0 or any(not r["ok"]
                                   for r in metrics.values()):
                v = "warn"
            else:
                v = "ok"
            rank = self._VERDICT_RANK[v]
            worst = max(worst, rank)
            n_warn += rank == 1
            n_crit += rank == 2
            tenants.setdefault(tid, {})["slo"] = \
                dict(metrics, verdict=v)
        score = max(0.0, round(1.0 - 0.25 * n_crit - 0.1 * n_warn, 4))
        verdict = ("ok", "warn", "critical")[worst]
        active = sorted(f"{k}:{t}" if t else k
                        for k, t in self._active)
        return HealthReport(
            step=self._last_step if self._last_step >= 0 else None,
            samples=self.samples, score=score, verdict=verdict,
            signals=signals, tenants=tenants,
            alerts={"counts": dict(sorted(self.alert_counts.items())),
                    "active": active,
                    "pending": len(self.alerts),
                    "dropped": self.alerts_dropped})

    # -- export ---------------------------------------------------------
    def as_dict(self) -> dict:
        """Machine-readable dump: the report plus the raw alert stream
        and SLO detail — what ``tools/health_report.py`` renders."""
        return {"kind": "health_monitor",
                "sample_every": self.sample_every,
                "window": self.window,
                "thresholds": dict(self.thresholds),
                "report": self.report().as_dict(),
                "alerts": [a.as_dict() for a in self.alerts],
                "alert_counts": dict(sorted(
                    self.alert_counts.items())),
                "alerts_dropped": self.alerts_dropped,
                "slo": (self.slo.status()
                        if self.slo is not None else {}),
                "slo_policies": ({t: p.as_dict() for t, p in
                                  self.slo.policies.items()}
                                 if self.slo is not None else {})}

    def save(self, path: str) -> int:
        """Write ``as_dict()`` as JSON; returns bytes written."""
        import json
        blob = json.dumps(self.as_dict(), indent=1)
        with open(path, "w") as f:
            f.write(blob)
        return len(blob)
