"""Resilience layer for the paged serving stack (counterpart of
paddle_tpu/inference/resilience.py): request-level failure isolation,
deterministic fault injection and terminal outcomes.

* ``RequestOutcome``: the terminal record of one request, FINISHED or a
  failure status (FAILED_OOM, FAILED_NUMERIC, FAILED_DEADLINE,
  REJECTED_ADMISSION, CANCELLED). Engines append these to an
  ``outcomes`` list the caller drains, next to ``admitted`` /
  ``finished`` / ``preempted``.
* ``FaultInjector``: schedule-driven faults keyed by the engine's step
  counter, wired into ``BlockAllocator.alloc`` (forced ``BlockOOM``),
  the fused model call (NaN planted in chosen slots' output rows, on the
  device) and the speculative engine's draft roll (a draft-pool OOM
  mid-roll, corrupted draft logits). The hooks run only when an injector
  was passed to the engine.
* ``CrashInjector``: on top of the fault schedules it raises
  ``EngineCrash`` out of the engine at scheduled (live round, phase)
  points, simulating process death; recovery rebuilds from a snapshot.

* ``RouterFaultInjector``: worker kills and hangs keyed by the router's
  tick clock (``kill_storm`` seeds a random one), consulted before every
  op the router issues to a worker.
* ``NetworkFaultInjector``: wire faults for the session transport
  (dropped connections before and after delivery, torn, corrupt and
  duplicated reply frames, a black-holed reply) keyed by (worker, op
  seq); ``storm`` seeds a random one.

The two fleet injectors are host-only copies of the reference's, held
AST-equal to it.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

import numpy as np
import torch

from .paged_cache import BlockOOM

__all__ = ["RequestOutcome", "FaultInjector", "CrashInjector",
           "EngineCrash", "RouterFaultInjector",
           "NetworkFaultInjector"]


class EngineCrash(RuntimeError):
    """Injected process death: the engine that raised it is to be
    abandoned and rebuilt from a snapshot. Deliberately not a BlockOOM
    subclass, so no engine-internal handler can swallow it."""


class RequestOutcome:
    """Terminal record of one serving request. Anything but FINISHED
    means the engine shed the request (its pages are freed, its slot
    reusable) while every other request kept stepping."""

    FINISHED = "finished"
    FAILED_OOM = "failed_oom"            # pool dry / retry budget blown
    FAILED_NUMERIC = "failed_numeric"    # non-finite hidden in the slot
    FAILED_DEADLINE = "failed_deadline"  # step / wall-clock budget blown
    REJECTED_ADMISSION = "rejected_admission"  # provably unservable
    FAILED_UNROUTABLE = "failed_unroutable"    # router: no live worker
    CANCELLED = "cancelled"              # deliberate early stop

    STATUSES = (FINISHED, FAILED_OOM, FAILED_NUMERIC, FAILED_DEADLINE,
                REJECTED_ADMISSION, FAILED_UNROUTABLE, CANCELLED)

    __slots__ = ("rid", "status", "reason", "tokens", "preemptions",
                 "step")

    def __init__(self, rid: int, status: str, reason: str = "",
                 tokens: int = 0, preemptions: int = 0, step: int = 0):
        if status not in self.STATUSES:
            raise ValueError(f"unknown outcome status {status!r}")
        self.rid = int(rid)
        self.status = status
        self.reason = reason
        self.tokens = int(tokens)        # consumed rows at termination
        self.preemptions = int(preemptions)
        self.step = int(step)            # engine step of the verdict

    @property
    def failed(self) -> bool:
        return self.status != self.FINISHED

    def as_dict(self) -> dict:
        return {"rid": self.rid, "status": self.status,
                "reason": self.reason, "tokens": self.tokens,
                "preemptions": self.preemptions, "step": self.step}

    def __repr__(self):
        tail = f", reason={self.reason!r}" if self.reason else ""
        return (f"RequestOutcome(rid={self.rid}, status={self.status}, "
                f"tokens={self.tokens}, step={self.step}{tail})")


def _norm_oom(sched) -> Dict[int, int]:
    """{step: count} with count < 0 meaning every alloc that step; a
    bare iterable of steps means every alloc at each."""
    if sched is None:
        return {}
    if isinstance(sched, dict):
        return {int(s): int(n) for s, n in sched.items()}
    return {int(s): FaultInjector.ALL for s in sched}


def _norm_nan(sched) -> Dict[int, tuple]:
    if sched is None:
        return {}
    return {int(s): tuple(int(x) for x in np.atleast_1d(slots))
            for s, slots in sched.items()}


class FaultInjector:
    """Deterministic fault schedules keyed by the serving engine's step
    counter (1-indexed; the engine calls ``begin_step`` at the top of
    every ``step``/``step_multi``, and the speculative engine at the top
    of every round with the coming verify step's index, so draft-phase
    faults share the clock).

      oom_at        {step: n}: the first n ``BlockAllocator.alloc``
                    calls of the TARGET pool at that step raise
                    BlockOOM; n < 0 (``ALL``, also what a bare list of
                    steps means) fails every alloc that step, which
                    forces a shed.
      nan_at        {step: [slots]}: after the fused model call at that
                    step those slots' output rows become NaN (the
                    numeric guard then fails the request). Other rows
                    stay bitwise unchanged.
      draft_oom_at  as oom_at, on the DRAFT pool's allocator.
      draft_nan_at  {step: [slots]}: those slots' draft logits become
                    NaN during the roll (the verify rejects the noise).

    ``seed`` drives ``storm``; the injector itself plays schedules back.
    The counters record what fired."""

    ALL = -1

    def __init__(self, seed: int = 0,
                 oom_at: Union[Dict[int, int], Iterable[int], None] = None,
                 nan_at: Optional[Dict[int, Iterable[int]]] = None,
                 draft_oom_at: Union[Dict[int, int], Iterable[int],
                                     None] = None,
                 draft_nan_at: Optional[Dict[int, Iterable[int]]] = None):
        self.seed = int(seed)
        self._oom = {"target": _norm_oom(oom_at),
                     "draft": _norm_oom(draft_oom_at)}
        self.nan_at = _norm_nan(nan_at)
        self.draft_nan_at = _norm_nan(draft_nan_at)
        self.step = 0
        self.injected_oom = 0
        self.injected_draft_oom = 0
        self.injected_nan = 0
        self.injected_draft_nan = 0

    @classmethod
    def storm(cls, seed: int, steps: int, *, oom_sheds: int = 3,
              nan_events: int = 2, max_batch: int = 4,
              first_step: int = 2) -> "FaultInjector":
        """A seeded random storm: ``oom_sheds`` whole-step forced OOMs
        and ``nan_events`` single-slot NaN plantings at distinct steps in
        [first_step, steps). The same seed gives the same schedule (and
        the reference's, for both draw from ``np.random.RandomState``)."""
        rng = np.random.RandomState(seed)
        n = oom_sheds + nan_events
        if steps - first_step < n:
            raise ValueError("not enough steps for the requested storm")
        picks = rng.choice(np.arange(first_step, steps), size=n,
                           replace=False)
        oom_at = {int(s): cls.ALL for s in picks[:oom_sheds]}
        nan_at = {int(s): [int(rng.randint(max_batch))]
                  for s in picks[oom_sheds:]}
        return cls(seed=seed, oom_at=oom_at, nan_at=nan_at)

    # -- engine-facing hooks ------------------------------------------
    def begin_step(self, step: int) -> None:
        self.step = int(step)

    def begin_round(self) -> None:
        """Live-round clock tick of the crash schedules: a no-op here,
        ``CrashInjector`` overrides it."""

    def crash_point(self, phase: str) -> None:
        """Crash-schedule consultation: a no-op here, ``CrashInjector``
        overrides it and may raise EngineCrash."""

    def on_alloc(self, pool: str, n: int = 1) -> None:
        """BlockAllocator.alloc hook: raise BlockOOM when the schedule
        says so (consuming one scheduled failure unless unbounded)."""
        sched = self._oom[pool]
        rem = sched.get(self.step)
        if rem is None or rem == 0:
            return
        if rem > 0:
            sched[self.step] = rem - 1
        if pool == "draft":
            self.injected_draft_oom += 1
        else:
            self.injected_oom += 1
        raise BlockOOM(f"injected fault: forced {pool}-pool OOM at "
                       f"step {self.step}",
                       details={"injected": True, "pool": pool,
                                "step": self.step})

    @staticmethod
    def _corrupt(out: torch.Tensor, slots):
        """A copy of ``out`` [B, ...] with ``slots``' rows set to NaN, on
        ``out``'s device; the other rows are copied bitwise."""
        rows = [int(s) for s in slots if 0 <= int(s) < out.shape[0]]
        res = out.clone()
        if rows:
            res[torch.tensor(rows, device=out.device)] = float("nan")
        return res, len(rows)

    def corrupt_hidden(self, out):
        """Plant the scheduled NaNs into the fused step's output rows.
        Returns ``out`` itself on steps with nothing scheduled."""
        slots = self.nan_at.get(self.step)
        if not slots:
            return out
        out, hit = self._corrupt(out, slots)
        self.injected_nan += hit
        return out

    def corrupt_draft_logits(self, logits):
        """Plant the scheduled NaNs into draft sampling logits."""
        slots = self.draft_nan_at.get(self.step)
        if not slots:
            return logits
        logits, hit = self._corrupt(logits, slots)
        self.injected_draft_nan += hit
        return logits

    def as_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step,
                "injected_oom": self.injected_oom,
                "injected_draft_oom": self.injected_draft_oom,
                "injected_nan": self.injected_nan,
                "injected_draft_nan": self.injected_draft_nan}

    def __repr__(self):
        return (f"FaultInjector(seed={self.seed}, "
                f"oom={self.injected_oom}, nan={self.injected_nan}, "
                f"draft_oom={self.injected_draft_oom}, "
                f"draft_nan={self.injected_draft_nan})")


class CrashInjector(FaultInjector):
    """A FaultInjector that also kills the engine: at scheduled (live
    round, phase) points it raises ``EngineCrash`` out of the running
    call, leaving the engine mid-mutation as a process death would.

    ``crash_at``: {round: phase or iterable of phases}. Rounds are the
    live-round clock: ``begin_round()`` is called by the serving host at
    the top of every live round and not during replay. Each scheduled
    (round, phase) fires at most once. Phases:

      begin           step top, right after the fault clock ticks
      post_admission  an admission pass completed
      post_prefill    a prefill completed and its admitted event fired
      mid_spec_round  between the speculative draft roll and the verify
      pre_journal     after the engine round, before RecoverableServer
                      journals its emissions (the round replays)
      post_journal    after the journal append, before the caller sees
                      the emissions (replay must not re-emit)

    ``arm(False)`` disarms the crash points; the inherited fault
    schedules stay live, keyed by the engine step clock a snapshot
    restores, so a replayed step re-injects the same faults."""

    PHASES = ("begin", "post_admission", "post_prefill",
              "mid_spec_round", "pre_journal", "post_journal")

    def __init__(self, crash_at=None, seed: int = 0, **fault_kw):
        super().__init__(seed=seed, **fault_kw)
        sched: Dict[int, set] = {}
        for r, p in (crash_at or {}).items():
            phases = (p,) if isinstance(p, str) else tuple(p)
            for ph in phases:
                if ph not in self.PHASES:
                    raise ValueError(f"unknown crash phase {ph!r} "
                                     f"(one of {self.PHASES})")
            sched[int(r)] = set(phases)
        self.crash_at = sched
        self.round = 0
        self.crashes = 0
        self._armed = True

    @classmethod
    def storm(cls, seed: int, rounds: int, *, crashes: int = 4,
              phases=None, first_round: int = 2,
              **fault_kw) -> "CrashInjector":
        """Seeded random crash storm: ``crashes`` kills at distinct live
        rounds in [first_round, rounds), each at a random phase of
        ``phases`` (default: the ones that fire every round)."""
        rng = np.random.RandomState(seed)
        phases = tuple(phases) if phases is not None else \
            ("begin", "post_admission", "pre_journal", "post_journal")
        if rounds - first_round < crashes:
            raise ValueError("not enough rounds for the crash storm")
        picks = rng.choice(np.arange(first_round, rounds),
                           size=crashes, replace=False)
        return cls(crash_at={int(r): phases[rng.randint(len(phases))]
                             for r in picks},
                   seed=seed, **fault_kw)

    def begin_round(self) -> None:
        self.round += 1

    def arm(self, on: bool) -> None:
        self._armed = bool(on)

    def crash_point(self, phase: str) -> None:
        if not self._armed:
            return
        sched = self.crash_at.get(self.round)
        if sched and phase in sched:
            sched.discard(phase)
            self.crashes += 1
            raise EngineCrash(f"injected crash at live round "
                              f"{self.round}, phase {phase!r} "
                              f"(engine step {self.step})")

    def as_dict(self) -> dict:
        d = super().as_dict()
        d.update({"round": self.round, "crashes": self.crashes})
        return d

    def __repr__(self):
        return (f"CrashInjector(seed={self.seed}, round={self.round}, "
                f"crashes={self.crashes}, oom={self.injected_oom}, "
                f"nan={self.injected_nan})")


class RouterFaultInjector(CrashInjector):
    """CrashInjector extended one fault domain up: deterministic
    WORKER kills and hangs, keyed by the router's TICK clock (one
    tick per ``Router.step``; ``begin_tick`` is called at the top of
    every tick, the router-level mirror of ``begin_round``). The
    router consults ``on_worker_op(worker, point)`` immediately
    before each operation it is about to issue to a worker:

      "kill"  the worker dies AT that point — the handle is killed
              (a pipes worker takes a real SIGKILL; an in-process
              worker is abandoned) and the op fails with WorkerDied.
              Each scheduled (tick, worker) kill fires at most once.
      "hang"  the worker goes silent: this op (and every op until the
              scheduled hang expires) fails with WorkerTimeout while
              the worker itself stays alive and UNAWARE — exactly a
              hung/partitioned process. The router's circuit breaker
              owns the consequence.

      kill_at   {tick: {worker_name: point}} — point is one of
                ``ROUTER_POINTS`` ("submit", "before_round",
                "after_round", "export", "import", "scrape", "ping"),
                matched against the op the router is about to issue;
                "before_round"/"after_round" bracket the worker's
                serving round ("after_round" kills AFTER the round
                call returned, so the round's emissions were seen —
                the death is detected at the next tick's op).
      hang_at   {tick: {worker_name: n_ticks}} — from that tick the
                worker times out for n_ticks ticks, then answers
                again (the stale-copy release path).

    The engine-level schedules (``oom_at``/``nan_at``/``crash_at``)
    are inherited but belong to PER-WORKER injectors — this object
    rides the router, which never owns an engine step clock. Pure
    schedule playback like every injector: zero overhead when absent,
    identical storms run after run."""

    ROUTER_POINTS = ("submit", "before_round", "after_round",
                     "export", "import", "scrape", "ping")

    def __init__(self, kill_at=None, hang_at=None, seed: int = 0,
                 **fault_kw):
        super().__init__(seed=seed, **fault_kw)
        self.kill_at: Dict[int, dict] = {}
        for t, m in (kill_at or {}).items():
            for w, point in m.items():
                if point not in self.ROUTER_POINTS:
                    raise ValueError(
                        f"unknown router kill point {point!r} (one "
                        f"of {self.ROUTER_POINTS})")
            self.kill_at[int(t)] = dict(m)
        self.hang_at: Dict[int, dict] = {
            int(t): {str(w): int(n) for w, n in m.items()}
            for t, m in (hang_at or {}).items()}
        self.tick = 0
        self.killed = 0
        self.hung_ops = 0
        self._hang_until: Dict[str, int] = {}

    @classmethod
    def kill_storm(cls, seed: int, ticks: int, workers, *,
                   kills: int = 2, hangs: int = 0,
                   first_tick: int = 2,
                   points=("before_round",)) -> "RouterFaultInjector":
        """Seeded random router storm: ``kills`` worker deaths and
        ``hangs`` transient silences at distinct ticks in
        [first_tick, ticks), each aimed at a random worker. Same seed
        -> same storm."""
        rng = np.random.RandomState(seed)
        workers = list(workers)
        n = kills + hangs
        if ticks - first_tick < n:
            raise ValueError("not enough ticks for the router storm")
        picks = rng.choice(np.arange(first_tick, ticks), size=n,
                           replace=False)
        kill_at = {int(t): {workers[rng.randint(len(workers))]:
                            points[rng.randint(len(points))]}
                   for t in picks[:kills]}
        hang_at = {int(t): {workers[rng.randint(len(workers))]:
                            int(rng.randint(1, 3))}
                   for t in picks[kills:]}
        return cls(kill_at=kill_at, hang_at=hang_at, seed=seed)

    def begin_tick(self) -> None:
        self.tick += 1

    def on_worker_op(self, worker: str, point: str) -> Optional[str]:
        """Verdict for the op the router is about to issue: None
        (proceed), "kill" (kill the worker first), or "hang" (the op
        times out; the worker never sees it)."""
        if not self._armed:
            return None
        sched = self.hang_at.get(self.tick)
        if sched and worker in sched:
            self._hang_until[worker] = self.tick + sched.pop(worker)
        until = self._hang_until.get(worker)
        if until is not None:
            if self.tick < until:
                self.hung_ops += 1
                return "hang"
            del self._hang_until[worker]
        sched = self.kill_at.get(self.tick)
        if sched and sched.get(worker) == point:
            del sched[worker]
            self.killed += 1
            return "kill"
        return None

    def as_dict(self) -> dict:
        d = super().as_dict()
        d.update({"tick": self.tick, "killed": self.killed,
                  "hung_ops": self.hung_ops})
        return d

    def __repr__(self):
        return (f"RouterFaultInjector(seed={self.seed}, "
                f"tick={self.tick}, killed={self.killed}, "
                f"hung_ops={self.hung_ops})")


class NetworkFaultInjector:
    """Deterministic NETWORK faults for the session transport
    (inference/net.py) — the fault domain below RouterFaultInjector's
    kills and hangs: the worker process stays healthy, only the wire
    lies. Schedules are keyed by (worker name, op seq) — the
    transport's per-op sequence number is its deterministic clock, so
    two identical runs take identical faults, recover through
    identical reconnect sequences, and report identical ``net.*``
    counters. Each scheduled fault fires at most once (the verdict is
    consumed on first consult), so the retry that follows runs clean.

    Fault kinds (``plan = {worker: {seq: kind}}``):

      drop_before       the connection drops before the op frame is
                        delivered — the worker never saw it; the
                        resend after reconnect executes it (once).
      drop_after        the connection drops after delivery — the
                        worker executed and cached the reply; the
                        resend is answered from the reply cache, NOT
                        re-executed (the idempotency contract).
      truncate_header   the reply frame is torn mid-header (EOF after
                        4 of the 8 header bytes).
      truncate_payload  the reply frame is torn mid-payload.
      corrupt           one payload byte is flipped — the CRC check
                        rejects the frame.
      duplicate         the reply frame arrives twice; the second
                        copy must be discarded by the want-seq check.
      blackhole         every byte of the reply is swallowed until
                        the op deadline expires — a silent peer; the
                        liveness probe then proves the worker alive
                        and the resend resolves the op.

    Like every injector here: pure schedule playback, zero overhead
    when absent (the transport consults it only when one was passed),
    ``arm(False)`` disarms during replay."""

    FAULTS = ("drop_before", "drop_after", "truncate_header",
              "truncate_payload", "corrupt", "duplicate", "blackhole")
    SEND_FAULTS = ("drop_before", "drop_after", "blackhole")
    FRAME_FAULTS = ("truncate_header", "truncate_payload", "corrupt",
                    "duplicate")

    def __init__(self, plan: Optional[Dict[str, dict]] = None,
                 seed: int = 0):
        self.seed = int(seed)
        self.plan: Dict[str, Dict[int, str]] = {}
        for worker, sched in (plan or {}).items():
            for s, kind in sched.items():
                if kind not in self.FAULTS:
                    raise ValueError(f"unknown network fault {kind!r} "
                                     f"(one of {self.FAULTS})")
            self.plan[str(worker)] = {int(s): str(k)
                                      for s, k in sched.items()}
        self._armed = True
        self.fired: Dict[str, int] = {k: 0 for k in self.FAULTS}

    @classmethod
    def storm(cls, seed: int, workers, *, span=(2, 30), drops: int = 3,
              frames: int = 2, blackholes: int = 1
              ) -> "NetworkFaultInjector":
        """Seeded random network storm: ``drops`` connection drops
        (before/after delivery), ``frames`` torn/corrupt/duplicate
        reply frames and ``blackholes`` silent-peer timeouts, each
        aimed at a random (worker, op seq) in ``span``. Same seed ->
        same storm — the acceptance-criteria generator."""
        rng = np.random.RandomState(seed)
        workers = list(workers)
        n = drops + frames + blackholes
        lo, hi = int(span[0]), int(span[1])
        if hi - lo < n:
            raise ValueError("not enough op seqs for the net storm")
        kinds = (list(rng.choice(["drop_before", "drop_after"],
                                 size=drops))
                 + list(rng.choice(["truncate_header",
                                    "truncate_payload", "corrupt",
                                    "duplicate"], size=frames))
                 + ["blackhole"] * blackholes)
        plan: Dict[str, Dict[int, str]] = {}
        # distinct seqs per worker so two faults never collide on one op
        seqs = {w: list(rng.choice(np.arange(lo, hi), size=n,
                                   replace=False)) for w in workers}
        for kind in kinds:
            w = workers[rng.randint(len(workers))]
            plan.setdefault(w, {})[int(seqs[w].pop())] = str(kind)
        return cls(plan=plan, seed=seed)

    def arm(self, on: bool) -> None:
        self._armed = bool(on)

    def _take(self, worker: str, seq: int, kinds) -> Optional[str]:
        if not self._armed:
            return None
        sched = self.plan.get(worker)
        if not sched:
            return None
        kind = sched.get(int(seq))
        if kind is None or kind not in kinds:
            return None
        del sched[int(seq)]           # fires at most once
        self.fired[kind] += 1
        return kind

    def on_send(self, worker: str, seq: int) -> Optional[str]:
        """Verdict consulted by the transport as it is about to send
        op ``seq``: None (clean), "drop_before", "drop_after" or
        "blackhole"."""
        return self._take(worker, seq, self.SEND_FAULTS)

    def on_reply(self, worker: str, seq: int) -> Optional[str]:
        """Verdict consulted when a complete reply frame for op
        ``seq`` is buffered: None, "truncate_header",
        "truncate_payload", "corrupt" or "duplicate"."""
        return self._take(worker, seq, self.FRAME_FAULTS)

    @property
    def pending(self) -> int:
        return sum(len(s) for s in self.plan.values())

    def as_dict(self) -> dict:
        return {"seed": self.seed, "pending": self.pending,
                "fired": dict(self.fired)}

    def __repr__(self):
        shot = {k: v for k, v in self.fired.items() if v}
        return (f"NetworkFaultInjector(seed={self.seed}, "
                f"pending={self.pending}, fired={shot})")
