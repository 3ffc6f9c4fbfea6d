"""Disaggregated prefill/decode serving behind a fault-tolerant,
prefix-aware router (counterpart of paddle_tpu/inference/router.py,
host-only numpy and stdlib; held AST-equal to the reference apart from
imports, docstrings and ``build_model_from_spec``, which seeds the
port's model with a CPU ``torch.Generator`` and places it on the spec's
``device``, ``cuda`` unless the spec names another).

* **Placement**: every worker advertises its chain-hash prefix index
  (``h_i = H(h_{i-1}, block_tokens)`` over embedding rows) plus a
  health/pressure scrape. A new request lands on the worker holding its
  longest indexed prefix; with no match anywhere it lands on a
  prefill-role worker by load, and a pressured best-match worker spills
  to a cooler one.
* **Page migration**: a finished prefill moves as a per-slot slice of
  the pool snapshot (``PagedKVCache.export_slice``: content-addressed
  (hash, page) pairs, numpy on the wire), is adopted into the target
  pool's cached-free tier (``import_slice``) and the stream is
  resubmitted there with ``resume=True``; admission's prefix matching
  adopts the migrated pages and prefills only the suffix. The importing
  worker journals the slice, so the pages survive its own crashes.
* **The fault domain boundary**: workers die (process kill, dead pipe,
  failed call) and hang (no answer inside the timeout). A dead worker's
  streams are resubmitted to survivors from the router's own record
  (prompt + every delivered token + the remaining deadline budget); a
  hung worker trips a circuit breaker. ``FAILED_OOM`` retries with a
  bounded budget, ``REJECTED_ADMISSION`` is delivered only when every
  live worker refused, and with no worker left the verdict is a
  deterministic ``FAILED_UNROUTABLE``. Outcomes are delivered exactly
  once at the router.

The worker side is ``EngineWorker``, an op dispatcher over a
``RecoverableServer``, behind ``InProcWorker`` (this process; a kill
abandons the object) or ``PipeWorker`` (a spawned child process; a kill
is a real SIGKILL). Replies are builtins and numpy only, so the socket
transport's restricted unpickler (``recovery.unframe_message``) accepts
every one of them. On the card each child opens its own CUDA context
and loads the kernels the parent built (``ops/hopper/_build.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

import numpy as np
import torch

from ..device import resolve_device
from .paged_cache import chain_block_hashes
from .recovery import RecoverableServer, RequestJournal, read_journal
from .resilience import EngineCrash, RequestOutcome
from .telemetry import StatsBase

__all__ = ["Router", "RouterStats", "EngineWorker", "InProcWorker",
           "PipeWorker", "WorkerDied", "WorkerTimeout", "WorkerError",
           "build_model_from_spec", "build_server_from_spec",
           "token_chain_hashes"]


class WorkerDied(RuntimeError):
    """The worker process is gone (dead pipe, EngineCrash, injected
    kill): its engine object is unrecoverable from here — the router
    resubmits its in-flight streams to survivors."""


class WorkerTimeout(RuntimeError):
    """The worker did not answer inside the timeout. It MAY still be
    alive (hung, paused, partitioned) and MAY have processed the op —
    the router opens its circuit breaker and treats every copy it
    held as stale until it answers a ping again."""


class WorkerError(RuntimeError):
    """The worker answered with an application error (bad rid, slice
    geometry mismatch, ...). The worker itself is healthy."""


# ---------------------------------------------------------------------
# worker-side harness
# ---------------------------------------------------------------------

def token_chain_hashes(model, token_ids, block_size: int):
    """The chain-hash identity of a token stream as the POOLS compute
    it (hashes are over embedding rows, the serving engines' history
    unit): what a router's ``hash_fn`` should be, built from the same
    ``TokenServingModel`` the workers serve (identical weights =>
    identical hashes — the content address IS the embedded content).
    Returns one hash per FULL block."""
    toks = [int(t) for t in np.asarray(token_ids).reshape(-1)]
    if not toks:
        return []
    return chain_block_hashes(model.embed(toks), block_size)


def build_model_from_spec(spec: dict):
    """The MODEL half of ``build_server_from_spec``: the same weights
    from the spec's seeds alone, on the spec's ``device`` (``cuda``
    unless it names another; without a card ``cuda`` raises). The core
    draws its weights from a CPU ``torch.Generator`` seeded with
    ``model_seed``, so a child on the card and a parent on the CPU hold
    the same bits; the embedding is ``np.random.RandomState(embed_seed)``
    exactly as in the JAX package, so the embedding, every
    ``token_chain_hashes`` value and every placement decision that reads
    them are equal across the packages for one spec. Factored out so a
    fleet supervisor can rebuild a dead worker's model for
    ``RecoverableServer.recover``."""
    from ..incubate.nn import FusedMultiTransformer
    from .speculative import TokenServingModel

    gen = torch.Generator("cpu").manual_seed(
        int(spec.get("model_seed", 0)))
    core = FusedMultiTransformer(
        int(spec.get("d_model", 32)), int(spec.get("heads", 4)),
        int(spec.get("ffn", 64)),
        num_layers=int(spec.get("layers", 2)),
        device=resolve_device(spec.get("device")), generator=gen)
    embed = np.random.RandomState(
        int(spec.get("embed_seed", 1234))).randn(
            int(spec.get("vocab", 50)),
            int(spec.get("d_model", 32))).astype(np.float32)
    # head_roll=N reads out against the embedding rolled N rows: the
    # greedy stream then WALKS the vocab instead of collapsing to the
    # tied readout's fixed point (argmax(h E^T) is stationary for a
    # random core) — a constant stream would let a wrong-handoff bug
    # hide inside a bit-identity assertion, a walking one cannot.
    roll = int(spec.get("head_roll", 0))
    head = (np.roll(embed, -roll, axis=0).T.copy() if roll else None)
    return TokenServingModel(core, embed, lm_head=head)


def build_server_from_spec(spec: dict) -> RecoverableServer:
    """Construct a worker's ``RecoverableServer`` from a PICKLABLE,
    data-only spec — the one constructor both transports share, so a
    spawned child process builds bit-identical weights from the same
    seeds the parent (or a single-engine baseline) uses.

    Keys (defaults in parens): model dims ``d_model`` (32), ``heads``
    (4), ``ffn`` (64), ``layers`` (2), ``vocab`` (50), seeds
    ``model_seed`` (0) / ``embed_seed`` (1234), ``head_roll`` (0 —
    see the note at the readout below), ``device`` ("cuda"; a child
    without a card raises rather than run on the CPU); engine knobs ``k``
    (0), ``max_batch`` (2), ``block_size`` (4), ``num_blocks`` (60),
    ``max_blocks_per_seq`` (10), ``prefix_cache`` (True),
    ``chunk_tokens``, ``prefill_token_budget``, ``kv_dtype``,
    ``tenants``, ``max_preemptions``; ``monitor`` (False) wires a
    ``HealthMonitor`` (the scrape's health verdict source); host
    knobs ``journal_path`` / ``snapshot_path`` (required) and
    ``snapshot_every`` (0).

    ``recover=True`` (the fleet supervisor's respawn path) rebuilds
    the server FROM ITS FILES instead of fresh: same seeds, then
    ``RecoverableServer.recover`` restores the last snapshot and
    replays the journal suffix — the respawned incarnation holds
    bit-identical state to the dead one at its last journaled round."""
    from .monitor import HealthMonitor
    from .speculative import SpeculativeEngine

    tsm = build_model_from_spec(spec)
    if spec.get("recover"):
        return RecoverableServer.recover(
            tsm, None, journal_path=spec["journal_path"],
            snapshot_path=spec["snapshot_path"],
            monitor=HealthMonitor() if spec.get("monitor") else None)
    eng = SpeculativeEngine(
        tsm, None, k=int(spec.get("k", 0)),
        max_batch=int(spec.get("max_batch", 2)),
        block_size=int(spec.get("block_size", 4)),
        num_blocks=int(spec.get("num_blocks", 60)),
        max_blocks_per_seq=int(spec.get("max_blocks_per_seq", 10)),
        prefix_cache=bool(spec.get("prefix_cache", True)),
        chunk_tokens=spec.get("chunk_tokens"),
        prefill_token_budget=spec.get("prefill_token_budget"),
        kv_dtype=spec.get("kv_dtype", "float32"),
        max_preemptions=spec.get("max_preemptions"),
        tenants=spec.get("tenants"),
        monitor=HealthMonitor() if spec.get("monitor") else None)
    return RecoverableServer(
        eng, journal_path=spec["journal_path"],
        snapshot_path=spec["snapshot_path"],
        snapshot_every=int(spec.get("snapshot_every", 0)))


class EngineWorker:
    """Op dispatcher over one ``RecoverableServer`` — the entire
    worker-side protocol, shared verbatim by the in-process and
    child-process transports. Ops take/return plain picklable dicts:

      submit         {tokens, kw}        -> {rid, emitted, outcomes}
      round          {}                  -> {emitted, outcomes}
      release        {rid}               -> {emitted, outcomes}
      export_slice   {rid}               -> {slice | None}
      import_slice   {slice}             -> {imported}
      export_slices  {rids}              -> {slices: {rid: slice|None}}
      import_slices  {slices}            -> {imported}   (sum; each
                                            slice journals exactly as
                                            one import_slice)
      scrape         {}                  -> placement inputs (prefix
                                            index, pressure, queue,
                                            health report view)
      audit          {}                  -> {ok}   (deep invariants)
      ping           {}                  -> {}
      close          {}                  -> {}     (clean shutdown)

    ``emitted`` is ALWAYS the generated-stream DELTA since the last
    report, not ``step()``'s raw return: the admission-time first
    token never rides a round's return value, so a delta over
    ``generated(rid)`` is the only report that loses nothing."""

    def __init__(self, server: RecoverableServer, *,
                 name: str = "worker", role: str = "mixed"):
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"unknown worker role {role!r}")
        self.server = server
        self.name = str(name)
        self.role = role
        self._live: Set[int] = set()
        self._reported: Dict[int, int] = {}

    def _emissions(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for rid in sorted(self._live):
            gen = self.server.generated(rid)
            n = self._reported.get(rid, 0)
            if len(gen) > n:
                out[rid] = [int(t) for t in gen[n:]]
                self._reported[rid] = len(gen)
        return out

    def _drain(self) -> List[dict]:
        out = [oc.as_dict() for oc in self.server.drain_outcomes()]
        for oc in out:
            if oc["status"] != RequestOutcome.FINISHED:
                # failed streams stay host-readable until release,
                # but they will never grow: stop polling them
                self._live.discard(oc["rid"])
                self._reported.pop(oc["rid"], None)
        return out

    def _scrape(self) -> dict:
        eng = self.server.engine          # SpeculativeEngine
        core = eng.engine                 # PagedServingEngine
        cache = core.cache
        occ = cache.pool_occupancy(tiers_only=True)
        health = None
        if core.monitor is not None:
            health = core.monitor.report().placement()
        return {
            "name": self.name, "role": self.role,
            "block_size": cache.block_size,
            # the advertised prefix index: every chain hash this pool
            # can adopt (live + cached-free pages). bytes16 per block
            # — a few KB even at production pool sizes.
            "index": list(cache._hash_to_block.keys()),
            "pressure": round(occ["active"] / max(1, occ["usable"]),
                              6),
            "free": occ["free"] + occ["cached_free"],
            "queued": int(core._queue_len),
            "active": int(core.active.sum() + core.prefilling.sum()),
            "health": health,
            "registry": core.registry.scrape(
                ("pool.", "queue.", "spec.acceptance", "journal.")),
        }

    def handle(self, op: str, payload: dict) -> dict:
        srv = self.server
        if op == "submit":
            rid = srv.submit(payload["tokens"],
                             **payload.get("kw", {}))
            self._live.add(rid)
            return {"rid": rid, "emitted": self._emissions(),
                    "outcomes": self._drain()}
        if op == "round":
            srv.step()
            return {"emitted": self._emissions(),
                    "outcomes": self._drain()}
        if op == "release":
            rid = int(payload["rid"])
            self._live.discard(rid)
            self._reported.pop(rid, None)
            srv.release(rid)
            return {"emitted": self._emissions(),
                    "outcomes": self._drain()}
        if op == "export_slice":
            return {"slice": srv.export_slice(int(payload["rid"]))}
        if op == "import_slice":
            return {"imported": srv.import_slice(payload["slice"])}
        if op == "export_slices":
            return {"slices": srv.export_slices(payload["rids"])}
        if op == "import_slices":
            return {"imported": srv.import_slices(payload["slices"])}
        if op == "scrape":
            return self._scrape()
        if op == "audit":
            return {"ok": bool(srv.check_invariants())}
        if op == "ping":
            return {}
        if op == "close":
            srv.close()
            return {}
        raise ValueError(f"unknown worker op {op!r}")


# ---------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------

class WorkerHandle:
    """Transport-neutral face of one worker: ``request`` raises
    ``WorkerDied`` / ``WorkerTimeout`` / ``WorkerError``; ``kill``
    makes death REAL (SIGKILL / abandonment) — it is what the
    injector's scheduled kills call."""

    name: str
    role: str

    def request(self, op: str, payload: Optional[dict] = None,
                timeout: Optional[float] = None) -> dict:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def alive(self) -> bool:
        raise NotImplementedError


class InProcWorker(WorkerHandle):
    """The worker harness in THIS process. Deterministic and cheap —
    the transport the seeded kill storms run on. ``kill()`` abandons
    the harness exactly like a process death abandons its heap: the
    object becomes unreachable through this handle, its journal /
    snapshot files stay on disk (forensics, or another incarnation's
    recovery), and every later request raises ``WorkerDied``."""

    def __init__(self, server_or_spec, *, name: str,
                 role: str = "mixed"):
        server = (build_server_from_spec(server_or_spec)
                  if isinstance(server_or_spec, dict)
                  else server_or_spec)
        self.name = str(name)
        self.role = role
        self.worker: Optional[EngineWorker] = EngineWorker(
            server, name=name, role=role)
        self._dead = False

    def request(self, op, payload=None, timeout=None) -> dict:
        if self._dead:
            raise WorkerDied(f"worker {self.name!r} is dead")
        try:
            return self.worker.handle(op, payload or {})
        except EngineCrash as e:
            # an engine that raised EngineCrash is
            # abandoned, so the worker around it is dead
            self.kill()
            raise WorkerDied(
                f"worker {self.name!r} crashed: {e}") from e
        except (WorkerDied, WorkerTimeout):
            raise
        except Exception as e:
            raise WorkerError(f"{type(e).__name__}: {e}") from e

    def kill(self) -> None:
        self._dead = True
        self.worker = None          # abandoned, like a dead heap

    def close(self) -> None:
        if not self._dead:
            try:
                self.worker.handle("close", {})
            finally:
                self._dead = True
                self.worker = None

    @property
    def alive(self) -> bool:
        return not self._dead


def _pipe_worker_main(conn, spec: dict) -> None:
    """Child-process entry (multiprocessing spawn target): build the
    server from the data-only spec, answer framed ops until EOF /
    close / EngineCrash. Never raises out — every application error
    returns as ``{"_err": ...}`` so one bad op cannot kill a healthy
    worker; an ``EngineCrash`` reports ``{"_died": True}`` and exits
    (the engine must be abandoned — that IS a process death)."""
    try:
        worker = EngineWorker(build_server_from_spec(spec),
                              name=spec.get("name", "worker"),
                              role=spec.get("role", "mixed"))
        conn.send({"ready": True})
    except Exception as e:           # surface build failures loudly
        try:
            conn.send({"_err": f"{type(e).__name__}: {e}",
                       "_died": True})
        finally:
            return
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg is None:
            break
        seq, op, payload = msg
        try:
            out = worker.handle(op, payload or {})
        except EngineCrash as e:
            conn.send({"_err": f"EngineCrash: {e}", "_died": True,
                       "_seq": seq})
            break
        except Exception as e:
            out = {"_err": f"{type(e).__name__}: {e}"}
        conn.send(dict(out, _seq=seq))
        if op == "close":
            break


class PipeWorker(WorkerHandle):
    """A REAL worker process (multiprocessing ``spawn`` — a clean
    interpreter, nothing inherited but the spec) speaking the op
    protocol over a duplex pipe. ``kill()`` is a genuine SIGKILL.
    The honest multi-process acceptance rig: same router, same
    protocol, real process death."""

    def __init__(self, spec: dict, *, name: str, role: str = "mixed",
                 timeout: float = 120.0, start_method: str = "spawn",
                 wait_ready: bool = True):
        import multiprocessing as mp
        ctx = mp.get_context(start_method)
        self.name = str(name)
        self.role = role
        self.timeout = float(timeout)
        self._conn, child = ctx.Pipe()
        self.proc = ctx.Process(
            target=_pipe_worker_main,
            args=(child, dict(spec, name=name, role=role)),
            daemon=True)
        self.proc.start()
        child.close()
        self._killed = False
        self._seq = 0
        self._ready = False
        # wait_ready=False returns as soon as the process is spawned
        # (build failure then surfaces at the first request): an
        # N-worker fleet built in a loop overlaps the N model builds
        # instead of paying them sequentially
        if wait_ready:
            self._handshake()

    def _handshake(self) -> None:
        ready = self._recv(self.timeout, want_seq=None)
        if not ready.get("ready"):
            self._killed = True
            raise WorkerDied(f"worker {self.name!r} failed to "
                             f"build: {ready.get('_err')}")
        self._ready = True

    def _recv(self, timeout: float, want_seq) -> dict:
        """Receive the response to op ``want_seq``, DISCARDING stale
        answers: a real timeout abandons an op whose response may
        still arrive later — without the seq check that late answer
        would be read as the NEXT op's reply and every call after it
        would silently receive its predecessor's response (permanent
        protocol desync). ``want_seq=None`` accepts anything (the
        build handshake)."""
        import time as _time
        deadline = _time.monotonic() + timeout
        while True:
            # clamp the poll to the remaining budget: the final poll
            # must fire AT the deadline, not up to 50 ms past it
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise WorkerTimeout(
                    f"worker {self.name!r}: no answer in {timeout}s")
            try:
                if self._conn.poll(min(0.05, remaining)):
                    resp = self._conn.recv()
                    if want_seq is None or \
                            resp.get("_seq") == want_seq:
                        return resp
                    continue              # stale: a timed-out op's
                                          # answer arriving late
            except (EOFError, OSError) as e:
                raise WorkerDied(
                    f"worker {self.name!r} pipe closed: {e}") from e
            if not self.proc.is_alive():
                raise WorkerDied(f"worker {self.name!r} process died "
                                 f"(exitcode {self.proc.exitcode})")

    def request(self, op, payload=None, timeout=None) -> dict:
        if self._killed or not self.proc.is_alive():
            raise WorkerDied(f"worker {self.name!r} is dead")
        if not self._ready:
            self._handshake()       # deferred-build handshake
        self._seq += 1
        try:
            self._conn.send((self._seq, op, payload or {}))
        except (BrokenPipeError, OSError) as e:
            raise WorkerDied(
                f"worker {self.name!r} pipe broken: {e}") from e
        resp = self._recv(timeout if timeout is not None
                          else self.timeout, want_seq=self._seq)
        resp.pop("_seq", None)
        if resp.get("_died"):
            self._killed = True
            raise WorkerDied(f"worker {self.name!r}: {resp['_err']}")
        if "_err" in resp:
            raise WorkerError(resp["_err"])
        return resp

    def kill(self) -> None:
        self._killed = True
        if self.proc.is_alive():
            self.proc.kill()        # SIGKILL — a real process death
        self.proc.join(timeout=10)

    def close(self) -> None:
        if not self._killed and self.proc.is_alive():
            try:
                self.request("close", timeout=self.timeout)
            except (WorkerDied, WorkerTimeout, WorkerError):
                pass
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(timeout=10)
        self._killed = True

    @property
    def alive(self) -> bool:
        return not self._killed and self.proc.is_alive()


# ---------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------

class RouterStats(StatsBase):
    """Router-surface accounting, sibling of the engine stats.

      submitted          client submissions accepted (rid handed out)
      delivered          terminal outcomes delivered (exactly once)
      placed_prefix      placements won by a prefix-index match
      placed_fresh       placements by role/load (no match anywhere)
      spillovers         best-match worker over-pressure -> placed on
                         a cooler worker instead
      migrations         streams moved prefill -> decode worker
      migrated_blocks    pages imported by migration targets
      export_batches     batched export_slices ops issued (one per
                         donor per tick, N slots per slice — the
                         round-trip saving is migrations minus this)
      resubmissions      streams re-placed after a worker failure
      oom_resubmissions  FAILED_OOM outcomes retried elsewhere
      worker_deaths      workers detected dead
      worker_timeouts    calls that timed out (circuit-breaker opens)
      stale_released     stale copies released on a worker's rejoin
      unroutable         FAILED_UNROUTABLE verdicts delivered
      respawns           dead workers re-registered by a supervisor
                         (``register_respawn``)
      rebalances         policy-approved migrations, journaled as
                         "rebalance" records ``Router.recover``
                         replays (0 with no policy — pre-fleet
                         journals stay byte-identical)
      migrations_skipped streams a ``MigrationPolicy`` priced and
                         declined to move (zero slice bytes shipped)
      net_reconnects     session-transport reconnects the router has
                         OBSERVED via ``handle.net_stats()`` (the
                         degraded-state trigger; 0 on raw transports)
      degraded_transitions  up -> degraded transitions: a worker rode
                         out a network fault WITHOUT resubmission —
                         the cheap failure the session layer buys
    """

    __slots__ = FIELDS = (
        "submitted", "delivered", "placed_prefix", "placed_fresh",
        "spillovers", "migrations", "migrated_blocks",
        "export_batches",
        "resubmissions", "oom_resubmissions", "worker_deaths",
        "worker_timeouts", "stale_released", "unroutable",
        "respawns", "rebalances", "migrations_skipped",
        "net_reconnects", "degraded_transitions")
    REPR = ("submitted", "delivered", "migrations", "resubmissions",
            "worker_deaths", "unroutable")


class _RouterReq:
    """The router's own record of one client stream — the resubmission
    source of truth (prompt, every token delivered so far, remaining
    budgets). ``steps_used`` counts worker rounds the stream was
    assigned through: the deadline budget a resubmission carries is
    ``deadline_steps - steps_used``, REMAINING — a retry must never
    reset the clock."""

    __slots__ = ("rid", "tokens", "generated", "tenant_id",
                 "max_preemptions", "deadline_steps", "max_new_tokens",
                 "steps_used", "resubmissions", "oom_retries",
                 "worker", "wrid", "terminal", "status")

    def __init__(self, rid: int, tokens: List[int], *,
                 tenant_id=None, max_preemptions=None,
                 deadline_steps=None, max_new_tokens=None,
                 oom_retries: int = 0):
        self.rid = rid
        self.tokens = list(tokens)
        self.generated: List[int] = []
        self.tenant_id = tenant_id
        self.max_preemptions = max_preemptions
        self.deadline_steps = deadline_steps
        self.max_new_tokens = max_new_tokens
        self.steps_used = 0
        self.resubmissions = 0
        self.oom_retries = oom_retries
        self.worker: Optional[str] = None
        self.wrid: Optional[int] = None
        self.terminal = False
        self.status: Optional[str] = None


class _WorkerState:
    __slots__ = ("handle", "name", "role", "order", "status",
                 "backoff", "retry_at", "assigned", "by_rid", "stale",
                 "index", "pressure", "queued", "active", "health",
                 "respawned", "net_session", "net_mark",
                 "degraded_until")

    def __init__(self, handle: WorkerHandle, order: int,
                 backoff: int):
        self.handle = handle
        self.name = handle.name
        self.role = handle.role
        self.order = order
        self.status = "up"            # up | degraded | suspect | dead
        self.backoff = backoff
        self.retry_at = 0
        self.assigned: Dict[int, int] = {}    # worker rid -> client rid
        self.by_rid: Dict[int, int] = {}      # client rid -> worker rid
        self.stale: Set[int] = set()          # worker rids to release
        self.index: Set[bytes] = set()
        self.pressure = 0.0
        self.queued = 0
        self.active = 0
        self.health: Optional[dict] = None
        # set by Router.register_respawn: this incarnation was rebuilt
        # by a supervisor and its first successful ping IS the rejoin
        # (journaled so a WAL reader can pair spawn <-> rejoin)
        self.respawned = False
        # session-transport bookkeeping (_net_pass): whether the
        # handle's session has been journaled, the reconnect counter
        # high-water mark already accounted for, and the tick at
        # which a degraded worker (riding out a reconnect — streams
        # NOT resubmitted, copies NOT released) is promoted back up
        self.net_session = False
        self.net_mark = 0
        self.degraded_until = 0

    @property
    def load(self):
        return (self.queued + self.active, self.pressure)


class Router:
    """See the module docstring. Client surface mirrors the engines:
    ``submit(tokens, ...) -> rid``; ``step() -> {rid: [tokens]}`` (one
    router TICK: suspect retries, scrapes, migrations, then one round
    on every busy worker); ``drain_outcomes()`` — terminal verdicts,
    exactly once; ``tokens``/``generated`` from the router's own
    record; ``release(rid)``; ``close()``.

      workers             list of WorkerHandle (unique names)
      hash_fn             tokens -> chain hashes (see
                          ``token_chain_hashes``); None disables
                          prefix-aware placement (role/load only)
      injector            RouterFaultInjector (storms)
      journal_path        the router's OWN WAL (submissions,
                          emissions, deliveries): ``Router.recover``
                          rebuilds the request table from it and
                          resubmits every non-terminal stream —
                          journal-backed resubmission survives the
                          ROUTER process too
      migrate             move streams off prefill-role workers onto
                          decode-role workers once their prefill is
                          done (needs both roles present)
      policy              MigrationPolicy (inference/fleet.py): price
                          each candidate move — remaining work x
                          pressure delta vs slice-transfer cost —
                          BEFORE any export op, so a skipped move
                          ships zero slice bytes. None (default)
                          keeps the unconditional
                          every-finished-prefill behaviour
      max_oom_resubmissions  FAILED_OOM retries per request before
                          the failure is delivered
      max_resubmissions   worker-failure resubmissions per request
                          before FAILED_UNROUTABLE
      unroutable_after    ticks a request may sit unplaceable (all
                          workers suspect/full) before the
                          deterministic FAILED_UNROUTABLE verdict
      backoff_ticks/backoff_max  circuit-breaker retry schedule for
                          suspect workers (exponential, capped)
      degraded_ticks      ticks a worker stays in the ``degraded``
                          state after its session transport reports a
                          reconnect with no NEW reconnects — degraded
                          workers keep serving their streams (nothing
                          is resubmitted or released; the WorkerDied
                          machinery engages only on real death) but
                          are folded into the hot set so NEW
                          placements prefer calmer workers, and they
                          neither donate nor receive migrations
      spill_pressure      pool-pressure fraction above which a
                          best-match / best-role worker is passed
                          over for a cooler one
      call_timeout        per-op transport timeout (pipes)
    """

    def __init__(self, workers, *, hash_fn: Optional[Callable] = None,
                 injector=None, journal_path: Optional[str] = None,
                 migrate: bool = True, policy=None,
                 max_oom_resubmissions: int = 2,
                 max_resubmissions: int = 4,
                 unroutable_after: int = 4,
                 backoff_ticks: int = 2, backoff_max: int = 16,
                 degraded_ticks: int = 2,
                 spill_pressure: float = 0.92,
                 scrape_every: int = 1,
                 call_timeout: float = 120.0,
                 _fresh: bool = True):
        if not workers:
            raise ValueError("a router needs at least one worker")
        names = [w.name for w in workers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker names: {names}")
        self._workers: Dict[str, _WorkerState] = {
            w.name: _WorkerState(w, i, backoff_ticks)
            for i, w in enumerate(workers)}
        self.hash_fn = hash_fn
        self.injector = injector
        self.migrate = migrate
        self.policy = policy
        self.max_oom_resubmissions = int(max_oom_resubmissions)
        self.max_resubmissions = int(max_resubmissions)
        self.unroutable_after = int(unroutable_after)
        self.backoff_ticks = int(backoff_ticks)
        self.backoff_max = int(backoff_max)
        self.degraded_ticks = int(degraded_ticks)
        self.spill_pressure = float(spill_pressure)
        self.scrape_every = int(scrape_every)
        self.call_timeout = float(call_timeout)
        self.stats = RouterStats()
        self.tick = 0
        self.outcomes: List[RequestOutcome] = []
        self._reqs: Dict[int, _RouterReq] = {}
        self._delivered: Set[int] = set()
        self._pending: Dict[int, int] = {}     # rid -> tick queued
        self._emit_buffer: Dict[int, List[int]] = {}
        # outcomes handed to the client but not yet journaled: the
        # drain record is written at the START of the next router
        # call (the RecoverableServer recipe) — a router death
        # between calls leaves them unjournaled and recover()
        # RE-DELIVERS them to the rebuilt client, never loses them
        self._pending_drain: List[list] = []
        self._tick_stepped: Set[int] = set()
        self._next_rid = 0
        self.journal: Optional[RequestJournal] = None
        if journal_path is not None:
            self.journal = RequestJournal(journal_path, fresh=_fresh)
        self._scrape_pass(force=True)

    # -- plumbing -----------------------------------------------------
    def _jrec(self, kind: str, payload: dict) -> None:
        if self.journal is not None:
            self.journal.append(kind, payload)

    def _flush_drains(self) -> None:
        """Journal the verdicts the client has ALREADY drained —
        written at the start of the next call, not at drain time, so
        a death between calls re-delivers (the caller that held them
        died with the router) while a verdict journaled here can
        never deliver twice."""
        if self.journal is not None and self._pending_drain:
            self.journal.append("delivered",
                                {"rids": self._pending_drain})
            self._pending_drain = []

    def _op(self, ws: _WorkerState, op: str,
            payload: Optional[dict] = None,
            point: Optional[str] = None) -> dict:
        """One worker call behind the injector's kill/hang verdicts —
        the router-level crash points."""
        inj = self.injector
        if inj is not None and point is not None:
            v = inj.on_worker_op(ws.name, point)
            if v == "kill":
                ws.handle.kill()
                raise WorkerDied(f"worker {ws.name!r} killed by "
                                 f"injector at {point!r}")
            if v == "hang":
                raise WorkerTimeout(f"worker {ws.name!r} hung at "
                                    f"{point!r} (injected)")
        return ws.handle.request(op, payload or {},
                                 timeout=self.call_timeout)

    def _live(self) -> List[_WorkerState]:
        # degraded workers ARE live: they keep their streams and
        # serve their rounds — the state only biases NEW placement
        # and migration away from them while the network settles
        return [ws for ws in self._workers.values()
                if ws.status in ("up", "degraded")]

    def _all_dead(self) -> bool:
        return all(ws.status == "dead"
                   for ws in self._workers.values())

    # -- client surface -----------------------------------------------
    def submit(self, token_ids, *, max_new_tokens: Optional[int] = None,
               tenant_id: Optional[str] = None,
               deadline_steps: Optional[int] = None,
               max_preemptions: Optional[int] = None) -> int:
        """Accept a client stream and place it. Always returns a rid;
        every verdict — including rejection and unroutability — is a
        terminal outcome in ``drain_outcomes()``, never an exception
        (malformed submissions still raise, like the engines)."""
        toks = [int(t) for t in np.asarray(token_ids).reshape(-1)]
        if not toks:
            raise ValueError("empty prompt")
        self._flush_drains()
        rid = self._next_rid
        self._next_rid += 1
        req = _RouterReq(rid, toks, tenant_id=tenant_id,
                         max_preemptions=max_preemptions,
                         deadline_steps=deadline_steps,
                         max_new_tokens=max_new_tokens,
                         oom_retries=self.max_oom_resubmissions)
        self._reqs[rid] = req
        self.stats.submitted += 1
        self._jrec("submit", {
            "rid": rid, "tokens": toks,
            "kw": {"tenant_id": tenant_id,
                   "deadline_steps": deadline_steps,
                   "max_preemptions": max_preemptions,
                   "max_new_tokens": max_new_tokens}})
        self._try_place(req)
        return rid

    def step(self) -> Dict[int, List[int]]:
        """One router tick. Order: tick the injector clock, retry
        suspended workers, settle degraded session transports
        (``_net_pass``), scrape placement inputs, retry unplaced
        streams (or give the deterministic unroutable verdict),
        migrate finished prefills, then drive ONE round on every
        worker holding streams. Returns {rid: [tokens]} — every token
        delivered this tick (including admission tokens from
        placements that happened inside the tick)."""
        self._flush_drains()
        self.tick += 1
        if self.injector is not None:
            self.injector.begin_tick()
        self._retry_suspects()
        self._net_pass()
        self._scrape_pass()
        self._pending_pass()
        if self.migrate:
            self._migrate_pass()
        self._round_pass()
        if self._tick_stepped:
            # the deadline ledger: WHICH streams consumed a round
            # this tick (emissions alone undercount — prefill rounds
            # and worker-queued rounds emit nothing but still spend
            # deadline budget), so recover() rebuilds steps_used
            # exactly instead of guessing from emissions
            self._jrec("tick",
                       {"stepped": sorted(self._tick_stepped)})
            self._tick_stepped = set()
        out = self._emit_buffer
        self._emit_buffer = {}
        return out

    def drain_outcomes(self) -> List[RequestOutcome]:
        """Terminal verdicts not yet handed out — the exactly-once
        edge. The drain record reaches the journal at the start of
        the NEXT router call; see _flush_drains."""
        self._flush_drains()
        out = self.outcomes
        self.outcomes = []
        if out:
            self._pending_drain.extend(
                [oc.rid, oc.status] for oc in out)
        return out

    def tokens(self, rid: int) -> List[int]:
        req = self._reqs[rid]
        return list(req.tokens) + list(req.generated)

    def generated(self, rid: int) -> List[int]:
        req = self._reqs[rid]
        out = list(req.generated)
        if req.max_new_tokens is not None:
            out = out[:req.max_new_tokens]
        return out

    def release(self, rid: int) -> None:
        """Client-side finish: free the stream's worker copy and
        deliver its FINISHED outcome (exactly once)."""
        self._flush_drains()
        req = self._reqs[rid]
        self._jrec("release", {"rid": rid})
        self._release_copy(req)
        if not req.terminal:
            self._deliver(req, RequestOutcome.FINISHED, "released")

    def check_invariants(self) -> bool:
        """Deep pool + engine audit on every live worker."""
        for ws in self._live():
            assert self._op(ws, "audit")["ok"]
        return True

    def close(self) -> None:
        self._flush_drains()
        for ws in self._workers.values():
            try:
                ws.handle.close()
            except (WorkerDied, WorkerTimeout, WorkerError):
                pass
        if self.journal is not None:
            self.journal.close()

    # -- recovery (router journal) ------------------------------------
    @classmethod
    def recover(cls, workers, *, journal_path: str,
                **router_kw) -> "Router":
        """Rebuild a router from its own journal after the ROUTER
        process died: the request table (prompt + delivered tokens +
        verdicts) replays from the WAL, then every non-terminal
        stream is resubmitted on the next ``step()`` from its
        recorded frontier — the same pending-token resume handoff a
        worker death takes, so recovered streams continue
        bit-identically. Exactly-once holds across the router's own
        death in BOTH directions: verdicts the dead router's client
        DRAINED stay delivered (the drain record replays into the
        dedupe set), while verdicts enqueued but never drained were
        never journaled — the rebuilt router re-derives and
        RE-delivers them (already-complete streams immediately, the
        rest through resubmission). ``steps_used`` replays exactly
        from the per-tick "tick" records (which streams consumed a
        round), so deadline budgets stay spent, not reset."""
        records = read_journal(journal_path)
        router = cls(workers, journal_path=journal_path,
                     _fresh=False, **router_kw)
        for seq, kind, payload in records:
            if kind == "submit":
                kw = payload["kw"]
                req = _RouterReq(
                    payload["rid"], payload["tokens"],
                    tenant_id=kw.get("tenant_id"),
                    max_preemptions=kw.get("max_preemptions"),
                    deadline_steps=kw.get("deadline_steps"),
                    max_new_tokens=kw.get("max_new_tokens"),
                    oom_retries=router.max_oom_resubmissions)
                router._reqs[req.rid] = req
                router._next_rid = max(router._next_rid, req.rid + 1)
                router.stats.submitted += 1
            elif kind == "emit":
                req = router._reqs.get(payload["rid"])
                if req is not None:
                    req.generated.extend(int(t)
                                         for t in payload["toks"])
            elif kind == "tick":
                for rid in payload["stepped"]:
                    req = router._reqs.get(rid)
                    if req is not None:
                        req.steps_used += 1
            elif kind == "delivered":
                for rid, status in payload["rids"]:
                    req = router._reqs.get(rid)
                    if req is not None:
                        req.terminal = True
                        req.status = status
                        router._delivered.add(rid)
            elif kind == "release":
                req = router._reqs.get(payload["rid"])
                if req is not None and not req.terminal:
                    req.terminal = True
                    req.status = RequestOutcome.FINISHED
                    router._delivered.add(req.rid)
            elif kind == "respawn":
                # fleet lifecycle (supervisor spawn / circuit-breaker
                # rejoin pairs): placement is per-incarnation — the
                # rebuilt router starts from the workers it was GIVEN
                # — but the respawn count replays so capacity history
                # survives the router's own death
                if payload.get("event") == "spawn":
                    router.stats.respawns += 1
            elif kind == "rebalance":
                # policy/migration decisions replay into the ledger
                # deterministically; the moves themselves are
                # per-incarnation (the recovered streams resubmit
                # through the normal placement pass)
                router.stats.rebalances += 1
            elif kind == "net":
                # session-transport lane (reconnects and degraded
                # transitions): the worker states themselves are
                # per-incarnation — a rebuilt router starts from the
                # handles it was given — but the counters replay so
                # the flapping history survives the router's death
                if payload.get("event") == "reconnect":
                    router.stats.net_reconnects += \
                        int(payload.get("n", 1))
                elif payload.get("event") == "degraded":
                    router.stats.degraded_transitions += 1
        for req in router._reqs.values():
            if req.terminal:
                continue
            if req.max_new_tokens is not None and \
                    len(req.generated) >= req.max_new_tokens:
                # the stream is complete but its verdict was never
                # drained pre-death: the RE-delivery half of
                # exactly-once (the worker copy, if any survives, is
                # unknown to this incarnation and ages out with its
                # worker — a respawned fleet starts clean)
                router._deliver(req, RequestOutcome.FINISHED,
                                "max_new_tokens (recovered)")
            else:
                router._pending[req.rid] = router.tick
        return router

    # -- placement ----------------------------------------------------
    def _hashes_for(self, req: _RouterReq) -> List[bytes]:
        if self.hash_fn is None:
            return []
        stream = list(req.tokens) + list(req.generated)
        # hash what the TARGET worker will prefill: on a resume
        # handoff the pending token is not consumed at admission
        if req.generated:
            stream = stream[:-1]
        return list(self.hash_fn(stream))

    def _match_len(self, ws: _WorkerState,
                   hashes: List[bytes]) -> int:
        n = 0
        for h in hashes:
            if h not in ws.index:
                break
            n += 1
        return n

    def _hot(self, ws: _WorkerState) -> bool:
        if ws.status == "degraded":
            return True               # flapping network: place cooler
        if ws.pressure >= self.spill_pressure:
            return True
        h = ws.health
        return bool(h) and h.get("verdict") == "critical"

    def _choose(self, req: _RouterReq, hashes: List[bytes],
                tried: Set[str]) -> Optional[_WorkerState]:
        cands = [ws for ws in self._live() if ws.name not in tried]
        if not cands:
            return None
        by_match = sorted(
            cands, key=lambda ws: (-self._match_len(ws, hashes),
                                   ws.load, ws.order))
        best = by_match[0]
        if hashes and self._match_len(best, hashes) > 0:
            if self._hot(best):
                cool = [ws for ws in cands if not self._hot(ws)]
                if cool:
                    self.stats.spillovers += 1
                    return sorted(
                        cool,
                        key=lambda ws: (-self._match_len(ws, hashes),
                                        ws.load, ws.order))[0]
            return best
        # no prefix anywhere: fresh prompts want prefill capacity,
        # resumed streams want decode capacity
        pref = (("decode", "mixed", "prefill") if req.generated
                else ("prefill", "mixed", "decode"))
        rank = {r: i for i, r in enumerate(pref)}
        cool = [ws for ws in cands if not self._hot(ws)] or cands
        return sorted(cool, key=lambda ws: (rank.get(ws.role, 1),
                                            ws.load, ws.order))[0]

    def _submit_kw(self, req: _RouterReq, resume: bool) -> dict:
        kw: dict = {}
        if req.tenant_id is not None:
            kw["tenant_id"] = req.tenant_id
        if req.max_preemptions is not None:
            kw["max_preemptions"] = req.max_preemptions
        if req.deadline_steps is not None:
            # REMAINING budget only — rebased like a snapshot
            # restore's wall-clock deadlines, never a fresh clock
            kw["deadline_steps"] = (req.deadline_steps
                                    - req.steps_used)
        if resume:
            kw["resume"] = True
        return kw

    def _place_and_submit(self, req: _RouterReq,
                          exclude: Set[str] = frozenset()) -> str:
        """Try to place one stream: "placed", "rejected" (every live
        worker PROVED it can never serve it), or "none" (no live
        candidate took it)."""
        hashes = self._hashes_for(req)
        tried: Set[str] = set(exclude)
        rejections: List[str] = []
        resume = bool(req.generated)
        payload = {"tokens": list(req.tokens) + list(req.generated),
                   "kw": self._submit_kw(req, resume)}
        while True:
            ws = self._choose(req, hashes, tried)
            if ws is None:
                break
            tried.add(ws.name)
            try:
                resp = self._op(ws, "submit", payload, point="submit")
            except WorkerDied:
                self._on_worker_failure(ws, died=True)
                continue
            except WorkerTimeout:
                self._on_worker_failure(ws, died=False)
                continue
            wrid = int(resp["rid"])
            ws.assigned[wrid] = req.rid
            ws.by_rid[req.rid] = wrid
            req.worker, req.wrid = ws.name, wrid
            rej = self._process_response(ws, resp,
                                         intercept_rid=req.rid)
            if rej is not None:
                rejections.append(f"{ws.name}: {rej.get('reason')}")
                continue
            if hashes and self._match_len(ws, hashes) > 0:
                self.stats.placed_prefix += 1
            else:
                self.stats.placed_fresh += 1
            return "placed"
        if rejections and not exclude and \
                not any(ws.status == "suspect"
                        for ws in self._workers.values()):
            # the loop tried every live worker (only rejections come
            # back here — an acceptance returned above), none is
            # merely suspended, and dead workers can never serve: the
            # refusal is PROVEN fleet-wide, the cross-host
            # REJECTED_ADMISSION
            return "rejected"
        return "none"

    def _try_place(self, req: _RouterReq) -> None:
        """Place (or queue, or terminally fail) one unassigned
        stream."""
        if req.terminal:
            return
        if req.deadline_steps is not None and \
                req.deadline_steps - req.steps_used <= 0:
            self._deliver(req, RequestOutcome.FAILED_DEADLINE,
                          "deadline budget exhausted across "
                          "resubmission")
            return
        verdict = self._place_and_submit(req)
        if verdict == "placed":
            self._pending.pop(req.rid, None)
            return
        if verdict == "rejected":
            self._deliver(
                req, RequestOutcome.REJECTED_ADMISSION,
                "no worker can ever serve this request under its "
                "current tenant/pool contracts")
            return
        if self._all_dead():
            self._deliver(req, RequestOutcome.FAILED_UNROUTABLE,
                          "all workers down")
            return
        self._pending.setdefault(req.rid, self.tick)

    # -- failure domain -----------------------------------------------
    def _on_worker_failure(self, ws: _WorkerState,
                           died: bool) -> None:
        """A worker stopped answering: dead (resubmit everything) or
        hung (suspend behind the circuit breaker, treat its copies as
        stale, resubmit everything)."""
        if ws.status == "dead":
            return
        moved = sorted(set(ws.assigned.values()))
        if died:
            ws.status = "dead"
            self.stats.worker_deaths += 1
            # a respawned incarnation's journal replay rebuilds these
            # very copies — stale-marked NOW so the rejoin ping
            # releases them (their streams are resubmitted elsewhere
            # below); workers that never come back simply keep an
            # inert stale set
            ws.stale.update(ws.assigned.keys())
            try:
                ws.handle.kill()
            except Exception:
                pass
        else:
            ws.status = "suspect"
            self.stats.worker_timeouts += 1
            ws.retry_at = self.tick + ws.backoff
            ws.backoff = min(ws.backoff * 2, self.backoff_max)
            # the hung worker may still hold (and grow) its copies:
            # stale from here — released if it ever answers again
            ws.stale.update(ws.assigned.keys())
        ws.assigned.clear()
        ws.by_rid.clear()
        for rid in moved:
            req = self._reqs[rid]
            if req.terminal:
                continue
            req.worker = req.wrid = None
            req.resubmissions += 1
            self.stats.resubmissions += 1
            if req.resubmissions > self.max_resubmissions:
                self._deliver(req, RequestOutcome.FAILED_UNROUTABLE,
                              f"resubmission budget "
                              f"({self.max_resubmissions}) exhausted")
                continue
            self._try_place(req)

    def register_respawn(self, name: str, handle) -> None:
        """A supervisor rebuilt a DEAD worker (same name, fresh
        process/handle, state recovered from its journal+snapshot):
        swap the handle in and route the incarnation through the
        circuit-breaker rejoin path — suspect first, pinged next
        tick, stale copies (journal-replayed duplicates of streams
        already resubmitted elsewhere) released at rejoin. The router
        never trusts a respawn blindly: a corpse that cannot answer
        the rejoin ping goes straight back to dead."""
        ws = self._workers.get(name)
        if ws is None:
            raise KeyError(f"unknown worker {name!r}")
        if ws.status != "dead":
            raise ValueError(f"worker {name!r} is {ws.status!r}, not "
                             f"dead — respawn replaces corpses only")
        ws.handle = handle
        ws.status = "suspect"
        ws.backoff = self.backoff_ticks
        ws.retry_at = self.tick + 1
        ws.respawned = True
        # scraped placement signals are from the dead incarnation:
        # zero them until the rejoined worker is scraped for real
        ws.index = set()
        ws.pressure = 0.0
        ws.queued = ws.active = 0
        ws.health = None
        self.stats.respawns += 1
        self._jrec("respawn", {"worker": name, "event": "spawn",
                               "tick": self.tick})

    def _retry_suspects(self) -> None:
        for ws in self._workers.values():
            if ws.status != "suspect" or self.tick < ws.retry_at:
                continue
            try:
                self._op(ws, "ping", point="ping")
            except WorkerDied:
                ws.status = "dead"
                self.stats.worker_deaths += 1
                continue
            except WorkerTimeout:
                ws.retry_at = self.tick + ws.backoff
                ws.backoff = min(ws.backoff * 2, self.backoff_max)
                continue
            # the circuit closes: the worker is back, but every copy
            # it held was resubmitted elsewhere — release the stale
            # ones so they stop consuming its pool
            ws.status = "up"
            ws.backoff = self.backoff_ticks
            if ws.respawned:
                # a supervisor-rebuilt incarnation just answered its
                # first ping: THIS is the rejoin — journaled so the
                # WAL pairs it with the earlier "spawn" record
                ws.respawned = False
                self._jrec("respawn", {"worker": ws.name,
                                       "event": "rejoin",
                                       "tick": self.tick})
            self._release_stale(ws)

    def _net_pass(self) -> None:
        """Poll each live handle's session-transport counters
        (``net_stats`` — {} or absent on raw transports: this pass is
        DARK without the session layer). A reconnect since the last
        look marks the worker ``degraded`` for ``degraded_ticks``:
        its streams stay put and its copies stay held — a network
        blip must not engage the resubmission machinery — but new
        placement and migration route around it until it holds a
        quiet transport for the full window. Transitions and
        reconnect deltas are journaled as "net" records so a WAL
        reader (tools/fleet_doctor.py) can audit the lane and
        ``Router.recover`` replays the counters."""
        for name in sorted(self._workers):
            ws = self._workers[name]
            if ws.status not in ("up", "degraded"):
                continue
            fn = getattr(ws.handle, "net_stats", None)
            if fn is None:
                continue
            d = fn()
            if not d:
                continue
            if not ws.net_session:
                ws.net_session = True
                self._jrec("net", {"worker": ws.name,
                                   "event": "session",
                                   "tick": self.tick})
            rec = int(d.get("reconnects", 0))
            if rec > ws.net_mark:
                delta = rec - ws.net_mark
                ws.net_mark = rec
                self.stats.net_reconnects += delta
                ws.degraded_until = self.tick + self.degraded_ticks
                self._jrec("net", {"worker": ws.name,
                                   "event": "reconnect", "n": delta,
                                   "tick": self.tick})
                if ws.status == "up":
                    ws.status = "degraded"
                    self.stats.degraded_transitions += 1
                    self._jrec("net", {"worker": ws.name,
                                       "event": "degraded",
                                       "tick": self.tick})
            elif ws.status == "degraded" and \
                    self.tick >= ws.degraded_until:
                ws.status = "up"
                self._jrec("net", {"worker": ws.name,
                                   "event": "recovered",
                                   "tick": self.tick})

    def _release_stale(self, ws: _WorkerState) -> None:
        for wrid in sorted(ws.stale):
            try:
                resp = self._op(ws, "release", {"rid": int(wrid)})
                self._process_response(ws, resp)
                self.stats.stale_released += 1
            except WorkerError:
                pass                  # already gone worker-side
            except WorkerDied:
                self._on_worker_failure(ws, died=True)
                return
            except WorkerTimeout:
                self._on_worker_failure(ws, died=False)
                return
            ws.stale.discard(wrid)

    # -- scrape / pending / migration / rounds ------------------------
    def _scrape_pass(self, force: bool = False) -> None:
        if not force and self.scrape_every > 1 and \
                self.tick % self.scrape_every:
            return
        for ws in self._live():
            try:
                resp = self._op(ws, "scrape", point="scrape")
            except WorkerDied:
                self._on_worker_failure(ws, died=True)
                continue
            except WorkerTimeout:
                self._on_worker_failure(ws, died=False)
                continue
            except WorkerError:
                # a worker dying BETWEEN the ping and the scrape can
                # surface as a transport-wrapped application error
                # (half-dead harness, torn response) rather than a
                # clean WorkerDied — it must NOT escape into the
                # placement pass. Scrape is a pure read, so the
                # circuit breaker owns the verdict: suspect now, and
                # the rejoin ping resolves dead-vs-alive next tick.
                self._on_worker_failure(ws, died=False)
                continue
            ws.index = set(resp.get("index", ()))
            ws.pressure = float(resp.get("pressure", 0.0))
            ws.queued = int(resp.get("queued", 0))
            ws.active = int(resp.get("active", 0))
            ws.health = resp.get("health")

    def _pending_pass(self) -> None:
        for rid, since in sorted(self._pending.items()):
            req = self._reqs[rid]
            if req.terminal:
                self._pending.pop(rid, None)
                continue
            if self._all_dead():
                self._pending.pop(rid, None)
                self._deliver(req, RequestOutcome.FAILED_UNROUTABLE,
                              "all workers down")
                continue
            if self._live():
                self._try_place(req)
                if req.worker is not None or req.terminal:
                    continue
            if self.tick - since >= self.unroutable_after:
                self._pending.pop(rid, None)
                self._deliver(
                    req, RequestOutcome.FAILED_UNROUTABLE,
                    f"unplaceable for {self.unroutable_after} "
                    f"tick(s) (workers suspended or full)")

    def _migrate_pass(self) -> None:
        """SLICE-BATCHED migration: per donor (prefill worker) per
        tick, ONE ``export_slices`` op ships every finished-prefill
        slot's pages (N slots, one round trip — not one export per
        slot), destinations are chosen per stream exactly as before,
        the slices bound for each destination land as ONE
        ``import_slices`` op, and only then do the per-stream
        resume-submit handoffs run. Failure semantics are unchanged
        from the per-slot pass: a donor lost at export resubmits its
        streams cold; a target lost at import leaves ITS streams on
        the donor (other destinations and the remaining donors still
        migrate the same tick); a target lost at a
        handoff leaves the remaining streams on the donor for the
        next tick."""
        targets = [ws for ws in self._live() if ws.role == "decode"
                   and not self._hot(ws)]
        if not targets:
            return
        for src in [ws for ws in self._live()
                    if ws.role == "prefill"
                    and ws.status == "up"]:
            moved = [(wrid, rid) for wrid, rid
                     in sorted(src.assigned.items())
                     if not self._reqs[rid].terminal
                     and self._reqs[rid].generated]
            if not moved:
                continue
            if self.policy is not None:
                # price every candidate BEFORE the export op: a
                # declined move never ships a byte. The benefit side
                # is the stream's remaining decode work weighted by
                # the scraped pressure delta toward the coolest live
                # target (the same worker the per-stream choice below
                # would pick this tick).
                live_targets = [ws for ws in targets
                                if ws.status == "up"]
                if not live_targets:
                    return
                dst0 = sorted(live_targets,
                              key=lambda ws: (ws.load, ws.order))[0]
                priced = []
                for wrid, rid in moved:
                    req = self._reqs[rid]
                    pos = len(req.tokens) + len(req.generated)
                    rem = (None if req.max_new_tokens is None else
                           req.max_new_tokens - len(req.generated))
                    if self.policy.should_move(
                            position=pos, remaining=rem,
                            src_pressure=src.pressure,
                            dst_pressure=dst0.pressure):
                        priced.append((wrid, rid))
                    else:
                        self.stats.migrations_skipped += 1
                moved = priced
                if not moved:
                    continue
            # one export per donor per tick — the whole batch of
            # finished prefills rides a single round trip
            try:
                slices = self._op(
                    src, "export_slices",
                    {"rids": [int(w) for w, _ in moved]},
                    point="export").get("slices", {})
            except WorkerDied:
                self._on_worker_failure(src, died=True)
                continue
            except WorkerTimeout:
                self._on_worker_failure(src, died=False)
                continue
            self.stats.export_batches += 1
            # destination per stream (the same least-loaded choice
            # the per-slot pass made), then one import per chosen
            # destination carrying all its slices
            plan: List[tuple] = []      # (wrid, rid, slice, dst)
            by_dst: Dict[str, List[dict]] = {}
            for wrid, rid in moved:
                live_targets = [ws for ws in targets
                                if ws.status == "up"]
                if not live_targets:
                    return
                dst = sorted(live_targets,
                             key=lambda ws: (ws.load, ws.order))[0]
                slc = slices.get(int(wrid))
                plan.append((wrid, rid, slc, dst))
                if slc is not None:
                    by_dst.setdefault(dst.name, []).append(slc)
            for dname, batch in by_dst.items():
                dst = self._workers[dname]
                try:
                    got = self._op(dst, "import_slices",
                                   {"slices": batch},
                                   point="import")
                    self.stats.migrated_blocks += int(
                        got.get("imported", 0))
                except WorkerDied:
                    # this target's streams stay on the donor (its
                    # handoffs are skipped below); other destinations
                    # and the remaining donors still migrate this tick
                    self._on_worker_failure(dst, died=True)
                    continue
                except WorkerTimeout:
                    self._on_worker_failure(dst, died=False)
                    continue
                except WorkerError:
                    pass              # e.g. geometry drift: go cold
            for wrid, rid, _slc, dst in plan:
                req = self._reqs[rid]
                if req.terminal or dst.status != "up":
                    continue
                before = self.stats.migrations
                self._handoff(req, src, dst)
                if self.policy is not None and \
                        self.stats.migrations > before:
                    # the policy's decision became a real move:
                    # journal it so Router.recover replays the
                    # rebalance ledger deterministically (no-policy
                    # routers journal nothing here — pre-fleet WALs
                    # stay byte-identical)
                    self.stats.rebalances += 1
                    self._jrec("rebalance",
                               {"rid": int(rid), "src": src.name,
                                "dst": dst.name, "tick": self.tick})
                if src.status != "up":
                    break             # src died mid-handoff

    def _handoff(self, req: _RouterReq, src: _WorkerState,
                 dst: _WorkerState) -> None:
        """Hand one exported stream off: pending-token resume submit
        on the target (whose pool already holds the imported pages),
        then release the donor copy. Every leg can lose a worker —
        the stream survives every case (the donor's death resubmits
        it cold; the target's death leaves it on the donor)."""
        old_wrid = req.wrid
        resume_payload = {
            "tokens": list(req.tokens) + list(req.generated),
            "kw": self._submit_kw(req, resume=True)}
        try:
            resp = self._op(dst, "submit", resume_payload,
                            point="submit")
        except WorkerDied:
            self._on_worker_failure(dst, died=True)
            return                    # stream stays on src
        except WorkerTimeout:
            self._on_worker_failure(dst, died=False)
            return
        wrid = int(resp["rid"])
        # move the assignment BEFORE processing, so emissions map to
        # the new copy and the donor's release below reads as stale
        src.assigned.pop(old_wrid, None)
        src.by_rid.pop(req.rid, None)
        ws_assigned_prev = (req.worker, req.wrid)
        dst.assigned[wrid] = req.rid
        dst.by_rid[req.rid] = wrid
        req.worker, req.wrid = dst.name, wrid
        rej = self._process_response(dst, resp,
                                     intercept_rid=req.rid)
        if rej is not None:
            # target refused (quota/pool contract): stream stays on
            # the donor — restore the assignment
            req.worker, req.wrid = ws_assigned_prev
            src.assigned[old_wrid] = req.rid
            src.by_rid[req.rid] = old_wrid
            return
        self.stats.migrations += 1
        # release the donor copy; if the donor fails HERE the moved
        # stream is already safe on dst (the failure handler only
        # resubmits streams still assigned to src). Stale-marked
        # across the call so a timeout cannot orphan the copy.
        src.stale.add(int(old_wrid))
        try:
            resp = self._op(src, "release", {"rid": int(old_wrid)})
            self._process_response(src, resp)
            src.stale.discard(int(old_wrid))
        except WorkerError:
            src.stale.discard(int(old_wrid))
        except WorkerDied:
            self._on_worker_failure(src, died=True)
        except WorkerTimeout:
            self._on_worker_failure(src, died=False)

    def _round_pass(self) -> None:
        for ws in list(self._workers.values()):
            if ws.status not in ("up", "degraded"):
                continue
            if ws.stale:
                self._release_stale(ws)
                if ws.status not in ("up", "degraded"):
                    continue
            if not ws.assigned:
                continue
            stepped = sorted(set(ws.assigned.values()))
            try:
                resp = self._op(ws, "round", {},
                                point="before_round")
            except WorkerDied:
                self._on_worker_failure(ws, died=True)
                continue
            except WorkerTimeout:
                self._on_worker_failure(ws, died=False)
                continue
            killed_after = False
            if self.injector is not None:
                v = self.injector.on_worker_op(ws.name, "after_round")
                if v == "kill":
                    ws.handle.kill()
                    killed_after = True
            for rid in stepped:
                req = self._reqs[rid]
                if not req.terminal:
                    req.steps_used += 1
                    self._tick_stepped.add(rid)
            self._process_response(ws, resp)
            if killed_after:
                # the round's emissions were seen (the kill landed
                # after the answer) — the death is handled now
                self._on_worker_failure(ws, died=True)

    # -- response / outcome processing --------------------------------
    def _process_response(self, ws: _WorkerState, resp: dict,
                          intercept_rid: Optional[int] = None
                          ) -> Optional[dict]:
        """Fold one worker answer into the router's record: emissions
        append to streams (and the tick's emit buffer), outcomes
        deliver/retry/reject. ``intercept_rid``: a placement in
        flight — ITS REJECTED_ADMISSION is returned to the caller
        instead of delivered (the router keeps trying other
        workers)."""
        intercepted = None
        for wrid, toks in sorted(
                (resp.get("emitted") or {}).items()):
            rid = ws.assigned.get(int(wrid))
            if rid is None:
                continue              # stale copy: drop on the floor
            req = self._reqs[rid]
            if req.terminal:
                continue
            self._record_emission(req, toks)
        for oc in resp.get("outcomes") or ():
            wrid = int(oc["rid"])
            rid = ws.assigned.get(wrid)
            if rid is None:
                continue
            req = self._reqs[rid]
            ws.assigned.pop(wrid, None)
            ws.by_rid.pop(rid, None)
            if req.wrid == wrid and req.worker == ws.name:
                req.worker = req.wrid = None
            if req.terminal:
                continue
            if intercept_rid == rid and \
                    oc["status"] == RequestOutcome.REJECTED_ADMISSION:
                intercepted = oc
                continue
            self._worker_outcome(ws, req, oc)
        return intercepted

    def _record_emission(self, req: _RouterReq,
                         toks: List[int]) -> None:
        toks = [int(t) for t in toks]
        self._jrec("emit", {"rid": req.rid, "toks": toks})
        for t in toks:
            req.generated.append(t)
            if req.max_new_tokens is None or \
                    len(req.generated) <= req.max_new_tokens:
                self._emit_buffer.setdefault(req.rid, []).append(t)
        if req.max_new_tokens is not None and \
                len(req.generated) >= req.max_new_tokens and \
                not req.terminal:
            self._release_copy(req)
            self._deliver(req, RequestOutcome.FINISHED,
                          "max_new_tokens")

    def _release_copy(self, req: _RouterReq) -> None:
        """Best-effort release of the stream's current worker copy
        (unassigned FIRST, so the release's own FINISHED outcome
        reads as stale and cannot double-deliver). The wrid sits in
        ``ws.stale`` ACROSS the release call: a timeout mid-release
        would otherwise orphan a copy that is neither assigned nor
        stale — never released on rejoin, generating into the pool
        forever."""
        if req.worker is None:
            return
        ws = self._workers[req.worker]
        wrid = int(req.wrid)
        ws.assigned.pop(wrid, None)
        ws.by_rid.pop(req.rid, None)
        req.worker = req.wrid = None
        ws.stale.add(wrid)
        try:
            resp = self._op(ws, "release", {"rid": wrid})
            self._process_response(ws, resp)
            ws.stale.discard(wrid)
        except WorkerError:
            ws.stale.discard(wrid)    # already gone worker-side
        except WorkerDied:
            self._on_worker_failure(ws, died=True)
        except WorkerTimeout:
            self._on_worker_failure(ws, died=False)

    def _worker_outcome(self, ws: _WorkerState, req: _RouterReq,
                        oc: dict) -> None:
        status = oc["status"]
        reason = oc.get("reason", "")
        if status == RequestOutcome.FINISHED:
            # a capacity-finish freed the slot but the worker's
            # host-side stream record lives until released: queue the
            # release so a long-running worker doesn't accumulate one
            # record per finished stream
            ws.stale.add(int(oc["rid"]))
            self._deliver(req, status, reason or "finished at worker")
        elif status == RequestOutcome.FAILED_OOM:
            if req.oom_retries > 0:
                req.oom_retries -= 1
                self.stats.oom_resubmissions += 1
                verdict = self._place_and_submit(
                    req, exclude={ws.name} if len(self._live()) > 1
                    else frozenset())
                if verdict != "placed":
                    self._pending.setdefault(req.rid, self.tick)
            else:
                self._deliver(req, status, reason)
        elif status in (RequestOutcome.FAILED_NUMERIC,
                        RequestOutcome.FAILED_DEADLINE,
                        RequestOutcome.REJECTED_ADMISSION,
                        RequestOutcome.FAILED_UNROUTABLE,
                        RequestOutcome.CANCELLED):
            # deadline / numeric / (late) rejection: the verdict is
            # the worker's to make — forward it exactly once. Members
            # are NAMED (not a catch-all) so a future outcome kind
            # must be consciously routed here — enforced statically
            # by tools/check_static.py (journal-coverage)
            self._deliver(req, status, reason)
        else:
            # RequestOutcome.__init__ validates against STATUSES, so
            # an unknown status cannot reach a worker outcome dict;
            # forward defensively rather than hang the stream
            self._deliver(req, status, reason)

    def _deliver(self, req: _RouterReq, status: str,
                 reason: str) -> None:
        if req.terminal or req.rid in self._delivered:
            return
        req.terminal = True
        req.status = status
        self._pending.pop(req.rid, None)
        self._delivered.add(req.rid)
        # NOT journaled here: the verdict only becomes durable once
        # the client has actually drained it (_flush_drains) — a
        # verdict enqueued but undrained at a router death must
        # RE-deliver after recovery, not vanish into the dedupe set
        self.outcomes.append(RequestOutcome(
            req.rid, status, reason=reason,
            tokens=len(req.tokens) + len(req.generated),
            preemptions=req.resubmissions, step=self.tick))
        self.stats.delivered += 1
        if status == RequestOutcome.FAILED_UNROUTABLE:
            self.stats.unroutable += 1
