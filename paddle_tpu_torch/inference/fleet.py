"""Self-healing serving fleet: supervisor respawn, socket transport and
cost-aware migration (counterpart of paddle_tpu/inference/fleet.py,
host-only stdlib; held AST-equal to the reference apart from imports
and docstrings).

* ``FleetSupervisor``: owns each worker's data-only spec and its
  journal/snapshot paths. A worker the router marks dead is rebuilt
  from its files (``build_server_from_spec`` with ``recover=True``:
  same seeds, snapshot restore + journal replay) and re-registered
  through the router's circuit-breaker rejoin path
  (``Router.register_respawn``), so a kill storm recovers to full
  capacity. It also takes fleet checkpoints of in-process workers'
  pools as delta snapshots and has a ``snapshot``/``restore`` of its
  own control-plane state.
* ``SocketWorker``: the ``EngineWorker`` op protocol over TCP with the
  journal's length+CRC framing (``recovery.frame_message``). Raw
  (``resilient=False``): every wire anomaly is ``WorkerDied``. With the
  session layer (``resilient=True``, the default; inference/net.py):
  reconnect, idempotent resend and a reply cache, escalating only on a
  refused probe or an exhausted retry budget. ``kill()`` is a SIGKILL.
* ``MigrationPolicy``: prices each candidate prefill->decode move,
  ``span_flops(pos, pos + remaining) x (p_src - p_dst) >
  resident_kv_bytes(pos) x flops_per_byte``, before any export op, so a
  declined move ships zero slice bytes; approved moves are journaled as
  "rebalance" records that ``Router.recover`` replays.

Observability rides the registry: ``fleet.*`` gauges (workers live,
respawns, migrations) and ``net.*`` sums of the session transports'
counters, both dark without a supervisor; a ``HealthMonitor`` bound to
the supervisor's registry raises ``capacity-degraded``.
"""
from __future__ import annotations

import socket as _socketlib
import time as _time
from typing import Dict, Optional

from .accounting import WorkModel
from .net import ResilientTransport, SocketHost
from .recovery import (FRAME_HEADER_SIZE, frame_body_size,
                       frame_message, unframe_message)
from .resilience import EngineCrash
from .router import (EngineWorker, InProcWorker, WorkerDied,
                     WorkerError, WorkerTimeout, WorkerHandle,
                     build_server_from_spec)
from .telemetry import MetricsRegistry

__all__ = ["FleetSupervisor", "MigrationPolicy", "SocketWorker"]


# ---------------------------------------------------------------------
# cost-aware migration
# ---------------------------------------------------------------------

class MigrationPolicy:
    """Move/stay pricing for the router's migration pass (wired as
    ``Router(policy=...)``). The benefit of moving a stream is the
    work it has LEFT, done on a cooler pool; the cost is the pages it
    would ship. Both sides are priced by the same ``WorkModel`` the
    goodput ledger uses, so the decision and the ledger agree on what
    a FLOP is.

      work            WorkModel of the served core
      flops_per_byte  exchange rate between slice-transfer bytes and
                      compute: how many FLOPs of remaining work one
                      shipped byte must buy. Higher = stickier
                      streams (transfers are expensive); 0 = every
                      finished prefill moves (the pre-policy router,
                      minus the pressure-delta gate)
      horizon         assumed remaining tokens for streams with no
                      max_new_tokens budget
      min_delta       pressure delta at or below which a move is
                      never worth it (a balanced fleet stays put)
    """

    def __init__(self, work: WorkModel, *, flops_per_byte: float = 32.0,
                 horizon: int = 32, min_delta: float = 0.0):
        self.work = work
        self.flops_per_byte = float(flops_per_byte)
        self.horizon = int(horizon)
        self.min_delta = float(min_delta)
        self.approved = 0
        self.declined = 0

    @classmethod
    def for_model(cls, model, **kw) -> "MigrationPolicy":
        """Price against a live model (or TokenServingModel)."""
        return cls(WorkModel.for_model(model), **kw)

    def price(self, *, position: int, remaining: Optional[int],
              src_pressure: float, dst_pressure: float):
        """(benefit_flops, cost_flops) of one candidate move."""
        rem = self.horizon if remaining is None else max(0,
                                                         int(remaining))
        pos = int(position)
        delta = float(src_pressure) - float(dst_pressure)
        benefit = (self.work.span_flops(pos, pos + rem)
                   * max(0.0, delta))
        cost = (self.work.resident_kv_bytes(pos)
                * self.flops_per_byte)
        return benefit, cost

    def should_move(self, *, position: int, remaining: Optional[int],
                    src_pressure: float, dst_pressure: float) -> bool:
        delta = float(src_pressure) - float(dst_pressure)
        if delta <= self.min_delta:
            self.declined += 1
            return False
        benefit, cost = self.price(
            position=position, remaining=remaining,
            src_pressure=src_pressure, dst_pressure=dst_pressure)
        ok = benefit > cost
        if ok:
            self.approved += 1
        else:
            self.declined += 1
        return ok


# ---------------------------------------------------------------------
# socket transport
# ---------------------------------------------------------------------

def _read_exact(sock, n: int) -> bytes:
    """Exactly ``n`` bytes off a blocking socket; EOF mid-read raises
    ``ConnectionError`` — a torn frame is a dead peer, never data."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 16, n - got))
        if not chunk:
            raise ConnectionError("socket closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _socket_worker_main(host: str, port: int, spec: dict,
                        resilient: bool = False,
                        accept_timeout: float = 60.0) -> None:
    """Child-process entry (multiprocessing spawn target): connect
    back to the parent FIRST (cheap, so the parent's accept returns
    before the model build), then build the server from the data-only
    spec and answer framed ops until EOF / close / EngineCrash. Same
    error surface as the pipe child: application errors return as
    ``{"_err": ...}``, ``EngineCrash`` reports ``{"_died": True}``
    and exits — the engine must be abandoned, and over a socket an
    exit IS the abandonment (the parent reads EOF).

    With ``resilient=True`` the child first binds its OWN listening
    socket and advertises the port in the ready message; op serving
    is then handed to ``SocketHost`` (inference/net.py), which treats
    a dropped connection as a re-accept — the process outlives its
    connections, and retried ops are answered from the reply cache
    instead of re-executing. ``EngineCrash`` and ``close`` still end
    the process: real death stays real."""
    serve_sock = None
    if resilient:
        serve_sock = _socketlib.socket(_socketlib.AF_INET,
                                       _socketlib.SOCK_STREAM)
        serve_sock.bind((host, 0))
        serve_sock.listen(1)
    sock = _socketlib.create_connection((host, int(port)))
    try:
        try:
            worker = EngineWorker(build_server_from_spec(spec),
                                  name=spec.get("name", "worker"),
                                  role=spec.get("role", "mixed"))
            ready = {"ready": True}
            if serve_sock is not None:
                ready["port"] = serve_sock.getsockname()[1]
            sock.sendall(frame_message(ready))
        except Exception as e:     # surface build failures loudly
            try:
                sock.sendall(frame_message(
                    {"_err": f"{type(e).__name__}: {e}",
                     "_died": True}))
            except OSError:
                pass
            return
        if serve_sock is not None:
            host_loop = SocketHost(serve_sock, worker, conn=sock,
                                   accept_timeout=accept_timeout)
            host_loop.serve()
            return
        while True:
            try:
                head = _read_exact(sock, FRAME_HEADER_SIZE)
                body = _read_exact(sock, frame_body_size(head))
                msg = unframe_message(head, body)
            except Exception:      # EOF / torn frame / bad CRC:
                break              # the parent is gone or lying
            if msg is None:
                break
            seq, op, payload = msg
            try:
                out = worker.handle(op, payload or {})
            except EngineCrash as e:
                try:
                    sock.sendall(frame_message(
                        {"_err": f"EngineCrash: {e}", "_died": True,
                         "_seq": seq}))
                except OSError:
                    pass
                break
            except Exception as e:
                out = {"_err": f"{type(e).__name__}: {e}"}
            try:
                sock.sendall(frame_message(dict(out, _seq=seq)))
            except OSError:
                break
            if op == "close":
                break
    finally:
        sock.close()
        if serve_sock is not None:
            serve_sock.close()


class SocketWorker(WorkerHandle):
    """A REAL worker process speaking the ``EngineWorker`` op protocol
    over TCP (127.0.0.1 by default — the same class serves a remote
    bind address) with the journal's length+CRC framing.

    Fault mapping depends on the transport mode. The ORIGINAL mapping
    (``resilient=False``) equates every wire anomaly with death: a
    closed socket, EOF mid-frame, or a CRC mismatch is ``WorkerDied``
    (dead socket == dead pipe == same abandonment semantics); only a
    silent peer inside its deadline is ``WorkerTimeout``. With
    ``resilient=True`` (the default) the session layer
    (``ResilientTransport``, inference/net.py) absorbs those wire
    anomalies with reconnect + idempotent resend, and only a REFUSED
    liveness probe (``WorkerDied``) or an exhausted retry budget
    (``WorkerTimeout``) escalates — the same taxonomy, reached only
    when the worker is genuinely gone or genuinely silent.
    ``kill()`` is a genuine SIGKILL either way.

      resilient     run the session layer (child serves through
                    ``SocketHost``; reconnect survives drops)
      net_injector  optional ``NetworkFaultInjector`` handed to the
                    transport — test/bench wiring; absent, the fault
                    hooks cost nothing
    """

    def __init__(self, spec: dict, *, name: str, role: str = "mixed",
                 timeout: float = 120.0, start_method: str = "spawn",
                 wait_ready: bool = True, host: str = "127.0.0.1",
                 resilient: bool = True, net_injector=None,
                 probe_timeout: float = 5.0, max_retries: int = 4):
        import multiprocessing as mp
        ctx = mp.get_context(start_method)
        self.name = str(name)
        self.role = role
        self.timeout = float(timeout)
        self.resilient = bool(resilient)
        self.probe_timeout = float(probe_timeout)
        self.max_retries = int(max_retries)
        self._net_injector = net_injector
        self._net: Optional[ResilientTransport] = None
        self._host = str(host)
        lsock = _socketlib.socket(_socketlib.AF_INET,
                                  _socketlib.SOCK_STREAM)
        try:
            lsock.bind((host, 0))
            lsock.listen(1)
            bound_host, port = lsock.getsockname()[:2]
            self.proc = ctx.Process(
                target=_socket_worker_main,
                args=(bound_host, port,
                      dict(spec, name=name, role=role),
                      self.resilient),
                daemon=True)
            self.proc.start()
            # the child connects before building its model, so this
            # accept only waits out the interpreter spawn + import
            lsock.settimeout(self.timeout)
            try:
                self._sock, _ = lsock.accept()
            except _socketlib.timeout:
                self.proc.kill()
                raise WorkerDied(f"worker {self.name!r} never "
                                 f"connected back") from None
        finally:
            lsock.close()
        # a bytearray: receiving a frame stays linear in its size (see
        # ResilientTransport)
        self._buf = bytearray()
        self._killed = False
        self._seq = 0
        self._ready = False
        if wait_ready:
            self._handshake()

    def _handshake(self) -> None:
        ready = self._recv(self.timeout, want_seq=None)
        if not ready.get("ready"):
            self._killed = True
            raise WorkerDied(f"worker {self.name!r} failed to "
                             f"build: {ready.get('_err')}")
        self._ready = True
        port = ready.get("port")
        if self.resilient and port:
            # the child advertised its own listener: hand the socket
            # to the session layer and open the session (the hello
            # ack doubles as the first liveness proof)
            self._net = ResilientTransport(
                self._sock, name=self.name,
                peer=(self._host, int(port)), timeout=self.timeout,
                probe_timeout=self.probe_timeout,
                max_retries=self.max_retries,
                injector=self._net_injector)
            self._net.hello()

    def _pop_msg(self) -> Optional[dict]:
        """One complete framed message off the receive buffer, or
        None if a full frame has not arrived yet. An undecodable
        frame (CRC / unpickling) kills the transport — a peer whose
        bytes cannot be trusted is indistinguishable from a dead
        one."""
        if len(self._buf) < FRAME_HEADER_SIZE:
            return None
        head = self._buf[:FRAME_HEADER_SIZE]
        n = frame_body_size(head)
        if len(self._buf) < FRAME_HEADER_SIZE + n:
            return None
        body = self._buf[FRAME_HEADER_SIZE:FRAME_HEADER_SIZE + n]
        self._buf = self._buf[FRAME_HEADER_SIZE + n:]
        try:
            return unframe_message(head, body)
        except Exception as e:
            self._killed = True
            raise WorkerDied(f"worker {self.name!r} sent a torn/"
                             f"corrupt frame: {e}") from e

    def _recv(self, timeout: float, want_seq) -> dict:
        """Response to op ``want_seq``, discarding stale answers —
        same protocol-desync defence as the pipe transport (a
        timed-out op's late answer must never be read as the next
        op's reply). ``want_seq=None`` accepts anything (the build
        handshake)."""
        deadline = _time.monotonic() + timeout
        while True:
            msg = self._pop_msg()
            if msg is not None:
                if want_seq is None or msg.get("_seq") == want_seq:
                    return msg
                continue               # stale late answer
            # clamp the poll to the remaining budget: the final poll
            # must fire AT the deadline, not up to 50 ms past it
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise WorkerTimeout(
                    f"worker {self.name!r}: no answer in {timeout}s")
            self._sock.settimeout(min(0.05, remaining))
            try:
                chunk = self._sock.recv(1 << 16)
                if not chunk:          # EOF: peer gone (SIGKILL too)
                    raise WorkerDied(
                        f"worker {self.name!r} socket closed "
                        f"(exitcode {self.proc.exitcode})")
                self._buf += chunk
            except _socketlib.timeout:
                pass
            except (ConnectionError, OSError) as e:
                raise WorkerDied(
                    f"worker {self.name!r} socket error: {e}") from e

    def request(self, op, payload=None, timeout=None) -> dict:
        if self._killed:
            raise WorkerDied(f"worker {self.name!r} is dead")
        if not self._ready:
            self._handshake()          # deferred-build handshake
        if self._net is not None:
            # session-layer path: the transport absorbs transient
            # wire faults; only its WorkerDied/WorkerTimeout
            # escalations reach us, and the app-level verdicts below
            # are interpreted identically to the raw path
            try:
                resp = self._net.call(op, payload, timeout)
            except WorkerDied:
                self._killed = True
                raise
            if resp.get("_died"):
                self._killed = True
                raise WorkerDied(
                    f"worker {self.name!r}: {resp['_err']}")
            if "_err" in resp:
                raise WorkerError(resp["_err"])
            return resp
        self._seq += 1
        # the send gets the op's budget, not the <= 50 ms the last
        # reply's poll left on the socket (too short for a page slice)
        self._sock.settimeout(timeout if timeout is not None
                              else self.timeout)
        try:
            self._sock.sendall(
                frame_message((self._seq, op, payload or {})))
        except (BrokenPipeError, ConnectionError, OSError) as e:
            raise WorkerDied(
                f"worker {self.name!r} socket broken: {e}") from e
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
            self.proc.kill()           # SIGKILL — real process death
        self.proc.join(timeout=10)
        if self._net is not None:
            self._net.close()
        try:
            self._sock.close()
        except OSError:
            pass

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
        if self._net is not None:
            self._net.close()
        try:
            self._sock.close()
        except OSError:
            pass

    def net_stats(self) -> dict:
        """The session transport's ``net.*`` counters ({} on the raw
        transport) — the router's degraded-state pass and the fleet
        registry's ``net`` prefix both read this."""
        return self._net.net_stats() if self._net is not None else {}

    @property
    def alive(self) -> bool:
        return not self._killed and self.proc.is_alive()


# ---------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------

class FleetSupervisor:
    """Closes the loop the router leaves open: a worker the router
    marks DEAD gets rebuilt from its own files and rejoins through
    the circuit breaker. Drive it with one ``tick()`` after each
    ``router.step()`` — the supervisor is control plane only and
    never touches the data path (placement, rounds, emissions stay
    the router's).

      router            the Router whose fleet this supervises
      specs             {worker_name: build_server_from_spec dict} —
                        MUST be the same specs the live workers were
                        built from (same seeds/paths), or the respawn
                        breaks the bit-identity contract. A spec may
                        carry ``transport``: "inproc" (default) or
                        "socket" to override the fleet-wide default.
      transport         default respawn transport
      registry          MetricsRegistry for the ``fleet.*`` gauges
                        (fresh one if None — always on either way)
      monitor           optional HealthMonitor: bound to the fleet
                        registry, stepped per tick — its
                        ``capacity-degraded`` detector lights up only
                        through this wiring
      max_respawns      respawn ATTEMPTS per worker before the corpse
                        is left for the coroner (bounds the
                        crash-loop: a corrupt snapshot must not buy
                        an infinite rebuild cycle)
      checkpoint_every  take a fleet checkpoint of every live
                        in-process worker's pool each N ticks: full
                        ``PagedKVCache.snapshot()`` the first time,
                        ``snapshot(base=...)`` DELTAS after — the
                        periodic cost scales with dirtied pages, not
                        pool size. 0 disables. (Socket/pipe workers
                        self-checkpoint via their own
                        ``snapshot_every``; a supervisor cannot reach
                        through a process boundary for pages and does
                        not try.)
      socket_timeout    per-op timeout handed to respawned
                        SocketWorkers
    """

    def __init__(self, router, specs: Dict[str, dict], *,
                 transport: str = "inproc", registry=None,
                 monitor=None, max_respawns: int = 4,
                 checkpoint_every: int = 0,
                 socket_timeout: float = 120.0):
        if transport not in ("inproc", "socket"):
            raise ValueError(f"unknown transport {transport!r}")
        self.specs = {str(n): dict(s) for n, s in specs.items()}
        unknown = sorted(set(self.specs) - set(router._workers))
        if unknown:
            raise ValueError(f"specs name workers the router does "
                             f"not have: {unknown}")
        self.router = router
        self.transport = transport
        self.registry = (MetricsRegistry() if registry is None
                         else registry)
        self.registry.attach("fleet", self._fleet_gauges)
        self.registry.attach("net", self._net_gauges)
        self.monitor = monitor
        if monitor is not None:
            monitor.bind(self.registry)
        self.max_respawns = int(max_respawns)
        self.checkpoint_every = int(checkpoint_every)
        self.socket_timeout = float(socket_timeout)
        self.respawn_counts: Dict[str, int] = {}
        self.respawns_total = 0
        self.failed_respawns = 0
        self.last_error: Optional[str] = None
        # fleet checkpoint archive: {name: {"base": full_snap,
        # "delta": latest_delta_or_None}} — in-memory, re-seeded from
        # the next full checkpoint after a restore
        self._checkpoints: Dict[str, dict] = {}
        self.checkpoint_full_bytes = 0
        self.checkpoint_delta_bytes = 0

    # -- gauges -------------------------------------------------------
    def _fleet_gauges(self) -> dict:
        r = self.router
        live = sum(1 for ws in r._workers.values()
                   if ws.status in ("up", "degraded"))
        degraded = sum(1 for ws in r._workers.values()
                       if ws.status == "degraded")
        return {
            "workers_total": len(r._workers),
            "workers_live": live,
            "workers_degraded": degraded,
            "respawns": r.stats.respawns,
            "migrations.forced": (r.stats.migrations
                                  - r.stats.rebalances),
            "migrations.policy": r.stats.rebalances,
            "migrations.skipped": r.stats.migrations_skipped,
        }

    def _net_gauges(self) -> dict:
        """Fleet-wide sums of the session transports' ``net.*``
        counters. DARK ({}) when no worker runs the session layer —
        the ``net.*`` series never appears and the monitor's
        network-flapping detector stays off, the same
        dark-without-the-subsystem contract the fleet series keeps
        without a supervisor."""
        tot: Dict[str, int] = {}
        seen = False
        for name in sorted(self.router._workers):
            fn = getattr(self.router._workers[name].handle,
                         "net_stats", None)
            if fn is None:
                continue
            d = fn()
            if not d:
                continue
            seen = True
            for k, v in d.items():
                tot[k] = tot.get(k, 0) + int(v)
        return tot if seen else {}

    # -- the control loop ---------------------------------------------
    def tick(self) -> int:
        """One supervisor pass (call after ``router.step()``): respawn
        every corpse still inside its attempt budget, take the
        periodic fleet checkpoint, advance the fleet monitor.
        Returns the number of respawns registered this pass."""
        r = self.router
        respawned = 0
        for name in sorted(r._workers):
            if r._workers[name].status != "dead":
                continue
            spec = self.specs.get(name)
            if spec is None:
                continue               # not ours to resurrect
            if self.respawn_counts.get(name, 0) >= self.max_respawns:
                continue               # crash-looping: leave it dead
            if self.respawn(name):
                respawned += 1
        if self.checkpoint_every and r.tick and \
                r.tick % self.checkpoint_every == 0:
            self.checkpoint()
        if self.monitor is not None:
            self.monitor.on_step(r.tick)
        return respawned

    def respawn(self, name: str) -> bool:
        """Rebuild one dead worker from its spec + on-disk state and
        re-register it. The rebuild is ``RecoverableServer.recover``
        under the hood (``recover=True`` in the spec): snapshot
        restore + journal replay, the bit-identity contract. A failed
        rebuild (corrupt snapshot, diverged journal, vanished files)
        leaves the worker dead, burns one attempt, and records the
        error — the control plane must survive every data-plane
        corpse."""
        ws = self.router._workers[name]
        if ws.status != "dead":
            raise ValueError(f"worker {name!r} is {ws.status!r} — "
                             f"only corpses respawn")
        spec = dict(self.specs[name], recover=True)
        transport = spec.pop("transport", self.transport)
        self.respawn_counts[name] = \
            self.respawn_counts.get(name, 0) + 1
        try:
            if transport == "socket":
                # wait_ready=False: the rebuild (model + snapshot +
                # journal replay) proceeds in the child while the
                # router ticks on; the rejoin ping pays the handshake
                handle = SocketWorker(spec, name=name, role=ws.role,
                                      timeout=self.socket_timeout,
                                      wait_ready=False)
            else:
                handle = InProcWorker(spec, name=name, role=ws.role)
        except Exception as e:
            self.failed_respawns += 1
            self.last_error = f"{name}: {type(e).__name__}: {e}"
            return False
        self.router.register_respawn(name, handle)
        self.respawns_total += 1
        return True

    # -- fleet checkpoints (delta snapshots) --------------------------
    def checkpoint(self) -> Dict[str, dict]:
        """Snapshot every live IN-PROCESS worker's pool into the
        fleet archive: the first checkpoint per worker is full, later
        ones are ``snapshot(base=...)`` deltas carrying only pages
        whose content changed since the base — the periodic cost
        stops scaling with pool size. Returns {name: snapshot} for
        the workers captured this pass."""
        out: Dict[str, dict] = {}
        for name in sorted(self.router._workers):
            ws = self.router._workers[name]
            if ws.status != "up":
                continue
            harness = getattr(ws.handle, "worker", None)
            if harness is None:
                continue               # process worker: self-managed
            cache = harness.server.engine.engine.cache
            entry = self._checkpoints.get(name)
            if entry is None:
                snap = cache.snapshot()
                self._checkpoints[name] = {"base": snap,
                                           "delta": None}
                self.checkpoint_full_bytes += snap["payload"].nbytes
            else:
                snap = cache.snapshot(base=entry["base"])
                entry["delta"] = snap
                self.checkpoint_delta_bytes += snap["payload"].nbytes
            out[name] = snap
        return out

    # -- durable state ------------------------------------------------
    def snapshot(self) -> dict:
        """The supervisor's durable control-plane state: specs,
        budgets, attempt history, checkpoint accounting. Live wiring
        (router, registry, monitor) and the in-memory checkpoint
        archive are reconstructed at restore."""
        return {
            "kind": "fleet_supervisor",
            "specs": {n: dict(s) for n, s in self.specs.items()},
            "transport": self.transport,
            "max_respawns": self.max_respawns,
            "checkpoint_every": self.checkpoint_every,
            "socket_timeout": self.socket_timeout,
            "respawn_counts": dict(self.respawn_counts),
            "counters": {
                "respawns_total": self.respawns_total,
                "failed_respawns": self.failed_respawns,
                "checkpoint_full_bytes": self.checkpoint_full_bytes,
                "checkpoint_delta_bytes": self.checkpoint_delta_bytes,
            },
            "last_error": self.last_error,
        }

    @classmethod
    def restore(cls, snap: dict, router, *, registry=None,
                monitor=None) -> "FleetSupervisor":
        """Rebuild a supervisor around a (possibly itself recovered)
        router. Attempt budgets survive — a worker that crash-looped
        before the control plane died does not get a fresh budget
        just because the supervisor moved."""
        if snap.get("kind") != "fleet_supervisor":
            raise ValueError(f"not a fleet_supervisor snapshot "
                             f"(kind={snap.get('kind')!r})")
        sup = cls(router, snap["specs"],
                  transport=snap["transport"],
                  registry=registry, monitor=monitor,
                  max_respawns=snap["max_respawns"],
                  checkpoint_every=snap["checkpoint_every"],
                  socket_timeout=snap["socket_timeout"])
        sup.respawn_counts = {str(k): int(v) for k, v
                              in snap["respawn_counts"].items()}
        c = snap["counters"]
        sup.respawns_total = int(c["respawns_total"])
        sup.failed_respawns = int(c["failed_respawns"])
        sup.checkpoint_full_bytes = int(c["checkpoint_full_bytes"])
        sup.checkpoint_delta_bytes = int(c["checkpoint_delta_bytes"])
        sup.last_error = snap["last_error"]
        return sup
