"""Transient-fault-tolerant session transport for the socket fleet
(counterpart of paddle_tpu/inference/net.py, host-only stdlib; held
AST-equal to the reference apart from imports and docstrings).

On the raw socket transport (inference/fleet.py, ``resilient=False``) a
closed socket, EOF mid-frame or a CRC mismatch is ``WorkerDied``: right
for a process that died, and a full respawn plus resubmission for a
network that blinked. This layer treats a torn connection as a
reconnect:

* ``ReplyCache``: bounded seq -> framed-reply store on the worker side.
  A reply is cached before the send is attempted, so a retried op whose
  seq the cache holds is answered from the cache and never re-executed
  (``round`` mutates engine state; running it twice would double-step
  every stream).
* ``SocketHost``: the worker-side session server. The child binds its
  own listening socket (advertised in the ready handshake) and, when a
  connection tears, goes back to ``accept``. Every connection opens
  with a ``hello`` carrying the client's session id; its answer
  (session id + ``last_seq``) doubles as the liveness probe. A hello
  from a new session id resets the cache.
* ``ResilientTransport``: the client side. Each op carries a strictly
  increasing seq. On EOF, a torn or corrupt frame or an op timeout the
  client drops the connection, backs off on a capped doubling schedule,
  reconnects with a hello and resends the same frame. Only a REFUSED
  probe connect (``WorkerDied``: nothing listens) and an exhausted retry
  budget (``WorkerTimeout``) escalate to the router's taxonomy.

This module reads no wall clock (it does not import ``time``;
tools/check_static.py checks it): a timeout of T seconds is a plan of
``POLL_SLICE`` socket polls whose last one is clamped to the remainder
(an op's reply budget is spent only by polls that time out, so a reply
of any size arrives while its bytes flow),
backoff waits are keyed to the attempt index, session ids come from a
per-name class counter, and every ``net.*`` counter (``NetStats``) is
incremented on the client side only, driven by events a
``NetworkFaultInjector`` schedules by op seq, so two runs of one seeded
storm recover through identical reconnect sequences and counters.
"""
from __future__ import annotations

import select as _select
import socket as _socketlib
from typing import Dict, Optional, Tuple

from .recovery import (FRAME_HEADER_SIZE, frame_body_size,
                       frame_message, unframe_message)
from .router import WorkerDied, WorkerTimeout
from .telemetry import NetStats

__all__ = ["POLL_SLICE", "ReplyCache", "SocketHost",
           "ResilientTransport", "read_exact"]

# One socket poll quantum. Timeouts are expressed as counts of this
# slice (plus one clamped fractional slice), so deadline arithmetic
# is pure division — no clock reads anywhere in this module.
POLL_SLICE = 0.05


def _slice_plan(timeout: float):
    """``timeout`` seconds as a list of per-poll socket timeouts:
    full POLL_SLICE quanta plus one final slice clamped to the exact
    remainder. Summing the plan gives back ``timeout`` — the deadline
    fires at T, not at the next slice boundary after T."""
    t = max(0.0, float(timeout))
    n = int(t / POLL_SLICE)
    rem = t - n * POLL_SLICE
    plan = [POLL_SLICE] * n
    if rem > 1e-9 or not plan:
        plan.append(max(rem, 1e-4))
    return plan


def read_exact(sock, n: int) -> bytes:
    """Exactly ``n`` bytes off a blocking socket; EOF mid-read raises
    ``ConnectionError``. Unlike the one-shot transport, here a torn
    frame is a RECONNECT trigger, not a verdict."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 16, n - got))
        if not chunk:
            raise ConnectionError("socket closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


# ---------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------

class ReplyCache:
    """Bounded seq -> framed-reply store. ``put`` happens BEFORE the
    send attempt, so a reply the network ate survives for the retry;
    ``get`` on a held seq IS the idempotency contract (the op is not
    re-executed). ``last_seq`` is the execution high-water mark the
    hello answer advertises — a client whose in-flight seq is at or
    under it knows its retry will be served from cache. One op is in
    flight per session at a time, so a small capacity is generous;
    eviction only matters across pathological seq gaps."""

    __slots__ = ("capacity", "last_seq", "_frames", "_order")

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self.last_seq = 0
        self._frames: Dict[int, bytes] = {}
        self._order = []               # FIFO eviction order

    def put(self, seq: int, frame: bytes) -> None:
        seq = int(seq)
        if seq not in self._frames:
            self._order.append(seq)
        self._frames[seq] = frame
        self.last_seq = max(self.last_seq, seq)
        while len(self._order) > self.capacity:
            self._frames.pop(self._order.pop(0), None)

    def get(self, seq: int) -> Optional[bytes]:
        return self._frames.get(int(seq))

    def reset(self) -> None:
        self.last_seq = 0
        self._frames.clear()
        del self._order[:]

    def __len__(self):
        return len(self._frames)


class SocketHost:
    """Worker-side session server: owns the child's listening socket
    and answers framed ops across however many connections the
    network tears through. The dispatcher (``worker.handle``) and the
    app-level fault surface are untouched — this class only decides
    WHICH bytes answer a frame (fresh execution vs reply cache) and
    what a dead connection means (accept the next one).

      lsock           the child's OWN bound+listening socket; its port
                      rides the ready handshake so the client knows
                      where to reconnect
      worker          an ``EngineWorker`` (router.py op dispatcher)
      conn            the already-accepted first connection (the
                      parent's connect-back socket) — adopted so the
                      handshake connection serves ops without a
                      re-dial
      cache_ops       reply-cache capacity
      accept_timeout  seconds (a slice budget, not a clock) to wait
                      in accept for the client to come back after a
                      drop; expiry ends ``serve`` — an orphaned child
                      exits instead of listening forever

    ``serve`` returns a string verdict for the child main to act on:
    "close" (clean shutdown op), "died" (EngineCrash — the child must
    exit; over a socket the exit IS the abandonment) or "orphaned"
    (accept budget expired with no client)."""

    def __init__(self, lsock, worker, *, conn=None, cache_ops: int = 64,
                 accept_timeout: float = 60.0):
        self.lsock = lsock
        self.worker = worker
        self.cache = ReplyCache(cache_ops)
        self.session: Optional[str] = None
        self.accept_timeout = float(accept_timeout)
        self.accepts = 0
        self._conn = conn

    # -- connection management ----------------------------------------
    def _accept(self):
        """Next client connection, or None when the accept slice
        budget runs out (the client is not coming back)."""
        for sl in _slice_plan(self.accept_timeout):
            self.lsock.settimeout(sl)
            try:
                conn, _ = self.lsock.accept()
            except _socketlib.timeout:
                continue
            except OSError:
                return None
            self.accepts += 1
            return conn
        return None

    # -- the serve loop -----------------------------------------------
    def serve(self) -> str:
        conn = self._conn
        self._conn = None
        while True:
            if conn is None:
                conn = self._accept()
                if conn is None:
                    return "orphaned"
            verdict = self._serve_conn(conn)
            try:
                conn.close()
            except OSError:
                pass
            conn = None
            if verdict != "drop":
                return verdict

    def _serve_conn(self, conn) -> str:
        """Answer frames on one connection until it drops ("drop"),
        the client sends ``close`` ("close"), or the engine dies
        ("died")."""
        conn.settimeout(None)
        while True:
            try:
                head = read_exact(conn, FRAME_HEADER_SIZE)
                body = read_exact(conn, frame_body_size(head))
                msg = unframe_message(head, body)
            except Exception:          # EOF / torn frame / bad CRC:
                return "drop"          # the CONNECTION died, not us
            if msg is None:
                return "drop"
            if isinstance(msg, dict) and msg.get("_hello"):
                if not self._answer_hello(conn, msg):
                    return "drop"
                continue
            seq, op, payload = msg
            verdict = self._answer_op(conn, seq, op, payload)
            if verdict is not None:
                return verdict

    def _answer_hello(self, conn, msg) -> bool:
        sid = str(msg.get("session", ""))
        if sid != self.session:
            # a NEW session (fresh client incarnation): its seq space
            # restarts, so the previous incarnation's replies must
            # never answer it
            self.cache.reset()
            self.session = sid
        ack = frame_message({"_hello": True, "session": sid,
                             "last_seq": self.cache.last_seq,
                             "pong": True})
        try:
            conn.sendall(ack)
        except OSError:
            return False
        return True

    def _answer_op(self, conn, seq, op, payload) -> Optional[str]:
        cached = self.cache.get(seq)
        if cached is not None:
            # the retry of an op we already ran: answer from the
            # cache, never re-execute — transport idempotency
            try:
                conn.sendall(cached)
            except OSError:
                return "drop"
            return "close" if op == "close" else None
        try:
            out = self.worker.handle(op, payload or {})
        except Exception as e:
            died = type(e).__name__ == "EngineCrash"
            if died:
                try:
                    conn.sendall(frame_message(
                        {"_err": f"EngineCrash: {e}", "_died": True,
                         "_seq": seq}))
                except OSError:
                    pass
                return "died"
            out = {"_err": f"{type(e).__name__}: {e}"}
        frame = frame_message(dict(out, _seq=seq))
        # cache FIRST: if the send dies, the reply waits here for the
        # retry — the op will not run twice
        self.cache.put(seq, frame)
        try:
            conn.sendall(frame)
        except OSError:
            return "drop"
        return "close" if op == "close" else None


# ---------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------

class _NetFault(Exception):
    """Internal: one transient wire fault (EOF, torn/corrupt frame,
    op timeout, failed probe). Never escapes the transport — it is
    consumed by the retry loop, which either recovers or escalates to
    WorkerDied/WorkerTimeout."""

    def __init__(self, msg: str, *, blackhole: bool = False):
        super().__init__(msg)
        self.blackhole = blackhole


class ResilientTransport:
    """Client side of the session layer: per-op seqs, fault-triggered
    reconnect with capped attempt-keyed backoff, idempotent resend.
    ``call`` either returns the worker's reply dict (``_seq``
    stripped) or raises from the router taxonomy — ``WorkerDied``
    when the liveness probe is REFUSED (no listener: the process is
    gone), ``WorkerTimeout`` when the retry budget is exhausted (the
    peer may be alive but will not answer). App-level verdicts
    (``_err``/``_died`` in the reply) are the CALLER's to interpret,
    exactly as on the raw transport.

      sock           the already-connected first socket (the parent's
                     accept of the child's connect-back)
      name           worker name, for error messages and the injector
      peer           (host, port) of the worker's OWN listener — the
                     reconnect/probe target from the ready handshake
      timeout        default per-op reply budget (seconds -> slices)
      probe_timeout  connect + hello budget per probe
      max_retries    resend attempts per op before WorkerTimeout
      backoff_base   backoff starts at this many POLL_SLICEs...
      backoff_cap    ...doubling per attempt up to this many
      injector       optional ``NetworkFaultInjector``; consulted via
                     two hooks (``on_send``/``on_reply``) only when
                     present — absent injector, zero overhead
      stats          ``NetStats`` (fresh if None); exported through
                     the fleet registry as ``net.*``
    """

    _SESSION_COUNTS: Dict[str, int] = {}

    @classmethod
    def _next_session(cls, name: str) -> str:
        n = cls._SESSION_COUNTS.get(name, 0) + 1
        cls._SESSION_COUNTS[name] = n
        return f"{name}.s{n}"

    def __init__(self, sock, *, name: str, peer: Tuple[str, int],
                 timeout: float = 120.0, probe_timeout: float = 5.0,
                 max_retries: int = 4, backoff_base: int = 1,
                 backoff_cap: int = 8, injector=None, stats=None):
        self.name = str(name)
        self.peer = (str(peer[0]), int(peer[1]))
        self.timeout = float(timeout)
        self.probe_timeout = float(probe_timeout)
        self.max_retries = int(max_retries)
        self.backoff_base = max(1, int(backoff_base))
        self.backoff_cap = max(self.backoff_base, int(backoff_cap))
        self.injector = injector
        self.stats = NetStats() if stats is None else stats
        self.session = self._next_session(self.name)
        self.seq = 0
        self._conn = sock
        # a bytearray, not bytes: ``+=`` of each received chunk then
        # extends in place, so a frame of F bytes costs O(F) to receive
        # (bytes concatenation copies the whole buffer per 64 KiB chunk,
        # O(F^2): minutes for the ~10^8-byte page slices of a
        # full-width model)
        self._buf = bytearray()
        self._closed = False

    # -- low-level ----------------------------------------------------
    def _drop_conn(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
        self._buf = bytearray()                # a dead conn's bytes are noise

    def _backoff(self, attempt: int) -> None:
        """Attempt-keyed capped doubling: attempt k waits
        min(base << (k-1), cap) slices. Keyed to the attempt INDEX —
        never to a clock — so two runs back off identically."""
        n = min(self.backoff_base << (attempt - 1), self.backoff_cap)
        _select.select([], [], [], n * POLL_SLICE)

    def _pop_frame(self) -> Optional[Tuple[bytes, bytes]]:
        """One complete (head, body) off the receive buffer, or None
        if a full frame has not arrived yet."""
        if len(self._buf) < FRAME_HEADER_SIZE:
            return None
        head = self._buf[:FRAME_HEADER_SIZE]
        n = frame_body_size(head)
        if len(self._buf) < FRAME_HEADER_SIZE + n:
            return None
        body = self._buf[FRAME_HEADER_SIZE:FRAME_HEADER_SIZE + n]
        self._buf = self._buf[FRAME_HEADER_SIZE + n:]
        return head, body

    def _await(self, want_seq: int, timeout: float,
               blackhole: bool = False) -> dict:
        """Reply to op ``want_seq`` within a slice budget of
        ``timeout`` seconds of silence, or raise ``_NetFault``.
        ``blackhole`` (injected) swallows every received byte so the
        budget expires — a silent peer, manufactured
        deterministically."""
        conn = self._conn
        plan = _slice_plan(timeout)
        spent = 0
        while spent < len(plan):
            while not blackhole:
                frame = self._pop_frame()
                if frame is None:
                    break
                msg = self._decode(want_seq, frame)
                if msg is not None:
                    return msg
            conn.settimeout(plan[spent])
            try:
                chunk = conn.recv(1 << 16)
            except _socketlib.timeout:
                # only a poll that waited out its slice in silence
                # spends budget: counting polls that returned bytes
                # would cap a reply at len(plan) x 64 KiB (157 MB at
                # 120 s), below one full-width page slice
                spent += 1
                continue
            except (ConnectionError, OSError) as e:
                raise _NetFault(f"socket error: {e}")
            if not chunk:
                raise _NetFault("EOF (connection dropped)")
            if blackhole:
                continue               # the wire eats every byte
            self._buf += chunk
        raise _NetFault(f"no answer in {timeout}s",
                        blackhole=blackhole)

    def _decode(self, want_seq: int, frame) -> Optional[dict]:
        """One buffered frame -> the awaited reply, or None if the
        frame was consumed as noise (stale seq, injected tear/corrupt
        raises ``_NetFault`` instead)."""
        head, body = frame
        fault = (self.injector.on_reply(self.name, want_seq)
                 if self.injector is not None else None)
        if fault in ("truncate_header", "truncate_payload"):
            # the frame the network actually delivered ends mid-read;
            # everything buffered behind the tear is garbage too
            self._buf = bytearray()
            self.stats.frames_rejected += 1
            raise _NetFault(f"frame torn "
                            f"{'mid-header' if fault == 'truncate_header' else 'mid-payload'}")
        if fault == "corrupt":
            body = bytes([body[0] ^ 0xFF]) + body[1:]
        if fault == "duplicate":
            # the wire delivered the frame twice: park the copy at the
            # buffer front so it surfaces as a stale frame later
            self._buf = head + body + self._buf
        try:
            msg = unframe_message(head, body)
        except Exception as e:         # CRC / unpickling: lying bytes
            self._buf = bytearray()
            self.stats.frames_rejected += 1
            raise _NetFault(f"corrupt frame: {e}")
        if not isinstance(msg, dict):
            self.stats.stale_frames += 1
            return None
        if msg.get("_hello"):
            return None                # late hello ack: harmless
        if msg.get("_seq") != want_seq:
            # a timed-out op's late answer (or an injected duplicate)
            # must never be read as THIS op's reply
            self.stats.stale_frames += 1
            return None
        return msg

    # -- session establishment ----------------------------------------
    def hello(self) -> dict:
        """Open the session on the current connection (or reconnect
        if there is none): send the hello, await the ack. Called once
        after the ready handshake; thereafter hellos ride
        ``_reconnect``."""
        if self._conn is None:
            self._reconnect(self.seq)
            self.stats.sessions += 1
            return {"session": self.session}
        ack = self._hello_on(self._conn)
        if ack is None:
            self._drop_conn()
            self._recover_conn(self.seq)
        self.stats.sessions += 1
        return {"session": self.session}

    def _hello_on(self, conn) -> Optional[dict]:
        """Hello round-trip on ``conn``: the ack dict, or None on any
        wire fault (the caller decides whether to retry)."""
        try:
            conn.sendall(frame_message(
                {"_hello": True, "session": self.session}))
        except OSError:
            return None
        for sl in _slice_plan(self.probe_timeout):
            conn.settimeout(sl)
            try:
                chunk = conn.recv(1 << 16)
            except _socketlib.timeout:
                continue
            except (ConnectionError, OSError):
                return None
            if not chunk:
                return None
            self._buf += chunk
            frame = self._pop_frame()
            if frame is None:
                continue
            try:
                msg = unframe_message(*frame)
            except Exception:
                self._buf = bytearray()
                return None
            if isinstance(msg, dict) and msg.get("_hello") \
                    and msg.get("session") == self.session:
                return msg
        return None

    def _reconnect(self, seq: int) -> dict:
        """One probe + reconnect attempt: dial the worker's listener,
        prove liveness with a hello, adopt the connection. A REFUSED
        connect is the one certain death signal (no listener -> no
        process) and raises ``WorkerDied`` immediately; any other
        wire fault raises ``_NetFault`` for the retry loop."""
        self.stats.probes += 1
        try:
            conn = _socketlib.create_connection(
                self.peer, timeout=self.probe_timeout)
        except (ConnectionRefusedError, ConnectionResetError) as e:
            self._closed = True
            raise WorkerDied(
                f"worker {self.name!r} liveness probe refused "
                f"({e}): process is gone") from e
        except OSError as e:
            raise _NetFault(f"probe connect failed: {e}")
        ack = self._hello_on(conn)
        if ack is None:
            try:
                conn.close()
            except OSError:
                pass
            raise _NetFault("liveness probe got no hello answer")
        self._conn = conn
        self.stats.reconnects += 1
        if int(ack.get("last_seq", 0)) >= seq > 0:
            # the worker already EXECUTED this op: the resend will be
            # answered from its reply cache, not re-run
            self.stats.reply_cache_hits += 1
        return ack

    def _recover_conn(self, seq: int) -> None:
        """Backoff + probe until a connection stands, or escalate."""
        for attempt in range(1, self.max_retries + 1):
            self._backoff(attempt)
            try:
                self._reconnect(seq)
                return
            except _NetFault:
                continue
        raise WorkerTimeout(
            f"worker {self.name!r}: liveness probe got no answer "
            f"in {self.max_retries} attempts")

    # -- the op path --------------------------------------------------
    def call(self, op: str, payload=None, timeout=None) -> dict:
        """One op, exactly-once: send, await, and on any transient
        wire fault reconnect + resend the SAME seq (the worker's
        reply cache absorbs re-delivery). Raises ``WorkerDied`` /
        ``WorkerTimeout`` only on the two escalation conditions."""
        if self._closed:
            raise WorkerDied(f"worker {self.name!r} transport closed")
        t = self.timeout if timeout is None else float(timeout)
        self.seq += 1
        seq = self.seq
        frame = frame_message((seq, op, payload or {}))
        fault = (self.injector.on_send(self.name, seq)
                 if self.injector is not None else None)
        blackhole = fault == "blackhole"
        sent = False
        if fault == "drop_before":
            # the connection drops BEFORE delivery: the worker never
            # saw the op; the resend after reconnect executes it
            self._drop_conn()
        elif fault == "drop_after":
            # ...AFTER delivery: the worker executes and caches; the
            # resend is a cache hit, not a re-execution
            if self._conn is not None:
                self._send(frame, t)
            self._drop_conn()
        elif self._conn is not None:
            sent = self._send(frame, t)
        retried = False
        attempt = 0
        while True:
            if sent:
                try:
                    return self._finish(self._await(seq, t,
                                                    blackhole=blackhole))
                except _NetFault as e:
                    if e.blackhole:
                        self.stats.blackholes += 1
                    self._drop_conn()
            blackhole = False
            sent = False
            attempt += 1
            if attempt > self.max_retries:
                raise WorkerTimeout(
                    f"worker {self.name!r}: op {op!r} (seq {seq}) "
                    f"unanswered after {self.max_retries} retries")
            self._backoff(attempt)
            try:
                self._reconnect(seq)
            except _NetFault:
                continue               # probe failed; burn the attempt
            if not retried:
                retried = True
                self.stats.retried_ops += 1
            sent = self._send(frame, t)

    def _send(self, frame: bytes, timeout: float) -> bool:
        if self._conn is None:
            return False
        try:
            # the send gets the op's budget: the last poll of the
            # previous reply left a <= 50 ms timeout on the socket, and
            # sendall spends it on the whole frame (a full-width page
            # slice needs ~1 s on loopback)
            self._conn.settimeout(timeout)
            self._conn.sendall(frame)
            return True
        except (BrokenPipeError, ConnectionError, OSError):
            self._drop_conn()
            return False

    def _finish(self, resp: dict) -> dict:
        resp.pop("_seq", None)
        if resp.get("_died"):
            self._closed = True
        return resp

    def close(self) -> None:
        self._closed = True
        self._drop_conn()

    def net_stats(self) -> dict:
        return self.stats.as_dict()

    def __repr__(self):
        return (f"ResilientTransport({self.name!r}, "
                f"session={self.session!r}, seq={self.seq}, "
                f"reconnects={self.stats.reconnects})")
