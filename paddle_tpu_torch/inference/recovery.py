"""Crash recovery for the port's paged serving stack (counterpart of
paddle_tpu/inference/recovery.py): atomic snapshot persistence, a
write-ahead request journal, and a recoverable token-ID serving host
with exactly-once outcome delivery.

* **Snapshot** (``save_snapshot``/``load_snapshot``): the engine's
  ``snapshot()`` dict persisted atomically (write temp, fsync, rename)
  behind a magic + version + length + CRC header, so a truncated or
  foreign file fails with ``SnapshotVersionError``.
* **Journal** (``RequestJournal``): an append-only log of everything
  that crosses the serving boundary: submissions (written BEFORE the
  engine sees them), per-round emitted tokens, releases, cancels, tenant
  reconfigurations, imported slices and drained outcomes. Records are
  length + CRC framed; a record torn by a crash mid-append is dropped on
  read (the round it described simply replays).
* **Replay** (``RecoverableServer.recover``): restore the last snapshot,
  then replay the journal suffix in the recorded order. The engines are
  deterministic given their inputs, so the replayed rounds regenerate
  the journaled emissions exactly, checked record by record
  (``RecoveryError`` on divergence). On the card replay runs the same
  ragged kernels at the same shapes as the live run.
* **Exactly-once outcomes**: terminal outcomes reach the caller only
  through ``drain_outcomes()``, whose rids are journaled; replay
  regenerates every outcome and the journaled drains suppress the
  delivered ones.

The file formats are byte-identical to the JAX package's (the same
magic, header struct, version, CRC and framing): a snapshot or journal
either package writes loads in the other. Every load goes through an
allowlist of numpy arrays, dtypes, scalars and ``OrderedDict``, so a
payload must be plain data: the host converts torch tensors to numpy at
the journal boundary (``_to_host``) and never widens the allowlist.

Crash scheduling lives in ``resilience.CrashInjector``; its
``pre_journal`` and ``post_journal`` points fire around this host's
journal append.
"""
from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .resilience import RequestOutcome  # noqa: F401  (re-export surface)
from .speculative import SpeculativeEngine

__all__ = ["SNAPSHOT_VERSION", "SnapshotVersionError", "RecoveryError",
           "save_snapshot", "load_snapshot", "RequestJournal",
           "read_journal", "RecoverableServer", "FRAME_HEADER_SIZE",
           "frame_message", "frame_body_size", "unframe_message"]

SNAPSHOT_MAGIC = b"PTSNAP"
SNAPSHOT_VERSION = 1
_SNAP_HDR = struct.Struct("<IQI")      # version, body length, body crc


class SnapshotVersionError(RuntimeError):
    """The snapshot file is not readable by this build: wrong magic,
    wrong format version, or truncated/corrupt body. Raised INSTEAD of
    a pickle traceback so operators see the actual problem."""


class RecoveryError(RuntimeError):
    """Journal replay diverged from the recorded run (or the journal
    references state the snapshot cannot produce). Indicates journal
    corruption or broken engine determinism — recovery must stop
    rather than serve wrong tokens."""


def _to_host(obj):
    """``obj`` with every torch tensor (any device) replaced by its numpy
    array, through dicts, lists and tuples: journal payloads must load
    through the numpy-only allowlist below."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


# -- restricted unpickling ---------------------------------------------
#
# Snapshots and journals are plain data (numpy + containers + ints +
# bytes), so loading them never needs arbitrary globals. pickle.loads
# would execute whatever a malicious file references — and the offline
# doctor (tools/recovery_check.py) is explicitly pointed at files of
# unknown provenance — so every load goes through an allowlist instead:
# a snapshot referencing anything else fails with SnapshotVersionError,
# not code execution.

_ALLOWED_GLOBALS = {
    ("collections", "OrderedDict"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED_GLOBALS:
            return super().find_class(module, name)
        raise SnapshotVersionError(
            f"snapshot/journal references disallowed global "
            f"{module}.{name} — refusing to unpickle (the format is "
            f"plain numpy + containers; anything else means a foreign "
            f"or malicious file)")


def _restricted_loads(blob: bytes):
    import io
    return _RestrictedUnpickler(io.BytesIO(blob)).load()


# -- atomic snapshot persistence --------------------------------------

def save_snapshot(path: str, payload: dict) -> int:
    """Persist ``payload`` (any picklable dict) atomically: the bytes
    land in a temp file, are fsync'd, and REPLACE ``path`` in one
    rename — a crash mid-write leaves either the old snapshot or the
    new one, never a torn file. Returns the byte size written."""
    blob = pickle.dumps(payload, protocol=4)
    head = SNAPSHOT_MAGIC + _SNAP_HDR.pack(
        SNAPSHOT_VERSION, len(blob), zlib.crc32(blob) & 0xFFFFFFFF)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(head)
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(head) + len(blob)


def load_snapshot(path: str) -> dict:
    """Read a ``save_snapshot`` file, verifying magic, version, length
    and CRC before unpickling; every failure mode is a
    ``SnapshotVersionError`` naming what is wrong."""
    with open(path, "rb") as f:
        data = f.read()
    head_len = len(SNAPSHOT_MAGIC) + _SNAP_HDR.size
    if len(data) < head_len:
        raise SnapshotVersionError(
            f"truncated snapshot {path!r}: {len(data)} bytes, header "
            f"alone is {head_len}")
    if data[:len(SNAPSHOT_MAGIC)] != SNAPSHOT_MAGIC:
        raise SnapshotVersionError(
            f"{path!r} is not a serving snapshot (bad magic "
            f"{data[:len(SNAPSHOT_MAGIC)]!r})")
    ver, n, crc = _SNAP_HDR.unpack_from(data, len(SNAPSHOT_MAGIC))
    if ver != SNAPSHOT_VERSION:
        raise SnapshotVersionError(
            f"snapshot {path!r} is format v{ver}; this build reads "
            f"v{SNAPSHOT_VERSION} — re-snapshot from a matching build")
    body = data[head_len:]
    if len(body) < n:
        raise SnapshotVersionError(
            f"truncated snapshot {path!r}: body {len(body)} of {n} "
            f"bytes")
    body = body[:n]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise SnapshotVersionError(
            f"corrupt snapshot {path!r}: body CRC mismatch")
    return _restricted_loads(body)


# -- write-ahead request journal --------------------------------------

class RequestJournal:
    """Append-only WAL of serving-boundary events. Each record is
    ``(seq, kind, payload)`` pickled behind a (length, CRC) frame;
    ``read_journal`` drops a torn trailing record (crash mid-append)
    instead of failing. ``fresh=True`` truncates (a brand-new serving
    lineage); the default appends (recovery continues the lineage,
    seq numbering picked up where the journal left off).

    Durability scope: by default ``append`` flushes to the OS but does
    NOT fsync, so records survive death of the serving PROCESS (the
    crash model this subsystem defends) but a host/power loss may drop
    a flushed-yet-unsynced tail — pass ``sync=True`` to fsync every
    append when the journal must survive the machine too (snapshots
    always fsync)."""

    _HDR = struct.Struct("<II")

    def __init__(self, path: str, fresh: bool = False,
                 sync: bool = False, _scanned=None):
        self.path = path
        self.sync = sync
        self.seq = 0
        # intact journal bytes on disk (header + body per record) —
        # the ``journal.bytes`` durability gauge's ground truth
        self.bytes_written = 0
        # intact records found on open (append mode) — recovery reads
        # them from here instead of re-scanning the file
        self.startup_records: List[tuple] = []
        if not fresh:
            # _scanned lets recover() validate the journal READ-ONLY
            # (lineage check) before this open mutates it (torn-tail
            # truncate) — and skips a second full scan
            recs, valid = (_scan_journal(path) if _scanned is None
                           else _scanned)
            if valid is not None and valid < os.path.getsize(path):
                # a torn tail record must be CUT before appending, or
                # everything written after it would sit behind the
                # break and never be read back. Only when there IS a
                # torn tail: an intact journal reopens untouched, so
                # repeated open/recover cycles never re-truncate (or
                # even re-write) a clean file.
                with open(path, "r+b") as f:
                    f.truncate(valid)
            if recs:
                self.seq = recs[-1][0]
            self.startup_records = recs
            self.bytes_written = 0 if valid is None else int(valid)
        self._f = open(path, "wb" if fresh else "ab")

    def append(self, kind: str, payload: dict) -> int:
        self.seq += 1
        data = self._frame((self.seq, kind, payload))
        self._f.write(data)
        self.bytes_written += len(data)
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
        return self.seq

    @staticmethod
    def _frame(record: tuple) -> bytes:
        blob = pickle.dumps(record, protocol=4)
        return RequestJournal._HDR.pack(
            len(blob), zlib.crc32(blob) & 0xFFFFFFFF) + blob

    def compact(self, upto_seq: int) -> int:
        """Drop every record at or below ``upto_seq`` — a snapshot now
        covers them, so replaying them is impossible (recovery skips
        seq <= the snapshot's journal_seq) and keeping them only grows
        the file without bound on a long-running server. The
        survivors are rewritten behind a COMPACT MARKER record that
        REUSES seq == upto_seq: the marker keeps the file's last seq
        at/past the snapshot's journal_seq, so the recovery lineage
        check ("this journal belongs to this snapshot") still holds on
        an otherwise-empty journal, seq numbering continues unchanged,
        and replay skips it like any other covered record. Atomic
        (write temp + fsync + rename, same recipe as save_snapshot);
        the append handle reopens on the new file. No-op when there is
        nothing to drop. Returns the bytes reclaimed."""
        upto_seq = int(upto_seq)
        recs, _ = _scan_journal(self.path)
        old = [r for r in recs if r[0] <= upto_seq]
        if not old or (len(old) == 1 and old[0][1] == "compact"
                       and old[0][0] == upto_seq):
            return 0
        before = self.bytes_written
        frames = [self._frame((upto_seq, "compact",
                               {"upto": upto_seq}))]
        frames += [self._frame(r) for r in recs if r[0] > upto_seq]
        data = b"".join(frames)
        tmp = f"{self.path}.compact.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self.bytes_written = len(data)
        # the marker frame can outweigh a single tiny dropped record:
        # "reclaimed" never reports negative
        return max(0, before - len(data))

    def close(self) -> None:
        """Idempotent: closing a closed journal is a no-op, and the
        append handle is released exactly once (no fd leak when a
        host retires the same server twice)."""
        if not self._f.closed:
            self._f.close()

    @property
    def closed(self) -> bool:
        return self._f.closed


def _scan_journal(path: str):
    """([(seq, kind, payload)], valid_byte_length) — valid_byte_length
    is None when the file does not exist, else the offset right after
    the last INTACT record (a torn tail starts there). A break is only
    treated as a torn tail when the file ENDS inside the broken record
    — the only shape a crash mid-append can produce. A record whose
    bytes are all present but whose CRC fails, with more data behind
    it, is MID-FILE damage (reordered writeback on power loss, disk
    corruption): truncating there would silently destroy the intact
    records after the hole, so the scan raises ``RecoveryError``
    instead."""
    out: List[tuple] = []
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return out, None
    hdr = RequestJournal._HDR
    off = 0
    while off + hdr.size <= len(data):
        n, crc = hdr.unpack_from(data, off)
        end = off + hdr.size + n
        body = data[off + hdr.size:end]
        if len(body) < n:
            break                              # torn tail (file ends)
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            if end < len(data):
                raise RecoveryError(
                    f"journal {path!r} is damaged MID-FILE: record at "
                    f"byte {off} fails its CRC but {len(data) - end} "
                    f"byte(s) follow — refusing to drop intact "
                    f"records behind the hole")
            break                              # torn tail (last record)
        out.append(_restricted_loads(body))
        off = end
    return out, off


def read_journal(path: str) -> List[tuple]:
    """All intact records of a journal as [(seq, kind, payload)]. A
    torn or CRC-failing TAIL record is silently dropped — that is the
    crash-mid-append case and the event it described never completed.
    Mid-file damage (a broken record with intact data behind it)
    raises ``RecoveryError`` rather than silently losing the rest."""
    return _scan_journal(path)[0]


# -- wire framing ------------------------------------------------------
#
# The journal's (length, CRC32) frame doubles as a SOCKET wire format
# (the JAX package's inference/fleet.py): one framing discipline where a
# torn byte stream must be DETECTED rather than guessed at. A frame
# that fails its CRC over TCP means the peer died mid-write — exactly
# the torn-tail case on disk — and maps to the same abandonment
# semantics (dead socket == dead pipe).

FRAME_HEADER_SIZE = RequestJournal._HDR.size


def frame_message(obj) -> bytes:
    """One framed message: 8-byte (length, CRC32) header + pickled
    body — byte-compatible with a journal record frame."""
    blob = pickle.dumps(obj, protocol=4)
    return RequestJournal._HDR.pack(
        len(blob), zlib.crc32(blob) & 0xFFFFFFFF) + blob


def frame_body_size(head: bytes) -> int:
    """Body length announced by an 8-byte frame header."""
    return RequestJournal._HDR.unpack(head)[0]


def unframe_message(head: bytes, body: bytes):
    """Decode one framed message from its header + body. Raises
    ``ValueError`` on a CRC mismatch (torn frame) and refuses
    non-allowlisted globals like every other journal load — a socket
    peer gets no more unpickling power than a journal file does."""
    _n, crc = RequestJournal._HDR.unpack(head)
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ValueError("framed message CRC mismatch (torn frame)")
    return _restricted_loads(body)


# -- recoverable serving host -----------------------------------------

class RecoverableServer:
    """Crash-recoverable host around a ``SpeculativeEngine`` (the
    token-ID surface: ``k=0`` is plain paged serving, ``k=0,
    prefix_cache=True`` adds the prefix cache, ``k>0`` speculates —
    so ONE host covers every serving mode). All traffic flows through
    this object so the journal sees everything:

      submit()          WAL first, then the engine — a crash inside
                        admission replays the submission
      step()            one engine round; emissions journaled after
                        the round, snapshots taken every
                        ``snapshot_every`` rounds
      drain_outcomes()  exactly-once terminal outcomes (see module
                        docstring)
      release()         journaled caller-side finish

    Construction writes snapshot 0 (the empty engine) so a crash
    before the first periodic snapshot still recovers;
    ``RecoverableServer.recover`` rebuilds from the files after an
    ``EngineCrash`` (or a real process restart)."""

    def __init__(self, engine: SpeculativeEngine, *, journal_path: str,
                 snapshot_path: str, snapshot_every: int = 0,
                 sync: bool = False, compact_journal: bool = True,
                 _fresh: bool = True):
        self.engine = engine
        self.injector = engine.injector
        self.journal_path = journal_path
        self.snapshot_path = snapshot_path
        self.snapshot_every = int(snapshot_every)
        self.sync = bool(sync)      # fsync journal appends (host-death
                                    # durability; see RequestJournal)
        # drop journal records a successful snapshot covers (they can
        # never replay again — recovery skips seq <= the snapshot's):
        # bounds the journal on a long-running server. False keeps the
        # full history on disk (debugging/forensics).
        self.compact_journal = bool(compact_journal)
        self.rounds = 0                 # rounds served, live + replayed
        self.replayed_rounds = 0
        self.replayed_tokens = 0
        self.snapshots_taken = 0
        self.snapshot_bytes = 0
        self._delivered: set = set()    # rids whose outcome was drained
        # outcomes handed to the caller but not yet journaled: the
        # drain record is written at the START of the next server call
        # (before any crash point), so a death BETWEEN calls leaves
        # them unjournaled and recovery RE-DELIVERS them — the caller
        # that would have held them died with the process, so
        # re-delivery is what exactly-once means post-recovery
        self._pending_drain: List[list] = []
        # durability ground truth in the ALWAYS-ON registry (the
        # journal-lag health alert's source — previously these existed
        # only as trace spans): records appended since the last
        # snapshot, intact journal bytes, and engine steps since the
        # last snapshot. Live sources — read at scrape time, zero
        # hot-path cost.
        self._snap_seq = 0          # journal.seq at the last snapshot
        self._snap_step = 0         # engine step at the last snapshot
        self._closed = False
        engine.registry.attach("journal", self._journal_gauges)
        engine.registry.attach("snapshot", self._snapshot_gauges)
        if _fresh:
            self.journal = RequestJournal(journal_path, fresh=True,
                                          sync=self.sync)
            self.save_snapshot()

    def _engine_step(self) -> int:
        return self.engine.engine._step_count

    def _journal_gauges(self) -> dict:
        j = getattr(self, "journal", None)   # recover() wires it late
        if j is None:
            return {"lag_records": 0, "bytes": 0}
        return {"lag_records": j.seq - self._snap_seq,
                "bytes": j.bytes_written}

    def _snapshot_gauges(self) -> dict:
        return {"age_steps": self._engine_step() - self._snap_step}

    # -- persistence --------------------------------------------------
    def _flush_drains(self) -> None:
        if self._pending_drain:
            self.journal.append("outcomes",
                                {"rids": self._pending_drain})
            self._pending_drain = []

    def save_snapshot(self) -> None:
        # the snapshot's delivered set must never run ahead of the
        # journal: flush first so a crash right after the rename can
        # still account for every delivery it suppresses
        self._flush_drains()
        self.snapshot_bytes = save_snapshot(self.snapshot_path, {
            "kind": "recoverable_server",
            "engine": self.engine.snapshot(),
            "journal_seq": self.journal.seq,
            "rounds": self.rounds,
            "snapshot_every": self.snapshot_every,
            "delivered": sorted(self._delivered),
        })
        self.snapshots_taken += 1
        self._snap_seq = self.journal.seq
        self._snap_step = self._engine_step()
        if self.compact_journal:
            # the snapshot is durable (atomic rename happened): every
            # record at/below its journal_seq is dead weight now. The
            # lag gauge is already 0 (seq == _snap_seq) and the bytes
            # gauge shrinks to the surviving suffix. A crash between
            # the rename and this rewrite only leaves extra covered
            # records, which replay skips.
            self.journal.compact(self._snap_seq)

    # -- serving surface ----------------------------------------------
    def submit(self, token_ids, **kw) -> int:
        if kw.get("deadline_s") is not None:
            # wall-clock deadlines cannot replay deterministically (a
            # replayed round's wall time is not the live round's), so
            # a journaled server refuses them up front instead of
            # failing recovery with a RecoveryError later
            raise ValueError(
                "deadline_s is wall-clock and breaks deterministic "
                "journal replay; use deadline_steps on a "
                "RecoverableServer (bare engines still accept "
                "deadline_s)")
        self._flush_drains()
        toks = [int(t) for t in np.asarray(_to_host(token_ids)).reshape(-1)]
        kw = _to_host(dict(kw))
        self.journal.append("submit", {"tokens": toks,
                                       "kw": dict(kw)})
        return self.engine.submit(toks, **kw)

    def step(self) -> Dict[int, List[int]]:
        self._flush_drains()
        inj = self.injector
        col = self.engine.collector
        if inj is not None:
            inj.begin_round()           # live-round crash clock
        emitted = self.engine.step()
        if inj is not None:
            inj.crash_point("pre_journal")
        # the durability phases ride the engine timeline as spans —
        # journal-append and snapshot cost is visible next to the
        # model/prefill phases it competes with. try/finally, not a
        # bare bracket: injected crashes cannot fire between the
        # crash points, but a REAL append/snapshot failure (disk
        # full) could — and an unclosed span would skew the stack
        # for every later step on this collector
        if col is not None:
            col.span_begin("journal")
        try:
            self.journal.append("round", {
                "emitted": {int(r): [int(t) for t in toks]
                            for r, toks in emitted.items()}})
        finally:
            if col is not None:
                col.span_end()
        if inj is not None:
            inj.crash_point("post_journal")
        self.rounds += 1
        if self.snapshot_every and \
                self.rounds % self.snapshot_every == 0:
            if col is not None:
                col.span_begin("snapshot")
            try:
                self.save_snapshot()
            finally:
                if col is not None:
                    col.span_end(bytes=self.snapshot_bytes)
        return emitted

    def drain_outcomes(self) -> List[RequestOutcome]:
        """Terminal outcomes not yet delivered — the exactly-once edge
        of the recovery contract. The drain record reaches the journal
        at the start of the NEXT server call (before any crash point
        can fire), so an injected crash can never re-deliver, while a
        raw process kill between calls leaves the record unwritten and
        recovery re-delivers to the rebuilt caller — delivered exactly
        once from every observer that survives."""
        self._flush_drains()
        fresh = [oc for oc in self.engine.outcomes
                 if oc.rid not in self._delivered]
        self.engine.outcomes.clear()
        if fresh:
            self._pending_drain.extend(
                [oc.rid, oc.status] for oc in fresh)
            self._delivered.update(oc.rid for oc in fresh)
        return fresh

    def release(self, rid: int) -> None:
        self._flush_drains()
        self.journal.append("release", {"rid": int(rid)})
        self.engine.release(rid)

    def cancel(self, rid: int) -> bool:
        """Journaled early stop (best-of loser pruning, beam cuts,
        caller cancel): the record lands BEFORE the engine mutates,
        like a submit, so a crash after the append replays the
        cancellation and the replayed rounds serve the same surviving
        streams. Unknown/terminal rids return False live AND on
        replay (the engine's cancel is a no-op for them) — nothing to
        special-case."""
        self._flush_drains()
        self.journal.append("cancel", {"rid": int(rid)})
        return self.engine.cancel(rid)

    def export_slice(self, rid: int):
        """Migration export (a router's slice move): ``rid``'s finished
        prefix pages as a content-addressed kv_slice. A pure read —
        nothing to journal; the SOURCE of a migration keeps serving
        (or releasing) the request exactly as before."""
        return self.engine.export_slice(rid)

    def import_slice(self, slc: dict) -> int:
        """Adopt a migrated slice into this server's target pool. The
        slice is JOURNALED BEFORE the pool mutates, like a submit: a
        crash after the append replays the import, so the pages a
        replayed admission adopted are present again and the replayed
        rounds re-emit identically. (The slice also becomes durable
        here — a migration target that outlives its source still
        holds the pages in its own lineage.)"""
        self._flush_drains()
        slc = _to_host(slc)
        self.journal.append("import_slice", {"slice": slc})
        return self.engine.import_slice(slc)

    def export_slices(self, rids) -> dict:
        """BATCHED migration export — the router's one-export-per-
        worker-per-tick call (N finished-prefill slots ride one round
        trip instead of N). {rid: slice-or-None}, each entry exactly
        ``export_slice(rid)``; a pure read like its singular twin."""
        return {int(r): self.engine.export_slice(int(r))
                for r in rids}

    def import_slices(self, slices) -> int:
        """BATCHED migration import: every slice journals and lands
        exactly as one ``import_slice`` — the journal record stream
        (and therefore crash replay) is IDENTICAL to N singleton
        imports, so batching changes round trips, never durability
        semantics. Returns total new blocks written."""
        return sum(self.import_slice(s) for s in slices)

    def set_tenant(self, tenant_id: str, **cfg):
        """Journaled tenant registration/reconfiguration: the record
        replays after a crash, so quotas/weights/floors changed
        between snapshots survive recovery (construction-time
        ``tenants=`` config rides snapshot 0 instead)."""
        self._flush_drains()
        cfg = _to_host(dict(cfg))
        self.journal.append("set_tenant", {"tenant_id": str(tenant_id),
                                           "cfg": dict(cfg)})
        return self.engine.set_tenant(tenant_id, **cfg)

    def tenant_stats(self):
        return self.engine.tenant_stats

    def tenant_report(self):
        return self.engine.tenant_report()

    def tokens(self, rid: int) -> List[int]:
        return self.engine.tokens(rid)

    def generated(self, rid: int) -> List[int]:
        return self.engine.generated(rid)

    def check_invariants(self) -> bool:
        return self.engine.check_invariants()

    def close(self) -> None:
        """Clean shutdown: flush pending drain records and close the
        journal fd. IDEMPOTENT — a second close is a no-op (the flush
        ran once, the fd was released once), so teardown paths that
        cannot know whether the server was already retired (a router's
        worker harness, test fixtures) may call it unconditionally.
        An incarnation abandoned after an ``EngineCrash`` does not
        need this — its handle is released when the object is
        collected — but a host that cycles through many servers in
        one process should close each one it retires."""
        if self._closed:
            return
        self._closed = True
        self._flush_drains()
        self.journal.close()

    # -- recovery -----------------------------------------------------
    @classmethod
    def recover(cls, target, draft=None, *, journal_path: str,
                snapshot_path: str, injector=None, collector=None,
                monitor=None, ledger=None, sync: bool = False,
                compact_journal: bool = True,
                num_blocks: Optional[int] = None) -> "RecoverableServer":
        """Rebuild a server after a crash: restore the last snapshot,
        then deterministically replay the journal suffix. Crash points
        are disarmed for the whole replay (the recorded rounds already
        happened; re-dying inside them would loop forever) while fault
        schedules stay live on the restored step clock, so a replayed
        step re-injects exactly the faults the live step saw. Each
        replayed round's emissions are checked against the journal
        record — divergence is a hard ``RecoveryError``. ``num_blocks``
        rehomes the pool during recovery (restore-into-a-different-
        pool); it only composes with ``k=0`` engines, whose draft side
        is absent.

        ``collector`` (TraceCollector) is wired onto the restored
        engine and flipped to REPLAY mode for the journal replay, the
        exact mirror of the injector's ``arm(False)``: replayed rounds'
        timeline spans record flagged ``replay: True`` and request
        records the dead incarnation already observed stay frozen —
        tracing a recovery neither diverges the replay nor
        double-counts a span or a latency. Snapshots carry no
        collector state (telemetry is observational; its wall-clock
        stamps must never enter engine-behavioral state).

        ``monitor`` (HealthMonitor) rides the same bracket: monitor
        state is DERIVED, never snapshotted — a fresh monitor rebuilds
        its series by resampling the replayed steps (alerts re-derived
        there are flagged ``replayed`` and kept out of the live
        counts), while a monitor that lived through the crash keeps
        its live samples frozen and nothing double-counts."""
        snap = load_snapshot(snapshot_path)
        if snap.get("kind") != "recoverable_server":
            raise SnapshotVersionError(
                f"{snapshot_path!r} holds a {snap.get('kind')!r} "
                f"snapshot, not a recoverable_server one")
        eng_snap = snap["engine"]
        if num_blocks is not None:
            eng = SpeculativeEngine.restore(
                target, draft, _resize_engine_snap(eng_snap,
                                                   num_blocks),
                injector=injector, collector=collector,
                monitor=monitor, ledger=ledger)
        else:
            eng = SpeculativeEngine.restore(target, draft, eng_snap,
                                            injector=injector,
                                            collector=collector,
                                            monitor=monitor,
                                            ledger=ledger)
        srv = cls(eng, journal_path=journal_path,
                  snapshot_path=snapshot_path, sync=sync,
                  compact_journal=compact_journal,
                  snapshot_every=snap["snapshot_every"], _fresh=False)
        # scan READ-ONLY first: the lineage check must reject a
        # foreign journal before RequestJournal's open truncates its
        # (possibly live) torn tail
        records, valid = _scan_journal(journal_path)
        last_seq = records[-1][0] if records else 0
        if last_seq < snap["journal_seq"]:
            # the snapshot was taken AFTER journal seq N; a journal
            # ending short of N is not this snapshot's journal (wrong
            # path, lost file, stale backup). Proceeding would hand
            # out seqs <= N that the NEXT recovery silently skips —
            # every post-recovery request would vanish
            raise RecoveryError(
                f"journal {journal_path!r} ends at seq {last_seq} "
                f"but the snapshot covers seq {snap['journal_seq']} — "
                f"the journal does not belong to this snapshot "
                f"lineage")
        journal = RequestJournal(journal_path, fresh=False, sync=sync,
                                 _scanned=(records, valid))
        srv.journal = journal
        journal.startup_records = []        # `records` is held here
        srv.rounds = snap["rounds"]
        srv._delivered = set(snap["delivered"])
        # the durability gauges resume from the RECOVERED lineage: lag
        # counts from the snapshot being restored, age from the
        # restored step clock — exactly what a live server that just
        # snapshotted would report
        srv._snap_seq = snap["journal_seq"]
        srv._snap_step = srv._engine_step()
        if injector is not None:
            injector.arm(False)
        if collector is not None:
            collector.set_replay(True)
        if monitor is not None:
            monitor.set_replay(True)
        if ledger is not None:
            # same bracket as the collector/monitor: records the dead
            # incarnation observed live freeze; replay-born records
            # (and replayed steps a fresh ledger never saw) accumulate
            ledger.set_replay(True)
        ok = False
        try:
            for seq, kind, payload in records:
                if kind == "outcomes":
                    # delivered-ness is global, not suffix-local: an
                    # outcome drained after the snapshot must not
                    # re-deliver either
                    srv._delivered.update(
                        rid for rid, _ in payload["rids"])
                if seq <= snap["journal_seq"]:
                    continue
                if kind == "submit":
                    try:
                        eng.submit(payload["tokens"], **payload["kw"])
                    except (ValueError, TypeError, KeyError):
                        # the live call raised this SAME error (all
                        # submit validation fires before any engine
                        # mutation, deterministically), the caller saw
                        # it, and the engine was left untouched — so
                        # the record is a no-op on replay too. A good
                        # submit wrongly skipped here cannot slip
                        # through: the next round record's emission
                        # check would diverge.
                        pass
                elif kind == "round":
                    got = {int(r): [int(t) for t in toks]
                           for r, toks in eng.step().items()}
                    if got != payload["emitted"]:
                        raise RecoveryError(
                            f"replay of journal record {seq} "
                            f"diverged: engine emitted {got}, journal "
                            f"recorded {payload['emitted']}")
                    srv.rounds += 1
                    srv.replayed_rounds += 1
                    srv.replayed_tokens += sum(
                        len(t) for t in got.values())
                elif kind == "release":
                    try:
                        eng.release(payload["rid"])
                    except KeyError:
                        # unknown rid: raised live before any
                        # mutation, same determinism argument as the
                        # submit case above
                        pass
                elif kind == "cancel":
                    # deterministic bool return, never raises: an
                    # unknown/terminal rid was a no-op live and is a
                    # no-op here
                    eng.cancel(payload["rid"])
                elif kind == "set_tenant":
                    try:
                        eng.set_tenant(payload["tenant_id"],
                                       **payload["cfg"])
                    except ValueError:
                        # refused live (quota below charge, floors
                        # over pool) before any mutation: no-op on
                        # replay too
                        pass
                elif kind == "import_slice":
                    # re-adopt the migrated pages the live call
                    # imported: replayed admissions then adopt the
                    # same prefix the live ones did. A ValueError
                    # (geometry mismatch) was raised live before any
                    # mutation — same no-op argument as submit.
                    try:
                        eng.import_slice(payload["slice"])
                    except ValueError:
                        pass
                elif kind == "compact":
                    # a compaction marker reuses the covered seq, so
                    # the seq-gate above already skips it; belt and
                    # braces for a marker that somehow outran its
                    # snapshot
                    pass
            ok = True
        finally:
            if injector is not None:
                injector.arm(True)
            if collector is not None:
                collector.set_replay(False)
            if monitor is not None:
                monitor.set_replay(False)
            if ledger is not None:
                ledger.set_replay(False)
            if not ok:
                # a failed replay (RecoveryError divergence) abandons
                # this half-built server: release its journal append
                # handle so the caller can retry recovery — or point a
                # doctor at the files — without a leaked fd holding
                # the journal open
                journal.close()
        # outcomes regenerated by the replay that were already drained
        # pre-crash: drop them here, exactly-once stands
        eng.outcomes[:] = [oc for oc in eng.outcomes
                           if oc.rid not in srv._delivered]
        eng.check_invariants()
        return srv


def _resize_engine_snap(spec_snap: dict, num_blocks: int) -> dict:
    """Clone a SpeculativeEngine snapshot with the TARGET pool resized
    (restore-into-a-different-pool): the engine config's num_blocks is
    rewritten so the rebuilt engine owns the new budget, and the cache
    snapshot rehoming happens inside PagedKVCache.restore."""
    import copy
    out = copy.copy(spec_snap)
    out["engine"] = copy.copy(spec_snap["engine"])
    out["engine"]["config"] = dict(spec_snap["engine"]["config"],
                                   num_blocks=int(num_blocks))
    return out
