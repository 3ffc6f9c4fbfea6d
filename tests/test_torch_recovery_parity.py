"""The port's recovery host held against the JAX package on the CPU: the
snapshot, journal and frame formats are byte-identical; on the same
traffic both packages journal the same records and snapshot the same
state; a server crashed in either package recovers in the other from its
files and ends with the uninterrupted run's streams, every terminal
outcome delivered exactly once. The JAX side runs op by op and its
uninterrupted run is computed once for the module. (The ledger's rows
of a speculative run are in test_torch_spec_obs_parity.py.)"""
import numpy as np
import pytest

import paddle_tpu.inference as J
import paddle_tpu_torch.inference as P
from paddle_tpu.inference import recovery as j_rec
from paddle_tpu_torch.inference import recovery as p_rec
from tests.test_torch_obs_parity import _prompts
from tests.torch_twins import (EMBED, assert_snapshots_match, jax_model,
                               op_by_op, port_model)
from tests.torch_twins import shared_jax_cache  # noqa: F401

GEOMETRY = dict(k=0, max_batch=2, block_size=4, num_blocks=12,
                max_blocks_per_seq=8)
N_GEN = 8
CRASHES = {3: "post_journal", 5: "pre_journal", 8: "post_admission",
           11: "begin"}
_CRASH = (J.EngineCrash, P.EngineCrash)


@pytest.fixture(scope="module")
def tsms():
    """{package: TokenServingModel} over the same weights; the JAX side
    runs op by op for the module."""
    with op_by_op():
        jcore = jax_model()
        yield {J: J.TokenServingModel(jcore, EMBED),
               P: P.TokenServingModel(port_model(jcore), EMBED)}


PAYLOADS = {
    "arrays": {"arr": np.arange(12, dtype=np.float32).reshape(3, 4),
               "i8": np.array([-3, 7], np.int8), "hash": b"\x00\xffchain",
               "n": 7, "scalar": np.float32(0.5)},
    "records": {"kind": "recoverable_server", "journal_seq": 3,
                "delivered": [1, 2], "nested": [(1, "a"), {"k": None}]},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_file_formats_are_byte_identical(tmp_path, name):
    """The same payload gives the same snapshot bytes, journal bytes and
    frames in both packages, and each package loads the other's
    files."""
    payload = PAYLOADS[name]
    assert (p_rec.SNAPSHOT_MAGIC, p_rec.SNAPSHOT_VERSION,
            p_rec._SNAP_HDR.format, p_rec.FRAME_HEADER_SIZE) == \
        (j_rec.SNAPSHOT_MAGIC, j_rec.SNAPSHOT_VERSION,
         j_rec._SNAP_HDR.format, j_rec.FRAME_HEADER_SIZE)
    blobs = {}
    for tag, mod in (("jax", j_rec), ("port", p_rec)):
        sp, jp = str(tmp_path / f"{tag}.ckpt"), str(tmp_path / f"{tag}.wal")
        n = mod.save_snapshot(sp, payload)
        j = mod.RequestJournal(jp, fresh=True)
        j.append("submit", {"tokens": [1, 2, 3], "kw": {}})
        j.append("blob", payload)
        j.close()
        with open(sp, "rb") as f, open(jp, "rb") as g:
            blobs[tag] = (f.read(), g.read(), mod.frame_message(payload))
        assert n == len(blobs[tag][0])
    assert blobs["port"] == blobs["jax"]
    for load_mod, tag in ((p_rec, "jax"), (j_rec, "port")):
        got = load_mod.load_snapshot(str(tmp_path / f"{tag}.ckpt"))
        assert_snapshots_match(got, payload)
        recs = load_mod.read_journal(str(tmp_path / f"{tag}.wal"))
        assert [(s, k) for s, k, _ in recs] == [(1, "submit"),
                                                (2, "blob")]
    head, body = blobs["jax"][2][:8], blobs["jax"][2][8:]
    assert p_rec.frame_body_size(head) == len(body)
    assert_snapshots_match(p_rec.unframe_message(head, body), payload)


def test_port_payloads_refuse_torch_objects(tmp_path):
    """The allowlist is the reference's: a torch tensor in a payload
    fails to load (both packages), and the host converts tensors to
    numpy at the journal boundary, so a tensor prompt still journals
    loadable plain data."""
    import torch
    sp = str(tmp_path / "bad.ckpt")
    p_rec.save_snapshot(sp, {"t": torch.zeros(2)})
    for mod in (p_rec, j_rec):
        with pytest.raises(mod.SnapshotVersionError):
            mod.load_snapshot(sp)
    rec = p_rec._to_host({"a": [torch.arange(3)], "b": (torch.ones(1),)})
    assert isinstance(rec["a"][0], np.ndarray)
    assert isinstance(rec["b"], tuple) and \
        isinstance(rec["b"][0], np.ndarray)


def _serve_recoverable(tsms, order, tmp_path, crash_at, tag):
    """Serve the module's traffic through a RecoverableServer of
    ``order[0]``'s package; after each EngineCrash the NEXT package of
    ``order`` (cyclically) recovers from the files, its injector taking
    over the crash clock. Returns (streams, delivered (rid, status) in
    order, journal records, snapshot payload, recoveries)."""
    jp, sp = str(tmp_path / f"{tag}.wal"), str(tmp_path / f"{tag}.ckpt")
    injs = {inf: inf.CrashInjector(crash_at=dict(crash_at))
            for inf in order}
    cur = order[0]
    srv = cur.RecoverableServer(
        cur.SpeculativeEngine(tsms[cur], None, injector=injs[cur],
                              **GEOMETRY),
        journal_path=jp, snapshot_path=sp, snapshot_every=3, sync=True,
        compact_journal=False)
    rids = [srv.submit(p) for p in _prompts(31, 5, 6, 13)]
    done, delivered, switches = {}, [], 0
    for _ in range(200):
        live = [r for r in rids if r not in done]
        if not live:
            break
        try:
            srv.step()
            delivered += [(oc.rid, oc.status)
                          for oc in srv.drain_outcomes()]
            for r in live:
                if len(srv.generated(r)) >= N_GEN:
                    done[r] = srv.generated(r)[:N_GEN]
                    srv.release(r)
        except _CRASH:
            nxt = order[(order.index(cur) + 1) % len(order)]
            a, b = injs[cur], injs[nxt]
            b.round, b.crash_at, b.crashes = a.round, a.crash_at, a.crashes
            cur = nxt
            srv = cur.RecoverableServer.recover(
                tsms[cur], None, journal_path=jp, snapshot_path=sp,
                injector=injs[cur], sync=True, compact_journal=False)
            srv.check_invariants()
            switches += 1
    else:
        raise AssertionError("recoverable loop did not converge")
    srv.step()
    delivered += [(oc.rid, oc.status) for oc in srv.drain_outcomes()]
    srv.close()
    return (done, delivered, p_rec.read_journal(jp),
            p_rec.load_snapshot(sp), switches)


@pytest.fixture(scope="module")
def jax_run(tsms, tmp_path_factory):
    """The JAX package's uninterrupted recoverable run."""
    return _serve_recoverable(tsms, (J,), tmp_path_factory.mktemp("jax"),
                              {}, "jax")


def test_journal_and_snapshot_match_jax(tsms, jax_run, tmp_path):
    """Uninterrupted, the port journals the JAX package's records
    exactly (submits, rounds, releases, drains, seq numbers) and its
    last snapshot matches (control plane exactly, pages within HID)."""
    done, delivered, records, snap, _ = _serve_recoverable(
        tsms, (P,), tmp_path, {}, "port")
    assert done == jax_run[0]
    assert delivered == jax_run[1]
    assert records == jax_run[2]
    assert_snapshots_match(snap, jax_run[3])
    kinds = {k for _, k, _ in records}
    assert {"submit", "round", "release", "outcomes"} <= kinds


@pytest.mark.parametrize("first", ["jax", "port"])
def test_recovery_crosses_packages(tsms, jax_run, tmp_path, first):
    """Four crashes (post_journal, pre_journal, post_admission, begin),
    each recovered by the OTHER package from the files: the streams are
    the uninterrupted run's and every request's outcome is delivered
    exactly once."""
    order = (J, P) if first == "jax" else (P, J)
    done, delivered, records, _, switches = _serve_recoverable(
        tsms, order, tmp_path, CRASHES, first)
    assert switches == len(CRASHES)
    assert done == jax_run[0]
    rids = [rid for rid, _ in delivered]
    assert sorted(rids) == sorted(set(rids)) == sorted(done)
    assert all(s == "finished" for _, s in delivered)
    assert any(k == "outcomes" for _, k, _ in records)
