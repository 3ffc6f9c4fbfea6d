"""The port's fleet held against the JAX package on the CPU.

The same spec gives the same embedding, readout and chain hashes in both
packages, so placement inputs are equal. Core weights come from each
package's own PRNG, so the stream comparisons run the port's workers on
the reference weights: the port's ``build_model_from_spec`` is wrapped to
load the JAX builder's core state, which the supervisor's respawns go
through too. Then a seeded kill storm over a disaggregated fleet
(prefill and decode roles, migration, a supervisor respawning from the
workers' files, a worker whose session transport reports reconnects)
gives, tick by tick, equal placements and router stats, and at the end
equal router journal records (the spawn/rejoin and net lanes included),
outcome sequences, streams, supervisor state, fleet gauges and alerts. A
router journal either package wrote recovers in the other's
``Router.recover``, over workers of the recovering package, to what the
writer's own recovery gives. Everything compared is control plane,
compared exactly; the JAX side runs op by op (ROADMAP Queue C item 3).
The session layer's storms and the process and wire boundaries are in
tests/test_torch_fleet_wire.py.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu.inference as J
import paddle_tpu_torch.inference as P
from paddle_tpu.inference import router as j_router
from paddle_tpu_torch.inference import router as p_router
from tests.torch_twins import op_by_op
from tests.torch_twins import shared_jax_cache  # noqa: F401

VOCAB, BS, N_NEW = 50, 4, 8
BASE = dict(head_roll=1, block_size=BS, num_blocks=80,
            max_blocks_per_seq=10, snapshot_every=2)
_RNG = np.random.RandomState(31)
PROMPTS = [[int(t) for t in _RNG.randint(0, VOCAB, n)]
           for n in (6, 9, 13, 7, 11)]
PKGS = {"jax": (J, j_router), "port": (P, p_router)}


def _spec(root, name, **kw):
    return dict(BASE, journal_path=os.path.join(root, f"{name}.wal"),
                snapshot_path=os.path.join(root, f"{name}.ckpt"), **kw)


@pytest.fixture(scope="module")
def jax_state():
    """The core state the JAX builder makes for BASE, as numpy."""
    with op_by_op():
        jm = j_router.build_model_from_spec(BASE)
    return {k: np.asarray(v.numpy()) for k, v in
            jm.core.state_dict().items()}


@pytest.fixture
def packages(monkeypatch, jax_state):
    """The port's spec builder on the reference weights (respawns
    included); the JAX package op by op."""
    build = p_router.build_model_from_spec

    def on_reference_weights(spec):
        tsm = build(dict(spec, device="cpu"))
        tsm.core.load_state_dict({k: torch.from_numpy(v.copy())
                                  for k, v in jax_state.items()})
        return tsm

    monkeypatch.setattr(p_router, "build_model_from_spec",
                        on_reference_weights)
    with op_by_op():
        yield PKGS


def test_spec_gives_equal_embedding_head_and_hashes():
    """One spec, both builders: the embedding, the rolled readout and
    every chain hash are equal, so placement inputs are equal."""
    spec = dict(BASE, vocab=64, d_model=16, heads=2, ffn=32, layers=1,
                embed_seed=99, head_roll=3)
    with op_by_op():
        jm = j_router.build_model_from_spec(spec)
    pm = p_router.build_model_from_spec(dict(spec, device="cpu"))
    np.testing.assert_array_equal(pm._embed_np, np.asarray(jm._embed_np))
    np.testing.assert_array_equal(pm.lm_head.numpy(),
                                  np.asarray(jm.lm_head.numpy()))
    rng = np.random.RandomState(5)
    for n in (3, 4, 17, 40):
        toks = [int(t) for t in rng.randint(0, 64, n)]
        want = j_router.token_chain_hashes(jm, toks, BS)
        assert p_router.token_chain_hashes(pm, toks, BS) == want
        assert len(want) == n // BS
    # the core is seeded by a CPU generator: the same bits every build
    again = p_router.build_model_from_spec(dict(spec, device="cpu"))
    for a, b in zip(pm.core.state_dict().values(),
                    again.core.state_dict().values()):
        assert torch.equal(a, b)


def _flaky(cls):
    """An in-process worker whose session transport reports one
    reconnect every third round it serves (the degraded-state lane)."""
    class Flaky(cls):
        rounds = 0

        def request(self, op, payload=None, timeout=None):
            if op == "round":
                self.rounds += 1
            return super().request(op, payload, timeout)

        def net_stats(self):
            return {"reconnects": self.rounds // 3, "sessions": 1}
    return Flaky


def _records(wal):
    return [(k, p) for _, k, p in J.read_journal(wal)]


def _storm_fleet(pkg, root, storm_seed):
    """A disaggregated fleet (p0 prefill, d0 flaky decode, d1 decode)
    under a seeded kill storm with a supervisor; returns what the two
    packages must agree on."""
    mod, rmod = PKGS[pkg]
    names = {"p0": "prefill", "d0": "decode", "d1": "decode"}
    specs = {n: _spec(root, n) for n in names}
    workers = [(_flaky(mod.InProcWorker) if n == "d0" else
                mod.InProcWorker)(specs[n], name=n, role=role)
               for n, role in names.items()]
    model = workers[0].worker.server.engine.target
    inj = mod.RouterFaultInjector.kill_storm(
        storm_seed, 10, list(names), kills=2, hangs=1,
        points=("before_round", "after_round", "submit", "scrape"))
    wal = os.path.join(root, "router.wal")
    r = mod.Router(workers, hash_fn=lambda t: rmod.token_chain_hashes(
        model, t, BS), injector=inj, journal_path=wal, backoff_ticks=1)
    monitor = mod.HealthMonitor()
    sup = mod.FleetSupervisor(r, specs, monitor=monitor)
    rids = [r.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    ticks, outcomes = [], []
    for _ in range(60):
        r.step()
        sup.tick()
        outcomes += [o.as_dict() for o in r.drain_outcomes()]
        ticks.append(({rid: (q.worker, q.wrid) for rid, q in
                       sorted(r._reqs.items())},
                      {n: ws.status for n, ws in r._workers.items()},
                      r.stats.as_dict()))
        if len(outcomes) == len(rids) and \
                all(ws.status == "up" for ws in r._workers.values()):
            break
    assert r.check_invariants()
    out = dict(
        ticks=ticks, outcomes=outcomes, stats=r.stats.as_dict(),
        streams=[r.generated(x) for x in rids],
        injector=inj.as_dict(), gauges=sup.registry.as_dict(),
        supervisor={k: v for k, v in sup.snapshot().items()
                    if k != "specs"},
        alerts=[(a.kind, a.step) for a in monitor.alerts])
    r.close()
    out["journal"] = _records(wal)
    return out


@pytest.mark.parametrize("storm_seed", [3, 8])
def test_kill_storm_control_plane_is_equal(packages, tmp_path,
                                           storm_seed):
    got = {}
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        os.makedirs(root)
        got[pkg] = _storm_fleet(pkg, root, storm_seed)
    j, p = got["jax"], got["port"]
    assert p["stats"]["worker_deaths"] >= 1
    assert p["stats"]["respawns"] >= 1 and p["stats"]["migrations"] >= 1
    assert p["stats"]["degraded_transitions"] >= 1
    kinds = {k for k, _ in p["journal"]}
    assert {"respawn", "net", "emit", "tick", "delivered"} <= kinds
    assert len(p["outcomes"]) == len(PROMPTS)
    assert sorted(o["rid"] for o in p["outcomes"]) == \
        list(range(len(PROMPTS)))
    for key in ("ticks", "stats", "outcomes", "streams", "journal",
                "injector", "gauges", "supervisor", "alerts"):
        assert p[key] == j[key], key


def _cold_fleet(pkg, root, tag):
    mod = PKGS[pkg][0]
    return [mod.InProcWorker(_spec(root, f"{tag}{i}"), name=f"w{i}")
            for i in range(2)]


def _recover_and_drive(pkg, root, wal, tag):
    mod, rmod = PKGS[pkg]
    workers = _cold_fleet(pkg, root, tag)
    model = workers[0].worker.server.engine.target
    r = mod.Router.recover(workers, journal_path=wal,
                           hash_fn=lambda t: rmod.token_chain_hashes(
                               model, t, BS))
    recovered = r.stats.as_dict()
    ocs = [o.as_dict() for o in r.drain_outcomes()]
    for _ in range(60):
        if len(ocs) >= len(PROMPTS):
            break
        r.step()
        ocs += [o.as_dict() for o in r.drain_outcomes()]
    out = dict(recovered=recovered, outcomes=ocs, stats=r.stats.as_dict(),
               streams=[r.generated(x) for x in range(len(PROMPTS))])
    r.close()
    out["journal"] = _records(wal)
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_router_journal_recovers_in_the_other_package(
        packages, tmp_path, writer, reader):
    """The writer's router serves half the traffic (one worker killed,
    one verdict drained and journaled) and dies without closing; its WAL
    recovers in the reader package over the reader's own cold workers
    exactly as the writer's own recovery of the same WAL does."""
    mod, rmod = PKGS[writer]
    root = str(tmp_path / "w")
    os.makedirs(root)
    workers = _cold_fleet(writer, root, "live")
    model = workers[0].worker.server.engine.target
    wal = os.path.join(root, "router.wal")
    inj = mod.RouterFaultInjector(kill_at={3: {"w0": "before_round"}},
                                  seed=1)
    r = mod.Router(workers, hash_fn=lambda t: rmod.token_chain_hashes(
        model, t, BS), injector=inj, journal_path=wal, backoff_ticks=1)
    rids = [r.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    drained = []
    for _ in range(40):
        r.step()
        drained += r.drain_outcomes()
        if len(drained) >= 2:
            break
    r.step()                      # journals the drain record
    assert 1 <= len(drained) < len(rids) and r.stats.worker_deaths == 1
    r.journal.close()             # the process dies; files stay
    got = {}
    for pkg in (writer, reader):
        d = str(tmp_path / f"r_{pkg}")
        os.makedirs(d)
        shutil.copy(wal, os.path.join(d, "router.wal"))
        got[pkg] = _recover_and_drive(pkg, d,
                                      os.path.join(d, "router.wal"), "c")
    a, b = got[writer], got[reader]
    assert b == a
    assert sorted(o["rid"] for o in b["outcomes"]) == sorted(
        set(rids) - {o.rid for o in drained})
    assert all(o["status"] == "finished" for o in b["outcomes"])
