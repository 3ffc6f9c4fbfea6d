"""The noisy-neighbor storm through the port's tenant layer, held against
the JAX package on the CPU: twins of tests/test_tenants.py's
``TestNoisyNeighborStorm`` (the plain and prefix-cache storm and its
composition with speculative serving; the crash-recovery composition
waits for the recovery host) at its sizes.

One tenant floods prompts and takes injected faults while two tenants
with reserved floors serve: the victims' streams are bit-identical to
their solo run, every failure is the flooder's, the flooder stays
inside its quota (audited against the tables after every step), and
the port's outcome sequence EQUALS the JAX engine's under the same
traffic and schedule (the JAX side computed once per module)."""
import numpy as np
import pytest

from paddle_tpu.inference import FaultInjector as JaxFI
from paddle_tpu.inference import PagedServingEngine as JaxPSE
from paddle_tpu.inference import SpeculativeEngine as JaxSpec
from paddle_tpu.inference import TokenServingModel as JaxTSM
from paddle_tpu_torch.inference import (FaultInjector, PagedServingEngine,
                                        RequestOutcome, SpeculativeEngine,
                                        TokenServingModel)
from tests.torch_twins import (D, EMBED, VOCAB, drive, jax_model,
                               port_model)
from tests.torch_twins import shared_jax_cache  # noqa: F401

# 22 generated + 10 prompt tokens fill the victims' 8-block floors; the
# flooder's quota of 6 blocks caps it at 24 held tokens
N_GEN = 22
STORM = dict(seed=21, oom_at=[4], nan_at={3: [2]})


@pytest.fixture(scope="module")
def cores():
    jcore = jax_model()
    return jcore, port_model(jcore)


def _prompt(rng, n):
    return np.asarray(rng.randn(n, D), np.float32)


def _victims():
    rng = np.random.RandomState(21)
    return [(_prompt(rng, 10), "v1"), (_prompt(rng, 10), "v2")]


def _noisy_work():
    rng = np.random.RandomState(22)
    flood = [(_prompt(rng, 12), "flood") for _ in range(5)]
    # the last flood prompt needs 9 blocks > the quota of 6: rejected at
    # submit
    big = [(_prompt(np.random.RandomState(23), 34), "flood")]
    return _victims() + flood + big


def _kw(prefix):
    return dict(max_batch=4, block_size=4, num_blocks=40,
                max_blocks_per_seq=10, prefix_cache=prefix,
                tenants={"v1": {"reserved_blocks": 8},
                         "v2": {"reserved_blocks": 8},
                         "flood": {"quota_blocks": 6}})


TARGETS = {0: N_GEN, 1: N_GEN}


@pytest.fixture(scope="module")
def jax_noisy(cores):
    """The JAX engine's outcome sequence and tenant stats under the
    noisy storm, per prefix-cache setting (computed once)."""
    out = {}
    for prefix in (False, True):
        _, _, _, eng, log = drive(
            lambda: JaxPSE(cores[0], injector=JaxFI(**STORM),
                           **_kw(prefix)),
            _noisy_work(), TARGETS)
        out[prefix] = (log, {t: s.as_dict()
                             for t, s in eng.tenant_stats.items()})
    return out


@pytest.mark.parametrize("prefix", [False, True])
def test_noisy_neighbor_storm(cores, jax_noisy, prefix):
    """Flooding tenant plus injected whole-step OOM and NaN aimed at
    its steps: victims bit-identical to their solo run; REJECTED and
    shed outcomes correct, attributed, and the JAX engine's; deep
    audits (the charge against the tables included) every step."""
    tcore = cores[1]
    solo, solo_oc, solo_rids, _, _ = drive(
        lambda: PagedServingEngine(tcore, **_kw(prefix)), _victims(),
        TARGETS, audit=True)
    assert all(not oc.failed for oc in solo_oc.values())
    inj = FaultInjector(**STORM)
    streams, outcomes, rids, eng, log = drive(
        lambda: PagedServingEngine(tcore, injector=inj, **_kw(prefix)),
        _noisy_work(), TARGETS, audit=True)
    jlog, jstats = jax_noisy[prefix]
    assert log == jlog
    assert {t: s.as_dict() for t, s in eng.tenant_stats.items()} == jstats
    flood_rids = set(rids[2:])
    for i in (0, 1):
        oc = outcomes.get(rids[i])
        assert oc is None or not oc.failed
        assert streams[rids[i]] == solo[solo_rids[i]]
    for rid, oc in outcomes.items():
        if oc.failed:
            assert rid in flood_rids, f"non-flood request {rid} failed"
    ts = eng.tenant_stats
    assert ts["v1"].failed == 0 and ts["v2"].failed == 0
    assert ts["flood"].failed >= 3 and ts["flood"].quota_hits >= 1
    assert eng.cache.tenant_charge("flood") <= 6
    assert ts["v1"].tokens_served > 0 and ts["flood"].blocks_held <= 6
    assert inj.injected_oom >= 1 and inj.injected_nan >= 1
    nan_failed = [r for r, oc in outcomes.items()
                  if oc.status == RequestOutcome.FAILED_NUMERIC]
    assert nan_failed and set(nan_failed) <= flood_rids
    rejected = [r for r, oc in outcomes.items()
                if oc.status == RequestOutcome.REJECTED_ADMISSION]
    assert rejected == [rids[-1]]
    assert eng.resilience_stats.rejected == 1
    assert any(oc.status == RequestOutcome.FAILED_OOM
               and "quota" in oc.reason for oc in outcomes.values())


def test_noisy_neighbor_composes_with_speculative(cores):
    """The same containment through SpeculativeEngine.step: the
    victims' token streams equal their solo speculative run while a
    quota'd tenant floods, the flooder stays in its quota, and the
    tenant stats are the JAX engine's."""
    rng = np.random.default_rng(24)
    v_prompts = [list(rng.integers(0, VOCAB, 9)) for _ in range(2)]
    f_prompts = [list(rng.integers(0, VOCAB, 9)) for _ in range(4)]
    kw = dict(k=2, max_batch=3, block_size=1, num_blocks=120,
              max_blocks_per_seq=40,
              tenants={"v1": {"reserved_blocks": 25},
                       "v2": {"reserved_blocks": 25},
                       "flood": {"quota_blocks": 14}})

    def run(make, flood):
        e = make()
        vids = [e.submit(p, tenant_id=t)
                for p, t in zip(v_prompts, ("v1", "v2"))]
        if flood:
            for p in f_prompts:
                e.submit(p, tenant_id="flood")
        done, log = {}, []
        for _ in range(200):
            if all(r in done for r in vids):
                break
            e.step()
            e.check_invariants()
            log += [o.as_dict() for o in e.outcomes]
            e.outcomes.clear()
            for r in vids:
                if r not in done and len(e.generated(r)) >= 12:
                    done[r] = e.generated(r)[:12]
                    e.release(r)
        else:
            raise AssertionError("speculative tenant driver stalled")
        return [done[r] for r in vids], e, log

    tsm = TokenServingModel(cores[1], EMBED)
    solo, _, _ = run(lambda: SpeculativeEngine(tsm, None, **kw), False)
    noisy, e, log = run(lambda: SpeculativeEngine(tsm, None, **kw), True)
    _, je, jlog = run(lambda: JaxSpec(JaxTSM(cores[0], EMBED), None, **kw),
                      True)
    assert noisy == solo
    assert log == jlog
    ts = e.tenant_stats
    assert {t: s.as_dict() for t, s in ts.items()} == \
        {t: s.as_dict() for t, s in je.tenant_stats.items()}
    assert ts["v1"].failed == 0 and ts["v2"].failed == 0
    assert ts["flood"].quota_hits >= 1
    assert e.engine.cache.tenant_charge("flood") <= 14
