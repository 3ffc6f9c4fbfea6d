"""Seeded fault storms through the port's serving engines, held against
the JAX package on the CPU: twins of tests/test_resilience.py's
``TestFaultStormBitIdentity`` and ``TestDraftPoolOOM`` at its sizes.

Under a schedule of forced OOMs (sheds) and NaN plantings no exception
leaves ``step()``, the audits hold after every step, every failure has
the right terminal outcome, the port's outcome sequence EQUALS the JAX
engine's under the same schedule (computed once per module), and every
survivor's stream is bit-identical to the port's own fault-free run."""
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

N_GEN = 18
STORM = dict(seed=11, oom_at=[5, 11, 17, 23], nan_at={3: [1], 8: [3]})
SPEC_STORM = dict(seed=13, oom_at=[3, 5, 7], nan_at={2: [0], 9: [1]},
                  draft_oom_at={10: JaxFI.ALL}, draft_nan_at={2: [2]})


@pytest.fixture(scope="module")
def cores():
    jcore = jax_model()
    return jcore, port_model(jcore)


def _prompts():
    # distinct content, identical length: every slot crosses page
    # boundaries on the same steps, so a whole-step forced OOM finds the
    # oldest slot allocating (the shed condition)
    rng = np.random.RandomState(11)
    return [rng.randn(12, D).astype(np.float32) for _ in range(8)]


def _kw(prefix):
    return dict(max_batch=4, block_size=4, num_blocks=48,
                max_blocks_per_seq=10, prefix_cache=prefix)


def _work():
    return [(p, None) for p in _prompts()], {i: N_GEN for i in range(8)}


@pytest.fixture(scope="module")
def jax_storm_logs(cores):
    """The JAX engine's outcome sequence under the paged storm, per
    prefix-cache setting (computed once)."""
    work, targets = _work()
    return {prefix: drive(lambda: JaxPSE(cores[0],
                                         injector=JaxFI(**STORM),
                                         **_kw(prefix)),
                          work, targets)[4]
            for prefix in (False, True)}


@pytest.mark.parametrize("prefix", [False, True])
def test_paged_engine_storm(cores, jax_storm_logs, prefix):
    """>= 3 forced-OOM sheds and >= 2 NaN-failed slots: survivors
    bit-identical to the fault-free run, the outcome sequence the JAX
    engine's, audits after every step, nothing raised."""
    work, targets = _work()
    base, base_oc, _, _, _ = drive(
        lambda: PagedServingEngine(cores[1], **_kw(prefix)), work, targets)
    inj = FaultInjector(**STORM)
    storm, oc, _, eng, log = drive(
        lambda: PagedServingEngine(cores[1], injector=inj, **_kw(prefix)),
        work, targets, audit=True)
    assert log == jax_storm_logs[prefix]
    st = eng.resilience_stats
    assert st.shed >= 3 and st.nan_failed >= 2
    assert inj.injected_oom >= 3 and st.audits > 0
    assert all(o.status == RequestOutcome.FINISHED
               for o in base_oc.values())
    survivors = 0
    for rid, stream in base.items():
        o = oc.get(rid)
        if o is not None and o.failed:
            assert o.status in (RequestOutcome.FAILED_OOM,
                                RequestOutcome.FAILED_NUMERIC)
            got = storm.get(rid, [])
            assert got == stream[:len(got)]
        else:
            survivors += 1
            assert storm[rid] == stream, f"survivor {rid} diverged"
    assert survivors >= 2


def _spec_run(make, prompts, n_gen=12):
    """tests/test_resilience.py's speculative driver: serve until every
    request has n_gen tokens or failed; returns (done streams, failed
    outcomes, engine, outcome log)."""
    e = make()
    rids = [e.submit(p) for p in prompts]
    done, failed, log = {}, {}, []
    for _ in range(200):
        live = [r for r in rids if r not in done and r not in failed]
        if not live:
            break
        e.step()
        if e.injector is not None:
            e.check_invariants()
        for oc in e.outcomes:
            log.append(oc.as_dict())
            if oc.failed:
                failed[oc.rid] = oc
        e.outcomes.clear()
        for r in live:
            if r not in failed and len(e.generated(r)) >= n_gen:
                done[r] = e.generated(r)[:n_gen]
                e.release(r)
    else:
        raise AssertionError("speculative driver stalled")
    return done, failed, e, log


def _spec_prompts(seed, n, length):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, VOCAB, length)) for _ in range(n)]


def test_speculative_storm(cores):
    """Target-pool sheds, verify-step NaNs, a draft-pool OOM and draft
    logit corruption in one run through SpeculativeEngine.step: the
    outcome sequence the JAX engine's, survivors bit-identical to the
    fault-free speculative run."""
    prompts = _spec_prompts(12, 6, 9)
    kw = dict(k=2, max_batch=3, block_size=1, num_blocks=100,
              max_blocks_per_seq=32, prefix_cache=True)
    jtsm = JaxTSM(cores[0], EMBED)
    tsm = TokenServingModel(cores[1], EMBED)
    _, _, _, jlog = _spec_run(
        lambda: JaxSpec(jtsm, None, injector=JaxFI(**SPEC_STORM), **kw),
        prompts)
    base, base_failed, _, _ = _spec_run(
        lambda: SpeculativeEngine(tsm, None, **kw), prompts)
    assert not base_failed and len(base) == len(prompts)
    inj = FaultInjector(**SPEC_STORM)
    storm, failed, e, log = _spec_run(
        lambda: SpeculativeEngine(tsm, None, injector=inj, **kw), prompts)
    assert log == jlog
    st = e.resilience_stats
    assert st.shed >= 3 and st.nan_failed >= 2
    assert inj.injected_draft_oom >= 1 and inj.injected_draft_nan >= 1
    for oc in failed.values():
        assert oc.status in (RequestOutcome.FAILED_OOM,
                             RequestOutcome.FAILED_NUMERIC)
    survivors = [r for r in base if r not in failed]
    assert survivors
    for r in survivors:
        assert storm[r] == base[r], f"speculative survivor {r} diverged"


def test_mid_roll_draft_oom_rolls_back_cleanly(cores):
    """An injected draft-pool OOM mid-roll rolls the partial roll back
    page-wise: the target pool is untouched (no preemption, no shed),
    both pools' audits hold, the stream is the fault-free one, and the
    draft rebuilds (speculation resumes) — as in the JAX engine, whose
    draft stats match."""
    prompts = _spec_prompts(14, 1, 7) + _spec_prompts(15, 1, 9)
    kw = dict(k=3, max_batch=2, block_size=4, num_blocks=40,
              max_blocks_per_seq=10)

    def run(make):
        e = make()
        rids = [e.submit(p) for p in prompts]
        for _ in range(60):
            e.step()
            e.check_invariants()
            if all(len(e.generated(r)) >= 10 for r in rids):
                break
        return {r: e.generated(r)[:10] for r in rids}, e

    tsm = TokenServingModel(cores[1], EMBED)
    base, _ = run(lambda: SpeculativeEngine(tsm, None, **kw))
    inj = FaultInjector(draft_oom_at={2: FaultInjector.ALL})
    storm, e = run(lambda: SpeculativeEngine(tsm, None, injector=inj,
                                             **kw))
    jinj = JaxFI(draft_oom_at={2: JaxFI.ALL})
    _, je = run(lambda: JaxSpec(JaxTSM(cores[0], EMBED), None,
                                injector=jinj, **kw))
    assert inj.injected_draft_oom >= 1
    assert inj.as_dict() == jinj.as_dict()
    assert e.stats.draft_oom_rolls >= 1
    assert e.stats.as_dict() == je.stats.as_dict()
    assert e.resilience_stats.shed == 0
    assert e.resilience_stats.nan_failed == 0
    assert all(not oc.failed for oc in e.outcomes)
    assert storm == base
    assert not e._draft_dirty
    assert e.stats.proposed > 0
