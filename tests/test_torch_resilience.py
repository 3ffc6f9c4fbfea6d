"""The port's resilience layer (paddle_tpu_torch/inference/resilience.py
and the failure isolation in scheduler.py / paged_cache.py) held against
the JAX package on the CPU: twins of tests/test_resilience.py's
host-side tests at its sizes (d 32, 4 heads, 2 layers). The fault storms
are in test_torch_storms.py.

Each twin runs the reference test's scenario on the port and asserts
what the reference asserts; where a run produces terminal outcomes, the
port's outcome sequence (rid, status, reason, tokens, preemptions, step)
must EQUAL the JAX engine's on the same traffic and schedule, and
survivors' streams equal the port's own fault-free run bitwise."""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import FaultInjector as JaxFI
from paddle_tpu.inference import PagedKVCache as JaxKV
from paddle_tpu.inference import PagedServingEngine as JaxPSE
from paddle_tpu.inference import RequestOutcome as JaxRO
from paddle_tpu_torch.inference import (BlockOOM, FaultInjector,
                                        PagedKVCache, PagedServingEngine,
                                        RequestOutcome, ResilienceStats)
from tests.torch_twins import (D, HEADS, LAYERS, drive, jax_model,
                               port_model, to_jax, to_port, tok_of)
from tests.torch_twins import shared_jax_cache  # noqa: F401


@pytest.fixture(scope="module")
def cores():
    jcore = jax_model()
    return jcore, port_model(jcore)


def _prompts(seed, *lens):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, D).astype(np.float32) for n in lens]


def _both(cores, prompts, n_gen, injectors=(None, None), audit=True,
          **kw):
    """The same traffic through both packages' engines; returns the
    port's (streams, outcomes, engine) and asserts the two outcome
    sequences equal."""
    jcore, tcore = cores
    work = [(p, None) for p in prompts]
    targets = {i: n_gen for i in range(len(prompts))}
    js, joc, _, _, jlog = drive(
        lambda: JaxPSE(jcore, injector=injectors[0], **kw), work,
        targets)
    ts, toc, _, te, tlog = drive(
        lambda: PagedServingEngine(tcore, injector=injectors[1], **kw),
        work, targets, audit=audit)
    assert tlog == jlog
    return ts, toc, te


class TestRequestOutcome:
    def test_statuses_and_dict(self):
        oc = RequestOutcome(3, RequestOutcome.FAILED_OOM,
                            reason="pool exhausted", tokens=17,
                            preemptions=2, step=9)
        assert oc.failed and oc.as_dict()["status"] == "failed_oom"
        assert oc.as_dict() == JaxRO(3, JaxRO.FAILED_OOM,
                                     reason="pool exhausted", tokens=17,
                                     preemptions=2, step=9).as_dict()
        assert not RequestOutcome(0, RequestOutcome.FINISHED).failed
        assert RequestOutcome.STATUSES == JaxRO.STATUSES
        with pytest.raises(ValueError):
            RequestOutcome(0, "exploded")

    def test_resilience_stats_surface(self):
        st = ResilienceStats()
        assert st.failed == 0
        st.shed, st.nan_failed, st.deadline_failed = 2, 1, 1
        d = st.as_dict()
        assert d["failed"] == 4 and "retried" in d and "audits" in d


class TestFaultInjector:
    def test_oom_schedule_counts_and_all(self):
        inj = FaultInjector(oom_at={3: 2}, draft_oom_at=[5])
        inj.begin_step(2)
        inj.on_alloc("target")              # not scheduled: silent
        inj.begin_step(3)
        for _ in range(2):
            with pytest.raises(BlockOOM, match="injected fault"):
                inj.on_alloc("target")
        inj.on_alloc("target")              # budget of 2 consumed
        assert inj.injected_oom == 2
        inj.begin_step(5)
        for _ in range(4):                  # list form = every alloc
            with pytest.raises(BlockOOM, match="draft-pool") as ei:
                inj.on_alloc("draft")
        assert ei.value.details == {"injected": True, "pool": "draft",
                                    "step": 5}
        assert inj.injected_draft_oom == 4
        assert inj.as_dict() == dict(seed=0, step=5, injected_oom=2,
                                     injected_draft_oom=4,
                                     injected_nan=0, injected_draft_nan=0)

    def test_nan_corruption_preserves_other_rows_bitwise(self):
        inj = FaultInjector(nan_at={1: [1]})
        inj.begin_step(1)
        x = torch.from_numpy(np.random.RandomState(0)
                             .randn(3, 2, D).astype(np.float32))
        before = x.clone()
        out = inj.corrupt_hidden(x)
        assert torch.isnan(out[1]).all()
        assert torch.equal(out[0], before[0])
        assert torch.equal(out[2], before[2])
        assert torch.equal(x, before)       # the input is not written
        assert inj.injected_nan == 1
        inj.begin_step(2)
        assert inj.corrupt_hidden(x) is x

    @pytest.mark.parametrize("seed", [7, 8, 11, 21])
    def test_storm_is_seed_deterministic(self, seed):
        """Same seed, same schedule, and the reference's schedule: both
        packages draw from np.random.RandomState."""
        a = FaultInjector.storm(seed, 40)
        b = FaultInjector.storm(seed, 40)
        ref = JaxFI.storm(seed, 40)
        assert a._oom == b._oom == ref._oom
        assert a.nan_at == b.nan_at == ref.nan_at
        assert len(a._oom["target"]) == 3 and len(a.nan_at) == 2
        c = FaultInjector.storm(seed + 1, 40)
        assert a._oom != c._oom or a.nan_at != c.nan_at


class TestActionableOOM:
    def test_oom_message_carries_occupancy_breakdown(self):
        msgs = []
        for cls, kw in ((PagedKVCache, {"device": "cpu"}), (JaxKV, {})):
            cache = cls(1, HEADS, D // HEADS, block_size=8, num_blocks=5,
                        max_seqs=2, max_blocks_per_seq=4, **kw)
            cache.ensure(0, 24)
            cache.ensure(1, 8)
            with pytest.raises(BlockOOM if cls is PagedKVCache
                               else Exception) as ei:
                cache.ensure(1, 16)
            msgs.append((str(ei.value), ei.value.details))
        msg = msgs[0][0]
        assert "4 active / 0 cached-free / 0 free of 4" in msg
        assert "blocks per slot: {0: 3, 1: 1}" in msg
        assert msgs[0] == msgs[1]

    def test_ref_free_errors_name_owning_slot(self):
        cache = PagedKVCache(1, HEADS, D // HEADS, block_size=8,
                             num_blocks=6, max_seqs=2,
                             max_blocks_per_seq=4, device="cpu")
        cache.ensure(0, 10)
        b = cache.seq_blocks[0][0]
        with pytest.raises(ValueError, match=r"owned by slot\(s\) \[0\]"):
            cache.allocator.free([b])
            cache.allocator.free([b])   # double free names the owner
        free_b = cache.allocator._free[0]   # never allocated
        with pytest.raises(ValueError, match="no owner"):
            cache.allocator.ref([free_b])


class TestShedIsolation:
    def test_survivor_bit_identical_through_peer_shed(self, cores):
        prompts = _prompts(5, 9, 10)
        kw = dict(max_batch=2, block_size=4, num_blocks=30,
                  max_blocks_per_seq=10)
        base, base_oc, _ = _both(cores, prompts, 12, **kw)
        assert all(oc.status == RequestOutcome.FINISHED
                   for oc in base_oc.values())
        inj = FaultInjector(oom_at=[4])     # every alloc at step 4
        storm, oc, eng = _both(cores, prompts, 12,
                               (JaxFI(oom_at=[4]), inj), **kw)
        assert eng.resilience_stats.shed == 1
        shed = [r for r, o in oc.items()
                if o.status == RequestOutcome.FAILED_OOM]
        assert len(shed) == 1
        assert "pool exhausted" in oc[shed[0]].reason
        for r in base:
            if r not in shed:
                assert storm[r] == base[r], "survivor stream diverged"
        assert storm[shed[0]] == base[shed[0]][:len(storm[shed[0]])]


class TestRetryBudget:
    def test_preemption_budget_fails_instead_of_livelock(self, cores):
        _, oc, eng = _both(cores, _prompts(6, 14, 14), 30, max_batch=2,
                           block_size=16, num_blocks=5,
                           max_blocks_per_seq=4, max_preemptions=0)
        failed = [o for o in oc.values()
                  if o.status == RequestOutcome.FAILED_OOM]
        assert len(failed) == 1
        assert "retry budget" in failed[0].reason
        assert failed[0].preemptions == 0
        assert eng.resilience_stats.shed == 1
        assert any(o.status == RequestOutcome.FINISHED
                   for o in oc.values())

    def test_unbounded_budget_still_requeues(self, cores):
        _, oc, eng = _both(cores, _prompts(6, 14, 14), 30, max_batch=2,
                           block_size=16, num_blocks=5,
                           max_blocks_per_seq=4)
        assert all(o.status == RequestOutcome.FINISHED
                   for o in oc.values())
        assert eng.resilience_stats.retried >= 1


class TestDeadlines:
    def test_queued_request_deadline(self, cores):
        """A request that never leaves the queue times out at the step
        the reference's rule gives (and the JAX engine's verdict)."""
        got = []
        for core, wrap, cls in ((cores[0], to_jax, JaxPSE),
                                (cores[1], to_port, PagedServingEngine)):
            eng = cls(core, max_batch=1, block_size=8, num_blocks=20,
                      max_blocks_per_seq=4)
            a, b = _prompts(7, 6, 6)
            eng.submit(wrap(a))
            (_, slot, h), = eng.admitted
            eng.admitted.clear()
            rb = eng.submit(wrap(b), deadline_steps=3)
            x = np.zeros((1, 1, D), np.float32)
            x[slot, 0] = np.asarray(h.numpy())[0]
            for _ in range(5):
                eng.step(wrap(x))
            got.append([o.as_dict() for o in eng.outcomes])
        (oc,) = eng.outcomes
        assert oc.rid == rb
        assert oc.status == RequestOutcome.FAILED_DEADLINE
        assert "3 steps" in oc.reason and oc.step == 4
        assert eng.resilience_stats.deadline_failed == 1
        assert not eng.queue and eng.active[slot]
        assert got[1] == got[0]

    def test_active_request_wall_clock_deadline(self, cores):
        eng = PagedServingEngine(cores[1], max_batch=1, block_size=8,
                                 num_blocks=20, max_blocks_per_seq=4)
        eng.submit(to_port(_prompts(8, 6)[0]), deadline_s=0.0)
        eng.admitted.clear()
        out = eng.step(torch.zeros(1, 1, D))
        assert out is None                  # failed at step top, no call
        (oc,) = eng.outcomes
        assert oc.status == RequestOutcome.FAILED_DEADLINE
        assert "wall-clock" in oc.reason
        assert oc.tokens == 6
        eng.check_invariants()


class TestNumericGuard:
    def test_nan_fails_one_request_not_engine(self, cores):
        prompts = _prompts(9, 9, 11)
        kw = dict(max_batch=2, block_size=8, num_blocks=20,
                  max_blocks_per_seq=4, prefix_cache=True)
        base, _, _ = _both(cores, prompts, 10, **kw)
        inj = FaultInjector(nan_at={3: [0]})
        storm, oc, eng = _both(cores, prompts, 10,
                               (JaxFI(nan_at={3: [0]}), inj), **kw)
        assert inj.injected_nan == 1
        assert eng.resilience_stats.nan_failed == 1
        failed = [r for r, o in oc.items()
                  if o.status == RequestOutcome.FAILED_NUMERIC]
        assert len(failed) == 1
        assert "non-finite" in oc[failed[0]].reason
        for r in base:
            if r not in failed:
                assert storm[r] == base[r]
        eng.check_invariants()

    def test_nan_feedback_row_cannot_poison_trash_block(self, cores):
        """A caller feeding the whole ``out[:, :1]`` back, NaN row of the
        failed slot included: the masked row is zeroed on the device, so
        only one request fails and the survivor's stream is the
        fault-free one."""
        prompts = _prompts(9, 9, 11)
        kw = dict(max_batch=2, block_size=8, num_blocks=20,
                  max_blocks_per_seq=4)

        def lazy_loop(injector):
            eng = PagedServingEngine(cores[1], injector=injector, **kw)
            rids = [eng.submit(to_port(p)) for p in prompts]
            slot_of = {r: s for r, s, _ in eng.admitted}
            x = np.zeros((2, 1, D), np.float32)
            for r, s, h in eng.admitted:
                x[s, 0] = h.numpy()[0]
            eng.admitted.clear()
            toks = {r: [] for r in rids}
            for _ in range(8):
                out = eng.step(to_port(x))
                assert out is not None
                o = out.numpy()
                for r in rids:
                    if eng.active[slot_of[r]]:
                        toks[r].append(tok_of(o[slot_of[r], 0]))
                x = o[:, :1].copy()     # verbatim, NaN rows included
            return toks, eng

        base, _ = lazy_loop(None)
        storm, eng = lazy_loop(FaultInjector(nan_at={2: [0]}))
        assert eng.resilience_stats.nan_failed == 1
        (oc,) = [o for o in eng.outcomes if o.failed]
        assert oc.status == RequestOutcome.FAILED_NUMERIC
        for r in base:
            if r != oc.rid:
                assert storm[r] == base[r], \
                    "survivor poisoned through the trash block"


class TestFairRequeue:
    def test_preempted_order_by_age_ahead_of_never_admitted(self, cores):
        orders = []
        for core, wrap, cls in ((cores[0], to_jax, JaxPSE),
                                (cores[1], to_port, PagedServingEngine)):
            eng = cls(core, max_batch=2, block_size=8, num_blocks=20,
                      max_blocks_per_seq=4)
            ra, rb, rc = [eng.submit(wrap(p))
                          for p in _prompts(10, 6, 6, 6)]
            eng.admitted.clear()
            assert [r.rid for r in eng.queue] == [rc]
            eng.preempt(0)
            eng._try_admit()
            eng.preempted.clear()
            eng.admitted.clear()
            assert [r.rid for r in eng.queue] == [rc]
            eng._preempt_youngest()         # A (fresh admit_seq)
            eng._preempt_youngest()         # B
            orders.append([r.rid for r in eng.queue])
        assert orders[1] == [ra, rb, rc] == orders[0]


class TestInvariantAuditor:
    def _cache(self, prefix=True):
        return PagedKVCache(LAYERS, HEADS, D // HEADS, block_size=8,
                            num_blocks=10, max_seqs=2,
                            max_blocks_per_seq=4, prefix_cache=prefix,
                            device="cpu")

    def test_clean_cache_passes(self):
        cache = self._cache()
        cache.ensure(0, 20)
        cache.fork(0, 1, 20)
        assert cache.check_invariants()

    def test_refcount_vs_tables_violation(self):
        cache = self._cache()
        cache.ensure(0, 10)
        cache.allocator.refcount[cache.seq_blocks[0][0]] += 1
        with pytest.raises(AssertionError, match="refcount"):
            cache.check_invariants()

    def test_index_pointing_at_free_block_violation(self):
        cache = self._cache()
        cache.ensure(0, 10)
        free_b = cache.allocator._free[-1]
        cache._hash_to_block[b"h"] = free_b
        cache._block_hash[free_b] = b"h"
        with pytest.raises(AssertionError, match="free-list block"):
            cache.check_invariants()

    def test_partition_violation(self):
        cache = self._cache()
        cache.ensure(0, 10)
        cache.allocator._free.append(int(cache.seq_blocks[0][0]))
        with pytest.raises(AssertionError, match="overlap"):
            cache.check_invariants()

    def test_shared_page_written_in_place_violation(self):
        cache = self._cache(prefix=False)
        cache.ensure(0, 16)
        cache.fork(0, 1, 16)
        shared = int(cache.seq_blocks[0][0])
        assert cache.check_invariants()     # fingerprint recorded
        cache.pools[0][shared] = 1.5
        with pytest.raises(AssertionError, match="written in place"):
            cache.check_invariants()
