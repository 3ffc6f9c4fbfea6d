"""The port's tenant layer (paddle_tpu_torch/inference/scheduler.py's
quotas, floors, weighted fair queuing and health-based admission, and
paged_cache.py's per-tenant charge) held against the JAX package on the
CPU: twins of tests/test_tenants.py and of test_mixed_verify.py's
sub-queue tests, at their sizes. The noisy-neighbor storms are in
test_torch_tenant_storms.py; the storm's composition with crash
recovery (``test_noisy_neighbor_composes_with_crash_recovery``) runs on
the port as the reference wrote it (``tests/torch_ref_suite.py``).

Each scenario runs on both packages' engines: the port asserts what the
reference test asserts, and its record (admission order, outcome
sequence, charges, tenant stats, virtual times) must EQUAL the JAX
engine's."""
import numpy as np
import pytest

from paddle_tpu.inference import PagedKVCache as JaxKV
from paddle_tpu.inference import PagedServingEngine as JaxPSE
from paddle_tpu_torch.inference import (DEFAULT_TENANT, BlockOOM,
                                        PagedKVCache, PagedServingEngine,
                                        RequestOutcome, Tenant, TenantStats)
from tests.torch_ref_suite import suite
from tests.torch_twins import (D, HEADS, LAYERS, drive, jax_model,
                               port_model, to_jax, to_port)
from tests.torch_twins import shared_jax_cache  # noqa: F401


@pytest.fixture(scope="module")
def cores():
    jcore = jax_model()
    return jcore, port_model(jcore)


def _prompt(rng, n):
    return np.asarray(rng.randn(n, D), np.float32)


def _on_both(cores, scenario, **kw):
    """``scenario(engine, wrap)`` on the JAX engine and on the port's;
    asserts the two returned records equal and returns (port record,
    port engine)."""
    out = []
    for core, wrap, cls in ((cores[0], to_jax, JaxPSE),
                            (cores[1], to_port, PagedServingEngine)):
        eng = cls(core, **kw)
        out.append((scenario(eng, wrap), eng))
    assert out[1][0] == out[0][0]
    return out[1]


def _outcomes(eng):
    return [o.as_dict() for o in eng.outcomes]


def _stats(eng):
    return {t: s.as_dict() for t, s in eng.tenant_stats.items()}


# -- the charge policy: one charge per block-table reference ------------

class TestChargePolicy:
    def _caches(self):
        kw = dict(block_size=8, num_blocks=12, max_seqs=3,
                  max_blocks_per_seq=4, prefix_cache=True)
        return (JaxKV(LAYERS, HEADS, D // HEADS, **kw),
                PagedKVCache(LAYERS, HEADS, D // HEADS, device="cpu", **kw))

    def _run(self, ops):
        """The same op sequence on both pools; the charges after every op
        equal."""
        jc, tc = self._caches()
        for op, *args in ops:
            getattr(jc, op)(*args)
            getattr(tc, op)(*args)
            assert tc._tenant_charge == jc._tenant_charge
            assert tc.seq_tenant == jc.seq_tenant
        tc.check_invariants()
        return tc

    def test_per_reference_charging_is_neighbor_independent(self):
        c = self._run([("set_seq_tenant", 0, "a"), ("ensure", 0, 16)])
        assert c.tenant_charge("a") == 2
        c = self._run([("set_seq_tenant", 0, "a"), ("ensure", 0, 16),
                       ("set_seq_tenant", 1, "b"), ("fork", 0, 1, 16)])
        assert c.tenant_charge("a") == 2 and c.tenant_charge("b") == 2
        c = self._run([("set_seq_tenant", 0, "a"), ("ensure", 0, 16),
                       ("set_seq_tenant", 1, "b"), ("fork", 0, 1, 16),
                       ("free_seq", 0)])
        assert c.tenant_charge("a") == 0
        assert c.tenant_charge("b") == 2
        assert c.tenant_blocks_held() == {"b": 2}

    def test_truncate_and_quarantine_move_charge(self):
        c = self._run([("set_seq_tenant", 0, "a"), ("ensure", 0, 32),
                       ("truncate", 0, 10)])
        assert c.tenant_charge("a") == 2
        c = self._run([("set_seq_tenant", 0, "a"), ("ensure", 0, 32),
                       ("truncate", 0, 10), ("quarantine_seq", 0)])
        assert c.tenant_charge("a") == 0
        assert c.seq_tenant[0] is None

    def test_set_seq_tenant_moves_existing_charge(self):
        c = self._run([("set_seq_tenant", 0, "a"), ("ensure", 0, 8),
                       ("set_seq_tenant", 0, "b")])
        assert c.tenant_charge("a") == 0
        assert c.tenant_charge("b") == 1

    def test_audit_catches_corrupt_charge(self):
        _, cache = self._caches()
        cache.set_seq_tenant(0, "a")
        cache.ensure(0, 8)
        cache._tenant_charge["a"] += 1          # corrupt the books
        with pytest.raises(AssertionError, match="ground truth"):
            cache.check_invariants()

    def test_oom_message_names_the_hogging_tenant(self):
        msgs = []
        for cls, kw in ((JaxKV, {}), (PagedKVCache, {"device": "cpu"})):
            cache = cls(1, HEADS, D // HEADS, block_size=8, num_blocks=5,
                        max_seqs=2, max_blocks_per_seq=4, **kw)
            cache.set_seq_tenant(0, "hog")
            cache.ensure(0, 24)
            cache.set_seq_tenant(1, "victim")
            cache.ensure(1, 8)
            with pytest.raises(Exception) as ei:
                cache.ensure(1, 16)
            msgs.append(str(ei.value))
        assert isinstance(ei.value, BlockOOM)
        assert "blocks per tenant: {'hog': 3, 'victim': 1}" in msgs[1]
        assert msgs[1] == msgs[0]
        b = cache.seq_blocks[0][0]
        with pytest.raises(ValueError, match=r"tenant\(s\) \['hog'\]"):
            cache.allocator.ref([b])
            cache.allocator.free([b])
            cache.allocator.free([b])
            cache.allocator.free([b])


# -- the registry and health-based admission ----------------------------

class TestTenantRegistry:
    KW = dict(max_batch=2, block_size=4, num_blocks=20,
              max_blocks_per_seq=8)

    def test_tenant_validation(self, cores):
        with pytest.raises(ValueError, match="weight"):
            Tenant("t", weight=0)
        with pytest.raises(ValueError, match="reserved_blocks"):
            Tenant("t", quota_blocks=2, reserved_blocks=4)
        eng = PagedServingEngine(cores[1], **self.KW)
        with pytest.raises(ValueError, match="unkeepable"):
            eng.set_tenant("t", reserved_blocks=100)

    def test_quota_below_current_charge_refused(self, cores):
        def scenario(eng, wrap):
            eng.submit(wrap(_prompt(np.random.RandomState(0), 8)),
                       tenant_id="t")
            held = eng.cache.tenant_charge("t")
            with pytest.raises(ValueError, match="drain the tenant"):
                eng.set_tenant("t", quota_blocks=held - 1)
            eng.set_tenant("t", quota_blocks=held)
            return held
        held, _ = _on_both(cores, scenario, **self.KW)
        assert held > 0

    def test_unknown_tenant_auto_registers_unlimited(self, cores):
        eng = PagedServingEngine(cores[1], **self.KW)
        eng.submit(to_port(_prompt(np.random.RandomState(0), 4)),
                   tenant_id="new")
        assert list(eng.tenants) == [DEFAULT_TENANT, "new"]
        assert eng.tenants["new"].quota_blocks is None
        assert isinstance(eng.tenant_stats["new"], TenantStats)


class TestHealthAdmission:
    KW = dict(max_batch=2, block_size=4, num_blocks=16,
              max_blocks_per_seq=12)

    def _both(self, cores, scenario, **kw):
        return _on_both(cores, scenario, **dict(self.KW, **kw))

    def test_quota_impossible_prompt_rejected_not_queued(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(0)
            eng.submit(wrap(_prompt(rng, 20)), tenant_id="t")
            rec = [_outcomes(eng), len(eng.queue), eng.num_active]
            eng.outcomes.clear()
            eng.submit(wrap(_prompt(rng, 8)), tenant_id="t")
            return rec + [len(eng.admitted), _outcomes(eng), _stats(eng)]
        rec, eng = self._both(cores, scenario,
                              tenants={"t": {"quota_blocks": 3}})
        (oc,), queued, active, admitted, later, _ = rec
        assert oc["status"] == RequestOutcome.REJECTED_ADMISSION
        assert "quota" in oc["reason"]
        assert queued == 0 and active == 0
        assert eng.resilience_stats.rejected == 1
        assert eng.tenant_stats["t"].rejections == 1
        assert admitted == 1 and not later

    def test_floor_locked_pool_rejects_oversized_prompt(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(0)
            eng.submit(wrap(_prompt(rng, 24)), tenant_id="other")
            rec = [_outcomes(eng)]
            eng.outcomes.clear()
            eng.submit(wrap(_prompt(rng, 24)), tenant_id="vip")
            return rec + [len(eng.admitted), _outcomes(eng)]
        ((oc,), admitted, later), _ = self._both(
            cores, scenario, tenants={"vip": {"reserved_blocks": 10}})
        assert oc["status"] == RequestOutcome.REJECTED_ADMISSION
        assert "reserved floors" in oc["reason"]
        assert admitted == 1 and not later

    def test_deadline_below_prefill_floor_rejected(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(0)
            eng.submit(wrap(_prompt(rng, 30)), deadline_steps=3)
            rec = [_outcomes(eng)]
            eng.outcomes.clear()
            eng.submit(wrap(_prompt(rng, 30)), deadline_steps=30)
            return rec + [_outcomes(eng), eng.num_prefilling]
        ((oc,), later, prefilling), _ = self._both(
            cores, scenario, prefill_token_budget=4, chunk_tokens=4)
        assert oc["status"] == RequestOutcome.REJECTED_ADMISSION
        assert "cannot be met" in oc["reason"]
        assert not later and prefilling == 1

    def test_block_boundary_prompt_counts_first_decode_block(self, cores):
        def scenario(eng, wrap):
            eng.submit(wrap(_prompt(np.random.RandomState(3), 16)),
                       tenant_id="t")
            return [_outcomes(eng), len(eng.queue),
                    eng.tenant_stats["t"].quota_hits]
        ((oc,), queued, hits), _ = self._both(
            cores, scenario, tenants={"t": {"quota_blocks": 4}})
        assert oc["status"] == RequestOutcome.REJECTED_ADMISSION
        assert queued == 0 and hits == 0

    def test_block_boundary_prompt_cannot_stall_the_pool_queue(self,
                                                               cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(3)
            eng.submit(wrap(_prompt(rng, 16)))
            rec = [_outcomes(eng)]
            eng.outcomes.clear()
            eng.submit(wrap(_prompt(rng, 8)))
            return rec + [len(eng.admitted), _outcomes(eng)]
        ((oc,), admitted, later), _ = self._both(
            cores, scenario, num_blocks=6, max_blocks_per_seq=5,
            watermark_blocks=1)
        assert oc["status"] == RequestOutcome.REJECTED_ADMISSION
        assert admitted == 1 and not later

    def test_floor_room_uses_full_reservation_not_current_unmet(self,
                                                                cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(4)
            eng.submit(wrap(_prompt(rng, 8)), tenant_id="vip")
            admitted = len(eng.admitted)
            eng.admitted.clear()
            eng.submit(wrap(_prompt(rng, 12)), tenant_id="b")
            return [admitted, _outcomes(eng), len(eng.queue)]
        (admitted, (oc,), queued), _ = self._both(
            cores, scenario, num_blocks=11, max_blocks_per_seq=8,
            tenants={"vip": {"reserved_blocks": 8}})
        assert admitted == 1
        assert oc["status"] == RequestOutcome.REJECTED_ADMISSION
        assert "reserved floors" in oc["reason"] and queued == 0

    def test_rejection_never_raises_and_is_deterministic(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(7)
            out = []
            for n in (20, 6, 20, 8):
                rid = eng.submit(wrap(_prompt(rng, n)), tenant_id="t")
                out.append((rid, [(oc.rid, oc.status)
                                  for oc in eng.outcomes]))
            return out
        run1, _ = self._both(cores, scenario,
                             tenants={"t": {"quota_blocks": 2}})
        run2, _ = self._both(cores, scenario,
                             tenants={"t": {"quota_blocks": 2}})
        assert run1 == run2


# -- weighted fair admission ----------------------------------------------

def _admission_order(eng, n):
    order = []
    for _ in range(n):
        (rid, slot, _h), = eng.admitted
        eng.admitted.clear()
        order.append(rid)
        eng.release(slot)
    return order


class TestWeightedFairAdmission:
    def test_two_to_one_weighting(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(0)
            rids = {}
            for t in "aaaaaabbb":
                rids[eng.submit(wrap(_prompt(rng, 4)), tenant_id=t)] = t
            order = _admission_order(eng, 9)
            return [rids[r] for r in order], order, \
                {t: v.vtime for t, v in eng.tenants.items()}
        (tenants_order, order, _), _ = _on_both(
            cores, scenario, max_batch=1, block_size=4, num_blocks=30,
            max_blocks_per_seq=4,
            tenants={"a": {"weight": 2.0}, "b": {"weight": 1.0}})
        assert tenants_order.count("a") == 6
        assert tenants_order.count("b") == 3
        for i in range(1, 10):
            a = tenants_order[:i].count("a")
            b = tenants_order[:i].count("b")
            assert a <= 2 * (b + 1), f"burst at prefix {i}"
        for t in ("a", "b"):
            own = [r for r, tt in zip(order, tenants_order) if tt == t]
            assert own == sorted(own)

    def test_single_tenant_is_fifo(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(0)
            rids = [eng.submit(wrap(_prompt(rng, 4))) for _ in range(5)]
            return rids, _admission_order(eng, 5)
        (rids, order), _ = _on_both(cores, scenario, max_batch=1,
                                    block_size=4, num_blocks=30,
                                    max_blocks_per_seq=4)
        assert order == rids

    def test_quota_blocked_tenant_does_not_block_neighbors(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(0)
            eng.submit(wrap(_prompt(rng, 12)), tenant_id="capped")
            eng.admitted.clear()
            r2 = eng.submit(wrap(_prompt(rng, 12)), tenant_id="capped")
            blocked = not eng.admitted
            r3 = eng.submit(wrap(_prompt(rng, 8)), tenant_id="free")
            (rid, _s, _h), = eng.admitted
            return [blocked, rid == r3, [r.rid for r in eng.queue] == [r2],
                    eng.tenant_stats["capped"].quota_hits]
        (blocked, r3_first, queue_ok, hits), _ = _on_both(
            cores, scenario, max_batch=2, block_size=4, num_blocks=30,
            max_blocks_per_seq=6,
            tenants={"capped": {"quota_blocks": 4}})
        assert blocked and r3_first and queue_ok and hits >= 1

    def test_idle_tenant_cannot_hoard_credit(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(0)
            for _ in range(4):
                eng.submit(wrap(_prompt(rng, 4)), tenant_id="a")
                (rid, slot, _h), = eng.admitted
                eng.admitted.clear()
                eng.release(slot)
            vt = eng.tenants["a"].vtime
            ra = [eng.submit(wrap(_prompt(rng, 4)), tenant_id="a")
                  for _ in range(2)]
            rb = [eng.submit(wrap(_prompt(rng, 4)), tenant_id="b")
                  for _ in range(2)]
            return vt, ra, rb, _admission_order(eng, 4)
        (vt, ra, rb, order), _ = _on_both(
            cores, scenario, max_batch=1, block_size=4, num_blocks=40,
            max_blocks_per_seq=4, tenants={"a": {}, "b": {}})
        assert vt == 4.0
        assert order != rb + ra
        assert set(order[:2]) != set(rb)


def _decode_until(eng, wrap, steps, stop):
    """Feed each admitted hidden back as the next input for up to
    ``steps`` steps, auditing after each, until ``stop(eng)``."""
    x = np.zeros((eng.max_batch, 1, D), np.float32)
    for _, slot, h in eng.admitted:
        x[slot, 0] = np.asarray(h.numpy())[0]
    eng.admitted.clear()
    for _ in range(steps):
        out = eng.step(wrap(x))
        eng.check_invariants()
        if stop(eng):
            return
        if out is not None:
            x = np.asarray(out.numpy())[:, :1].copy()


class TestQuotaContainment:
    def test_quota_hit_preempts_own_youngest_never_neighbor(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(3)
            rids = [eng.submit(wrap(_prompt(rng, 8)), tenant_id=t)
                    for t in ("t", "t", "n")]
            _decode_until(eng, wrap, 10, lambda e: bool(e.preempted))
            return [rids, list(eng.preempted),
                    eng.tenant_stats["t"].quota_hits,
                    eng.cache.tenant_charge("t"),
                    any(r is not None and r.rid == rids[2]
                        for r in eng._requests)]
        (rids, preempted, hits, charge, n_alive), _ = _on_both(
            cores, scenario, max_batch=3, block_size=4, num_blocks=40,
            max_blocks_per_seq=8, tenants={"t": {"quota_blocks": 5}})
        assert preempted == [rids[1]]
        assert hits >= 1 and charge <= 5 and n_alive

    def test_sole_request_quota_hit_sheds_with_named_reason(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(4)
            rids = [eng.submit(wrap(_prompt(rng, 10)), tenant_id=t)
                    for t in ("t", "n")]
            _decode_until(eng, wrap, 6,
                          lambda e: any(o.failed for o in e.outcomes))
            return rids, _outcomes(eng), _stats(eng)
        (rids, outs, stats), _ = _on_both(
            cores, scenario, max_batch=2, block_size=4, num_blocks=40,
            max_blocks_per_seq=8, tenants={"t": {"quota_blocks": 3}})
        (shed,) = [o for o in outs if o["status"] != "finished"]
        assert shed["rid"] == rids[0]
        assert shed["status"] == RequestOutcome.FAILED_OOM
        assert "quota" in shed["reason"] and "'t'" in shed["reason"]
        assert stats["t"]["sheds"] == 1 and stats["n"]["sheds"] == 0


class TestReservedFloor:
    def test_floor_tenant_admits_through_a_full_pool(self, cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(5)
            eng.submit(wrap(_prompt(rng, 20)), tenant_id="hog")
            first = len(eng.admitted)
            eng.admitted.clear()
            h2 = eng.submit(wrap(_prompt(rng, 20)), tenant_id="hog")
            waits = not eng.admitted
            v = eng.submit(wrap(_prompt(rng, 20)), tenant_id="vip")
            (rid, _s, _h), = eng.admitted
            eng.admitted.clear()
            eng.check_invariants()
            return [first, waits, rid == v,
                    [r.rid for r in eng.queue] == [h2]]
        rec, _ = _on_both(cores, scenario, max_batch=3, block_size=4,
                          num_blocks=13, max_blocks_per_seq=8,
                          tenants={"vip": {"reserved_blocks": 6}})
        assert rec == [1, True, True, True]

    def test_hog_growth_self_evicts_instead_of_dipping_floor(self, cores):
        def scenario(eng, wrap):
            rh = eng.submit(wrap(_prompt(np.random.RandomState(6), 22)),
                            tenant_id="hog")
            _decode_until(eng, wrap, 6, lambda e: bool(e.preempted))
            return [rh, list(eng.preempted), _outcomes(eng),
                    eng.free_blocks]
        (rh, preempted, outs, free), _ = _on_both(
            cores, scenario, max_batch=2, block_size=4, num_blocks=11,
            max_blocks_per_seq=10, tenants={"vip": {"reserved_blocks": 4}})
        assert preempted == [rh]
        assert not any(o["status"] != "finished" for o in outs)
        assert free >= 4

    def test_below_floor_growth_evicts_sole_borrower_not_itself(self,
                                                                cores):
        def scenario(eng, wrap):
            rng = np.random.RandomState(8)
            rh = eng.submit(wrap(_prompt(rng, 37)), tenant_id="hog")
            hog = eng.admitted[0]
            eng.admitted.clear()
            eng.set_tenant("vip", reserved_blocks=6)
            rv = eng.submit(wrap(_prompt(rng, 6)), tenant_id="vip")
            (vrid, vslot, _), = eng.admitted
            eng.admitted.append(hog)
            _decode_until(eng, wrap, 3, lambda e: bool(e.preempted))
            return [rh, vrid == rv, list(eng.preempted), _outcomes(eng),
                    bool(eng.active[vslot]), eng.cache.tenant_charge("vip")]
        (rh, ok, preempted, outs, vip_active, charge), _ = _on_both(
            cores, scenario, max_batch=2, block_size=4, num_blocks=13,
            max_blocks_per_seq=10)
        assert ok and preempted == [rh]
        assert not any(o["status"] != "finished" for o in outs)
        assert vip_active and charge == 3


class TestDefaultTenantBackcompat:
    def test_no_tenant_id_is_one_implicit_unlimited_tenant(self, cores):
        """No tenant_id: one implicit unlimited tenant, bit-identical
        streams and equal stats to naming the default tenant; the JAX
        engine's outcome sequence on the same traffic."""
        rng = np.random.RandomState(9)
        prompts = [_prompt(rng, 9), _prompt(rng, 11)]
        kw = dict(max_batch=2, block_size=4, num_blocks=30,
                  max_blocks_per_seq=10)
        runs = []
        for tid in (None, DEFAULT_TENANT):
            runs.append(drive(
                lambda: PagedServingEngine(cores[1], **kw),
                [(p, tid) for p in prompts], {0: 10, 1: 10}))
        jlog = drive(lambda: JaxPSE(cores[0], **kw),
                     [(p, None) for p in prompts], {0: 10, 1: 10})[4]
        (s_none, oc_none, _, eng, log), (s_expl, oc_expl, _, eng2, _) = runs
        assert log == jlog
        assert list(eng.tenants) == [DEFAULT_TENANT]
        ten = eng.tenants[DEFAULT_TENANT]
        assert ten.quota_blocks is None
        assert ten.reserved_blocks == 0 and ten.weight == 1.0
        assert s_none == s_expl
        assert {r: o.status for r, o in oc_none.items()} == \
            {r: o.status for r, o in oc_expl.items()}
        assert eng.resilience_stats.as_dict() == \
            eng2.resilience_stats.as_dict()
        assert eng.tenant_stats[DEFAULT_TENANT].as_dict() == \
            eng2.tenant_stats[DEFAULT_TENANT].as_dict()
        assert eng.resilience_stats.failed == 0


# -- per-tenant sub-queues (tests/test_mixed_verify.py:224, :249) ---------

def test_subqueue_structure_and_merged_order(cores):
    def scenario(eng, wrap):
        rng = np.random.default_rng(5)
        rids = [eng.submit(wrap(rng.standard_normal((5, D)).astype(
            np.float32)), tenant_id=t) for t in "aaba"]
        rec = [[r.rid for r in eng.tenants["a"].fifo],
               [r.rid for r in eng.tenants["b"].fifo],
               [r.rid for r in eng.queue], eng._queue_len]
        eng.preempt(0)
        rec += [[r.rid for r in eng.tenants["a"].fifo],
                [r.rid for r in eng.queue][0]]
        eng.check_invariants()
        return rids, rec
    (rids, rec), _ = _on_both(cores, scenario, max_batch=1, block_size=4,
                              num_blocks=64)
    a1, a2, b1, a3 = rids
    assert rec == [[a2, a3], [b1], [a2, b1, a3], 3, [a1, a2, a3], a1]


def test_wfq_admission_order_weighted(cores):
    def scenario(eng, wrap):
        rng = np.random.default_rng(6)
        rids = {}
        for t in "aaaabb":
            rids[eng.submit(wrap(rng.standard_normal((5, D)).astype(
                np.float32)), tenant_id=t)] = t
        order = []
        for _ in range(6):
            (rid, slot, _) = eng.admitted.pop()
            order.append(rids[rid])
            eng.release(slot)
        eng.check_invariants()
        return order, eng.tenant_report()
    (order, report), eng = _on_both(
        cores, scenario, max_batch=1, block_size=4, num_blocks=64,
        tenants={"a": {"weight": 2.0}, "b": {"weight": 1.0}})
    assert order == ["a", "b", "a", "a", "b", "a"]
    assert report["a"]["stats"]["admitted"] == 4


globals().update(suite("tests/test_tenants.py", __name__, only=(
    "TestNoisyNeighborStorm.test_noisy_neighbor_composes_with_crash_recovery",
)))
