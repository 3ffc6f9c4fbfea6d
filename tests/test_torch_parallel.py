"""The PyTorch port's fork-shared parallel decoding (paddle_tpu_torch:
branch groups in PagedServingEngine, RNG lanes, best-of, fork_stream and
grammar masks in SpeculativeEngine) on the CPU, at the sizes of
tests/test_parallel.py (d 32, 4 heads, 2 layers, vocab 50, 16-token
pages).

The port's own twins of test_parallel.py hold the lane oracle inside the
port: ``submit(p, n=N, seed=S)`` gives the streams of N lone submits
seeded ``branch_lane_seed(S, i)``, bitwise, under plain decode, k=2
speculation with rollback, int8 KV pages and the prefix cache. The
parity tests hold the port against the JAX package on the same weights
(``weights.token_serving_model``), the JAX side op by op: the streams of
greedy and seeded top-k groups are equal, and so is the control plane
exactly (group records, block tables and refcounts, ParallelStats, the
outcome sequence). Hidden rows agree within HID (XLA and ATen reduce in
different orders); the sampled tokens are equal because both packages
draw the same uniforms from the same lanes, and a draw would have to
land within that difference of a CDF edge to part them.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.inference import SpeculativeEngine as JaxSpec
from paddle_tpu.inference import TokenServingModel as JaxTSM
from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.inference import (SpeculativeEngine,
                                        TokenServingModel, branch_lane_seed,
                                        logit_mask_fn, register_logit_mask)
from paddle_tpu_torch.inference.scheduler import _GroupTable

pytestmark = pytest.mark.parallel
torch.set_num_threads(1)

D, HEADS, FFN, LAYERS = 32, 4, 64, 2
BS, MB = 16, 4            # 16-token pages, 4 pages a sequence (64 tokens)
VOCAB = 50
HID = dict(atol=1e-4, rtol=1e-4)

_RNG = np.random.RandomState(1234)
_EMBED = _RNG.randn(VOCAB, D).astype(np.float32)
_HEAD = _RNG.randn(D, VOCAB).astype(np.float32)


def _core(layers=LAYERS, seed=0):
    return FusedMultiTransformer(D, HEADS, FFN, num_layers=layers,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(
                                     seed))


def _target():
    return TokenServingModel(_core(), _EMBED, _HEAD)


def _adversarial_draft():
    return TokenServingModel(_core(1, seed=99), _EMBED, _HEAD)


def _prompt(n=9, seed=42):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, VOCAB, n)]


def _eng(tsm, draft=None, **kw):
    kws = dict(k=0, max_batch=4, block_size=BS, num_blocks=60,
               max_blocks_per_seq=MB)
    kws.update(kw)
    return SpeculativeEngine(tsm, draft, **kws)


def _serve_group(e, gid, n, n_gen, max_rounds=200, each=None):
    """Step until the group has its n rids and each branch generated
    n_gen tokens; the streams in branch order."""
    for _ in range(max_rounds):
        g = e.group(gid)
        if g is not None and len(g["rids"]) == n and \
                all(r in e._by_rid and len(e.generated(r)) >= n_gen
                    for r in g["rids"]):
            return [e.generated(r)[:n_gen] for r in g["rids"]]
        e.step()
        if each is not None:
            each(e)
    raise AssertionError("group serve loop did not converge")


def _serve_rids(e, rids, n_gen, max_rounds=200):
    for _ in range(max_rounds):
        if all(len(e.generated(r)) >= n_gen for r in rids):
            return [e.generated(r)[:n_gen] for r in rids]
        e.step()
    raise AssertionError("serve loop did not converge")


SAMPLED = dict(sampling="top_k", temperature=1.0, top_k=10, seed=1)


# -- lane seeds and the mask registry ----------------------------------

class TestLanesAndMasks:
    def test_lane_zero_is_the_seed(self):
        assert branch_lane_seed(123, 0) == 123
        lanes = [branch_lane_seed(123, i) for i in range(8)]
        assert len(set(lanes)) == 8
        assert all(0 <= s < 2 ** 32 for s in lanes)
        assert branch_lane_seed(2 ** 32 - 1, 3) == \
            (2 ** 32 - 1 + 3 * 0x9E3779B9) % 2 ** 32

    def test_mask_registry_is_by_name(self):
        register_logit_mask(
            "test_low_half", lambda toks, V: [t < V // 2
                                              for t in range(V)])
        fn = logit_mask_fn("test_low_half")
        assert fn([1, 2], 10) == [True] * 5 + [False] * 5
        with pytest.raises(KeyError, match="no_such_mask"):
            logit_mask_fn("no_such_mask")
        with pytest.raises(ValueError, match="callable"):
            register_logit_mask("bad", 42)

    def test_submit_validations(self):
        e = _eng(_target())
        with pytest.raises(ValueError, match="n must be"):
            e.submit(_prompt(), n=0)
        with pytest.raises(ValueError, match="best_of"):
            e.submit(_prompt(), best_of=True)
        with pytest.raises(KeyError, match="never_registered"):
            e.submit(_prompt(), logit_mask="never_registered")
        # a handed-off stream is one branch, as in the reference
        with pytest.raises(ValueError, match="one branch"):
            e.submit(_prompt(), resume=True, n=2)
        with pytest.raises(ValueError, match="max_batch"):
            e.submit(_prompt(), n=99)


# -- greedy groups: one prefill, n equal streams -----------------------

class TestGreedyGroup:
    def test_group_matches_lone_stream_and_prices_one_prefill(self):
        p = _prompt()
        e = _eng(_target())
        gid = e.submit(p, n=4)
        streams = _serve_group(e, gid, 4, 10)
        e.check_invariants()
        e1 = _eng(_target())
        lone = _serve_rids(e1, [e1.submit(p)], 10)[0]
        assert streams == [lone] * 4
        ps = e.engine.parallel_stats
        assert ps.groups == 1 and ps.branches == 3
        assert ps.prefill_tokens_saved == 3 * len(p)
        assert ps.branches_per_group == 3.0
        assert ps.shared_blocks == 3 * e.engine.cache.blocks_needed(len(p))
        reg = e.engine.registry.as_dict()
        assert reg["parallel.groups"] == 1 and reg["parallel.branches"] == 3

    def test_prefix_cache_and_int8_compose(self):
        rng = np.random.default_rng(7)
        p = [int(t) for t in rng.integers(0, VOCAB, 2 * BS + 5)]
        for kw in (dict(prefix_cache=True), dict(kv_dtype="int8")):
            e = _eng(_target(), **kw)
            gid = e.submit(p, n=3)
            streams = _serve_group(e, gid, 3, 8)
            e.check_invariants()
            e1 = _eng(_target(), **kw)
            lone = _serve_rids(e1, [e1.submit(p)], 8)[0]
            assert streams == [lone] * 3, kw


# -- the lane oracle: a group == n lone lane-seeded runs ---------------

class TestSeededLaneOracle:
    N, S, NGEN = 4, 777, 10

    def _oracle(self, eng_kw, draft=None, draft2=None):
        p = _prompt()
        e = _eng(_target(), draft, **eng_kw)
        gid = e.submit(p, n=self.N, seed=self.S)
        group = _serve_group(e, gid, self.N, self.NGEN)
        e.check_invariants()
        e2 = _eng(_target(), draft2, **eng_kw)
        rids = [e2.submit(p, seed=branch_lane_seed(self.S, i))
                for i in range(self.N)]
        assert group == _serve_rids(e2, rids, self.NGEN)
        assert len(set(map(tuple, group))) > 1, \
            "branches never diverged: the lane oracle proved nothing"
        return e

    def test_plain_sampling(self):
        self._oracle(dict(**SAMPLED))

    @pytest.mark.spec
    def test_speculative_rollback_sampling(self):
        """Adversarial draft: most rounds reject mid-window, so the
        accept and residual draws consume each branch's lane."""
        e = self._oracle(dict(k=2, **SAMPLED), _adversarial_draft(),
                         _adversarial_draft())
        assert e.stats.rolled_back > 0

    def test_unseeded_groups_share_the_engine_rng(self):
        p = _prompt()
        e = _eng(_target(), **SAMPLED)
        gid = e.submit(p, n=3)
        _serve_group(e, gid, 3, 6)
        assert all(e._by_rid[r].lane is None
                   for r in e.group(gid)["rids"])

    @pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                    dict(prefix_cache=True),
                                    dict(prefill_token_budget=8)],
                             ids=["int8", "prefix", "budget"])
    def test_oracle_holds_on_int8_pages_prefix_cache_and_budget(self, kw):
        """int8 KV pages, the prefix cache (the lone submits adopt the
        first one's pages), and token-budget admission (the branch slots
        are reserved while the prompt streams)."""
        self._oracle(dict(SAMPLED, **kw))


# -- shared pages: refcounts, COW, deep fingerprints --------------------

class TestSharedPages:
    def test_refcount_equals_branch_tables_then_cow_splits(self):
        rng = np.random.default_rng(7)
        p = [int(t) for t in rng.integers(0, VOCAB, 2 * BS + 5)]
        e = _eng(_target(), **SAMPLED)
        gid = e.submit(p, n=4, seed=5)
        _serve_group(e, gid, 4, 3)
        peng = e.engine
        g = e.group(gid)
        by_slot = {r.rid: s for s, r in enumerate(peng._requests)
                   if r is not None}
        rep = peng.cache.share_report([by_slot[r] for r in g["rids"]])
        full = len(p) // BS
        assert len(rep["shared_blocks"]) == full
        for b in rep["shared_blocks"]:
            assert rep["multiplicity"][b] == 4
            assert rep["refcount"][b] >= 4
        assert rep["bytes_saved"] == \
            3 * full * BS * peng.cache.kv_bytes_per_token()
        tails = [peng.cache.seq_blocks[by_slot[r]][-1] for r in g["rids"]]
        assert len(set(tails)) == 4
        peng.check_invariants()
        peng.cache.check_invariants(lens=peng.lens, active=peng.active,
                                    deep=True)

    def test_group_needs_n_free_slots(self):
        e = _eng(_target(), max_batch=2)
        with pytest.raises(ValueError, match="max_batch"):
            e.submit(_prompt(), n=3)
        gid = e.submit(_prompt(), n=2)
        assert _serve_group(e, gid, 2, 4) is not None
        e.check_invariants()


# -- best-of, cancel, fork_stream ---------------------------------------

class TestBestOfAndBeam:
    def test_best_of_first_finisher_wins_losers_cancelled(self):
        e = _eng(_target(), **SAMPLED)
        gid = e.submit(_prompt(), n=3, seed=11, best_of=True)
        for _ in range(200):
            e.step()
            g = e.group(gid)
            if g is not None and g["done"]:
                break
        g = e.group(gid)
        assert g["done"] and g["winner"] in g["rids"]
        e.check_invariants()
        cancelled = [oc for oc in e.outcomes if oc.status == "cancelled"]
        assert {oc.rid for oc in cancelled} == \
            set(g["rids"]) - {g["winner"]}
        assert all(oc.failed for oc in cancelled)
        assert e.resilience_stats.cancelled == 2
        assert e.resilience_stats.failed == 0

    def test_caller_cancel_detaches_one_branch(self):
        p = _prompt()
        e = _eng(_target())
        gid = e.submit(p, n=3)
        _serve_group(e, gid, 3, 4)
        victim = e.group(gid)["rids"][1]
        partial = e.generated(victim)
        assert e.cancel(victim)
        assert not e.cancel(victim)
        assert e.generated(victim) == partial
        survivors = [r for r in e.group(gid)["rids"] if r != victim]
        streams = _serve_rids(e, survivors, 8)
        e1 = _eng(_target())
        lone = _serve_rids(e1, [e1.submit(p)], 8)[0]
        assert streams == [lone] * 2
        e.check_invariants()

    def test_fork_stream_clones_mid_stream(self):
        p = _prompt()
        e = _eng(_target())
        r0 = e.submit(p)
        _serve_rids(e, [r0], 4)
        cut = len(e.generated(r0))
        clone = e.fork_stream(r0)
        g = e.group(e.engine.groups.gid_of(clone))
        assert g["rids"] == [r0, clone]
        a, b = _serve_rids(e, [r0, clone], cut + 6)
        assert a == b
        assert e.engine.parallel_stats.branches == 1
        e.check_invariants()


# -- grammar masks ------------------------------------------------------

class TestGrammarMask:
    @pytest.mark.spec
    def test_stream_is_provably_in_language(self):
        register_logit_mask(
            "even_only", lambda toks, V: [t % 2 == 0 for t in range(V)])
        e = _eng(_target(), _adversarial_draft(), k=2, **SAMPLED)
        gid = e.submit(_prompt(), n=3, seed=21, logit_mask="even_only")
        streams = _serve_group(e, gid, 3, 10)
        assert all(t % 2 == 0 for s in streams for t in s), streams
        assert e.stats.rolled_back > 0
        e.check_invariants()

    def test_mask_is_stateful_over_the_stream(self):
        register_logit_mask(
            "alternate_halves",
            lambda toks, V: [(t < V // 2) == (len(toks) % 2 == 0)
                             for t in range(V)])
        e = _eng(_target(), **SAMPLED)
        rid = e.submit(_prompt(), seed=9, logit_mask="alternate_halves")
        (toks,) = _serve_rids(e, [rid], 10)
        plen = len(_prompt())
        for i, t in enumerate(toks):
            assert (t < VOCAB // 2) == ((plen + i) % 2 == 0), (i, t)


# -- the port's own: token-budget groups, the table, best-of refills ----

def test_budget_group_reserves_branch_slots_and_forks_after_launch():
    """Token-budget admission: while the lead's prompt streams, its
    branch slots are reserved (prefilling, no request) and sit in the
    decode mask; the fork runs after the launch that wrote the last
    chunk; every step passes the engine and deep pool audits. A second
    group waits head-of-line until n slots are free."""
    p = _prompt(37, seed=3)
    e = _eng(_target(), prefill_token_budget=8, chunk_tokens=8)
    peng = e.engine
    gid = e.submit(p, n=3)
    waiting = e.submit(_prompt(12, seed=4), n=2)
    assert peng.groups.groups[gid]["reserved"] == [1, 2]
    assert peng.num_prefilling == 3 and peng.free_slots == 1
    assert [r.rid for r in peng.queue] == [waiting]

    def audit(eng):
        eng.check_invariants()
        eng.engine.cache.check_invariants(deep=True)
    streams = _serve_group(e, gid, 3, 4, each=audit)
    e1 = _eng(_target(), prefill_token_budget=8, chunk_tokens=8)
    assert streams == [_serve_rids(e1, [e1.submit(p)], 4)[0]] * 3
    assert peng.groups.groups[gid]["forked"]
    assert not peng.groups.reserved_slots()
    # the waiting group admits once two slots free up
    for r in e.group(gid)["rids"]:
        e.release(r)
    assert _serve_group(e, waiting, 2, 2, each=audit)
    assert e.group(gid) is None


def test_lead_preempted_mid_prefill_gives_up_its_reservation():
    """A lead evicted while its prompt streams frees its reserved slots
    at once; re-admitted, it reserves afresh and still forks its
    group."""
    e = _eng(_target(), prefill_token_budget=4, chunk_tokens=4)
    peng = e.engine
    gid = e.submit(_prompt(20, seed=5), n=3)
    e.step()
    slot = peng._requests.index(next(r for r in peng._requests
                                     if r is not None and r.rid == gid))
    assert len(peng.groups.groups[gid]["reserved"]) == 2
    peng.preempt(slot)
    assert not peng.groups.groups[gid]["reserved"]
    assert peng.free_slots == 4
    peng.check_invariants()
    e._handle_events()
    streams = _serve_group(e, gid, 3, 3)
    assert len({tuple(s) for s in streams}) == 1
    e.check_invariants()


def test_group_table_snapshot_round_trips():
    t = _GroupTable()
    t.create(5, 3)["reserved"].extend([1, 2])
    t.add_branch(5, 9)
    t.create(7, 1)["forked"] = True
    rec = t.snapshot()
    u = _GroupTable()
    u.restore(rec)
    assert u.snapshot() == rec
    assert u.gid_of(9) == 5 and u.reserved_slots() == {1, 2}
    assert u.on_terminal(5)["live"] == [9]
    assert u.on_terminal(9) is not None and u.gid_of(5) is None


def test_best_of_win_leaves_a_refilled_slot_alone():
    """A best-of win cancels the losers, and the cancel refills their
    slots from the queue at once: the winner's capacity loop must not
    then release the request that took a loser's slot."""
    e = _eng(_target(), max_batch=3, max_blocks_per_seq=1)
    gid = e.submit(_prompt(12), n=3, best_of=True)
    # the winner's release refills its slot with the first; the first
    # loser's cancel refills its slot with the second
    others = [e.submit(_prompt(5, seed=s)) for s in (8, 9)]
    for _ in range(40):
        e.step()
        g = e.group(gid)
        if g is not None and g["done"] and \
                all(len(e.generated(r)) >= 2 for r in others):
            break
    assert e.group(gid)["done"]
    assert all(len(e.generated(r)) >= 2 for r in others)
    assert [o.status for o in e.outcomes].count("cancelled") == 2
    assert not set(others) & {o.rid for o in e.outcomes}
    e.check_invariants()


def test_share_report_and_charges_match_jax():
    """``share_report`` and the reference-per-table charge after a fork,
    a COW split and a truncate equal the JAX pool's (every slot
    unattributed: the charge sits under the None tenant in both)."""
    from paddle_tpu.inference import PagedKVCache as JaxKV
    from paddle_tpu_torch.inference import PagedKVCache
    jc = JaxKV(1, 2, 8, 4, 12, 3)
    tc = PagedKVCache(1, 2, 8, 4, 12, 3, device="cpu")
    for op, *args in [("ensure", 0, 10), ("fork", 0, 1, 10),
                      ("fork", 0, 2, 10), ("ensure", 1, 11),
                      ("truncate", 2, 3), ("ensure", 0, 14)]:
        getattr(jc, op)(*args)
        getattr(tc, op)(*args)
        assert tc.share_report([0, 1, 2]) == jc.share_report([0, 1, 2])
        assert tc._tenant_charge == jc._tenant_charge
        tc.check_invariants()


# -- parity with the JAX package ------------------------------------------

@pytest.fixture
def jax_op_by_op():
    names = ("FLAGS_eager_op_jit", "FLAGS_eager_layer_jit")
    before = {n: paddle.flags.get_flag(n) for n in names}
    paddle.set_flags({n: False for n in names})
    yield
    paddle.set_flags(before)


def _pair(**kw):
    """A JAX and a port SpeculativeEngine over the same weights."""
    paddle.seed(0)
    jcore = JaxFMT(D, HEADS, FFN, num_layers=LAYERS)
    state = {k: np.asarray(v.numpy()) for k, v in
             jcore.state_dict().items()}
    tt = weights.token_serving_model(state, _EMBED, HEADS, lm_head=_HEAD,
                                     device="cpu")
    cfg = dict(dict(k=0, max_batch=4, block_size=BS, num_blocks=60,
                    max_blocks_per_seq=MB), **kw)
    je = JaxSpec(JaxTSM(jcore, _EMBED, _HEAD), None, **cfg)
    je.engine.ragged_step = "force"
    return je, SpeculativeEngine(tt, None, **cfg)


def _plane(e):
    """The control plane the two packages must share exactly."""
    eng, a = e.engine, e.engine.cache.allocator
    return dict(groups=eng.groups.snapshot(),
                free=[int(b) for b in a._free],
                refcount=a.refcount.tolist(),
                tables=eng.cache.block_tables.tolist(),
                lens=eng.lens.tolist(), active=eng.active.tolist(),
                prefilling=eng.prefilling.tolist(),
                parallel=eng.parallel_stats.as_dict(),
                outcomes=[o.as_dict() for o in e.outcomes])


def _lockstep(je, te, submits, n_gen, best_of_gid=None):
    """Submit to both, step both, compare the control plane after every
    round; returns the port's streams by rid."""
    for args in submits:
        assert je.submit(*args[:1], **args[1]) == \
            te.submit(*args[:1], **args[1])
        assert _plane(te) == _plane(je)
    for _ in range(60):
        je.step()
        te.step()
        assert _plane(te) == _plane(je)
        rids = sorted(te._by_rid)
        assert sorted(je._by_rid) == rids
        for r in rids:
            assert te.tokens(r) == je.tokens(r), r
        if best_of_gid is not None:
            if te.group(best_of_gid)["done"]:
                assert te.group(best_of_gid)["winner"] == \
                    je.group(best_of_gid)["winner"]
                return
        elif len(rids) > len(submits) and \
                all(len(te.generated(r)) >= n_gen for r in rids):
            return {r: te.generated(r) for r in rids}
    raise AssertionError("lockstep serve did not converge")


@pytest.mark.usefixtures("jax_op_by_op")
def test_greedy_group_equals_jax_with_token_budget():
    """Greedy n=3 under a token budget (reserved slots, fork after the
    packed launch) beside a lone request: streams and control plane
    equal after every round; the shared prefill hidden within HID."""
    je, te = _pair(prefill_token_budget=8, chunk_tokens=8)
    hj, ht = [], []
    jl, tl = je.target.logits, te.target.logits
    je.target.logits = lambda h: (hj.append(np.asarray(h.numpy())),
                                  jl(h))[1]
    te.target.logits = lambda h: (ht.append(h.numpy().copy()), tl(h))[1]
    streams = _lockstep(je, te, [(_prompt(21), dict(n=3)),
                                 (_prompt(7, seed=2), {})], 5)
    assert len(streams) == 4
    assert len(ht) == len(hj)
    for a, b in zip(ht, hj):
        np.testing.assert_allclose(a, b, **HID)
    te.check_invariants()


@pytest.mark.usefixtures("jax_op_by_op")
def test_seeded_top_k_group_equals_jax():
    """Seeded top-k n=4 (sync admission): the four lane streams, the
    group records, tables, refcounts and ParallelStats equal the JAX
    engine's after every round, and the probability rows within HID."""
    je, te = _pair(**SAMPLED)
    pj, pt = [], []
    js, ts = je.target.sample, te.target.sample

    def rec(store, fn, conv):
        def sample(*a, **kw):
            out = fn(*a, **kw)
            store.append(conv(out[1]))
            return out
        return sample
    je.target.sample = rec(pj, js, np.asarray)
    te.target.sample = rec(pt, ts, np.asarray)
    streams = _lockstep(je, te, [(_prompt(), dict(n=4, seed=777))], 8)
    assert len({tuple(s) for s in streams.values()}) > 1
    assert len(pt) == len(pj)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, b, **HID)


@pytest.mark.usefixtures("jax_op_by_op")
def test_best_of_and_fork_stream_outcomes_equal_jax():
    """best-of n=3 under top-k: the same winner and the same outcome
    sequence (the two CANCELLED rids included); then fork_stream of a
    running lone stream: the same clone rid, group record and pages."""
    je, te = _pair(max_blocks_per_seq=1, **SAMPLED)
    _lockstep(je, te, [(_prompt(12), dict(n=3, seed=11, best_of=True))],
              0, best_of_gid=0)
    je.step()
    te.step()
    assert _plane(te) == _plane(je)
    assert [o["status"] for o in _plane(te)["outcomes"]].count(
        "cancelled") == 2
    r = te.submit(_prompt(5, seed=6))
    assert je.submit(_prompt(5, seed=6)) == r
    je.step()
    te.step()
    assert te.fork_stream(r) == je.fork_stream(r)
    assert _plane(te) == _plane(je)
    for _ in range(3):
        je.step()
        te.step()
        assert _plane(te) == _plane(je)
        assert te.tokens(r) == je.tokens(r)
