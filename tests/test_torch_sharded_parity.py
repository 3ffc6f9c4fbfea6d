"""Head-sharded paged serving held against the JAX package on the CPU:
``ShardedServingCore`` at mp=2 in both packages on the same weights
(copied through ``paddle_tpu_torch.weights``), plain, prefix-cached,
speculative (k=2), int8-KV and token-budget mixed-step serving.

What is checked: greedy streams EQUAL; the hidden states of one chunked
prefill call and one decode call within HID (atol 1e-4, rtol 1e-4: XLA
and ATen reduce in different orders); ``allreduce_count``, block tables,
refcounts and chain hashes EXACTLY. Snapshots and slices cross the
packages and the widths: a JAX mp=2 snapshot restores in the port at
mp=1 and mp=2, the port's mp=2 snapshot restores in the JAX package at
mp=1 (equal snapshot keys and geometry, streams that continue equal),
and an mp=2 slice of either package imports into the other's mp=1 pool.

The JAX side runs op by op (``jax_op_by_op``), with
``compiled_step=False``: the conftest's eight virtual CPU devices would
otherwise engage its compiled step, which the port does not have
(ROADMAP item 10b); its host-staged path is the port's. Its engines take
the packed ragged step (``ragged_step = "force"``), as the port's do."""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import SpeculativeEngine as JaxSpec
from paddle_tpu.inference import TokenServingModel as JaxTSM
from paddle_tpu_torch.inference import SpeculativeEngine, TokenServingModel
from tests.test_torch_serving import jax_op_by_op  # noqa: F401
from tests.test_torch_snapshot import _pair
from tests.torch_twins import D, HID, VOCAB, assert_snapshots_match
from tests.torch_twins import shared_jax_cache  # noqa: F401

BS = 4
_RNG = np.random.RandomState(21)
EMB = (_RNG.randn(VOCAB, D) * 0.3).astype(np.float32)
# rolled readout: greedy streams walk the vocabulary instead of settling
# on the tied readout's fixed point
HEAD = np.roll(EMB, -1, 0).T.copy()
PROMPTS = [list(_RNG.randint(0, VOCAB, n)) for n in (7, 11, 5)]
MODES = {
    "plain": dict(k=0),
    "prefix": dict(k=0, prefix_cache=True),
    "speculative": dict(k=2),
    "int8": dict(k=0, kv_dtype="int8", prefix_cache=True),
    "budget": dict(k=2, prefill_token_budget=8, prefix_cache=True),
}

pytestmark = [pytest.mark.sharded, pytest.mark.usefixtures("jax_op_by_op")]


def _models(mp_jax=2, mp_port=2):
    """(JAX surface, port surface) on the same weights, each sharded at
    its width (1: unsharded)."""
    jcore, tcore = _pair()
    j = JaxTSM(jcore, EMB, lm_head=HEAD)
    t = TokenServingModel(tcore, EMB, lm_head=HEAD)
    if mp_jax > 1:
        j = j.shard(mp_jax, compiled_step=False)
    if mp_port > 1:
        t = t.shard(mp_port)
    return j, t


def _engine(cls, tsm, **kw):
    cfg = dict(k=0, max_batch=3, block_size=BS, num_blocks=40)
    cfg.update(kw)
    eng = cls(tsm, **cfg)
    eng.engine.ragged_step = "force"
    return eng


def _serve(eng, rids, steps):
    for _ in range(steps):
        eng.step()
    return {r: eng.tokens(r) for r in rids}


def _assert_control_plane_equal(jc, tc):
    assert tc.mp == jc.mp
    np.testing.assert_array_equal(tc.block_tables, jc.block_tables)
    np.testing.assert_array_equal(tc.allocator.refcount,
                                  jc.allocator.refcount)
    assert list(tc.allocator._free) == list(jc.allocator._free)
    assert list(tc.allocator._cached) == list(jc.allocator._cached)
    assert tc._hash_to_block == jc._hash_to_block
    assert tc._block_hash == jc._block_hash


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mp2_serving_equals_jax(mode):
    j, t = _models()
    je, te = _engine(JaxSpec, j, **MODES[mode]), \
        _engine(SpeculativeEngine, t, **MODES[mode])
    streams = []
    for e in (je, te):
        rids = [e.submit(p) for p in PROMPTS]
        streams.append(_serve(e, rids, 8))
    assert streams[1] == streams[0]
    assert te.engine.cache.mp == je.engine.cache.mp == 2
    assert t.core.allreduce_count == j.core.allreduce_count > 0
    _assert_control_plane_equal(je.engine.cache, te.engine.cache)
    if MODES[mode]["k"]:
        _assert_control_plane_equal(je.draft_cache, te.draft_cache)
    te.check_invariants()


def test_mp2_hidden_states_match_jax():
    """One chunked prefill call (6 rows) and one fused decode call over
    two slots, through mp=2 pools of both packages."""
    j, t = _models()
    jc = j.core.gen_paged_cache(BS, 12, 2)
    tc = t.core.gen_paged_cache(BS, 12, 2)
    rng = np.random.RandomState(5)
    x = rng.randn(1, 6, D).astype(np.float32)
    xd = rng.randn(2, 1, D).astype(np.float32)
    hidden = []
    for core, c, wrap in ((j.core, jc, paddle.to_tensor),
                          (t.core, tc, torch.from_numpy)):
        torch.set_grad_enabled(core is j.core)
        for slot in (0, 1):
            c.ensure(slot, 6, write_from=0)
        t0 = np.zeros(1, np.int32)
        h0, _ = core(wrap(x), caches=c.prefill_views(0), time_step=wrap(t0))
        core(wrap(x), caches=c.prefill_views(1), time_step=wrap(t0))
        for slot in (0, 1):
            c.ensure(slot, 7)
        h1, _ = core(wrap(xd), caches=c.views,
                     time_step=wrap(np.full(2, 6, np.int32)))
        hidden.append([np.asarray(h.numpy()) for h in (h0, h1)])
    torch.set_grad_enabled(True)
    for a, b in zip(*hidden):
        np.testing.assert_allclose(b, a, **HID)
    assert t.core.allreduce_count == j.core.allreduce_count == 3 * 2


def _snap_after(eng, steps):
    rids = [eng.submit(p) for p in PROMPTS]
    _serve(eng, rids, steps)
    return rids, pickle.loads(pickle.dumps(eng.snapshot()))


def test_jax_mp2_snapshot_restores_in_the_port_at_mp1_and_mp2():
    kw = dict(k=2, prefix_cache=True)
    j, t2 = _models()
    je = _engine(JaxSpec, j, **kw)
    rids, js = _snap_after(je, 4)
    assert js["engine"]["cache"]["geometry"]["mp"] == 2
    te = _engine(SpeculativeEngine, t2, **kw)
    _, ts = _snap_after(te, 4)
    assert_snapshots_match(ts, js)
    ref = _serve(je, rids, 4)
    for mp in (1, 2):
        _, t = _models(mp_port=mp)
        res = SpeculativeEngine.restore(t, None, js)
        assert res.engine.cache.mp == mp
        assert _serve(res, rids, 4) == ref
        res.check_invariants()


def test_port_mp2_snapshot_restores_in_jax_at_mp1():
    kw = dict(k=0, kv_dtype="int8", prefix_cache=True)
    j1, t = _models(mp_jax=1)
    te = _engine(SpeculativeEngine, t, **kw)
    rids, ts = _snap_after(te, 4)
    ref = _serve(te, rids, 4)
    res = JaxSpec.restore(j1, None, ts)
    assert res.engine.cache.mp == 1
    assert _serve(res, rids, 4) == ref


def test_mp2_slices_cross_packages_into_mp1_pools():
    """An mp=2 slice of either package is canonical (full heads, equal
    hashes, payloads within HID) and imports into the other package's
    mp=1 pool, the same number of blocks each way."""
    kw = dict(k=0, prefix_cache=True)
    j, t = _models()
    je, te = _engine(JaxSpec, j, **kw), _engine(SpeculativeEngine, t, **kw)
    for e in (je, te):
        rids = [e.submit(p) for p in PROMPTS]
        _serve(e, rids, 8)
    js, ts = je.export_slice(rids[1]), te.export_slice(rids[1])
    assert ts is not None and ts["geometry"]["num_heads"] == \
        js["geometry"]["num_heads"]
    assert_snapshots_match(ts, js)
    j1, t1 = _models(mp_jax=1, mp_port=1)
    jd = _engine(JaxSpec, j1, **kw)
    td = _engine(SpeculativeEngine, t1, **kw)
    n_t = td.import_slice(pickle.loads(pickle.dumps(js)))
    n_j = jd.import_slice(pickle.loads(pickle.dumps(ts)))
    assert n_t == n_j == len(ts["hashes"]) > 0
    _assert_control_plane_equal(jd.engine.cache, td.engine.cache)
    td.check_invariants()
