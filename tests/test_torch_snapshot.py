"""Snapshots of the port's paged pool and engine held against the JAX
package on the CPU: ``PagedKVCache.snapshot``/``restore`` (twins of
``tests/test_paged_cache.py::TestSnapshotRestore``), delta snapshots,
quarantine, and PagedServingEngine snapshots (a twin of
``test_mixed_verify.py``'s queue-order round trip, and a mid-flight
snapshot crossing the packages both ways). The speculative engine's
snapshots and page slices are in test_torch_snapshot_engines.py.

What is checked across the packages: a snapshot's keys at every depth
and its control plane (refcounts, free-list and LRU order, tables, the
hash index, queue, counters, tenants, RNG states, events) EXACTLY, page
payloads within 1e-4; a snapshot taken by either package restores in
the other, and the restored engine continues as the one it came from
(greedy tokens equal; sampled tokens equal from equal RNG states)."""
import pickle

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.inference import PagedKVCache as JaxKV
from paddle_tpu.inference import PagedServingEngine as JaxPSE
from paddle_tpu_torch.inference import (BlockOOM, PagedKVCache,
                                        PagedServingEngine,
                                        chain_block_hashes)
from tests.torch_twins import (D, HEADS, HID, LAYERS,
                               assert_snapshots_match, port_model, to_jax,
                               to_port)
from tests.torch_twins import shared_jax_cache  # noqa: F401


# -- the pool ---------------------------------------------------------

def _loaded_caches():
    """TestSnapshotRestore._loaded_cache in both packages from the same
    numbers: slot 0 active with registered prefix pages, slot 1
    fork-sharing its prefix, a retired slot's 3 pages cached-free (known
    LRU order), and free blocks."""
    kw = dict(block_size=4, num_blocks=16, max_seqs=3,
              max_blocks_per_seq=6, prefix_cache=True)
    jc = JaxKV(LAYERS, HEADS, D // HEADS, **kw)
    tc = PagedKVCache(LAYERS, HEADS, D // HEADS, device="cpu", **kw)
    rng = np.random.RandomState(7)

    def fill(slot, toks):
        T = toks.shape[0]
        for c in (jc, tc):
            c.ensure(slot, T, write_from=0)
        for layer in range(LAYERS):
            k = rng.randn(1, T, HEADS, D // HEADS).astype(np.float32)
            v = rng.randn(1, T, HEADS, D // HEADS).astype(np.float32)
            jc.write_prefill_chunk(slot, layer, to_jax(k), to_jax(v), 0)
            tc.write_prefill_chunk(slot, layer, to_port(k), to_port(v), 0)
        # wait for the JAX writes: each reads the slot's block-table row
        # through a device copy that JAX may still be making when the
        # next host step (free_seq) zeroes that row in place; under load
        # the writes then landed in the trash block and the snapshot
        # held zeros where these rows belong
        for layer in range(LAYERS):
            _pool(jc, layer)

    t0 = rng.randn(10, D).astype(np.float32)     # 2 full blocks
    fill(0, t0)
    t2 = rng.randn(12, D).astype(np.float32)     # 3 full blocks
    for c in (jc, tc):
        c.register_prefix(0, chain_block_hashes(t0, 4))
        c.fork(0, 1, 8)                          # share 2 blocks
    fill(2, t2)
    for c in (jc, tc):
        c.register_prefix(2, chain_block_hashes(t2, 4))
        c.free_seq(2)                            # -> cached-free x3
    assert tc.allocator.num_cached == 3
    assert tc.check_invariants()
    return jc, tc


def _assert_state_equal(a, b):
    assert b.seq_blocks == a.seq_blocks
    np.testing.assert_array_equal(b.block_tables, a.block_tables)
    np.testing.assert_array_equal(b.allocator.refcount,
                                  a.allocator.refcount)
    assert list(b.allocator._free) == list(a.allocator._free)
    assert list(b.allocator._cached) == list(a.allocator._cached)
    assert b._hash_to_block == a._hash_to_block
    assert b._block_hash == a._block_hash
    assert b.seq_tenant == a.seq_tenant


def _pool(c, layer):
    return np.asarray(c.pools[layer].numpy())


class TestSnapshotRestore:
    """Twins of tests/test_paged_cache.py::TestSnapshotRestore: each
    reference check on the port's pool, the port's snapshot against the
    JAX pool's, and restores across the packages."""

    def test_round_trip_preserves_every_allocator_edge_state(self):
        jc, tc = _loaded_caches()
        snap = tc.snapshot()
        assert_snapshots_match(snap, jc.snapshot())
        out = PagedKVCache.restore(snap, device="cpu")
        _assert_state_equal(tc, out)
        live = [b for b in range(1, tc.num_blocks)
                if tc.allocator.refcount[b] > 0
                or b in tc.allocator._cached]
        for i in range(LAYERS):
            np.testing.assert_array_equal(_pool(tc, i)[live],
                                          _pool(out, i)[live])
        assert out.check_invariants()
        # across the packages, both ways, bitwise (the pages hold the
        # same written numbers)
        from_jax = PagedKVCache.restore(jc.snapshot(), device="cpu")
        to_jax_ = JaxKV.restore(pickle.loads(pickle.dumps(snap)))
        _assert_state_equal(jc, from_jax)
        _assert_state_equal(tc, to_jax_)
        for i in range(LAYERS):
            np.testing.assert_array_equal(_pool(from_jax, i)[live],
                                          _pool(tc, i)[live])
            np.testing.assert_array_equal(_pool(to_jax_, i)[live],
                                          _pool(tc, i)[live])

    def test_restored_pool_allocates_bit_identically(self):
        jc, tc = _loaded_caches()
        out = PagedKVCache.restore(tc.snapshot(), device="cpu")
        n = tc.allocator.num_free               # drain BOTH tiers
        got_a = [tc.allocator.alloc(1)[0] for _ in range(n)]
        got_b = [out.allocator.alloc(1)[0] for _ in range(n)]
        got_j = [jc.allocator.alloc(1)[0] for _ in range(n)]
        assert got_a == got_b == got_j
        assert tc._hash_to_block == out._hash_to_block == \
            jc._hash_to_block
        with pytest.raises(BlockOOM):
            out.allocator.alloc(1)

    def test_quarantined_blocks_never_ride_a_snapshot(self):
        jc, tc = _loaded_caches()
        suspect = list(tc.seq_blocks[0])
        solely_owned = [b for b in suspect
                        if tc.allocator.refcount[b] == 1]
        assert solely_owned
        jc.quarantine_seq(0)
        tc.quarantine_seq(0)
        snap = tc.snapshot()
        assert_snapshots_match(snap, jc.snapshot())
        for b in solely_owned:
            assert b not in snap["blocks"]
            assert b not in snap["refcount"]
        out = PagedKVCache.restore(snap, device="cpu")
        for b in solely_owned:
            assert out.allocator.refcount[b] == 0
            assert b not in out._block_hash
            assert b not in out.allocator._cached
        assert out.check_invariants()

    def test_trash_block_and_fork_shared_refcounts(self):
        _, tc = _loaded_caches()
        snap = tc.snapshot()
        assert 0 not in snap["blocks"]
        out = PagedKVCache.restore(snap, device="cpu")
        assert out.allocator.refcount[0] == 1
        assert 0 not in out.allocator._free
        shared = out.seq_blocks[0][0]
        assert out.seq_blocks[1][0] == shared
        assert out.allocator.refcount[shared] == 2
        before = _pool(out, 0)[shared].copy()
        out.ensure(1, 2, write_from=0)          # write range hits block 0
        assert out.seq_blocks[1][0] != shared   # split, peer untouched
        np.testing.assert_array_equal(_pool(out, 0)[shared], before)
        assert out.check_invariants()

    def test_rehome_into_larger_pool(self):
        jc, tc = _loaded_caches()
        out = PagedKVCache.restore(tc.snapshot(), num_blocks=32,
                                   device="cpu")
        ref = JaxKV.restore(jc.snapshot(), num_blocks=32)
        assert out.num_blocks == 32
        assert out.check_invariants()
        _assert_state_equal(ref, out)
        assert len(out._hash_to_block) == len(tc._hash_to_block)
        for h, old_b in tc._hash_to_block.items():
            new_b = out._hash_to_block[h]
            for i in range(LAYERS):
                np.testing.assert_array_equal(_pool(tc, i)[old_b],
                                              _pool(out, i)[new_b])
        assert out.allocator.num_free > tc.allocator.num_free

    def test_rehome_into_smaller_pool_drops_lru_cached_first(self):
        jc, tc = _loaded_caches()
        live = int((tc.allocator.refcount[1:] > 0).sum())
        out = PagedKVCache.restore(tc.snapshot(), num_blocks=live + 2,
                                   device="cpu")
        _assert_state_equal(JaxKV.restore(jc.snapshot(),
                                          num_blocks=live + 2), out)
        assert out.allocator.num_cached == 1
        assert out.allocator.reclaimed == tc.allocator.reclaimed + 2
        kept = list(out.allocator._cached)[0]
        newest_old = list(tc.allocator._cached)[-1]
        h = tc._block_hash[newest_old]
        assert out._hash_to_block[h] == kept
        assert out.check_invariants()

    def test_rehome_live_overflow_raises_precise_oom(self):
        jc, tc = _loaded_caches()
        live = int((tc.allocator.refcount[1:] > 0).sum())
        with pytest.raises(BlockOOM) as ei:
            PagedKVCache.restore(tc.snapshot(), num_blocks=live,
                                 device="cpu")
        with pytest.raises(Exception) as ej:
            JaxKV.restore(jc.snapshot(), num_blocks=live)
        assert str(ei.value) == str(ej.value)
        msg = str(ei.value)
        assert f"restore needs {live} live block(s)" in msg
        assert "cached-free" in msg and "blocks per slot" in msg
        assert ei.value.details["target_usable"] == live - 1


def test_delta_snapshot_ships_dirty_rows_and_restores_with_its_base():
    """A delta against a base ships only pages the base lacks (the
    JAX pool's delta names the same blocks), refuses to restore without
    its base, and base + delta restores the full snapshot's pool."""
    jc, tc = _loaded_caches()
    base, jbase = tc.snapshot(), jc.snapshot()
    rng = np.random.RandomState(3)
    for c in (jc, tc):
        c.ensure(0, 14)                          # a fresh, unhashed page
    k = rng.randn(1, 4, HEADS, D // HEADS).astype(np.float32)
    for layer in range(LAYERS):
        jc.write_prefill_chunk(0, layer, to_jax(k), to_jax(k), 10)
        tc.write_prefill_chunk(0, layer, to_port(k), to_port(k), 10)
    delta = tc.snapshot(base=base)
    assert_snapshots_match(delta, jc.snapshot(base=jbase))
    full = tc.snapshot()
    assert len(delta["blocks"]) < len(full["blocks"])
    assert delta["base_blocks"]
    with pytest.raises(ValueError, match="base"):
        PagedKVCache.restore(delta, device="cpu")
    a = PagedKVCache.restore(delta, base=base, device="cpu")
    b = PagedKVCache.restore(full, device="cpu")
    _assert_state_equal(a, b)
    live = sorted(int(x) for x in full["refcount"])
    for i in range(LAYERS):
        np.testing.assert_array_equal(_pool(a, i)[live], _pool(b, i)[live])
    # and the JAX pool restores the port's delta against the port's base
    _assert_state_equal(b, JaxKV.restore(delta, base=base))


# -- engines ----------------------------------------------------------

def _pair(dim=D, ffn=None):
    paddle.seed(0)
    jcore = JaxFMT(dim, HEADS, ffn or 2 * dim, num_layers=LAYERS)
    return jcore, port_model(jcore)


def test_snapshot_queue_order_roundtrips_through_subqueues():
    """Twin of tests/test_mixed_verify.py:277: the merged queue order
    (a preempted request ahead of everything) survives the snapshot, the
    sub-queues are rebuilt per tenant, and the snapshot restores in the
    JAX engine too."""
    jcore, tcore = _pair()
    rng = np.random.default_rng(7)
    prompts = [rng.standard_normal((5, D)).astype(np.float32)
               for _ in range(6)]
    tenants = (None, "a", "b", "a", "b", "c")
    engs = []
    for core, wrap, cls in ((jcore, to_jax, JaxPSE),
                            (tcore, to_port, PagedServingEngine)):
        eng = cls(core, max_batch=1, block_size=4, num_blocks=64)
        q = [eng.submit(wrap(p), tenant_id=t or "a")
             for p, t in zip(prompts, tenants)][1:]
        eng.preempt(0)
        want = [0] + q
        assert [r.rid for r in eng.queue] == want
        engs.append(eng)
    je, te = engs
    snap = te.snapshot()
    assert snap["queue"] == want
    assert_snapshots_match(snap, je.snapshot())
    res = PagedServingEngine.restore(tcore, snap)
    assert [r.rid for r in res.queue] == want
    for tid in ("a", "b", "c"):
        assert [r.rid for r in res.tenants[tid].fifo] == \
            [r.rid for r in te.tenants[tid].fifo]
    res.check_invariants()
    jres = JaxPSE.restore(jcore, pickle.loads(pickle.dumps(snap)))
    assert [r.rid for r in jres.queue] == want
    jres.check_invariants()


def _control_plane(eng):
    c = eng.cache
    return (list(c.allocator._free), c.allocator.refcount.tolist(),
            c.block_tables.tolist(), eng.lens.tolist(),
            eng.active.tolist(), eng.prefilling.tolist(),
            [r.rid for r in eng.queue], list(c.seq_tenant),
            {t: v.vtime for t, v in eng.tenants.items()})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_engine_snapshot_crosses_packages_mid_flight(direction):
    """A token-budget engine with the prefix cache, two tenants and a
    pool that preempts, snapshotted mid-prefill with a request
    preempted: both packages' snapshots match, and the snapshot taken
    by one package restores in the other, whose continuation keeps the
    control plane equal to the source engine's step by step and its
    hidden rows within 1e-4."""
    jcore, tcore = _pair()
    rng = np.random.RandomState(2)
    prompts = [rng.randn(n, D).astype(np.float32) for n in (11, 26, 7, 19)]
    kw = dict(block_size=4, num_blocks=12, chunk_tokens=8,
              prefill_token_budget=12, prefix_cache=True,
              tenants={"a": {"weight": 2.0}, "b": {}})
    # "force": the JAX engine packs its mixed steps on the CPU as the
    # port does (the snapshot carries the knob, so a restore packs too)
    je = JaxPSE(jcore, 3, ragged_step="force", **kw)
    te = PagedServingEngine(tcore, 3, ragged_step="force", **kw)
    for i, p in enumerate(prompts):
        assert je.submit(to_jax(p), tenant_id="ab"[i % 2]) == \
            te.submit(to_port(p), tenant_id="ab"[i % 2])
    xs = [rng.randn(3, 1, D).astype(np.float32) for _ in range(30)]
    cut = None
    for i in range(30):
        je.step(to_jax(xs[i]))
        te.step(to_port(xs[i]))
        assert _control_plane(te) == _control_plane(je)
        if te.preempted and te.prefilling.any():
            cut = i + 1
            break
        for slot in np.flatnonzero(te.lens >= 20):
            je.release(int(slot))
            te.release(int(slot))
    assert cut is not None, "no mid-prefill step with a preemption"
    assert_snapshots_match(te.snapshot(), je.snapshot())
    if direction == "jax_to_port":
        src, dst = je, PagedServingEngine.restore(
            tcore, pickle.loads(pickle.dumps(je.snapshot())))
        wrap_s, wrap_d = to_jax, to_port
    else:
        src, dst = te, JaxPSE.restore(
            jcore, pickle.loads(pickle.dumps(te.snapshot())))
        wrap_s, wrap_d = to_port, to_jax
    dst.check_invariants()
    for x in xs[cut:cut + 12]:
        if not src.active.any() and not src.prefilling.any() \
                and not src.queue:
            break
        active = src.active.copy()
        so, do = src.step(wrap_s(x)), dst.step(wrap_d(x))
        assert (so is None) == (do is None)
        if so is not None:
            rows = active & src.active
            np.testing.assert_allclose(np.asarray(do.numpy())[rows],
                                       np.asarray(so.numpy())[rows],
                                       **HID)
        assert _control_plane(dst) == _control_plane(src)
        assert [(r, s) for r, s, _ in dst.admitted] == \
            [(r, s) for r, s, _ in src.admitted]
        for e in (src, dst):
            e.admitted.clear()
            e.preempted.clear()
        dst.check_invariants()
        for slot in np.flatnonzero(src.lens >= 20):
            src.release(int(slot))
            dst.release(int(slot))
    assert [o.as_dict() for o in dst.outcomes] == \
        [o.as_dict() for o in src.outcomes]
