"""Snapshots and slices of the port's speculative engine held against the
JAX package on the CPU: SpeculativeEngine snapshots across the packages
(greedy and sampled, the RNG states in the snapshot), the int8 engine
round trip and rehoming (twin of tests/test_quantized.py:372) and page
slices handed to a second engine with ``submit(resume=True)``. The pool
and PagedServingEngine snapshots are in test_torch_snapshot.py."""
import pickle

import numpy as np
import pytest
import torch

from paddle_tpu.inference import PagedKVCache as JaxKV
from paddle_tpu.inference import SpeculativeEngine as JaxSpec
from paddle_tpu.inference import TokenServingModel as JaxTSM
from paddle_tpu_torch.inference import (PagedKVCache, SpeculativeEngine,
                                        TokenServingModel)
from tests.test_torch_serving import jax_op_by_op  # noqa: F401
from tests.test_torch_snapshot import _assert_state_equal, _pair
from tests.torch_twins import (D, LAYERS, VOCAB, assert_snapshots_match)
from tests.torch_twins import shared_jax_cache  # noqa: F401


def _serve(eng, rids, n):
    for _ in range(200):
        if all(len(eng.generated(r)) >= n for r in rids):
            break
        eng.step()
    return {r: eng.generated(r)[:n] for r in rids}


@pytest.mark.usefixtures("jax_op_by_op")
@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_speculative_snapshot_crosses_packages(mode):
    """SpeculativeEngine snapshots taken by either package restore in
    the other: greedy (k=0) continuations are token-equal, and a sampled
    self-drafted k=2 engine (the RNG state and the seeded lane in the
    snapshot) draws the same tokens after the restore as the source
    does."""
    jcore, tcore = _pair()
    emb = np.random.RandomState(11).randn(VOCAB, D).astype(np.float32)
    kw = dict(max_batch=2, block_size=4, num_blocks=40,
              max_blocks_per_seq=10)
    if mode == "greedy":
        kw.update(k=0)
    else:
        kw.update(k=2, sampling="top_k", top_k=8, temperature=0.8,
                  seed=5)
    je = JaxSpec(JaxTSM(jcore, emb), None, **kw)
    te = SpeculativeEngine(TokenServingModel(tcore, emb), None, **kw)
    # the third request waits queued in the 2 slots at the snapshot
    prompts = [list(np.random.RandomState(s).randint(0, VOCAB, n))
               for s, n in ((1, 9), (2, 6), (3, 5))]
    for e in (je, te):
        rids = [e.submit(p, seed=(17 if i == 1 and mode == "sample"
                                  else None))
                for i, p in enumerate(prompts)]
        _serve(e, rids[:2], 3)
    assert {r: te.tokens(r) for r in rids} == \
        {r: je.tokens(r) for r in rids}
    js, ts = je.snapshot(), te.snapshot()
    assert_snapshots_match(ts, js)
    ref_j = _serve(je, rids, 7)
    ref_t = _serve(te, rids, 7)
    assert ref_j == ref_t
    from_jax = SpeculativeEngine.restore(
        TokenServingModel(tcore, emb), None, pickle.loads(pickle.dumps(js)))
    to_jax_ = JaxSpec.restore(JaxTSM(jcore, emb), None,
                              pickle.loads(pickle.dumps(ts)))
    assert _serve(from_jax, rids, 7) == ref_j
    assert _serve(to_jax_, rids, 7) == ref_t
    from_jax.check_invariants()


def test_quantized_engine_snapshot_roundtrip_and_rehoming():
    """Twin of tests/test_quantized.py:372 at its sizes (d 64): an int8
    engine snapshot restores with the identical int8 payload and scales,
    allocates identically, continues the greedy stream of the
    uninterrupted run, and rehomes into bigger and smaller pools with
    its pages' content; the JAX engine's snapshot of the same run has
    the same keys and control plane."""
    jcore, tcore = _pair(64, 128)
    emb = np.random.default_rng(0).standard_normal(
        (VOCAB, 64)).astype(np.float32)
    prompt = list(np.random.default_rng(11).integers(0, VOCAB, 9))
    kw = dict(k=0, max_batch=2, block_size=4, num_blocks=24,
              kv_dtype="int8")

    def run(eng, n):
        for _ in range(100):
            eng.step()
            if len(eng.generated(rid)) >= n:
                break
        return eng.generated(rid)[:n]

    je = JaxSpec(JaxTSM(jcore, emb), **kw)
    eng = SpeculativeEngine(TokenServingModel(tcore, emb), **kw)
    rid = eng.submit(prompt)
    assert je.submit(prompt) == rid
    assert run(eng, 4) == run(je, 4)
    snap = eng.snapshot()
    assert_snapshots_match(snap, je.snapshot())
    full = run(eng, 10)
    assert full == run(je, 10)
    res = SpeculativeEngine.restore(TokenServingModel(tcore, emb), None,
                                    snap)
    assert res.engine.cache.quantized
    assert run(res, 10) == full
    csnap = snap["engine"]["cache"]
    a = PagedKVCache.restore(csnap, device="cpu")
    assert a.allocator._free == [int(b) for b in csnap["free_order"]]
    assert a.seq_blocks[0] == [int(b) for b in csnap["seq_blocks"][0]]
    b = PagedKVCache.restore(csnap, device="cpu")
    for layer in range(LAYERS):
        assert torch.equal(a.pools[layer], b.pools[layer])
        assert torch.equal(a.scales[layer], b.scales[layer])
    for nb in (40, 12):
        re = PagedKVCache.restore(csnap, num_blocks=nb, device="cpu")
        assert re.num_blocks == nb and re.quantized
        for bs_, bd in zip(a.seq_blocks[0], re.seq_blocks[0]):
            assert torch.equal(a.pools[0][bs_], re.pools[0][bd])
            assert torch.equal(a.scales[0][bs_], re.scales[0][bd])
        _assert_state_equal(JaxKV.restore(csnap, num_blocks=nb), re)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_slice_handoff_resumes_the_stream(source):
    """A running request's finished prefix pages move to a second
    engine with its own pool (``export_slice`` / ``import_slice``,
    either package's slice), and ``submit(resume=True)`` there
    continues the stream as the uninterrupted run: the imported pages
    are adopted, only the tail is prefilled."""
    jcore, tcore = _pair()
    emb = np.random.RandomState(11).randn(VOCAB, D).astype(np.float32)
    kw = dict(k=0, max_batch=2, block_size=4, num_blocks=40,
              max_blocks_per_seq=10, prefix_cache=True)
    prompt = list(np.random.RandomState(4).randint(0, VOCAB, 13))
    tsm = TokenServingModel(tcore, emb)
    ref = SpeculativeEngine(tsm, **kw)
    rid = ref.submit(prompt)
    whole = _serve(ref, [rid], 14)[rid]
    src = SpeculativeEngine(tsm, **kw) if source == "port" else \
        JaxSpec(JaxTSM(jcore, emb), **kw)
    src.submit(prompt)
    part = _serve(src, [rid], 6)[rid]
    assert part == whole[:6]
    slc = src.export_slice(rid)
    assert slc["kind"] == "kv_slice" and len(slc["hashes"]) == 4
    dst = SpeculativeEngine(tsm, **kw)
    assert dst.import_slice(slc) == 4
    assert dst.engine.cache.allocator.num_cached == 4
    rid2 = dst.submit(src.tokens(rid), resume=True)
    assert dst.engine.prefix_stats.hit_blocks == 4
    got = _serve(dst, [rid2], 8)[rid2]
    assert src.tokens(rid)[len(prompt):] + got == whole
    dst.check_invariants()
    if source == "port":
        src.check_invariants()
