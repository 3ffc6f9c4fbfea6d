"""The PyTorch port's prefix cache (paddle_tpu_torch/inference/paged_cache.py
chain hashes, the allocator's cached-free tier, match/adopt/register, and
the scheduler's prefix admission) held against the JAX package on the CPU
at tiny widths (d 64, 4 heads, 2 layers, vocab 128).

The control plane is host numpy in both packages, so it is compared
EXACTLY: chain hashes byte for byte, free list and cached-free order,
refcounts, block tables, the hash index and the prefix statistics after
the same operations or the same serving run. Greedy token streams are
compared as equal; hidden rows are not bit-compared (the two reduce in
different orders), so the JAX package's own bit-identity prefix tests are
not mirrored here.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.inference import PagedKVCache as JaxKV
from paddle_tpu.inference import SpeculativeEngine as JaxSpec
from paddle_tpu.inference import TokenServingModel as JaxTSM
from paddle_tpu.inference import chain_block_hashes as jax_hashes
from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import (PagedKVCache, PagedServingEngine,
                                        SpeculativeEngine,
                                        TokenServingModel,
                                        chain_block_hashes)
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
D, HEADS, FFN, LAYERS, VOCAB = 64, 4, 128, 2, 128
HID = dict(atol=1e-4, rtol=1e-4)

_RNG = np.random.RandomState(17)
_EMBED = _RNG.randn(VOCAB, D).astype(np.float32)
# a shared 8-token system prefix (two 4-token blocks) before every prompt
_SYSTEM = list(_RNG.randint(0, VOCAB, 8))
_PROMPTS = [_SYSTEM + list(_RNG.randint(0, VOCAB, n))
            for n in (3, 9, 6, 13)]
# 2 slots over 7 usable pages: the later prompts adopt the earlier
# ones' registered pages (live or cached-free), the pool preempts, and a
# preempted request re-adopts its own registered pages when it returns
POOL = dict(max_batch=2, block_size=4, num_blocks=8, chunk_tokens=8,
            prefill_token_budget=12, prefix_cache=True)


def _cores():
    paddle.seed(0)
    jcore = JaxFMT(D, HEADS, FFN, num_layers=LAYERS)
    state = {k: np.asarray(v.numpy()) for k, v in
             jcore.state_dict().items()}
    return jcore, weights.fused_multi_transformer(state, HEADS,
                                                  device="cpu")


def _control(cache):
    """Everything the prefix cache decides, as plain Python values."""
    a = cache.allocator
    return dict(free=[int(b) for b in a._free],
                cached=[int(b) for b in a._cached],
                refcount=a.refcount.tolist(),
                tables=cache.block_tables.tolist(),
                index={h: int(b) for h, b in cache._hash_to_block.items()},
                reclaimed=int(a.reclaimed))


def test_chain_hashes_equal_jax():
    rows = np.random.RandomState(0).randn(13, D).astype(np.float32)
    for parent in (b"", b"\x01" * 16):
        assert chain_block_hashes(rows, 4, parent=parent) == \
            jax_hashes(rows, 4, parent=parent)
    assert len(chain_block_hashes(rows, 4)) == 3   # the partial tail: no


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_allocator_tiers_match_jax(dtype):
    """One sequence of pool operations through both packages: register,
    release to the cached-free tier, adopt (share a live block and
    resurrect a cached one), truncate, and reclaim under pressure — the
    free list, the cached-free LRU order, refcounts, tables and the hash
    index stay equal after every operation."""
    rows = np.random.RandomState(1).randn(24, D).astype(np.float32)
    h = chain_block_hashes(rows, 4)
    jc = JaxKV(1, 2, 8, 4, 10, 3, dtype=dtype, prefix_cache=True)
    tc = PagedKVCache(1, 2, 8, 4, 10, 3, dtype=dtype, prefix_cache=True,
                      device="cpu")
    ops = [("ensure", 0, 14), ("register_prefix", 0, h[:3]),
           ("adopt_prefix", 1, h[:2]), ("free_seq", 0),
           ("adopt_prefix", 2, h[:4]), ("truncate", 2, 4),
           ("ensure", 2, 20), ("free_seq", 1), ("free_seq", 2),
           ("ensure", 0, 36), ("adopt_prefix", 1, h)]
    for op, *args in ops:
        jr = getattr(jc, op)(*args)
        tr = getattr(tc, op)(*args)
        assert tr == jr, op
        assert _control(tc) == _control(jc), op
        assert tc.match_prefix(h) == jc.match_prefix(h)
        assert tc.allocator.num_cached == jc.allocator.num_cached
        tc.check_invariants()
    assert tc.allocator.reclaimed == 3      # the last ensure reclaimed


def _serve(eng, n_gen=4):
    rids = [eng.submit(p) for p in _PROMPTS]
    done = {}
    for _ in range(200):
        eng.step()
        for r in rids:
            if r not in done and r in eng._by_rid and \
                    len(eng.generated(r)) >= n_gen:
                done[r] = eng.generated(r)[:n_gen]
                eng.release(r)
        if len(done) == len(rids):
            break
    assert len(done) == len(rids), "serve loop did not converge"
    return [done[r] for r in rids], [o.as_dict() for o in eng.outcomes]


def test_prefix_serving_matches_jax_fp32_pool():
    """SpeculativeEngine(k=0, prefix_cache=True) over an fp32 pool:
    greedy streams, outcomes, the allocator's tiers, the tables, the
    hash index and the prefix statistics equal the JAX engine's after
    the same run (the int8 pool is covered in test_torch_quantized)."""
    jcore, tcore = _cores()
    je = JaxSpec(JaxTSM(jcore, _EMBED), None, k=0, **POOL)
    je.engine.ragged_step = "force"
    te = SpeculativeEngine(TokenServingModel(tcore, _EMBED), None, k=0,
                           **POOL)
    j_streams, j_out = _serve(je)
    t_streams, t_out = _serve(te)
    assert t_streams == j_streams
    assert t_out == j_out
    assert _control(te.engine.cache) == _control(je.engine.cache)
    assert te.engine.prefix_stats.as_dict() == \
        je.engine.prefix_stats.as_dict()
    st = te.engine.prefix_stats
    assert st.hit_blocks > 0 and st.tokens_skipped > 0
    assert sum(o["preemptions"] for o in t_out) >= 1
    te.engine.check_invariants()


def test_adoption_agrees_with_a_cold_prefill():
    """Prefix adoption changes which pages a sequence owns, not what it
    computes: the admission hidden of a prompt whose system prefix is
    adopted equals the cold engine's within 1e-4, and the suffix-only
    prefill recomputed only the uncached rows."""
    _, tcore = _cores()
    emb = lambda toks: _EMBED[np.asarray(toks)]   # noqa: E731
    hs = {}
    for pc in (True, False):
        eng = PagedServingEngine(tcore, 2, 4, 8, chunk_tokens=8,
                                 prefix_cache=pc)
        eng.submit(emb(_PROMPTS[0]))
        eng.release(eng.admitted[0][1])
        eng.admitted.clear()
        eng.submit(emb(_PROMPTS[1]))
        hs[pc] = eng.admitted[0][2]
        if pc:
            assert eng.prefix_stats.hit_blocks == 2
            assert eng.prefix_stats.tokens_skipped == 8
            assert eng.prefix_stats.tokens_computed == \
                len(_PROMPTS[0]) + len(_PROMPTS[1]) - 8
        eng.check_invariants()
    np.testing.assert_allclose(hs[True].numpy(), hs[False].numpy(), **HID)


def test_preempted_in_its_admission_step_keeps_its_stream():
    """A request whose prefill lands in a step that then preempts it
    (the pool is one block larger than POOL's) leaves a stale admitted
    event behind; the token surface samples its first token from it but
    does not decode the still re-prefilling slot, so every greedy stream
    equals the one served from a pool that never preempts."""
    _, tcore = _cores()
    streams = {}
    for nb in (9, 40):
        te = SpeculativeEngine(TokenServingModel(tcore, _EMBED), None,
                               k=0, **dict(POOL, num_blocks=nb))
        streams[nb], out = _serve(te)
        if nb == 9:
            assert sum(o["preemptions"] for o in out) >= 1
        assert [o["tokens"] for o in out] == \
            [len(p) + 3 for p in _PROMPTS]
    assert streams[9] == streams[40]
