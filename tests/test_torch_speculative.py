"""The PyTorch port's speculative decoding (paddle_tpu_torch
SpeculativeEngine with k > 0, PagedServingEngine.step_multi at L = k+1 and
rollback, TokenServingModel.truncated_draft) held against the JAX package
on the CPU at the widths of test_torch_serving (d 64, 4 heads, 2 layers,
vocab 128).

Weights come from a ``paddle.seed(0)`` JAX model through
``paddle_tpu_torch.weights``; prompts from seeded numpy. The JAX engine
takes the packed ragged step (``ragged_step = "force"``), which the port
takes whenever a token budget is set. Checked: greedy streams equal to
the JAX package's AND to the port's own k=0 streams (speculative ==
plain), the control plane of both pools exactly after every round, and
``_reject_sample`` given the same probability rows: the same accepted
tokens and the same RandomState afterwards, which holds the sampled
modes without relying on float-equal probabilities."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.inference import SpeculativeEngine as JaxSpec
from paddle_tpu.inference import TokenServingModel as JaxTSM
from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import SpeculativeEngine, TokenServingModel
from tests.torch_twins import op_by_op

torch.set_num_threads(1)
D, HEADS, FFN, LAYERS, VOCAB = 64, 4, 128, 2, 128

_RNG = np.random.RandomState(7)
_EMBED = _RNG.randn(VOCAB, D).astype(np.float32)
_HEAD = _RNG.randn(D, VOCAB).astype(np.float32)
_PROMPTS = [list(_RNG.randint(0, VOCAB, n)) for n in (5, 23, 9, 31, 3, 14)]
# 3 slots over 15 usable 4-token pages: refills and preemptions, and a
# token budget that packs verify rows beside prefill chunks
POOL = dict(max_batch=3, block_size=4, num_blocks=16, chunk_tokens=8,
            prefill_token_budget=12)
N_GEN = 4


_MODELS = {}


@pytest.fixture
def jax_op_by_op():
    """The JAX package op by op for the test (``tests/
    test_torch_serving.py``'s fixture of the same name says why): under
    six loaded workers its cached layer captures once ended a greedy
    round with slot lengths [8, 23, 0] where the port's (and its own,
    unloaded) were [7, 23, 0], and once gave per-phase hidden rows 0.086
    off the port's (and its own, unloaded)."""
    with op_by_op():
        yield


def _models():
    """(JAX token model, port token model) over the same weights, built
    once per module: the JAX package compiles its layer captures per
    layer instance (``framework/layer_jit.py``), so one model shared by
    the tests compiles each capture once. Engines read the models and
    never write them."""
    if "m" not in _MODELS:
        paddle.seed(0)
        jcore = JaxFMT(D, HEADS, FFN, num_layers=LAYERS)
        state = {k: np.asarray(v.numpy()) for k, v in
                 jcore.state_dict().items()}
        tcore = weights.fused_multi_transformer(state, HEADS, device="cpu")
        _MODELS["m"] = (JaxTSM(jcore, _EMBED, _HEAD),
                        TokenServingModel(tcore, _EMBED, _HEAD))
    return _MODELS["m"]


def _serve(eng, prompts=_PROMPTS, n_gen=N_GEN):
    rids = [eng.submit(p) for p in prompts]
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


def _pair(k, draft_layers=None, **kw):
    """A JAX and a port speculative engine over the same weights (a
    self-draft, or a truncated draft of ``draft_layers``)."""
    jt, tt = _models()
    jd = td = None
    if draft_layers is not None:
        jd, td = jt.truncated_draft(draft_layers), \
            tt.truncated_draft(draft_layers)
    cfg = dict(POOL, **kw)
    je = JaxSpec(jt, jd, k=k, **cfg)
    je.engine.ragged_step = "force"
    return je, SpeculativeEngine(tt, td, k=k, **cfg)


_PLAIN = {}


def _plain_streams():
    """The port's own k=0 streams (computed once per module)."""
    if "s" not in _PLAIN:
        _, tt = _models()
        _PLAIN["s"] = _serve(SpeculativeEngine(tt, None, k=0, **POOL))[0]
    return _PLAIN["s"]


def _control(cache):
    a = cache.allocator
    return dict(free=[int(b) for b in a._free],
                refcount=a.refcount.tolist(),
                tables=cache.block_tables.tolist())


def _stats(eng):
    """SpecDecodeStats without ``draft_steps``: the JAX engine attaches a
    request whose admitted event went stale (ROADMAP Queue C) and rolls
    its draft row too; the port attaches it only once its re-prefill
    lands. Every other counter agrees."""
    d = eng.stats.as_dict()
    del d["draft_steps"]
    return d


@pytest.mark.usefixtures("jax_op_by_op")
@pytest.mark.parametrize("k", [2, 4])
def test_greedy_streams_equal_jax_and_plain(k):
    """Truncated 1-layer draft, greedy, both engines stepped in lockstep:
    after every round the target pool and the slot lengths equal the JAX
    engine's (rollback frees pages tail first), and so does the draft
    pool while both track the same slots; the streams and the outcome
    sequence equal the JAX engine's; the streams equal the port's k=0
    streams; verify rows rode beside prefill chunks."""
    je, te = _pair(k, draft_layers=1)
    rids = [(je.submit(p), te.submit(p)) for p in _PROMPTS]
    done = {}
    # the draft pools agree until the JAX engine attaches a stale
    # admission (see _stats): it then prefills a draft the port does not
    drafts_agree = True
    for _ in range(200):
        je.step()
        te.step()
        assert _control(te.engine.cache) == _control(je.engine.cache)
        assert te.engine.lens.tolist() == je.engine.lens.tolist()
        drafts_agree &= sorted(te._seqs) == sorted(je._seqs)
        if drafts_agree:
            assert _control(te.draft_cache) == _control(je.draft_cache)
            assert te._draft_lens.tolist() == je._draft_lens.tolist()
        for i, (j, t) in enumerate(rids):
            if i not in done and t in te._by_rid and \
                    len(te.generated(t)) >= N_GEN:
                done[i] = te.generated(t)[:N_GEN]
                assert je.generated(j)[:N_GEN] == done[i]
                je.release(j)
                te.release(t)
        if len(done) == len(rids):
            break
    t_streams = [done[i] for i in range(len(rids))]
    t_out = [o.as_dict() for o in te.outcomes]
    assert t_out == [o.as_dict() for o in je.outcomes]
    assert t_streams == _plain_streams()
    assert _stats(te) == _stats(je)
    st = te.stats
    assert st.proposed > 0 and 0 < st.accepted < st.proposed
    assert st.rolled_back > 0
    assert sum(o["preemptions"] for o in t_out) >= 1
    assert te.engine.prefill_stats.mixed_steps >= 1
    te.check_invariants()


def test_reject_sample_equals_jax():
    """The same probability rows through both packages' rejection
    sampling: the same (n_accepted, correction) and the same RandomState
    afterwards — including the p == q fallback and full acceptance."""
    class Holder:
        def __init__(self):
            self._rng = np.random.RandomState(3)
    rng = np.random.RandomState(11)
    cases = []
    for _ in range(40):
        kk = rng.randint(1, 5)
        p = rng.dirichlet(np.full(VOCAB, 0.3), size=kk + 1).astype(
            np.float32)
        q = [rng.dirichlet(np.full(VOCAB, 0.3)).astype(np.float32)
             for _ in range(kk)]
        d = [int(rng.randint(VOCAB)) for _ in range(kk)]
        cases.append((d, q, p))
    same = rng.dirichlet(np.ones(VOCAB), size=3).astype(np.float32)
    cases.append(([1, 2], [same[0], same[1]], same))     # p == q
    jh, th = Holder(), Holder()
    results = set()
    for d, q, p in cases:
        got = SpeculativeEngine._reject_sample(th, d, q, p)
        ref = JaxSpec._reject_sample(jh, d, q, p)
        assert got == ref
        results.add(got[0] == len(d))
        st_t, st_j = th._rng.get_state(), jh._rng.get_state()
        assert st_t[2:] == st_j[2:]
        np.testing.assert_array_equal(st_t[1], st_j[1])
    assert results == {True, False}     # both outcomes were exercised


def test_sampled_spec_serves():
    """top-k sampling with a truncated draft: every stream is in range,
    the books balance and both pools pass their audits."""
    _, tt = _models()
    eng = SpeculativeEngine(tt, tt.truncated_draft(1), k=3,
                            sampling="top_k", top_k=8, temperature=0.8,
                            seed=5, **POOL)
    streams, out = _serve(eng)
    assert all(len(s) == N_GEN and 0 <= min(s) and max(s) < VOCAB
               for s in streams)
    st = eng.stats
    assert st.emitted == st.accepted + st.target_steps
    assert st.rolled_back == st.proposed - st.accepted
    eng.check_invariants()


@pytest.mark.usefixtures("jax_op_by_op")
def test_int8_kv_target_with_float_draft_pool():
    """kv_dtype="int8" quantizes the TARGET pool only; the draft pool
    stays float. Greedy streams equal the JAX engine's in the same
    configuration."""
    je, te = _pair(2, draft_layers=1, kv_dtype="int8")
    assert te.engine.cache.dtype == torch.int8
    assert te.draft_cache.dtype == torch.float32
    j_streams, _ = _serve(je, prompts=_PROMPTS[:4], n_gen=4)
    t_streams, _ = _serve(te, prompts=_PROMPTS[:4], n_gen=4)
    assert t_streams == j_streams
    te.check_invariants()


def test_draft_pool_oom_rolls_back():
    """A draft pool too small for every slot's roll: a BlockOOM mid-roll
    rolls the partial roll back page-wise, the round verifies only the
    pending token, the draft slots rebuild (or stay dirty) — and the
    greedy streams stay the plain streams."""
    _, tt = _models()
    te = SpeculativeEngine(tt, tt.truncated_draft(1), k=2,
                           draft_num_blocks=9, **POOL)
    t_streams, _ = _serve(te, prompts=_PROMPTS[:4])
    assert te.stats.draft_oom_rolls >= 1
    assert t_streams == _plain_streams()[:4]
    te.check_invariants()


def test_preempted_in_its_admission_step_keeps_its_stream():
    """The stale-admission case under k > 0: a request whose prefill
    lands in a step that then preempts it must not be attached (nor get a
    draft cache) until its re-prefill lands; every greedy stream equals
    the one served from a pool that never preempts."""
    rng = np.random.RandomState(17)
    emb = rng.randn(VOCAB, D).astype(np.float32)
    system = list(rng.randint(0, VOCAB, 8))
    prompts = [system + list(rng.randint(0, VOCAB, n))
               for n in (3, 9, 6, 13)]
    _, tt = _models()
    tt = TokenServingModel(tt.core, emb)
    pool = dict(max_batch=2, block_size=4, chunk_tokens=8,
                prefill_token_budget=12, prefix_cache=True)
    streams = {}
    for nb in (9, 40):
        eng = SpeculativeEngine(tt, tt.truncated_draft(1), k=2,
                                num_blocks=nb, **pool)
        streams[nb], out = _serve(eng, prompts=prompts, n_gen=4)
        if nb == 9:
            assert sum(o["preemptions"] for o in out) >= 1
        eng.check_invariants()
    assert streams[9] == streams[40]


def test_truncated_draft_shares_the_targets_parameters():
    _, tt = _models()
    draft = tt.truncated_draft(1)
    assert draft.core.num_layers == 1
    assert draft.core.layers[0] is tt.core.layers[0]
    assert draft.core.layers[0].qkv.weight.data_ptr() == \
        tt.core.layers[0].qkv.weight.data_ptr()
    assert draft.lm_head is tt.lm_head
    with pytest.raises(ValueError, match="shallower"):
        tt.truncated_draft(LAYERS)


def test_rollback_trims_history_before_the_pages():
    """A rejected tail leaves the request's history: a preemption after
    a rollback re-prefills only the accepted rows."""
    _, tt = _models()
    eng = SpeculativeEngine(tt, None, k=3, max_batch=2, block_size=4,
                            num_blocks=20)
    rid = eng.submit(_PROMPTS[1])
    eng.step()
    pe = eng.engine
    slot = eng._by_rid[rid].slot
    n = int(pe.lens[slot])
    pe.step_multi(torch.zeros((2, 3, D)))
    assert int(pe.lens[slot]) == n + 3
    pe.rollback(slot, n + 1)
    req = pe._requests[slot]
    assert len(req) == n + 1 and int(pe.lens[slot]) == n + 1
    assert len(pe.cache.seq_blocks[slot]) == pe.cache.blocks_needed(n + 1)
    with pytest.raises(ValueError, match="outside"):
        pe.rollback(slot, n + 2)
    pe.check_invariants()


def test_int8_core_truncates_to_an_int8_twin():
    """``truncated`` keeps the class: an int8 core's twin serves its int8
    layers (the same buffers), equal to quantizing the float twin."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformerInt8
    _, tt = _models()
    q = FusedMultiTransformerInt8.from_float(tt.core)
    twin = q.truncated(1)
    assert isinstance(twin, FusedMultiTransformerInt8)
    assert twin.layers[0].qkv.weight_int8 is q.layers[0].qkv.weight_int8
    x = torch.from_numpy(np.random.RandomState(2).randn(
        2, 5, D).astype(np.float32))
    ref = FusedMultiTransformerInt8.from_float(tt.core.truncated(1))
    with torch.no_grad():
        assert torch.equal(twin(x), ref(x))


# -- twins of test_mixed_verify.py: verify rows beside prefill chunks ----

def _paged(core, **kw):
    from paddle_tpu_torch.inference import PagedServingEngine
    return PagedServingEngine(core, **dict(dict(
        max_batch=2, block_size=4, num_blocks=32, prefill_token_budget=4),
        **kw))


def test_step_multi_streams_prompts_under_a_budget():
    """In token-budget mode a verify step advances the prompt and
    returns None until a slot can verify; the slot completed in a step
    sits that step out."""
    _, tt = _models()
    eng = _paged(tt.core)
    rng = np.random.default_rng(2)
    eng.submit(rng.standard_normal((10, D)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 2, D)).astype(
        np.float32))
    assert eng.step_multi(x) is None
    assert eng.num_prefilling == 1
    steps = 1
    while eng.num_prefilling:
        assert eng.step_multi(x) is None
        steps += 1
    assert steps >= 2
    (rid, slot, h) = eng.admitted.pop()
    assert h is not None and int(eng.lens[slot]) == 10
    assert eng.step_multi(x) is not None
    assert int(eng.lens[slot]) == 12
    eng.check_invariants()


@pytest.mark.parametrize("k", [0, 2])
def test_spec_budget_streams_match_synchronous(k):
    """Greedy streams under a prefill token budget (packed ragged steps)
    equal those of synchronous admission (chunked prefill), for k=0 and
    a self-drafted k=2."""
    _, tt = _models()
    prompts = [list(p) for p in np.random.default_rng(1).integers(
        0, VOCAB, (5, 11))]
    cfg = dict(max_batch=3, block_size=4, num_blocks=64,
               max_blocks_per_seq=6)
    sync = _serve(SpeculativeEngine(tt, None, k=k, **cfg), prompts, 8)[0]
    eng = SpeculativeEngine(tt, None, k=k, prefill_token_budget=4, **cfg)
    assert _serve(eng, prompts, 8)[0] == sync
    assert eng.engine.prefill_stats.prefill_steps > 0
    eng.check_invariants()


def _mixed_drive(eng, prompts, xs, to_np, wrap):
    """Submit ``prompts``, run ``step_multi`` over ``xs``; the outputs,
    the admitted events and the final lengths."""
    for p in prompts:
        eng.submit(wrap(p))
    outs, events = [], []
    for x in xs:
        o = eng.step_multi(wrap(x))
        outs.append(None if o is None else to_np(o).copy())
        events += [(r, s, to_np(h).copy()) for r, s, h in eng.admitted]
        eng.admitted.clear()
    eng.check_invariants()
    return outs, events, eng.lens.copy()


@pytest.mark.usefixtures("jax_op_by_op")
def test_packed_verify_equals_jax_per_phase_calls():
    """The port packs a step's prefill chunks with the L-row verify into
    one ragged call; the JAX engine's eager path runs each phase as its
    own call. Lengths and admitted events equal, hidden rows within
    1e-4 (summation order)."""
    jt, tt = _models()
    rng = np.random.default_rng(3)
    prompts = [rng.standard_normal((n, D)).astype(np.float32)
               for n in (10, 6)]
    xs = [rng.standard_normal((2, 2, D)).astype(np.float32)
          for _ in range(10)]
    from paddle_tpu.inference import PagedServingEngine as JaxPaged
    je = JaxPaged(jt.core, max_batch=2, block_size=4, num_blocks=32,
                  prefill_token_budget=4, ragged_step=False)
    jo, jev, jl = _mixed_drive(je, prompts, xs,
                               lambda t: np.asarray(t.numpy()),
                               paddle.to_tensor)
    to, tev, tl = _mixed_drive(_paged(tt.core), prompts, xs,
                               lambda t: t.numpy(), torch.from_numpy)
    np.testing.assert_array_equal(tl, jl)
    assert len(tev) == len(jev) == 2
    for (ra, sa, ha), (rb, sb, hb) in zip(tev, jev):
        assert (ra, sa) == (rb, sb)
        np.testing.assert_allclose(ha, hb, atol=1e-4, rtol=1e-4)
    for a, b in zip(to, jo):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.usefixtures("jax_op_by_op")
def test_capacity_error_flushes_planned_chunks():
    """The over-capacity ValueError fires after the planning pass moved
    a prefill on: its planned chunk is flushed (pages written) before
    the error, so the slot's later stream equals the JAX engine's."""
    jt, tt = _models()
    rng = np.random.default_rng(8)
    p_long = rng.standard_normal((10, D)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, D)).astype(np.float32)
    xL = rng.standard_normal((2, 2, D)).astype(np.float32)

    def drive(eng, wrap, to_np):
        eng.submit(wrap(p_long[:6]))
        while eng.num_prefilling:
            eng.step_multi(wrap(x1))
        eng.admitted.clear()
        while int(eng.lens[0]) < 11:
            eng.step_multi(wrap(x1))
        eng.submit(wrap(p_long))
        with pytest.raises(ValueError):
            eng.step_multi(wrap(xL))        # 11 + 2 > 12
        eng.release(0)
        while eng.num_prefilling:
            eng.step_multi(wrap(x1))
        outs = [to_np(eng.step_multi(wrap(x1)))[1].copy()
                for _ in range(2)]
        eng.check_invariants()
        return outs

    from paddle_tpu.inference import PagedServingEngine as JaxPaged
    je = JaxPaged(jt.core, max_batch=2, block_size=4, num_blocks=32,
                  max_blocks_per_seq=3, prefill_token_budget=4,
                  ragged_step="force")
    ref = drive(je, paddle.to_tensor, lambda t: np.asarray(t.numpy()))
    got = drive(_paged(tt.core, max_blocks_per_seq=3), torch.from_numpy,
                lambda t: t.numpy())
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def test_mixed_verify_counts_as_mixed_step():
    _, tt = _models()
    eng = _paged(tt.core)
    rng = np.random.default_rng(4)
    eng.submit(rng.standard_normal((6, D)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 2, D)).astype(
        np.float32))
    while eng.num_prefilling:
        eng.step_multi(x)
    eng.admitted.clear()
    eng.step_multi(x)
    eng.submit(rng.standard_normal((9, D)).astype(np.float32))
    before = eng.prefill_stats.mixed_steps
    eng.step_multi(x)
    assert eng.prefill_stats.mixed_steps == before + 1
