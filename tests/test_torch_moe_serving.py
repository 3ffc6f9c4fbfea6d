"""The PyTorch port's MoE serving (paddle_tpu_torch MoeServingCore, its
routing, the grouped GEMM's plain version, and the core in every engine
mode) held against the JAX package on the CPU at the reference's widths
(d 32, 4 heads, expert FFN 64, 2 layers, vocab 50, 4 experts, top-2,
4-token pages).

Weights come from a ``paddle.seed`` JAX core through
``weights.moe_serving_core``. What is checked: routing ids, capacity
positions and the load / overflow counters EXACTLY (they are integer
functions of the gate logits, and an all-zero row is an exact tie that
both packages break towards the lowest expert id); combine weights
within 1e-6; hidden rows within 1e-5 x max|h| (XLA and ATen sum in
different orders); greedy streams and ``moe.*`` counters equal to the
JAX engine's in the plain paged, prefix-cache, token-budget and
speculative modes; ``shard_experts(ep)`` bitwise equal to the unsharded
fold within the port. The JAX baselines are built once per module."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.inference import MoeServingCore as JaxMoe
from paddle_tpu.inference import SpeculativeEngine as JaxSpec
from paddle_tpu.inference import TokenServingModel as JaxTSM
from paddle_tpu.inference import moe_serving as jms
from paddle_tpu.ops.pallas import grouped_gemm as jgg
from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.inference import (MoeServingCore, PagedKVCache,
                                        SpeculativeEngine,
                                        TokenServingModel, moe_capacity)
from paddle_tpu_torch.inference import moe_serving as tms
from paddle_tpu_torch.ops.hopper import grouped_gemm as tgg
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
D, H, FFN, LAYERS, VOCAB, BS = 32, 4, 64, 2, 50, 4
E, K = 4, 2
PROMPTS = [list(range(5 + i, 12 + i)) for i in range(3)]
TOL_H = 1e-5      # hidden rows, relative to max|h|


def _jax_core(seed=0, **kw):
    paddle.seed(seed)
    cfg = dict(num_experts=E, top_k=K, capacity_factor=1.25,
               num_layers=LAYERS)
    cfg.update(kw)
    return JaxMoe(D, H, FFN, **cfg)


def _port_core(jcore, **kw):
    state = {k: np.asarray(v.numpy()) for k, v in
             jcore.state_dict().items()}
    return weights.moe_serving_core(
        state, H, top_k=jcore.top_k,
        capacity_factor=jcore.capacity_factor, device="cpu", **kw)


def _heads(seed=0):
    rng = np.random.RandomState(seed)
    emb = (rng.randn(VOCAB, D) * 0.3).astype(np.float32)
    # rolled readout: greedy streams walk the vocab, so a routing bug
    # cannot hide inside a constant stream
    return emb, np.roll(emb, -1, 0).T.copy()


def _tsms(seed=0, **kw):
    """(JAX token model, port token model) over the same weights."""
    jcore = _jax_core(seed, **kw)
    emb, head = _heads(seed)
    return (JaxTSM(jcore, emb, lm_head=head),
            TokenServingModel(_port_core(jcore), emb, lm_head=head))


def _run(eng, steps=8):
    rids = [eng.submit(p) for p in PROMPTS]
    for _ in range(steps):
        eng.step()
    return {i: eng.tokens(r) for i, r in enumerate(rids)}


def _engine(cls, tsm, draft=None, **kw):
    cfg = dict(k=0, max_batch=3, block_size=BS, num_blocks=40)
    cfg.update(kw)
    eng = cls(tsm, draft, **cfg)
    if cls is JaxSpec:
        eng.engine.ragged_step = "force"
    return eng


def _moe(eng):
    return {k: v for k, v in eng.engine.registry.as_dict().items()
            if k.startswith("moe.")}


# the JAX engine's streams and moe.* counters per mode, once per module
_BASE = {}


def _jax_baseline(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _BASE:
        jt, _ = _tsms()
        eng = _engine(JaxSpec, jt, **kw)
        _BASE[key] = (_run(eng), _moe(eng))
    return _BASE[key]


def _port_run(tsm=None, draft=None, **kw):
    if tsm is None:
        tsm = _tsms()[1]
    eng = _engine(SpeculativeEngine, tsm, draft, **kw)
    return eng, _run(eng)


# -- routing -------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5"])
def test_route_matches_jax(cf):
    rng = np.random.RandomState(5)
    lg = rng.randn(24, E).astype(np.float32)
    lg[3] = 0.0                   # exact ties: lowest expert ids first
    lg[10:14] = 0.0
    cap = moe_capacity(cf, lg.shape[0], K, E)
    ref = [np.asarray(a) for a in jms._route_impl(jnp.asarray(lg), K, E,
                                                  cap)]
    got = [a.numpy() for a in tms._route_impl(torch.from_numpy(lg), K, E,
                                               cap)]
    names = ("w", "expert", "pos", "keep", "val", "load", "dropped")
    for name, g, r in zip(names, got, ref):
        if name in ("w", "val"):
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
    assert list(got[1][:, 3]) == [0, 1]
    if cf < 1:
        assert got[6].sum() > 0


def test_capacity_formula_and_guards():
    assert moe_capacity(1.25, 16, 2, 4) == 10
    assert moe_capacity(1.0, 8, 2, 4) == 4
    assert moe_capacity(1.0, 1, 2, 4) == 2
    with pytest.raises(ValueError, match="top_k"):
        MoeServingCore(D, H, FFN, num_experts=2, top_k=3, device="cpu")
    core = _port_core(_jax_core())
    with pytest.raises(ValueError, match="divide"):
        core.shard_experts(3)
    assert core.moe_spec == {"num_experts": E, "top_k": K,
                             "capacity_factor": 1.25, "ffn_dim": FFN}


# -- the grouped GEMM's plain version -----------------------------------

@pytest.mark.parametrize("block_m", [8, 16])
def test_plain_gmm_matches_jax_gmm(block_m):
    """Uneven groups padded by make_group_metadata: the plain version
    against the JAX gmm in interpret mode and its jnp reference."""
    sizes = [5, 0, 19, 8]
    offs, be, total = tgg.make_group_metadata(sizes, block_m)
    j_offs, j_be, j_total = jgg.make_group_metadata(sizes, block_m)
    np.testing.assert_array_equal(offs, j_offs)
    np.testing.assert_array_equal(be, j_be)
    assert total == j_total
    rng = np.random.RandomState(block_m)
    lhs = rng.randn(total, 48).astype(np.float32)
    rhs = rng.randn(len(sizes), 48, 40).astype(np.float32)
    got = tgg.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs), be,
                  block_m=block_m).numpy()
    for ref in (jgg.gmm(jnp.asarray(lhs), jnp.asarray(rhs), be,
                        block_m=block_m),
                jgg.gmm_reference(jnp.asarray(lhs), jnp.asarray(rhs), be,
                                  block_m=block_m)):
        ref = np.asarray(ref)
        tol = 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    assert tgg.launch_count() == 0       # the CPU never launches
    with pytest.raises(ValueError, match="multiple of block_m"):
        tgg.gmm(torch.zeros(total + 1, 48), torch.from_numpy(rhs), be,
                block_m=block_m)


# -- the core -------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["grouped", "fold"])
@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5"])
def test_forward_matches_jax(use_kernel, cf):
    """One forward over rows with an all-zero batch entry: hidden within
    TOL_H x max|h| of the JAX core, load and overflow counters equal;
    cf 0.5 forces overflow through the residual bypass."""
    jcore = _jax_core(capacity_factor=cf, use_kernel=False)
    tcore = _port_core(jcore, use_kernel=use_kernel)
    x = np.random.RandomState(7).randn(3, 5, D).astype(np.float32)
    x[1] = 0.0
    ref = np.asarray(jcore(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tcore(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_H * np.abs(ref).max(),
                               rtol=0)
    tm, jm = tcore.moe_metrics(), jcore.moe_metrics()
    assert tm == jm
    if cf < 1:
        assert tm["dropped_tokens"] > 0


# -- serving modes --------------------------------------------------------

MODES = {
    "plain": {},
    "prefix_cache": dict(prefix_cache=True),
    "token_budget": dict(prefill_token_budget=8, prefix_cache=True),
    "spec_self_draft_k2": dict(k=2),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_and_counters_equal_jax(mode):
    kw = MODES[mode]
    j_toks, j_moe = _jax_baseline(**kw)
    eng, toks = _port_run(**kw)
    assert toks == j_toks
    assert _moe(eng) == j_moe
    assert all(len(t) > len(p) for t, p in zip(toks.values(), PROMPTS))
    eng.check_invariants()


def test_grouped_path_streams_equal_the_fold():
    """use_kernel=True on the CPU: the grouped path (plain gmm) serves
    the same greedy streams and counters as the JAX engine's fold."""
    j_toks, j_moe = _jax_baseline()
    jcore = _jax_core()
    emb, head = _heads()
    tsm = TokenServingModel(_port_core(jcore, use_kernel=True), emb,
                            lm_head=head)
    eng, toks = _port_run(tsm)
    assert toks == j_toks
    assert _moe(eng) == j_moe


@pytest.mark.parametrize("ep", [2, 4])
def test_shard_experts_bitwise_equal_unsharded(ep):
    """shard_experts(ep): one forward bitwise equal to the unsharded
    fold, and the same streams; the registry reports ep."""
    _, base = _tsms()
    _, tsm = _tsms()
    tsm.core.shard_experts(ep)
    x = torch.from_numpy(
        np.random.RandomState(3).randn(2, 6, D).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(tsm.core(x), base.core(x))
    _, b_toks = _port_run(base)
    eng, toks = _port_run(tsm)
    assert toks == b_toks
    assert eng.engine.registry.as_dict()["moe.ep"] == ep


def test_ep2_speculative_equals_unsharded():
    _, tsm = _tsms()
    tsm.core.shard_experts(2)
    _, toks = _port_run(tsm, k=2)
    assert toks == _jax_baseline(k=2)[0]


# -- metrics ----------------------------------------------------------------

def test_moe_namespace_every_step():
    _, tsm = _tsms()
    eng = _engine(SpeculativeEngine, tsm)
    for p in PROMPTS:
        eng.submit(p)
    reg = eng.engine.registry
    last = -1
    for _ in range(6):
        eng.step()
        d = reg.as_dict()
        for key in ("moe.experts", "moe.top_k", "moe.calls", "moe.rows",
                    "moe.routed_tokens", "moe.dropped_tokens",
                    "moe.overflow_rate"):
            assert key in d, key
        for e in range(E):
            assert f"moe.load.{e}" in d and f"moe.overflow.{e}" in d
        assert d["moe.routed_tokens"] > last
        last = d["moe.routed_tokens"]
    d = reg.as_dict()
    assert sum(d[f"moe.load.{e}"] for e in range(E)) == \
        d["moe.routed_tokens"]
    assert sum(d[f"moe.overflow.{e}"] for e in range(E)) == \
        d["moe.dropped_tokens"]


def test_dense_engine_has_no_moe_namespace():
    core = FusedMultiTransformer(D, H, FFN, num_layers=LAYERS,
                                 device="cpu")
    emb, _ = _heads()
    eng = SpeculativeEngine(TokenServingModel(core, emb), k=0, max_batch=2,
                            block_size=BS, num_blocks=20)
    eng.submit(PROMPTS[0])
    eng.step()
    assert not any(k.startswith("moe.")
                   for k in eng.engine.registry.as_dict())


def test_overflow_shows_up_under_tight_capacity():
    _, tsm = _tsms(capacity_factor=0.5)
    eng, toks1 = _port_run(tsm)
    d = eng.engine.registry.as_dict()
    assert d["moe.dropped_tokens"] > 0
    assert 0.0 < d["moe.overflow_rate"] < 1.0
    _, toks2 = _port_run(_tsms(capacity_factor=0.5)[1])
    assert toks1 == toks2


# -- snapshot / restore -----------------------------------------------------

def test_snapshot_round_trip_and_reshard():
    jcore = _jax_core()
    a = _port_core(jcore)
    with torch.no_grad():
        a(torch.from_numpy(np.random.RandomState(3).randn(
            2, 4, D).astype(np.float32)))
    a.shard_experts(2)
    snap = a.snapshot()
    assert snap["kind"] == "moe_serving_core"
    b = _port_core(jcore)
    b.restore(snap)
    assert b.moe_metrics() == a.moe_metrics()
    assert b._ep == 2


def test_config_mismatch_refused():
    snap = _port_core(_jax_core()).snapshot()
    other = MoeServingCore(D, H, FFN, num_experts=2, top_k=2,
                           num_layers=LAYERS, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        other.restore(snap)


# -- the truncated draft ----------------------------------------------------

def test_truncated_draft_shares_weights_and_serves():
    """The MoE draft is the core's own routed twin over the same block
    modules; under k=2 it serves the JAX package's streams."""
    jt, tsm = _tsms()
    draft = tsm.truncated_draft(1)
    assert isinstance(draft.core, MoeServingCore)
    assert draft.core.num_layers == 1
    assert draft.core.layers[0] is tsm.core.layers[0]
    assert draft.core.layers[0].moe_w1.data_ptr() == \
        tsm.core.layers[0].moe_w1.data_ptr()
    jeng = _engine(JaxSpec, jt, jt.truncated_draft(1), k=2)
    j_toks = _run(jeng, steps=6)
    eng = _engine(SpeculativeEngine, tsm, draft, k=2)
    assert _run(eng, steps=6) == j_toks
    assert _moe(eng) == _moe(jeng)
    eng.check_invariants()
    with pytest.raises(ValueError, match="num_layers"):
        tsm.core.truncated(0)
    with pytest.raises(ValueError, match="num_layers"):
        tsm.core.truncated(LAYERS + 1)


def test_cache_geometry_from_the_core():
    cache = PagedKVCache.for_model(_port_core(_jax_core()), BS, 10,
                                   max_seqs=2)
    assert (cache.num_layers, cache.num_heads, cache.head_dim) == \
        (LAYERS, H, D // H)
