"""The PyTorch port's serving slice (paddle_tpu_torch: FusedMultiTransformer,
PagedKVCache, PagedServingEngine, ContinuousBatchingEngine,
TokenServingModel, SpeculativeEngine k=0) held against the JAX package
on the CPU at tiny widths (d 64, 4 heads, 2 layers, vocab 128).

Weights come from a ``paddle.seed(0)`` JAX model through
``paddle_tpu_torch.weights``; prompts and decode inputs from seeded numpy.
On the JAX side ``ragged_step = "force"`` makes its engine take the packed
mixed step, which the port takes whenever a token budget is set. What is
checked: the control plane EXACTLY (allocator free list and refcounts,
block tables, slot state, event and outcome sequences), hidden rows within
1e-4 (XLA and ATen reduce in different orders), greedy token streams
equal."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.inference import ContinuousBatchingEngine as JaxCBE
from paddle_tpu.inference import SpeculativeEngine as JaxSpec
from paddle_tpu.inference import TokenServingModel as JaxTSM
from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        SpeculativeEngine)
from paddle_tpu_torch.nn import LayerNorm, Linear

torch.set_num_threads(1)
D, HEADS, FFN, LAYERS, VOCAB = 64, 4, 128, 2, 128
HID = dict(atol=1e-4, rtol=1e-4)
REPO = Path(__file__).resolve().parents[1]

_RNG = np.random.RandomState(7)
_EMBED = _RNG.randn(VOCAB, D).astype(np.float32)
_HEAD = _RNG.randn(D, VOCAB).astype(np.float32)
_PROMPTS = [list(_RNG.randint(0, VOCAB, n)) for n in (5, 23, 9, 31, 3, 14)]
# 3 slots over 15 usable 4-token pages: the six prompts refill slots and
# force preemptions with re-prefill from history
POOL = dict(max_batch=3, block_size=4, num_blocks=16, chunk_tokens=8,
            prefill_token_budget=12)


def _jax_core():
    paddle.seed(0)
    return JaxFMT(D, HEADS, FFN, num_layers=LAYERS)


def _pair():
    """(JAX core, port core) holding the same weights."""
    jcore = _jax_core()
    state = {k: np.asarray(v.numpy()) for k, v in
             jcore.state_dict().items()}
    return jcore, weights.fused_multi_transformer(state, HEADS,
                                                  device="cpu")


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


@pytest.fixture
def jax_op_by_op():
    """Runs the JAX package op by op for the test (its per-op executable
    cache and its layer captures off), restoring the flags after. With
    them on, its first serve in a process ends prompt 3's stream with
    token 5 instead of 63 in a few percent of processes when other
    processes load the CPU (a near-tie of the top two logits; the second
    serve in the same process differs too, more rarely); op by op it
    gave 63 every time, as the port does."""
    names = ("FLAGS_eager_op_jit", "FLAGS_eager_layer_jit")
    before = {n: paddle.flags.get_flag(n) for n in names}
    paddle.set_flags({n: False for n in names})
    yield
    paddle.set_flags(before)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    banned = {"jax", "jaxlib", "paddle_tpu"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{f}: imports {n}"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedMultiTransformer(D, HEADS, FFN, num_layers=1)


@pytest.mark.parametrize("make", [lambda **kw: Linear(D, FFN, **kw),
                                  lambda **kw: LayerNorm(D, **kw)],
                         ids=["Linear", "LayerNorm"])
def test_layers_default_to_cuda(make):
    """The public layers place their parameters on the card unless the
    caller names a device; without a card that raises."""
    assert make(device="cpu").weight.device.type == "cpu"
    if torch.cuda.is_available():
        assert make().weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_forward_matches_jax():
    jcore, tcore = _pair()
    x = np.random.RandomState(0).randn(2, 7, D).astype(np.float32)
    ref = _np(jcore(paddle.to_tensor(x)))
    with torch.no_grad():
        got = tcore(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **HID)


def test_dense_engine_matches_jax():
    """ContinuousBatchingEngine: full-extent masked prefill, then
    per-row decode steps (the decode-attention path), slot release and
    refill."""
    jcore, tcore = _pair()
    rng = np.random.RandomState(1)
    je, te = JaxCBE(jcore, 2, 40), ContinuousBatchingEngine(tcore, 2, 40)
    for T in (9, 4):
        p = rng.randn(T, D).astype(np.float32)
        js, jh = je.add_request(paddle.to_tensor(p))
        ts, th = te.add_request(p)
        assert js == ts
        np.testing.assert_allclose(th.numpy(), _np(jh), **HID)
    for step in range(5):
        if step == 3:
            je.release(0)
            te.release(0)
            p = rng.randn(6, D).astype(np.float32)
            je.add_request(paddle.to_tensor(p))
            te.add_request(p)
        x = rng.randn(2, 1, D).astype(np.float32)
        jo = _np(je.step(paddle.to_tensor(x)))
        to = te.step(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(to, jo, **HID)
        np.testing.assert_array_equal(te.lens, je.lens)


def _serve(eng, n_gen=6):
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


@pytest.mark.usefixtures("jax_op_by_op")
def test_token_serving_streams_equal_jax():
    """SpeculativeEngine(k=0) with a token budget: six prompts through
    three slots (refill) and a pool small enough to preempt — greedy
    streams and the outcome sequence equal the JAX engine's."""
    jcore, tcore = _pair()
    from paddle_tpu_torch.inference import TokenServingModel
    je = JaxSpec(JaxTSM(jcore, _EMBED, _HEAD), None, k=0, **POOL)
    je.engine.ragged_step = "force"
    te = SpeculativeEngine(TokenServingModel(tcore, _EMBED, _HEAD), None,
                           k=0, **POOL)
    j_streams, j_out = _serve(je)
    t_streams, t_out = _serve(te)
    assert t_streams == j_streams
    assert t_out == j_out
    assert sum(o["preemptions"] for o in t_out) >= 1
    assert te.engine.prefill_stats.mixed_steps >= 1


def test_token_surface_matches_jax():
    jcore, tcore = _pair()
    from paddle_tpu_torch.inference import TokenServingModel
    jt, tt = JaxTSM(jcore, _EMBED), TokenServingModel(tcore, _EMBED)
    h = np.random.RandomState(3).randn(2, 3, D).astype(np.float32)
    jl = jt.logits(paddle.to_tensor(h))
    tl = tt.logits(torch.from_numpy(h))
    np.testing.assert_allclose(tl.numpy(), _np(jl), **HID)
    np.testing.assert_allclose(
        tt.probs(tl, temperature=0.7, top_k=5).numpy(),
        _np(jt.probs(jl, temperature=0.7, top_k=5)), **HID)
    jtok, _ = jt.sample(jl, mode="top_k", top_k=5, temperature=0.7,
                        rng=np.random.RandomState(5))
    ttok, _ = tt.sample(tl, mode="top_k", top_k=5, temperature=0.7,
                        rng=np.random.RandomState(5))
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tt.sample(tl)[0], jt.sample(jl)[0])


def test_fork_and_cow_match_jax_allocator():
    """fork / ensure (COW split) / truncate / free_seq: the same op
    sequence leaves both pools' allocators and tables identical."""
    from paddle_tpu.inference import PagedKVCache as JaxKV
    from paddle_tpu_torch.inference import PagedKVCache
    jc = JaxKV(1, 2, 8, 4, 12, 3)
    tc = PagedKVCache(1, 2, 8, 4, 12, 3, device="cpu")
    ops = [("ensure", 0, 10), ("fork", 0, 1, 10), ("ensure", 1, 11),
           ("ensure", 2, 5), ("truncate", 0, 3), ("free_seq", 2),
           ("ensure", 0, 16)]
    for op, *args in ops:
        getattr(jc, op)(*args)
        getattr(tc, op)(*args)
        assert list(tc.allocator._free) == list(jc.allocator._free)
        assert tc.allocator.refcount.tolist() == \
            jc.allocator.refcount.tolist()
        assert tc.block_tables.tolist() == jc.block_tables.tolist()
        tc.check_invariants()
