"""The PyTorch port's quantized serving slice (paddle_tpu_torch:
quantization.functional, ops/hopper/int8_matmul.py, int8 KV pages in
inference/paged_cache.py, the int8 ragged attention path,
FusedMultiTransformerInt8 and the int8 head of TokenServingModel) held
against the JAX package on the CPU at tiny widths (d 64, 4 heads,
2 layers, vocab 128).

What is checked, with its tolerance:
  * quantization bytes EQUAL: ``_quant_rows`` (KV rows), ``quantize``
    (weights) and the head's own quantization produce the same int8
    payload and float32 scales from the same float inputs;
  * the plain w8a16 product and ``quantized_matmul`` against the JAX
    functions (the Pallas kernel in interpret mode where its tiling
    applies), rtol 1e-5 and atol 1e-5 x max|ref|, on both sides of the
    256-row split;
  * the plain int8 ragged attention against the Pallas kernel in
    interpret mode, 2e-5 (the JAX module's own interpret tolerance);
  * pool byte counts equal;
  * the int8 stack's forward within 1e-4 (the two reduce in different
    orders, and at these widths the JAX projections dequantize while the
    port scales the w8a16 product);
  * int8 weights + int8 KV pages + prefix cache: greedy streams,
    outcomes and the whole prefix-cache control state EQUAL to the JAX
    engine's after the same run.
The CUDA kernels themselves are held against these plain versions by
the ``cuda``-marked tests in test_torch_cuda.py.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.incubate.nn import FusedMultiTransformerInt8 as JaxFMT8
from paddle_tpu.inference import PagedKVCache as JaxKV
from paddle_tpu.inference import SpeculativeEngine as JaxSpec
from paddle_tpu.inference import TokenServingModel as JaxTSM
from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate.nn import FusedMultiTransformerInt8
from paddle_tpu_torch.inference import (PagedKVCache, SpeculativeEngine,
                                        TokenServingModel)
from paddle_tpu_torch.inference import paged_cache as tpc
from paddle_tpu_torch.ops.hopper import int8_matmul as tim
from paddle_tpu_torch.ops.hopper import paged_attention as tpa
from paddle_tpu_torch.quantization import functional as tqf
from tests.torch_twins import shared_jax_cache  # noqa: F401

jpc = importlib.import_module("paddle_tpu.inference.paged_cache")
jqf = importlib.import_module("paddle_tpu.quantization.functional")
jim = importlib.import_module("paddle_tpu.ops.pallas.int8_matmul")
jpa = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

torch.set_num_threads(1)
D, HEADS, FFN, LAYERS, VOCAB = 64, 4, 128, 2, 128
HID = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return np.array(x.numpy() if hasattr(x, "numpy") else x)


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _rows(seed, shape):
    """Float rows with an all-zero row and rows at mixed magnitudes."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    x *= np.float32(10.0) ** rng.randint(-3, 3, shape[:-1] + (1,))
    x.reshape(-1, shape[-1])[0] = 0.0
    return x


def test_quant_rows_byte_equal():
    x = _rows(0, (7, 3, 16))
    jq, js = jpc._quant_rows(jnp.asarray(x))
    tq, ts = tpc._quant_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    # the all-zero row: payload 0, scale 0
    assert not tq.numpy()[0, 0].any() and ts.numpy()[0, 0] == 0.0


@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "scalar"])
def test_quantize_byte_equal(per_channel):
    """The weight quantization of FusedMultiTransformerInt8 (per-output-
    channel abs-max, floored at 1e-8) and a scalar scale, with the
    dequantized values."""
    w = _rows(1, (32, 24))
    if per_channel:
        scale = np.maximum(np.abs(w).max(axis=0), np.float32(1e-8))
        axis = -1
    else:
        scale, axis = np.float32(np.abs(w).max() / 3), None
    jq = _np(jqf.quantize(paddle.to_tensor(w), paddle.to_tensor(scale),
                          axis=axis))
    tq = tqf.quantize(torch.from_numpy(w), torch.as_tensor(scale),
                      axis=axis)
    assert tq.numpy().tobytes() == jq.tobytes()
    jd = _np(jqf.dequantize(paddle.to_tensor(jq), paddle.to_tensor(scale),
                            axis=axis))
    td = tqf.dequantize(tq, torch.as_tensor(scale), axis=axis)
    assert td.numpy().tobytes() == jd.tobytes()


def _jax_core():
    paddle.seed(0)
    return JaxFMT(D, HEADS, FFN, num_layers=LAYERS)


def _state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def test_int8_head_byte_equal():
    emb = np.random.RandomState(2).randn(VOCAB, D).astype(np.float32)
    jcore = _jax_core()
    tcore = weights.fused_multi_transformer(_state(jcore), HEADS,
                                            device="cpu")
    jt = JaxTSM(jcore, emb, weight_dtype="int8")
    tt = TokenServingModel(tcore, emb, weight_dtype="int8")
    assert tt._head_int8.numpy().tobytes() == \
        _np(jt._head_int8).tobytes()
    assert tt._head_scale.numpy().tobytes() == \
        _np(jt._head_scale).tobytes()
    assert tt.weight_bytes() == jt.weight_bytes() == VOCAB * D + 4 * VOCAB
    h = np.random.RandomState(3).randn(2, 3, D).astype(np.float32)
    _close(tt.logits(torch.from_numpy(h)).numpy(),
           _np(jt.logits(paddle.to_tensor(h))))


@pytest.mark.parametrize("M", [1, 8, 256])
def test_w8a16_plain_matches_pallas(M):
    """The plain version against the Pallas kernel (interpret mode) at
    the serving row counts, at widths its tiling takes."""
    rng = np.random.RandomState(M)
    K, N = 128, 256
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randint(-128, 128, (K, N)).astype(np.int8)
    ref = jim.w8a16_matmul(jnp.asarray(x), jnp.asarray(w))
    assert ref is not None          # the Pallas path, not a fallback
    got = tim.w8a16_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)
    # gradient: the plain contraction g @ w.T
    xt = torch.from_numpy(x).requires_grad_()
    tim.w8a16_matmul(xt, torch.from_numpy(w)).sum().backward()
    _close(xt.grad.numpy(), np.ones((M, N), np.float32) @
           w.astype(np.float32).T)


@pytest.mark.parametrize("sms", [132, 16, 1])
@pytest.mark.parametrize("M,K,N", [
    (1, 1024, 3072), (8, 1024, 1024), (8, 4096, 1024), (16, 1024, 4096),
    (8, 1024, 50304), (256, 1024, 3072), (64, 1024, 1024), (17, 300, 77),
    (2, 127, 5), (9, 129, 64), (1, 100000, 64), (1, 1, 1), (33, 512, 64)])
def test_w8a16_tiling(M, K, N, sms):
    """The host's tiling of a w8a16 call: row tiles of 1, 2, 4 or 8 rows
    (the FMA kernel) up to 8 rows, 16 up to 16, else 32 (the tensor-core
    kernel); every K split owns at least
    one K position, together they cover K exactly once, a cluster holds
    at most MAX_SPLITS blocks, and a call whose column strips and row
    tiles already fill the SMs takes one split."""
    tm, splits, per = tim.w8a16_tiling(M, K, N, sms)
    assert tm == min(t for t in (1, 2, 4, 8, 16, 32) if t >= min(M, 32))
    assert 1 <= splits <= tim.MAX_SPLITS and per >= 1
    span = per * tim.BLOCK_K
    owned = [max(0, min(K, (z + 1) * span) - z * span)
             for z in range(splits)]
    assert min(owned) >= 1 and sum(owned) == K
    blocks = -(-N // tim.BLOCK_N) * -(-M // tm)
    if blocks >= sms:
        assert splits == 1
    else:   # as many as one block an SM asks for, as K and a cluster allow
        k_tiles = -(-K // tim.BLOCK_K)
        want = min(tim.MAX_SPLITS, k_tiles, -(-sms // blocks))
        assert splits == -(-k_tiles // -(-k_tiles // want))


@pytest.mark.parametrize("rows", [256, 257])
def test_quantized_matmul_matches_jax(rows):
    """256 rows take the w8a16 path on both sides, 257 the dequantized
    library product."""
    rng = np.random.RandomState(rows)
    K, N = 128, 256
    w = rng.randn(K, N).astype(np.float32)
    scale = np.maximum(np.abs(w).max(axis=0), np.float32(1e-8))
    wq = _np(jqf.quantize(paddle.to_tensor(w), paddle.to_tensor(scale),
                          axis=-1))
    x = rng.randn(rows, K).astype(np.float32)
    ref = _np(jqf.quantized_matmul(paddle.to_tensor(x),
                                   paddle.to_tensor(wq),
                                   paddle.to_tensor(scale)))
    got = tqf.quantized_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                               torch.from_numpy(scale))
    _close(got.numpy(), ref)
    with pytest.raises(NotImplementedError, match="later slice"):
        tqf.quantized_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                             torch.from_numpy(scale),
                             x_scale=torch.ones(()))


def test_int8_ragged_plain_matches_pallas():
    """Int8 pages written by _quant_rows, a mixed batch with a zero-length
    segment and an all-trash row at t = 0 (block 0's scales are zero)."""
    rng = np.random.RandomState(12)
    NB, nkv, bs, hd, nh = 12, 2, 4, 8, 4
    q_lens = (1, 2, 0, 5, 1)
    kv_lens = np.asarray([9, 6, 4, 13, 1], np.int32)
    qp, sc = tpc._quant_rows(torch.from_numpy(
        rng.randn(NB, 2, nkv, bs, hd).astype(np.float32)))
    qp[0], sc[0] = 0, 0.0                          # the trash block
    bt = np.zeros((5, 4), np.int32)
    bt[0, :3] = [1, 2, 3]
    bt[1, :2] = [4, 5]
    bt[2, :1] = [10]
    bt[3, :4] = [6, 7, 8, 9]                       # row 4: all trash
    q = rng.randn(sum(q_lens), nh, hd).astype(np.float32)
    ref = jpa.paged_attention_ragged(
        jnp.asarray(q), jnp.asarray(qp.numpy()), jnp.asarray(bt), q_lens,
        jnp.asarray(kv_lens), kv_scales=jnp.asarray(sc.numpy()))
    args = (torch.from_numpy(q), qp, torch.from_numpy(bt), q_lens,
            torch.from_numpy(kv_lens))
    plain = tpa.paged_attention_ragged_reference(*args, kv_scales=sc)
    got = tpa.paged_attention_ragged(*args, kv_scales=sc)   # CPU: plain
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    assert torch.equal(got, plain)
    assert torch.isfinite(got).all()
    with pytest.raises(ValueError, match="kv_scales"):
        tpa.paged_attention_ragged(*args)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pool_bytes_equal_jax(dtype):
    jc = JaxKV(3, 4, 16, 4, 20, 2, dtype=dtype)
    tc = PagedKVCache(3, 4, 16, 4, 20, 2, dtype=dtype, device="cpu")
    assert tc.kv_bytes_per_token() == jc.kv_bytes_per_token()
    assert tc.pool_bytes() == jc.pool_bytes()
    assert tc.quantized == (dtype == "int8")


def test_int8_stack_matches_jax():
    """FusedMultiTransformerInt8: the JAX model's int8 buffers carried
    over by weights.py serve the same forward within 1e-4, and the
    port's own from_float quantizes the float weights to the same
    bytes."""
    jcore = _jax_core()
    j8 = JaxFMT8.from_float(jcore)
    t8 = weights.fused_multi_transformer(_state(j8), HEADS, device="cpu")
    assert isinstance(t8, FusedMultiTransformerInt8)
    tf = weights.fused_multi_transformer(_state(jcore), HEADS,
                                         device="cpu")
    mine = FusedMultiTransformerInt8.from_float(tf).state_dict()
    for k, v in _state(j8).items():
        assert mine[k].numpy().tobytes() == v.tobytes(), k
    x = np.random.RandomState(4).randn(2, 7, D).astype(np.float32)
    ref = _np(j8(paddle.to_tensor(x)))
    with torch.no_grad():
        got = t8(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **HID)
    assert "layers.0.qkv.weight" not in mine


# int8 weights + int8 KV pages + prefix cache: a shared 8-token system
# prefix (two 4-token blocks) before each prompt, 2 slots over 7 usable
# pages (the pool preempts and prompts adopt each other's pages)
_RNG = np.random.RandomState(23)
_EMBED = _RNG.randn(VOCAB, D).astype(np.float32)
_SYSTEM = list(_RNG.randint(0, VOCAB, 8))
_PROMPTS = [_SYSTEM + list(_RNG.randint(0, VOCAB, n))
            for n in (3, 9, 6, 13)]
POOL = dict(max_batch=2, block_size=4, num_blocks=8, chunk_tokens=8,
            prefill_token_budget=12, prefix_cache=True, kv_dtype="int8")


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


def test_quantized_serving_matches_jax():
    """The slice's configuration at tiny width: SpeculativeEngine(k=0)
    over TokenServingModel(FusedMultiTransformerInt8, weight_dtype=
    "int8") with int8 KV pages and the prefix cache. Streams, outcomes,
    free and cached-free tiers, tables, hash index and prefix statistics
    equal the JAX engine's; the pool fingerprints payload and scales."""
    j8 = JaxFMT8.from_float(_jax_core())
    jt = JaxTSM(j8, _EMBED, weight_dtype="int8")
    tt = weights.token_serving_model(
        _state(j8), _EMBED, HEADS, head_int8=_np(jt._head_int8),
        head_scale=_np(jt._head_scale), device="cpu")
    je = JaxSpec(jt, None, k=0, **POOL)
    je.engine.ragged_step = "force"
    te = SpeculativeEngine(tt, None, k=0, **POOL)
    j_streams, j_out = _serve(je)
    t_streams, t_out = _serve(te)
    assert t_streams == j_streams
    assert t_out == j_out
    jc, tc = je.engine.cache, te.engine.cache
    assert tc.quantized and tc.pools[0].dtype == torch.int8
    assert [int(b) for b in tc.allocator._free] == \
        [int(b) for b in jc.allocator._free]
    assert list(tc.allocator._cached) == list(jc.allocator._cached)
    assert tc.block_tables.tolist() == jc.block_tables.tolist()
    assert tc._hash_to_block == jc._hash_to_block
    assert te.engine.prefix_stats.as_dict() == \
        je.engine.prefix_stats.as_dict()
    assert te.engine.prefix_stats.hit_blocks > 0
    assert sum(o["preemptions"] for o in t_out) >= 1
    # the cached-free pages dequantize to the JAX pages' values within
    # one quantization step (the K/V rows differ by float rounding)
    ids = sorted(tc.allocator._cached)
    assert ids
    for li in range(LAYERS):
        js = _np(jc.scales[li])[ids]
        dj = _np(jc.pools[li])[ids].astype(np.float32) * js[..., None]
        dt = tc.pools[li][ids].float() * tc.scales[li][ids][..., None]
        np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5,
                                   atol=1.01 * float(js.max()))
    te.engine.check_invariants()
