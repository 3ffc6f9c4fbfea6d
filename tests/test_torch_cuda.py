"""Card tests of the PyTorch port: each hand-written CUDA kernel against
its plain PyTorch version, and the serving slice on CUDA against the
same slice on the CPU. They carry the ``cuda`` marker and skip without a
CUDA device (the kernels have no CPU mode). This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn import (FusedMultiTransformer,
                                          FusedMultiTransformerInt8)
from paddle_tpu_torch.inference import (MoeServingCore, SpeculativeEngine,
                                        TokenServingModel)
from paddle_tpu_torch.inference.paged_cache import _quant_rows
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import decode_attention as tda
from paddle_tpu_torch.ops.hopper import grouped_gemm as tgg
from paddle_tpu_torch.ops.hopper import int8_matmul as tim
from paddle_tpu_torch.ops.hopper import paged_attention as tpa

pytestmark = pytest.mark.cuda
# float32 kernels vs their float32 plain versions: summation order only
TOL = dict(atol=1e-5, rtol=1e-5)

RAGGED = {
    # name: (nh, nkv, hd, bs, q_lens, kv_lens, MB, trash_rows, tile_q)
    "decode": (4, 4, 64, 16, (1, 1, 1), (5, 16, 333), 24, (), None),
    "verify": (4, 4, 64, 16, (4, 4), (9, 200), 16, (), None),
    "prefill_chunk": (16, 16, 64, 16, (128,), (384,), 64, (), None),
    "mixed_zero_len_and_trash": (4, 4, 64, 4, (1, 6, 0, 1, 3),
                                 (1, 14, 4, 9, 3), 4, (0,), None),
    "gqa": (8, 2, 128, 8, (1, 5, 2), (12, 5, 17), 3, (), None),
    "partial_tail_tile": (4, 4, 64, 16, (70, 3, 1), (100, 40, 3), 8, (),
                          16),
    # head_dim not a multiple of 4: the scalar-load path
    "scalar_loads": (4, 2, 30, 16, (1, 3), (40, 70), 5, (), None),
}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _ragged(seed, nh, nkv, hd, bs, q_lens, kv_lens, MB, trash_rows):
    rng = np.random.RandomState(seed)
    need = [-(-int(L) // bs) for L in kv_lens]
    NB = 1 + sum(need) + 2
    pool = rng.randn(NB, 2, nkv, bs, hd).astype(np.float32)
    bt = np.zeros((len(q_lens), MB), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    k = 0
    for s, n in enumerate(need):
        if s not in trash_rows:
            bt[s, :n] = perm[k:k + n]
            k += n
    q = rng.randn(sum(q_lens), nh, hd).astype(np.float32)
    return (torch.from_numpy(q).cuda(), torch.from_numpy(pool).cuda(), bt,
            np.asarray(kv_lens, np.int32))


@pytest.mark.parametrize("name", sorted(RAGGED))
def test_ragged_kernel_matches_plain_version(name):
    _need_cuda()
    nh, nkv, hd, bs, q_lens, kv_lens, MB, trash, tile_q = RAGGED[name]
    q, pool, bt, lens = _ragged(4, nh, nkv, hd, bs, q_lens, kv_lens, MB,
                                trash)
    before = tpa.launch_count()
    got = tpa.paged_attention_ragged(q, pool, bt, q_lens, lens,
                                     tile_q=tile_q)
    assert tpa.launch_count() == before + 1
    ref = tpa.paged_attention_ragged_reference(q, pool, bt, q_lens, lens)
    torch.testing.assert_close(got, ref, **TOL)
    # a strided q (the split qkv projection's view) reads the same
    wide = torch.cat([q, q, q], dim=-1)[..., :hd]
    torch.testing.assert_close(
        tpa.paged_attention_ragged(wide, pool, bt, q_lens, lens,
                                   tile_q=tile_q), got, atol=0, rtol=0)


def test_ragged_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    q, pool, bt, lens = _ragged(5, 4, 4, 64, 16, (1, 2), (5, 9), 2, ())
    with pytest.raises(TypeError):
        tpa.paged_attention_ragged(q.double(), pool.double(), bt, (1, 2),
                                   lens)
    with pytest.raises(ValueError):
        tpa.paged_attention_ragged(q, pool.transpose(3, 4), bt, (1, 2),
                                   lens)


@pytest.mark.parametrize("nh,nkv,hd,S,lens", [
    (4, 4, 64, 32, [0, 1, 17, 32]),
    (8, 2, 64, 300, [5, 300, 0]),
    (16, 16, 64, 1024, [64, 1000, 513, 1024]),
    (4, 4, 30, 40, [3, 40]),          # scalar-load path
])
def test_decode_kernel_matches_plain_version(nh, nkv, hd, S, lens):
    _need_cuda()
    rng = np.random.RandomState(S)
    cache = torch.from_numpy(rng.randn(2, len(lens), nkv, S, hd).astype(
        np.float32)).cuda()
    q = torch.from_numpy(rng.randn(len(lens), nh, hd).astype(
        np.float32)).cuda()
    kc, vc = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    before = tda.launch_count()
    got = tda.decode_attention(q, kc, vc, lens)
    assert tda.launch_count() == before + 1
    torch.testing.assert_close(
        got, tda.decode_attention_reference(q, kc, vc, lens), **TOL)
    assert not got[np.asarray(lens) == 0].any()


def test_bfloat16_kernels_match_plain_version():
    """bfloat16 pools and caches: the kernels accumulate in float32 and
    round once on output, so they agree with the float32 plain version
    of the same bfloat16 inputs within bfloat16's rounding (2**-8)."""
    _need_cuda()
    q, pool, bt, lens = _ragged(6, 8, 2, 64, 16, (1, 20, 2), (50, 40, 9),
                                4, ())
    q, pool = q.bfloat16(), pool.bfloat16()
    got = tpa.paged_attention_ragged(q, pool, bt, (1, 20, 2), lens)
    ref = tpa.paged_attention_ragged_reference(q.float(), pool.float(), bt,
                                               (1, 20, 2), lens)
    torch.testing.assert_close(got.float(), ref, atol=1e-2, rtol=1e-2)
    cache = torch.randn((2, 3, 2, 70, 64), device="cuda").bfloat16()
    qd = torch.randn((3, 8, 64), device="cuda").bfloat16()
    kc, vc = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    got = tda.decode_attention(qd, kc, vc, [70, 1, 33])
    ref = tda.decode_attention_reference(qd.float(), kc.float(), vc.float(),
                                         [70, 1, 33])
    torch.testing.assert_close(got.float(), ref, atol=1e-2, rtol=1e-2)


def test_slice_on_cuda_matches_cpu_and_launches_once_per_layer():
    """The same token-budget engine on CUDA and on the CPU gives the same
    greedy streams, and every CUDA model call launches the ragged kernel
    once per layer."""
    _need_cuda()
    D, H, FFN, LAYERS, V = 64, 4, 128, 2, 128
    rng = np.random.RandomState(7)
    emb = rng.randn(V, D).astype(np.float32)
    head = rng.randn(D, V).astype(np.float32)
    prompts = [list(rng.randint(0, V, n)) for n in (5, 23, 9, 31, 3, 14)]
    pool = dict(max_batch=3, block_size=4, num_blocks=16, chunk_tokens=8,
                prefill_token_budget=12)
    cpu = FusedMultiTransformer(D, H, FFN, num_layers=LAYERS, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    gpu = FusedMultiTransformer(D, H, FFN, num_layers=LAYERS,
                                device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    calls = []
    gpu.register_forward_pre_hook(lambda m, a: calls.append(1))

    def serve(core):
        eng = SpeculativeEngine(TokenServingModel(core, emb, head), None,
                                k=0, **pool)
        rids = [eng.submit(p) for p in prompts]
        done = {}
        for _ in range(200):
            eng.step()
            for r in rids:
                if r not in done and r in eng._by_rid and \
                        len(eng.generated(r)) >= 8:
                    done[r] = eng.generated(r)[:8]
                    eng.release(r)
            if len(done) == len(rids):
                break
        return [done[r] for r in rids]

    ref = serve(cpu)
    tpa.reset_launch_count()
    assert serve(gpu) == ref
    assert tpa.launch_count() == LAYERS * len(calls) > 0


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["decode", "prefill_chunk",
                                  "mixed_zero_len_and_trash", "gqa",
                                  "scalar_loads"])
def test_int8_ragged_kernel_matches_plain_version(name, qdtype):
    """Int8 pages written by _quant_rows (block 0, the trash block, keeps
    zero scales): both sides dequantize the same bytes, so float32 q
    agrees to summation order; bfloat16 q within its rounding."""
    _need_cuda()
    nh, nkv, hd, bs, q_lens, kv_lens, MB, trash, tile_q = RAGGED[name]
    q, pool, bt, lens = _ragged(9, nh, nkv, hd, bs, q_lens, kv_lens, MB,
                                trash)
    qp, sc = _quant_rows(pool)
    qp[0], sc[0] = 0, 0.0
    q = q.to(getattr(torch, qdtype))
    before = tpa.launch_count()
    got = tpa.paged_attention_ragged(q, qp, bt, q_lens, lens,
                                     tile_q=tile_q, kv_scales=sc)
    assert tpa.launch_count() == before + 1
    ref = tpa.paged_attention_ragged_reference(q.float(), qp, bt, q_lens,
                                               lens, kv_scales=sc)
    assert torch.isfinite(got).all()
    tol = TOL if qdtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), ref, **tol)


W8A16 = {
    # name: (M, K, N, x dtype, x row stride padding)
    "decode_qkv": (8, 1024, 3072, "float32", 0),
    "single_row": (1, 1024, 1024, "float32", 0),
    "chunk_ffn2": (256, 4096, 1024, "float32", 0),
    "odd_widths": (5, 300, 77, "float32", 0),      # 1-byte weight loads
    "strided_x": (8, 512, 256, "float32", 64),
    "bfloat16_x": (8, 1024, 512, "bfloat16", 0),
}


@pytest.mark.parametrize("name", sorted(W8A16))
def test_w8a16_kernel_matches_plain_version(name):
    _need_cuda()
    M, K, N, dt, pad = W8A16[name]
    rng = np.random.RandomState(M + K + N)
    x = torch.from_numpy(rng.randn(M, K + pad).astype(np.float32)).cuda()
    x = x[:, :K].to(getattr(torch, dt))
    w = torch.from_numpy(rng.randint(-128, 128, (K, N)).astype(
        np.int8)).cuda()
    before = tim.launch_count()
    got = tim.w8a16_matmul(x, w)
    assert tim.launch_count() == before + 1
    ref = tim.w8a16_matmul_reference(x, w)
    tol = 1e-4 * float(ref.abs().max())
    torch.testing.assert_close(got, ref, atol=tol, rtol=1e-5)
    # fixed summation order: the same bits from run to run
    assert torch.equal(tim.w8a16_matmul(x, w), got)


def test_w8a16_kernel_gradient_and_refusals():
    _need_cuda()
    x = torch.randn(4, 64, device="cuda", requires_grad=True)
    w = torch.randint(-128, 128, (64, 32), device="cuda",
                      dtype=torch.int8)
    tim.w8a16_matmul(x, w).sum().backward()
    torch.testing.assert_close(x.grad, torch.ones(4, 32, device="cuda")
                               @ w.float().T)
    with pytest.raises(TypeError):
        tim.w8a16_matmul(x.detach().double(), w)
    with pytest.raises(ValueError):
        tim.w8a16_matmul(x.detach().t().contiguous().t(), w)
    with pytest.raises(ValueError):
        tim.w8a16_matmul(x.detach(), w.t())


def test_quantized_slice_on_cuda_matches_cpu():
    """Int8 weights, int8 KV pages and the prefix cache on CUDA against
    the same engine on the CPU: equal greedy streams and prefix hits,
    the int8 ragged kernel once per layer per model call, and the w8a16
    kernel for every projection of a call of <= 256 rows and every head
    call."""
    _need_cuda()
    D, H, FFN, LAYERS, V = 64, 4, 128, 2, 128
    rng = np.random.RandomState(8)
    emb = rng.randn(V, D).astype(np.float32)
    system = list(rng.randint(0, V, 8))
    prompts = [system + list(rng.randint(0, V, n)) for n in (3, 9, 6, 13)]
    pool = dict(max_batch=2, block_size=4, num_blocks=8, chunk_tokens=8,
                prefill_token_budget=12, prefix_cache=True,
                kv_dtype="int8")
    fcpu = FusedMultiTransformer(D, H, FFN, num_layers=LAYERS, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    cpu = FusedMultiTransformerInt8.from_float(fcpu)
    gpu = FusedMultiTransformerInt8(D, H, FFN, num_layers=LAYERS,
                                    device="cuda").quantize_weights()
    gpu.load_state_dict(cpu.state_dict())
    calls, small = [], []

    def pre(m, a):
        calls.append(1)
        small.append(a[0].shape[0] * a[0].shape[1] <= 256)
    gpu.register_forward_pre_hook(pre)

    def serve(core):
        tsm = TokenServingModel(core, emb, weight_dtype="int8")
        eng = SpeculativeEngine(tsm, None, k=0, **pool)
        heads = []
        logits = tsm.logits
        tsm.logits = lambda h: (heads.append(1), logits(h))[1]
        rids = [eng.submit(p) for p in prompts]
        done = {}
        for _ in range(200):
            eng.step()
            for r in rids:
                if r not in done and r in eng._by_rid and \
                        len(eng.generated(r)) >= 6:
                    done[r] = eng.generated(r)[:6]
                    eng.release(r)
            if len(done) == len(rids):
                break
        return [done[r] for r in rids], \
            eng.engine.prefix_stats.hit_blocks, len(heads)

    ref, ref_hits, _ = serve(cpu)
    tpa.reset_launch_count()
    tim.reset_launch_count()
    got, hits, n_heads = serve(gpu)
    assert got == ref and hits == ref_hits > 0
    assert tpa.launch_count() == LAYERS * len(calls) > 0
    assert tim.launch_count() == 4 * LAYERS * sum(small) + n_heads


GMM = {
    # name: (block_expert, block_m, K, N)
    # decode: 8 experts x cap_pad 8 (the rows kernel)
    "decode_ffn1": (np.repeat(np.arange(8), 1), 8, 1024, 4096),
    "decode_ffn2": (np.repeat(np.arange(8), 1), 8, 4096, 1024),
    # a 520-row mixed call: 8 experts x cap_pad 168 (the tile kernel;
    # expert runs end inside 64-row tiles)
    "mixed_ffn1": (np.repeat(np.arange(8), 21), 8, 1024, 4096),
    "mixed_ffn2": (np.repeat(np.arange(8), 21), 8, 4096, 1024),
    # odd K and N: scalar weight loads, ragged column tiles
    "odd_rows": (np.repeat(np.arange(3), 2), 8, 1000, 1001),
    "odd_tile": (np.repeat(np.arange(3), 9), 8, 333, 130),
    # non-contiguous expert ids: runs of one block, ids repeating
    "scattered_rows": (np.array([2, 0, 2, 1, 1, 3, 0]), 8, 256, 512),
    "scattered_tile": (np.repeat([2, 0, 2, 1], [5, 9, 1, 13]), 8, 256,
                       200),
    # uneven groups from make_group_metadata at block_m 16
    "grouped_16": (tgg.make_group_metadata([37, 0, 130, 9], 16)[1], 16,
                   512, 384),
}


@pytest.mark.parametrize("name", sorted(GMM))
def test_gmm_kernel_matches_plain_version(name):
    """Each shape against the plain version within 1e-4 x max|ref|
    (float32, summation order only), and bitwise equal from run to run
    (fixed K order, no atomics)."""
    _need_cuda()
    be, block_m, K, N = GMM[name]
    M = len(be) * block_m
    E = int(be.max()) + 1
    rng = np.random.RandomState(M + K + N)
    lhs = torch.from_numpy(rng.randn(M, K).astype(np.float32)).cuda()
    rhs = torch.from_numpy(rng.randn(E, K, N).astype(np.float32)).cuda()
    bed = torch.from_numpy(be.astype(np.int32)).cuda()
    before = tgg.launch_count()
    got = tgg.gmm(lhs, rhs, bed, block_m=block_m)
    assert tgg.launch_count() == before + 1
    ref = tgg.gmm_reference(lhs, rhs, bed, block_m=block_m)
    tol = 1e-4 * float(ref.abs().max())
    torch.testing.assert_close(got, ref, atol=tol, rtol=0)
    assert torch.equal(tgg.gmm(lhs, rhs, bed, block_m=block_m), got)
    # a host block_expert and a strided lhs give the same bits
    wide = torch.cat([lhs, lhs], dim=1)[:, :K]
    assert torch.equal(tgg.gmm(wide, rhs, be, block_m=block_m), got)


def test_gmm_kernel_empty_and_refusals():
    _need_cuda()
    rhs = torch.randn(2, 64, 32, device="cuda")
    before = tgg.launch_count()
    out = tgg.gmm(torch.zeros(0, 64, device="cuda"), rhs,
                  np.zeros(0, np.int32), block_m=8)
    assert out.shape == (0, 32) and tgg.launch_count() == before
    lhs = torch.randn(16, 64, device="cuda")
    with pytest.raises(TypeError):
        tgg.gmm(lhs.double(), rhs.double(), [0, 1], block_m=8)
    with pytest.raises(ValueError):
        tgg.gmm(lhs, rhs.transpose(1, 2), [0, 1], block_m=8)
    with pytest.raises(ValueError):
        tgg.gmm(lhs, rhs, [0, 1, 1], block_m=8)


def test_gmm_without_its_build_raises(monkeypatch, tmp_path):
    """No library and no source to build it from: the CUDA call raises,
    it never falls back to the plain version."""
    _need_cuda()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_BUILT", {})
    lhs = torch.randn(8, 64, device="cuda")
    rhs = torch.randn(1, 64, 32, device="cuda")
    with pytest.raises(RuntimeError, match="grouped_gemm"):
        tgg.gmm(lhs, rhs, [0], block_m=8)


@pytest.mark.parametrize("k", [0, 2])
def test_moe_engine_on_cuda_matches_cpu(k):
    """A 2-layer, 4-expert MoE at narrow width on CUDA (the gmm kernel
    path) against the same engine on the CPU (the fold): equal greedy
    streams and moe.* counters; gmm launches twice per layer per target
    and draft model call."""
    _need_cuda()
    D, H, FFN, LAYERS, V = 64, 4, 128, 2, 128
    rng = np.random.RandomState(9)
    emb = rng.randn(V, D).astype(np.float32)
    prompts = [list(rng.randint(0, V, n)) for n in (5, 23, 9, 31)]
    pool = dict(max_batch=3, block_size=4, num_blocks=24, chunk_tokens=8,
                prefill_token_budget=12)
    cpu = MoeServingCore(D, H, FFN, num_experts=4, num_layers=LAYERS,
                         device="cpu",
                         generator=torch.Generator().manual_seed(0))
    gpu = MoeServingCore(D, H, FFN, num_experts=4, num_layers=LAYERS,
                         device="cuda")
    gpu.load_state_dict(cpu.state_dict())

    def serve(core):
        tsm = TokenServingModel(core, emb)
        draft = tsm.truncated_draft(1) if k else None
        eng = SpeculativeEngine(tsm, draft, k=k, **pool)
        rids = [eng.submit(p) for p in prompts]
        done = {}
        for _ in range(200):
            eng.step()
            for r in rids:
                if r not in done and r in eng._by_rid and \
                        len(eng.generated(r)) >= 6:
                    done[r] = eng.generated(r)[:6]
                    eng.release(r)
            if len(done) == len(rids):
                break
        eng.check_invariants()
        moe = {key: v for key, v in eng.engine.registry.as_dict().items()
               if key.startswith("moe.")}
        draft_calls = draft.core._calls if draft is not None else 0
        return [done[r] for r in rids], moe, draft_calls

    ref, ref_moe, _ = serve(cpu)
    tgg.reset_launch_count()
    got, moe, draft_calls = serve(gpu)
    assert got == ref and moe == ref_moe
    # two gmm launches per MoE layer per model call: the target's 2
    # layers, the 1-layer draft's
    assert tgg.launch_count() == 2 * LAYERS * gpu._calls + \
        2 * draft_calls > 0
