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
from paddle_tpu_torch.models import LlamaConfig, LlamaSpmdTrainer
from paddle_tpu_torch.models.llama_spmd import tree_get, tree_paths
from paddle_tpu_torch.ops.hopper import decode_attention as tda
from paddle_tpu_torch.ops.hopper import flash_attention as tfa
from paddle_tpu_torch.ops.hopper import fused_adamw as tfw
from paddle_tpu_torch.ops.hopper import fused_norm as tfn
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


SPLIT = {
    # name: (nh, nkv, hd, bs, q_lens, kv_lens, MB, dtype, tile_q)
    # one decode row over 8200 keys (65 spans)
    "decode_8k_keys": (4, 4, 64, 16, (1, 1), (8200, 300), 513, "float32",
                       None),
    # 48-position pages: the span edges at 256 and 512 fall mid-page
    "prefill_span_edge_mid_page": (4, 4, 64, 48, (40, 1), (300, 530), 12,
                                   "float32", 16),
    # tile rows at 248..263: for the first 8, the span [256, 264) holds
    # only keys the causal mask hides
    "span_only_hidden_keys": (4, 4, 64, 16, (16, 1), (264, 9), 17,
                              "float32", 16),
    "gqa_g4": (16, 4, 128, 16, (1, 20, 3), (700, 300, 3), 44, "float32",
               None),
    "bf16_q_gqa_g4": (16, 4, 64, 16, (1, 20, 3), (700, 300, 3), 44,
                      "bfloat16", None),
}


@pytest.mark.parametrize("host_lens", [True, False])
@pytest.mark.parametrize("name", sorted(SPLIT))
def test_ragged_split_kv_matches_plain_version(name, host_lens):
    """The float-pool kernel's split-KV cases against the plain version
    (float32 under TOL; bf16 q and pages against the float32 plain
    version of the same bf16 values within bf16's rounding), bitwise
    equal across two calls. host_lens: the plan sizes its spans from the
    host lengths (the serving path) or from the table width (device
    lengths only; surplus spans hold no key)."""
    _need_cuda()
    nh, nkv, hd, bs, q_lens, kv_lens, MB, dt, tile_q = SPLIT[name]
    q, pool, bt, lens = _ragged(12, nh, nkv, hd, bs, q_lens, kv_lens, MB,
                                ())
    q, pool = q.to(getattr(torch, dt)), pool.to(getattr(torch, dt))
    dev_lens = torch.from_numpy(lens).cuda()
    plan = tpa.RaggedPlan(q_lens, lens if host_lens else None)
    got = tpa.paged_attention_ragged(q, pool, bt, q_lens, dev_lens,
                                     tile_q=tile_q, plan=plan)
    again = tpa.paged_attention_ragged(q, pool, bt, q_lens, dev_lens,
                                       tile_q=tile_q, plan=plan)
    assert torch.equal(got, again)
    ref = tpa.paged_attention_ragged_reference(q.float(), pool.float(), bt,
                                               q_lens, lens)
    assert torch.isfinite(got).all()
    tol = TOL if dt == "float32" else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), ref, **tol)


def test_ragged_rows_do_not_depend_on_the_rest_of_the_step():
    """One sequence's rows alone, inside a mixed step with other
    sequences (a prefill chunk, decode rows, a zero-length segment), at
    another tile width and with spans sized from the table width give
    the same bits: span and chunk edges sit at absolute key positions,
    and each row's arithmetic is fixed by them."""
    _need_cuda()
    nh, nkv, hd, bs, MB = 8, 2, 64, 16, 40
    q_lens = (50, 1, 0, 128, 1)
    kv_lens = (560, 610, 7, 384, 1)
    q, pool, bt, lens = _ragged(13, nh, nkv, hd, bs, q_lens, kv_lens, MB,
                                ())
    mixed = tpa.paged_attention_ragged(q, pool, bt, q_lens, lens)
    for s in (0, 1, 3):
        r0 = sum(q_lens[:s])
        rows = q[r0:r0 + q_lens[s]]
        want = mixed[r0:r0 + q_lens[s]]
        one = ((q_lens[s],), lens[s:s + 1], bt[s:s + 1])
        assert torch.equal(tpa.paged_attention_ragged(rows, pool, one[2],
                                                      one[0], one[1]), want)
        assert torch.equal(tpa.paged_attention_ragged(
            rows, pool, one[2], one[0], torch.from_numpy(one[1]).cuda(),
            tile_q=5), want)


DECODE = {
    # name: (nh, nkv, hd, S, lens, layout)
    "small": (4, 4, 64, 32, [0, 1, 17, 32], "cache"),
    "gqa_s300": (8, 2, 64, 300, [5, 300, 0], "cache"),
    "oracle_widths": (16, 16, 64, 1024, [64, 1000, 513, 1024], "cache"),
    "scalar_loads": (4, 4, 30, 40, [3, 40], "cache"),    # 4-byte copies
    "one_row_8200_keys": (4, 4, 64, 8200, [8200], "cache"),  # 65 spans
    # lengths at span edges, 0 and past S; S not a multiple of 128
    "span_edges_s1000": (16, 16, 64, 1000, [0, 1, 128, 129, 1000, 1500],
                         "cache"),
    "gqa_8_2_hd128": (8, 2, 128, 300, [300, 129, 7], "cache"),
    "gqa_32_8_hd128": (32, 8, 128, 1000, [1000, 640, 1], "cache"),
    "hd256": (8, 4, 256, 300, [300, 200, 0], "cache"),
    # q with row stride 3 nh hd and head stride 2 hd
    "strided_q": (8, 2, 64, 300, [299, 128, 33], "strided_q"),
    # K and V two tensors of different layouts
    "separate_kv": (8, 2, 64, 300, [300, 256, 1], "separate"),
    # 2080 span blocks, more than the card holds at once; both rows end
    # in a partial last span
    "many_long_spans": (16, 16, 64, 8200, [8200, 5000], "cache"),
}


def _decode_inputs(seed, B, nh, nkv, hd, S, layout, dtype=torch.float32):
    """q [B, nh, hd] and the caches [B, S, nkv, hd]: the serving model's
    transposed views of one [2, B, nkv, S, hd] cache, or (layout
    "separate") K contiguous and V a view of a [B, nkv, S, hd] tensor;
    "strided_q" takes q from a wider tensor."""
    g = torch.Generator().manual_seed(seed)
    cache = torch.randn((2, B, nkv, S, hd), generator=g).to("cuda", dtype)
    kc, vc = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    if layout == "separate":
        kc = kc.contiguous()
        vc = torch.randn((B, nkv, S, hd), generator=g).to(
            "cuda", dtype).transpose(1, 2)
    if layout == "strided_q":
        q = torch.randn((B, 3 * nh, 2 * hd), generator=g).to(
            "cuda", dtype)[:, :nh, :hd]
    else:
        q = torch.randn((B, nh, hd), generator=g).to("cuda", dtype)
    return q, kc, vc


@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_kernel_matches_plain_version(name):
    _need_cuda()
    nh, nkv, hd, S, lens, layout = DECODE[name]
    q, kc, vc = _decode_inputs(S, len(lens), nh, nkv, hd, S, layout)
    before = tda.launch_count()
    got = tda.decode_attention(q, kc, vc, lens)
    assert tda.launch_count() == before + 1
    torch.testing.assert_close(
        got, tda.decode_attention_reference(q, kc, vc, lens), **TOL)
    assert not got[np.asarray(lens) == 0].any()
    assert torch.equal(tda.decode_attention(q, kc, vc, lens), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,nkv,hd,S,lens", [
    (16, 16, 64, 1024, [64, 1000, 513, 1024, 0]),
    (32, 8, 128, 1008, [1, 129, 1008, 1500, 640]),
    (8, 4, 256, 304, [300, 128]),
    # 1280 span blocks, more than the card holds at once
    (16, 16, 64, 2048, [2048, 1500, 777, 2000, 0]),
])
def test_decode_kernel_equals_ragged_decode_rows_bitwise(nh, nkv, hd, S,
                                                         lens, dtype):
    """The dense kernel's rows are the ragged kernel's decode rows over a
    pool holding the same K/V, bit for bit: one split-KV body, the same
    spans and the same span-order merge (the ragged call sees lengths
    clamped to S, as the dense one does)."""
    _need_cuda()
    q, kc, vc = _decode_inputs(hd, len(lens), nh, nkv, hd, S, "cache",
                               getattr(torch, dtype))
    # the same K/V in shuffled pages of 16 (page 0 stays trash)
    B, MB = len(lens), S // 16
    bt = np.random.RandomState(S).permutation(np.arange(
        1, 1 + B * MB)).reshape(B, MB).astype(np.int32)
    pool = tpa.scatter_pages(kc, vc, bt, 1 + B * MB)
    kg, vg = tpa.gather_pages(pool, bt)
    assert torch.equal(kg, kc) and torch.equal(vg, vc)
    dense = tda.decode_attention(q, kc, vc, lens)
    assert torch.equal(tda.decode_attention(q, kc, vc, lens), dense)
    clamped = np.minimum(lens, S).astype(np.int32)
    for kv_lens in (clamped, torch.from_numpy(clamped).cuda()):
        paged = tpa.paged_attention_ragged(q, pool, bt, (1,) * len(lens),
                                           kv_lens)
        assert torch.equal(paged, dense)


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
    # decode: (nh, nkv, hd, S, lens, layout); hd 31 takes plain loads
    # (62-byte rows), hd 30 4-byte copies
    for nh, nkv, hd, S, lens, layout in (
            (8, 2, 64, 70, [70, 1, 33], "cache"),
            (4, 4, 64, 8200, [8200], "cache"),
            (32, 8, 128, 1000, [1000, 0, 129, 1200], "strided_q"),
            (8, 4, 256, 300, [300, 128], "separate"),
            (4, 2, 31, 40, [40, 3], "cache"),
            (4, 2, 30, 40, [40, 3], "cache")):
        qd, kc, vc = _decode_inputs(hd + S, len(lens), nh, nkv, hd, S,
                                    layout, torch.bfloat16)
        got = tda.decode_attention(qd, kc, vc, lens)
        ref = tda.decode_attention_reference(qd.float(), kc.float(),
                                             vc.float(), lens)
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


INT8_SPLIT = {
    # name: (nh, nkv, hd, bs, q_lens, kv_lens, MB, trash_rows, q dtype,
    #        tile_q)
    # long decode rows: 65, 24 and 3 spans
    "decode_long_rows": (4, 4, 64, 16, (1, 1, 1), (8200, 3000, 300), 513,
                         (), "float32", None),
    # 48-position pages: the span edges at 256 and 512 fall mid-page
    "span_edge_mid_page": (4, 4, 64, 48, (40, 1), (300, 530), 12, (),
                           "float32", 16),
    # tile rows at 248..263: for the first 8, the span [256, 264) holds
    # only keys the causal mask hides
    "masked_span": (4, 4, 64, 16, (16, 1), (264, 9), 17, (), "float32",
                    16),
    "gqa_g4_hd128": (16, 4, 128, 16, (1, 20, 3), (700, 300, 3), 44, (),
                     "float32", None),
    "gqa_g4_hd256": (4, 1, 256, 16, (1, 5), (400, 70), 25, (), "float32",
                     None),
    "bf16_q_gqa_g4": (16, 4, 64, 16, (1, 20, 3), (700, 300, 3), 44, (),
                      "bfloat16", None),
    # hd % 16 != 0: 4-byte copies; hd % 4 != 0: plain loads
    "hd40_4_byte_copies": (4, 2, 40, 16, (1, 7), (300, 150), 20, (),
                           "float32", None),
    "hd30_plain_loads": (4, 2, 30, 16, (1, 3), (40, 70), 5, (), "float32",
                         None),
    # row 0 at t = 0 through an all-trash table: block 0, zero scales
    "all_trash_row_zero_scales": (4, 4, 64, 16, (1, 2, 1), (1, 200, 9), 13,
                                  (0,), "float32", None),
}


def _int8_pool(pool):
    """The pool quantized as the serving appends write it; trash block 0
    keeps zero scales."""
    qp, sc = _quant_rows(pool)
    qp[0], sc[0] = 0, 0.0
    return qp, sc


@pytest.mark.parametrize("host_lens", [True, False])
@pytest.mark.parametrize("name", sorted(INT8_SPLIT))
def test_int8_split_kv_matches_plain_version(name, host_lens):
    """The int8 pool on the split-KV body against the plain version
    (float32 q within TOL: both sides dequantize the same bytes, the
    kernel with each key's scale factored out of its dot product; bf16 q
    within its rounding), finite, and bitwise equal across two calls.
    host_lens: spans sized from the host lengths or the table width."""
    _need_cuda()
    nh, nkv, hd, bs, q_lens, kv_lens, MB, trash, dt, tile_q = \
        INT8_SPLIT[name]
    q, pool, bt, lens = _ragged(14, nh, nkv, hd, bs, q_lens, kv_lens, MB,
                                trash)
    qp, sc = _int8_pool(pool)
    q = q.to(getattr(torch, dt))
    dev_lens = torch.from_numpy(lens).cuda()
    plan = tpa.RaggedPlan(q_lens, lens if host_lens else None)
    before = tpa.launch_count()
    got = tpa.paged_attention_ragged(q, qp, bt, q_lens, dev_lens,
                                     tile_q=tile_q, plan=plan, kv_scales=sc)
    assert tpa.launch_count() == before + 1
    again = tpa.paged_attention_ragged(q, qp, bt, q_lens, dev_lens,
                                       tile_q=tile_q, plan=plan,
                                       kv_scales=sc)
    assert torch.equal(got, again)
    ref = tpa.paged_attention_ragged_reference(q.float(), qp, bt, q_lens,
                                               lens, kv_scales=sc)
    assert torch.isfinite(got).all()
    tol = TOL if dt == "float32" else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), ref, **tol)
    for s in trash:          # zero scales: zero keys and values
        r0 = sum(q_lens[:s])
        assert not got[r0:r0 + q_lens[s]].any()


def test_int8_ragged_rows_do_not_depend_on_the_rest_of_the_step():
    """The int8 twin of the float test: one sequence's rows alone, inside
    a mixed step, at another tile width and with spans sized from the
    table width give the same bits."""
    _need_cuda()
    nh, nkv, hd, bs, MB = 8, 2, 64, 16, 40
    q_lens = (50, 1, 0, 128, 1)
    kv_lens = (560, 610, 7, 384, 1)
    q, pool, bt, lens = _ragged(15, nh, nkv, hd, bs, q_lens, kv_lens, MB,
                                ())
    qp, sc = _int8_pool(pool)
    mixed = tpa.paged_attention_ragged(q, qp, bt, q_lens, lens,
                                       kv_scales=sc)
    for s in (0, 1, 3):
        r0 = sum(q_lens[:s])
        rows = q[r0:r0 + q_lens[s]]
        want = mixed[r0:r0 + q_lens[s]]
        one = ((q_lens[s],), lens[s:s + 1], bt[s:s + 1])
        assert torch.equal(tpa.paged_attention_ragged(
            rows, qp, one[2], one[0], one[1], kv_scales=sc), want)
        assert torch.equal(tpa.paged_attention_ragged(
            rows, qp, one[2], one[0], torch.from_numpy(one[1]).cuda(),
            tile_q=5, kv_scales=sc), want)


W8A16 = {
    # name: (M, K, N, x dtype, x row stride padding)
    "decode_qkv": (8, 1024, 3072, "float32", 0),
    "single_row": (1, 1024, 1024, "float32", 0),
    "chunk_ffn2": (256, 4096, 1024, "float32", 0),
    "odd_widths": (5, 300, 77, "float32", 0),      # 1-byte weight loads
    "strided_x": (8, 512, 256, "float32", 64),
    "bfloat16_x": (8, 1024, 512, "bfloat16", 0),
    # every row tile (1, 2, 4, 8, 16 rows; 16-row tiles past 16), odd K
    # and N (zero-filled tails, 1-byte weight loads), x rows of 4-byte and
    # of odd bf16 strides (4-byte copies, plain loads)
    "m2_odd_k_odd_n": (2, 129, 33, "float32", 0),
    "m7": (7, 1024, 1024, "float32", 0),
    "m9_odd_k": (9, 1001, 3072, "float32", 0),
    "verify_m16_ffn2": (16, 4096, 1024, "float32", 0),
    "m17_odd_n": (17, 1024, 1027, "float32", 0),
    "m64_ffn1": (64, 1024, 4096, "float32", 0),
    "x_stride_4_bytes": (8, 512, 256, "float32", 1),
    "bf16_odd_x_stride": (16, 512, 256, "bfloat16", 3),
    "bf16_m256_qkv": (256, 1024, 3072, "bfloat16", 0),
    # the head: N 50304, one split
    "head_m1": (1, 1024, 50304, "float32", 0),
    "head_m8": (8, 1024, 50304, "float32", 0),
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
    # expert runs of 72, 24 and 40 rows: each ends inside a 64-row
    # tensor-core tile
    "run_ends_mid_tile": (np.repeat(np.arange(3), [9, 3, 5]), 8, 512, 256),
    # K not a multiple of 8 (the last 32-deep slab is partly zeros)
    "k_not_multiple_of_8": (np.repeat(np.arange(2), 10), 8, 1004, 384),
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


@pytest.mark.parametrize("name", ["mixed_ffn2", "odd_tile",
                                  "run_ends_mid_tile",
                                  "k_not_multiple_of_8"])
def test_gmm_kernel_reads_an_unaligned_lhs(name):
    """lhs as a view one element into a wider buffer (base and row
    stride not 16-byte aligned: the 4-byte copy path) gives the bits of
    the contiguous lhs."""
    _need_cuda()
    be, block_m, K, N = GMM[name]
    M = len(be) * block_m
    E = int(be.max()) + 1
    rng = np.random.RandomState(M + K + N)
    lhs = torch.from_numpy(rng.randn(M, K).astype(np.float32)).cuda()
    rhs = torch.from_numpy(rng.randn(E, K, N).astype(np.float32)).cuda()
    bed = torch.from_numpy(be.astype(np.int32)).cuda()
    wide = torch.zeros((M, K + 5), device="cuda")
    wide[:, 1:K + 1] = lhs
    view = wide[:, 1:K + 1]
    assert view.stride(0) % 4 and view.data_ptr() % 16
    got = tgg.gmm(lhs, rhs, bed, block_m=block_m)
    assert torch.equal(tgg.gmm(view, rhs, bed, block_m=block_m), got)
    ref = tgg.gmm_reference(lhs, rhs, bed, block_m=block_m)
    torch.testing.assert_close(got, ref, atol=1e-4 * float(ref.abs().max()),
                               rtol=0)


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


# -- the training slice: flash attention, fused RMSNorm, fused AdamW ------
# float32 kernels vs their plain versions: summation order (and, for
# flash, 64-wide key tiles against the Pallas 128-wide blocks of the
# online softmax) only
TOL_TRAIN = dict(atol=1e-4, rtol=1e-4)
# bfloat16: both sides round p and dS to bfloat16 at the same points, but
# relative to running maxima of different tile widths, and the outputs are
# bfloat16 themselves (1 ulp <= 2**-7 relative). Each row (a query of out
# and dq, a key of dk and dv) is held on its own, since late rows are
# smaller than early ones: max|err| within 3e-2 x max|ref| of that row,
# four ulps of the row's largest entry. A row whose exact value is 0 (dq
# of a causal first row: its one key gives dS = p (dP - delta) = 0) holds
# rounding noise only, so no row's max|ref| counts below 1e-3 x the
# tensor's
TOL_BF16_ROW = 3e-2

FLASH = {
    # name: (B, t_q, t_k, H, D, causal, dropout rate)
    "causal": (2, 192, 192, 4, 64, True, 0.0),
    "non_causal_tail": (1, 100, 150, 3, 128, False, 0.0),
    "cross_length": (2, 64, 192, 2, 64, True, 0.0),
    "causal_tail_hd128": (1, 130, 130, 2, 128, True, 0.0),
    "dropout": (2, 130, 130, 2, 64, True, 0.2),
    # edges of the bf16 kernels' 128-row tiles: one row past a tile, one
    # short of two, a causal offset (77) that is no multiple of 128, and
    # a key tail shorter than one 64-key box
    "causal_t129": (1, 129, 129, 2, 128, True, 0.0),
    "causal_t255": (2, 255, 255, 2, 64, True, 0.0),
    "cross_length_offset_77": (1, 200, 277, 2, 128, True, 0.0),
    "non_causal_hd64_tk77": (2, 130, 77, 3, 64, False, 0.0),
}


def _flash_inputs(name, dtype, seed=0):
    B, tq, tk, H, D, causal, rate = FLASH[name]
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((B, tq, H, D), generator=g) for _ in range(2))
    k, v = (torch.randn((B, tk, H, D), generator=g) for _ in range(2))
    return [t.to("cuda", dtype) for t in (q, k, v, do)], causal, rate


def _close_per_row(got, ref, rel):
    """[BH, T, D]: max|err| of each row within rel x max|ref| of the row."""
    got, ref = got.float(), ref.float()
    row = ref.abs().amax(-1)
    row = row.clamp_min(max(1e-3 * float(row.max()), 1e-30))
    err = (got - ref).abs().amax(-1) / row
    assert float(err.max()) <= rel, float(err.max())


def _bhtd(t):
    return tfa._to_bhtd(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_kernels_match_plain_versions(name, dtype):
    """Forward (out, lse) and backward (dq, dk, dv) kernels against the
    plain versions on the same card inputs; the backward of both from the
    plain forward's out and lse."""
    _need_cuda()
    dt = getattr(torch, dtype)
    (q, k, v, do), causal, rate = _flash_inputs(name, dt)
    scale = 1.0 / np.sqrt(q.shape[-1])
    seed = -7
    f0, b0 = tfa.launch_count("fwd"), tfa.launch_count("bwd")
    o, lse = tfa._fwd_kernel(q, k, v, causal, scale, rate, seed)
    o_ref, lse_ref = tfa.flash_fwd_reference(_bhtd(q), _bhtd(k), _bhtd(v),
                                             causal, scale, rate, seed)
    B, H = q.shape[0], q.shape[2]
    o_blhd = tfa._from_bhtd(o_ref, B, H)
    grads = tfa._bwd_kernel(q, k, v, o_blhd, lse_ref, do, causal, scale,
                            rate, seed)
    ref = tfa.flash_bwd_reference(_bhtd(q), _bhtd(k), _bhtd(v), o_ref,
                                  lse_ref, _bhtd(do), causal, scale, rate,
                                  seed)
    torch.cuda.synchronize()
    assert (tfa.launch_count("fwd"), tfa.launch_count("bwd")) == (f0 + 1,
                                                                  b0 + 1)
    torch.testing.assert_close(lse, lse_ref, **TOL_TRAIN)
    pairs = [(_bhtd(o), o_ref)] + [(_bhtd(g), r) for g, r in zip(grads, ref)]
    for got, want in pairs:
        assert bool(torch.isfinite(got).all())
        if dt == torch.float32:
            torch.testing.assert_close(got, want, **TOL_TRAIN)
        else:
            _close_per_row(got, want, TOL_BF16_ROW)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_reads_strided_and_gqa_repeated_inputs(dtype):
    """q/k/v as views of one packed [B, T, 3, H, D] projection (strided,
    no copy) and K/V repeated for GQA give the contiguous inputs' bits;
    the [BH, T, D] entry points agree with the [B, L, H, D] ones."""
    _need_cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn((2, 128, 3, 4, 64), generator=g).to("cuda", dt)
    q, k, v = qkv.unbind(2)
    o1, l1 = tfa._fwd_kernel(q, k, v, True, 0.125, 0.0, None)
    o2, l2 = tfa._fwd_kernel(*(t.contiguous() for t in (q, k, v)), True,
                             0.125, 0.0, None)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    kv = torch.randn((2, 2, 128, 2, 64), generator=g).to("cuda", dt)
    kr, vr = (t.repeat_interleave(2, dim=2) for t in kv.unbind(0))
    o3 = tfa._flash_fwd(_bhtd(q), _bhtd(kr), _bhtd(vr), True, 0.125)
    o4, _ = tfa._fwd_kernel(q, kr, vr, True, 0.125, 0.0, None)
    assert torch.equal(o3, _bhtd(o4))


@pytest.mark.parametrize("name", ["causal_t255", "dropout",
                                  "cross_length_offset_77"])
def test_flash_backward_is_bitwise_repeatable(name):
    """bf16: two backward calls on the same inputs give the same dq, dk
    and dv bits (each output is written once, no float atomics)."""
    _need_cuda()
    (q, k, v, do), causal, rate = _flash_inputs(name, torch.bfloat16)
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = tfa._fwd_kernel(q, k, v, causal, scale, rate, 5)
    first = tfa._bwd_kernel(q, k, v, o, lse, do, causal, scale, rate, 5)
    again = tfa._bwd_kernel(q, k, v, o, lse, do, causal, scale, rate, 5)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [64, 128])
def test_flash_wgmma_building_blocks_match_matmul(n):
    """The bf16 kernels' TMA tiles, wgmma descriptors and fragment layouts
    alone: a K-major score product (a @ b.T, b [n, 128]) and a register-A
    product with an MN-major B (a [64, n] @ b [n, 128], as P.V) against
    torch.matmul. The products of bf16 values are exact; the tensor cores
    sum them in their own order and rounding (1e-3; a wrong layout is off
    by O(1))."""
    _need_cuda()
    g = torch.Generator().manual_seed(n)
    a, b = (torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
            for shape in ((64, 128), (n, 128)))
    got = tfa._wgmma_probe(a, b, True)
    torch.testing.assert_close(got, a.float() @ b.float().T, atol=1e-3,
                               rtol=1e-3)
    a, b = (torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
            for shape in ((64, n), (n, 128)))
    got = tfa._wgmma_probe(a, b, False)
    torch.testing.assert_close(got, a.float() @ b.float(), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dropout_mask_is_the_position_hash(dtype):
    """With q = 0 every probability is exp(0) = 1 before dropout and v the
    identity, so out * t_k is the kernel's keep scale at every (row, col)
    (rounded to the input type, as p is before P.V): equal bit for bit to
    the plain ``_keep_scale``."""
    _need_cuda()
    dt = getattr(torch, dtype)
    B, H, T, D, rate, seed = 1, 3, 64, 64, 0.3, 12345
    q = torch.zeros((B, T, H, D), device="cuda", dtype=dt)
    eye = torch.eye(D, device="cuda", dtype=dt)[None, :, None].expand(
        B, T, H, D)
    o, _ = tfa._fwd_kernel(q, eye, eye.contiguous(), False, 1.0, rate, seed)
    got = _bhtd(o) * T
    want = tfa._drop_scale(B * H, torch.arange(T), torch.arange(T), seed,
                           rate, torch.device("cuda")).to(dt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,h", [(37, 4096), (64, 1000), (5, 9000),
                                    (3, 30)])
def test_rms_norm_kernel_matches_plain_version(rows, h, dtype):
    """With and without the residual: vector and scalar paths, rows held
    in registers and rows wider than the register cache."""
    _need_cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(rows + h)
    x, r, w = (torch.randn(shape, generator=g).to("cuda", dt)
               for shape in ((rows, h), (rows, h), (h,)))
    before = tfn.launch_count("rms_norm")
    y1, _ = tfn._rms_fwd(x, None, w, 1e-5)
    y2, z2 = tfn._rms_fwd(x, r, w, 1e-5)
    assert tfn.launch_count("rms_norm") == before + 2
    ry1, _ = tfn.rms_fwd_reference(x, None, w, 1e-5)
    ry2, rz2 = tfn.rms_fwd_reference(x, r, w, 1e-5)
    assert torch.equal(z2, rz2)
    # float32: rsqrtf and the sum order; bfloat16: one output ulp (2**-8)
    tol = TOL if dt == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(y1.float(), ry1.float(), **tol)
    torch.testing.assert_close(y2.float(), ry2.float(), **tol)


def _bf16_ulp(t):
    """One bfloat16 ulp at each value of the float32 tensor ``t``, or of
    2**-6 x max|t| for smaller values: where LayerNorm's
    ``xc * rstd * w + b`` cancels, the float32 rounding of the terms, not
    the bf16 rounding, sets the error."""
    a = t.abs().clamp_min(max(2.0 ** -6 * float(t.abs().max()),
                              2.0 ** -126))
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,h", [(4096, 768), (37, 1000), (5, 3000),
                                    (3, 30)])
def test_layer_norm_kernel_matches_plain_version(rows, h, dtype):
    """With and without the residual: BERT's rows, the vector path with
    rows held in registers and rows wider than the register cache, and
    the scalar path; then the backward through the kernel path."""
    _need_cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(rows + h)
    x, r, w, b = (torch.randn(shape, generator=g).to("cuda", dt)
                  for shape in ((rows, h), (rows, h), (h,), (h,)))
    before = tfn.launch_count("layer_norm")
    y1, _ = tfn._ln_fwd_call(x, None, w, b, 1e-12)
    y2, z2 = tfn._ln_fwd_call(x, r, w, b, 1e-12)
    assert tfn.launch_count("layer_norm") == before + 2
    ry1, _ = tfn.ln_fwd_reference(x, None, w, b, 1e-12)
    ry2, rz2 = tfn.ln_fwd_reference(x, r, w, b, 1e-12)
    assert torch.equal(z2, rz2)
    for got, want in ((y1, ry1), (y2, ry2)):
        got, want = got.float(), want.float()
        if dt == torch.float32:
            # rsqrtf and the sum order: 1e-5 of the largest output
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())
        else:
            assert bool(((got - want).abs() <= _bf16_ulp(want)).all())
    # the backward is plain PyTorch from the saved z: the kernel path's
    # gradients equal _ln_core_bwd from the plain version's z
    xs = [t.detach().requires_grad_(True) for t in (x, r, w, b)]
    gy = torch.randn((rows, h), generator=g).to("cuda", dt)
    y, _ = tfn.fused_layer_norm_residual(*xs, 1e-12)
    got = torch.autograd.grad(y, xs, gy)
    want = tfn._ln_core_bwd(1e-12, rz2, w, gy, None)
    for a, c in zip(got, want):
        torch.testing.assert_close(a.float(), c.float(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [((4096, 768), 0),
                                          ((4096, 3072), 0),
                                          ((1001, 3), 1)])
def test_dropout_kernel_matches_plain_version(shape, offset, dtype):
    """Bitwise: output and backward against the plain version (the same
    hash, the same correctly rounded division); keep rate; offset 1
    misaligns the buffers (the scalar path)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    n = shape[0] * shape[1]
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n + offset, generator=g).to("cuda", dt)[offset:]
    x = x.view(shape).requires_grad_(True)
    before = tfn.launch_count("dropout")
    y = tfn._dropout_via_vjp(x, 0.1, -123)
    gy = torch.randn(shape, generator=g).to("cuda", dt)
    gx, = torch.autograd.grad(y, (x,), gy)
    assert tfn.launch_count("dropout") == before + 2
    assert torch.equal(y, tfn.dropout_reference(x.detach(), 0.1, -123))
    keep = tfn.dropout_keep(n, -123, 0.1, "cuda").view(shape)
    want = ((gy.float() * keep.float())
            / torch.tensor(np.float32(0.9), device="cuda")).to(dt)
    assert torch.equal(gx, want)
    if n > 10 ** 6:
        assert abs(float(keep.float().mean()) - 0.9) < 1e-3
    # the same mask as the CPU's plain version
    assert torch.equal(keep.cpu(), tfn.dropout_keep(n, -123, 0.1, "cpu")
                       .view(shape))


def test_bert_card_matches_cpu():
    """A tiny BERT with hidden dropout 0.1 (the hash mask is
    device-independent) and attention dropout 0, fused encoder: the card
    (the LayerNorm and dropout kernels) against the CPU (their plain
    versions) from the same weights and seeds, with the launches of the
    per-step formula; then two AdamW steps."""
    _need_cuda()
    import paddle_tpu_torch
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    cfg = BertConfig.tiny(vocab=1000, hidden=128, layers=2, heads=2,
                          inter=256)
    cfg.attention_probs_dropout_prob = 0.0
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, 1000, (2, 32)))
    mlm = torch.from_numpy(np.where(rng.rand(2, 32) < 0.15,
                                    rng.randint(0, 1000, (2, 32)), -100))
    nsp = torch.from_numpy(rng.randint(0, 2, (2,)))
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": True})
    try:
        models, losses = [], []
        for dev in ("cuda", "cpu"):
            m = BertForPretraining(cfg, device=dev,
                                   generator=torch.Generator().manual_seed(1))
            if models:
                m.load_state_dict({k: v.cpu() for k, v in
                                   models[0].state_dict().items()})
            models.append(m)
        tfn.reset_launch_count()
        for m in models:
            dev = next(m.parameters()).device
            opt = AdamW(1e-4, parameters=m.parameters())
            out = []
            for _ in range(2):
                loss, _ = m(ids.to(dev), masked_lm_labels=mlm.to(dev),
                            next_sentence_label=nsp.to(dev))
                loss.backward()
                out.append(loss.detach().cpu())
                if len(out) == 1:
                    grads = {n: p.grad.detach().cpu()
                             for n, p in m.named_parameters()
                             if p.grad is not None}
                opt.step()
                opt.clear_grad()
            losses.append((out, grads))
        torch.cuda.synchronize()
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": False})
    L = cfg.num_hidden_layers
    # per step: dropout 1 + 3 per layer forward, the same backward;
    # LayerNorm + residual 2 per layer
    assert tfn.launch_count("dropout") == 2 * 2 * (1 + 3 * L)
    assert tfn.launch_count("layer_norm") == 2 * 2 * L
    (lc, gc), (lp, gp) = losses
    for a, b in zip(lc, lp):
        torch.testing.assert_close(a, b, atol=0, rtol=1e-5)
    assert set(gc) == set(gp)
    for n in gc:
        scale = float(gp[n].abs().max())
        assert float((gc[n] - gp[n]).abs().max()) <= 1e-3 * scale + 1e-6, n


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,offset", [(1000003, 0), (4096, 0), (999, 1)])
def test_adamw_kernel_matches_plain_version(n, offset, pdtype):
    """Three steps in place; offset 1 misaligns every buffer (the scalar
    path)."""
    _need_cuda()
    dt = getattr(torch, pdtype)
    g0 = torch.Generator().manual_seed(n)
    master = (0.02 * torch.randn(n + offset, generator=g0)).cuda()[offset:]
    bufs = {"p": master.to(dt), "m": torch.zeros_like(master),
            "v": torch.zeros_like(master), "master": master.clone()}
    ref = {k: t.clone() for k, t in bufs.items()}
    before = tfw.launch_count()
    for step in (1, 2, 3):
        grad = (torch.randn(n + offset, generator=g0) * 1e-2).cuda()[
            offset:].to(dt)
        args = (3e-4, 0.9, 0.95, 1e-8, 0.1, step)
        tfw.fused_adamw_update(bufs["p"], grad, bufs["m"], bufs["v"],
                               bufs["master"], *args)
        tfw.fused_adamw_reference(ref["p"], grad, ref["m"], ref["v"],
                                  ref["master"],
                                  tfw.adamw_scalars(*args, "cuda"))
    assert tfw.launch_count() == before + 3
    for k in ("m", "v", "master"):
        torch.testing.assert_close(bufs[k], ref[k], atol=1e-7, rtol=1e-5)
    # p is master rounded to p's type: one ulp where master sits on a tie
    torch.testing.assert_close(bufs["p"].float(), ref["p"].float(),
                               atol=1e-7, rtol=2 ** -7)


def _tiny_trainer(fused, remat=False, dtype=torch.float32):
    cfg = LlamaConfig.tiny(vocab=512, hidden=256, layers=2, heads=4,
                           kv_heads=2, inter=512, seq=128)
    tr = LlamaSpmdTrainer(cfg, lr=1e-3, remat=remat, seed=5,
                          compute_dtype=dtype, device="cuda")
    tr._fused = fused
    return tr


def test_trainer_kernel_path_matches_plain_path():
    """A tiny Llama (hd 64, GQA, T 128: the flash branch) on the card,
    float32: the kernels' step against the plain step from the same
    weights; loss, every gradient and two AdamW steps, with the launch
    counts of the per-step formula (flash forward and backward once per
    layer, RMSNorm twice per layer, AdamW once per leaf)."""
    _need_cuda()
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512,
                                                            (2, 128)))
    a, b = _tiny_trainer(True), _tiny_trainer(False)
    la = a.loss_fn(a.params, ids, ids)
    lb = b.loss_fn(b.params, ids, ids)
    torch.testing.assert_close(la, lb, atol=1e-5, rtol=1e-5)
    ga = torch.autograd.grad(la, a._leaves(a.params))
    gb = torch.autograd.grad(lb, b._leaves(b.params))
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, atol=2e-4, rtol=2e-4)
    for mod in (tfa, tfn, tfw):
        mod.reset_launch_count()
    for _ in range(2):
        a.train_step(ids)
        b.train_step(ids)
    torch.cuda.synchronize()
    L = 2
    assert (tfa.launch_count("fwd"), tfa.launch_count("bwd")) == (2 * L,
                                                                  2 * L)
    assert tfn.launch_count("rms_norm") == 2 * 2 * L
    assert tfw.launch_count() == 2 * 12
    # AdamW divides by sqrt(v): where a gradient is ~0 the two paths'
    # rounding can move a parameter by up to ~lr per step
    for path in tree_paths(a.params):
        torch.testing.assert_close(tree_get(a.params, path),
                                   tree_get(b.params, path),
                                   atol=2 * 2 * a.lr, rtol=0)


def test_trainer_mesh_matches_one_device_on_the_card():
    """dp 2 x pp 2 x mp 2 logical ranks on the card with the kernels
    (hd 64, T 128: the flash branch on every rank), float32, against the
    one-device trainer from the same seed: the loss, every gradient
    leaf, two steps' parameters; the launches of the schedule (each rank
    runs flash and RMSNorm on its 2 micro-batches of its stage's layer,
    AdamW on each leaf it holds)."""
    _need_cuda()
    from paddle_tpu_torch.parallel import collective
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    cfg = LlamaConfig.tiny(vocab=512, hidden=256, layers=2, heads=4,
                           kv_heads=2, inter=512, seq=128)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512,
                                                            (4, 128)))
    one = LlamaSpmdTrainer(cfg, lr=1e-3, remat=False, seed=5,
                           compute_dtype=torch.float32, device="cuda")
    mesh_mod.build_mesh(dp=2, pp=2, mp=2, devices=["cuda"] * 8)
    try:
        tr = LlamaSpmdTrainer(cfg, lr=1e-3, remat=False, seed=5,
                              n_micro=2, compute_dtype=torch.float32)
        assert tr._fused
        la, ga = tr.grads(ids)
        lb, gb = one.grads(ids)
        torch.testing.assert_close(la, lb, atol=1e-5, rtol=1e-5)
        for path, g in gb.items():
            torch.testing.assert_close(ga[path].reshape(g.shape), g,
                                       atol=2e-4, rtol=2e-4)
        for mod in (tfa, tfn, tfw):
            mod.reset_launch_count()
        collective.reset_counts()
        for _ in range(2):
            tr.train_step(ids)
            one.train_step(ids)
        torch.cuda.synchronize()
        # per step: 8 ranks x 1 layer x 2 micro-batches; one-device: 2
        execs = 8 * 2 + 2
        assert (tfa.launch_count("fwd"), tfa.launch_count("bwd")) == (
            2 * execs, 2 * execs)
        assert tfn.launch_count("rms_norm") == 2 * 2 * execs
        assert tfw.launch_count() == 2 * (9 * 8 + 3 * 4 + 12)
        assert collective.counts()["ppermute"]["calls"] == 2 * 2 * 4 * 2
        got = {p: tr.assemble(p, tree_get(tr.params, p))
               for p in tree_paths(tr.params)}
        for path in tree_paths(one.params):
            torch.testing.assert_close(
                got[path].reshape(tree_get(one.params, path).shape),
                tree_get(one.params, path), atol=2 * 2 * tr.lr, rtol=0)
    finally:
        mesh_mod.set_mesh(None)


def test_trainer_bf16_remat_relaunches_forward_kernels():
    """bf16 with remat: each block's forward runs again in the backward,
    so the forward kernels launch twice per layer per step."""
    _need_cuda()
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 512,
                                                            (2, 128)))
    tr = _tiny_trainer(True, remat=True, dtype=torch.bfloat16)
    for mod in (tfa, tfn, tfw):
        mod.reset_launch_count()
    losses = [float(tr.train_step(ids)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    L = 2
    assert tfa.launch_count("fwd") == 3 * 2 * L
    assert tfa.launch_count("bwd") == 3 * L
    assert tfn.launch_count("rms_norm") == 3 * 2 * 2 * L
    assert tfw.launch_count() == 3 * 12


def test_unmasked_forward_takes_the_flash_kernel():
    """A full forward with caches=None and no mask runs the flash kernel
    on the card (causal, head_dim 64) and matches the masked dense path."""
    _need_cuda()
    core = FusedMultiTransformer(128, 2, 256, num_layers=2, device="cuda")
    x = torch.randn((2, 128, 128), generator=torch.Generator().manual_seed(
        2)).cuda()
    mask = torch.full((128, 128), -1e30, device="cuda").triu(1)
    before = tfa.launch_count("fwd")
    with torch.no_grad():
        got = core(x)
        ref = core(x, attn_mask=mask)
    assert tfa.launch_count("fwd") == before + 2
    torch.testing.assert_close(got, ref, **TOL_TRAIN)


# -- fork-shared parallel decoding on the card ----------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_cow_split_copies_a_shared_partial_page_on_the_card(dtype):
    """Slot 1 forks slot 0 at 10 tokens (the third 4-token page partly
    full); its first write there splits the shared page: the private
    copy holds the page's payload and, on an int8 pool, its scales,
    bitwise, in every layer, on the card."""
    _need_cuda()
    from paddle_tpu_torch.inference import PagedKVCache
    c = PagedKVCache(2, 2, 8, 4, 12, 3, dtype=dtype, device="cuda")
    c.ensure(0, 10)
    g = torch.Generator(device="cuda").manual_seed(3)
    for i, p in enumerate(c.pools):
        if c.quantized:
            p.copy_(torch.randint(-127, 128, p.shape, generator=g,
                                  device="cuda", dtype=torch.int32)
                    .to(torch.int8))
            c.scales[i].copy_(torch.rand(c.scales[i].shape, generator=g,
                                         device="cuda"))
        else:
            p.copy_(torch.randn(p.shape, generator=g, device="cuda"))
    c.fork(0, 1, 10)
    old = c.seq_blocks[0][2]
    assert c.seq_blocks[1] == c.seq_blocks[0]
    c.check_invariants(deep=True)
    c.ensure(1, 11, write_from=10)
    new = c.seq_blocks[1][2]
    assert new != old and c.seq_blocks[1][:2] == c.seq_blocks[0][:2]
    for i, p in enumerate(c.pools):
        assert p.is_cuda and torch.equal(p[new], p[old])
        if c.quantized:
            assert torch.equal(c.scales[i][new], c.scales[i][old])
    c.check_invariants(deep=True)


def test_ragged_launch_over_shared_pages_matches_plain_version():
    """Rows whose tables reference the same physical pages (a group's
    prompt pages, each branch's own tail), decode and verify rows beside
    a prefill chunk, in one launch: the plain version's result within
    TOL, and a branch row bitwise equal to the same row alone."""
    _need_cuda()
    nh, nkv, hd, bs = 8, 2, 64, 16
    rng = np.random.RandomState(11)
    NB = 40
    pool = torch.from_numpy(rng.randn(NB, 2, nkv, bs, hd).astype(
        np.float32)).cuda()
    shared = [5, 9, 2, 30]                  # 4 prompt pages, 60 tokens
    tails = [11, 17, 23]
    bt = np.zeros((5, 8), np.int32)
    for r, t in enumerate(tails):
        bt[r, :4] = shared
        bt[r, 4] = t
    bt[3, :4] = shared                      # the lead, still at 60
    bt[4, :3] = [31, 32, 33]                # an unrelated prefill
    q_lens = (1, 1, 3, 1, 40)
    kv_lens = np.asarray([66, 70, 72, 60, 40], np.int32)
    q = torch.from_numpy(rng.randn(sum(q_lens), nh, hd).astype(
        np.float32)).cuda()
    before = tpa.launch_count()
    got = tpa.paged_attention_ragged(q, pool, bt, q_lens, kv_lens)
    assert tpa.launch_count() == before + 1
    ref = tpa.paged_attention_ragged_reference(q, pool, bt, q_lens,
                                               kv_lens)
    torch.testing.assert_close(got, ref, **TOL)
    alone = tpa.paged_attention_ragged(q[1:2], pool, bt[1:2], (1,),
                                       kv_lens[1:2])
    assert torch.equal(alone, got[1:2])


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_group_served_on_the_card_passes_the_deep_audit(kv_dtype):
    """A greedy n=3 group beside a lone request under a token budget on
    the card: the engine audit (group records, refcounts, the deep page
    fingerprints) holds after every round, the branches emit one
    stream, every model call launches the ragged kernel once per layer,
    and a cancelled branch leaves the audit whole."""
    _need_cuda()
    D, H, FFN, LAYERS, V = 64, 4, 128, 2, 128
    rng = np.random.RandomState(5)
    emb = rng.randn(V, D).astype(np.float32)
    core = FusedMultiTransformer(D, H, FFN, num_layers=LAYERS,
                                 device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(0))
    calls = []
    core.register_forward_pre_hook(lambda m, a: calls.append(1))
    eng = SpeculativeEngine(TokenServingModel(core, emb), None, k=0,
                            max_batch=6, block_size=4, num_blocks=60,
                            chunk_tokens=8, prefill_token_budget=12,
                            kv_dtype=kv_dtype)
    greedy = eng.submit(list(rng.randint(0, V, 21)), n=3)
    lone = eng.submit(list(rng.randint(0, V, 6)))
    tpa.reset_launch_count()
    calls.clear()
    for _ in range(12):
        eng.step()
        eng.check_invariants()
    rids = eng.group(greedy)["rids"]
    assert len(rids) == 3 and len(eng.generated(lone)) > 0
    assert len({tuple(eng.generated(r)) for r in rids}) == 1
    assert tpa.launch_count() == LAYERS * len(calls) > 0
    eng.cancel(rids[1])
    eng.step()
    eng.check_invariants()
    assert eng.resilience_stats.cancelled == 1


def _filled_pool(dtype, prefix=True):
    """A card pool with two active slots (one fork-sharing the other's
    prefix), a retired slot's pages cached-free and random contents in
    every layer (int8 payload and scales on an int8 pool)."""
    from paddle_tpu_torch.inference import PagedKVCache, chain_block_hashes
    c = PagedKVCache(2, 2, 8, 4, 16, 3, dtype=dtype, prefix_cache=prefix,
                     device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    for i, p in enumerate(c.pools):
        if c.quantized:
            p.copy_(torch.randint(-127, 128, p.shape, generator=g,
                                  device="cuda", dtype=torch.int32)
                    .to(torch.int8))
            c.scales[i].copy_(torch.rand(c.scales[i].shape, generator=g,
                                         device="cuda"))
        else:
            p.copy_(torch.randn(p.shape, generator=g, device="cuda"))
    rows = np.random.RandomState(5).randn(12, 8).astype(np.float32)
    c.ensure(0, 10)
    c.register_prefix(0, chain_block_hashes(rows[:10], 4))
    c.fork(0, 1, 8)
    c.ensure(2, 12)
    c.register_prefix(2, chain_block_hashes(rows[::-1].copy(), 4))
    c.free_seq(2)
    c.check_invariants()
    return c


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pool_snapshot_round_trip_on_the_card(dtype):
    """A card pool's snapshot restores on the card with every live and
    cached-free page bitwise (int8: payload and scales), the allocator's
    exact state, and a delta against an earlier snapshot restores the
    same pages; rehoming into a smaller pool drops the LRU cached-free
    page and keeps the rest bitwise."""
    _need_cuda()
    from paddle_tpu_torch.inference import PagedKVCache
    c = _filled_pool(dtype)
    snap = c.snapshot()
    assert snap["payload"].dtype == (np.int8 if dtype == "int8"
                                     else np.float32)
    out = PagedKVCache.restore(snap, device="cuda")
    keep = sorted(int(b) for b in snap["refcount"]) + \
        list(snap["cached_order"])
    ids = torch.tensor(keep, device="cuda")
    arrs = list(zip(c.pools, out.pools)) + (
        list(zip(c.scales, out.scales)) if c.quantized else [])
    for a, b in arrs:
        assert b.is_cuda and torch.equal(a[ids], b[ids])
    assert out.allocator._free == c.allocator._free
    assert list(out.allocator._cached) == list(c.allocator._cached)
    c.ensure(1, 14)                          # a fresh unhashed page
    c.pools[0][c.seq_blocks[1][-1]] = 1      # new content on the card
    delta = c.snapshot(base=snap)
    assert len(delta["blocks"]) < len(c.snapshot()["blocks"])
    d = PagedKVCache.restore(delta, base=snap, device="cuda")
    full = PagedKVCache.restore(c.snapshot(), device="cuda")
    live = torch.tensor(sorted(int(b) for b in delta["refcount"]),
                        device="cuda")
    for a, b in zip(d.pools + (d.scales or []),
                    full.pools + (full.scales or [])):
        assert torch.equal(a[live], b[live])
    n_live = sum(1 for n in snap["refcount"].values() if n > 0)
    small = PagedKVCache.restore(snap, num_blocks=n_live + 1 + 2,
                                 device="cuda")
    assert small.allocator.reclaimed == c.allocator.reclaimed + 1
    small.check_invariants(deep=True)


def test_numeric_guard_fails_a_nan_row_of_a_card_output():
    """The guard reads one [B] bool per step off a CUDA output: the slot
    whose row holds a NaN fails FAILED_NUMERIC with its pages
    quarantined, the other slot steps on."""
    _need_cuda()
    from paddle_tpu_torch.inference import PagedServingEngine
    core = FusedMultiTransformer(32, 4, 64, num_layers=2, device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(0))
    eng = PagedServingEngine(core, 2, 4, 20, numeric_guard=True,
                             prefix_cache=True)
    rng = np.random.RandomState(1)
    for n in (9, 11):
        eng.submit(rng.randn(n, 32).astype(np.float32))
    x = torch.zeros(2, 1, 32, device="cuda")
    for slot in (0, 1):
        x[slot] = eng.admitted[slot][2]
    eng.admitted.clear()
    eng.step(x)
    out = torch.zeros(2, 1, 32, device="cuda")
    out[1] = float("nan")
    stepping = eng.active.copy()
    eng._guard_numeric(out, stepping)
    (oc,) = eng.outcomes
    assert oc.status == "failed_numeric" and "slot 1" in oc.reason
    assert eng.active[0] and not eng.active[1]
    eng.check_invariants()


def test_injected_nan_leaves_other_rows_bitwise_on_the_card():
    """FaultInjector's NaN planting writes the scheduled slots' rows on
    the card and copies the others bitwise; the input stays as it was."""
    _need_cuda()
    from paddle_tpu_torch.inference import FaultInjector
    inj = FaultInjector(nan_at={3: [0, 2]}, draft_nan_at={3: [1]})
    inj.begin_step(3)
    x = torch.randn(4, 2, 64, device="cuda")
    before = x.clone()
    out = inj.corrupt_hidden(x)
    assert out.is_cuda and torch.isnan(out[[0, 2]]).all()
    assert torch.equal(out[[1, 3]], before[[1, 3]])
    assert torch.equal(x, before)
    lg = inj.corrupt_draft_logits(torch.randn(4, 100, device="cuda"))
    assert torch.isnan(lg[1]).all() and not torch.isnan(lg[[0, 2, 3]]).any()
    assert inj.injected_nan == 2 and inj.injected_draft_nan == 1


@pytest.mark.parametrize("tile_kv", [None, 128, 64, 256])
def test_ragged_kernel_tile_kv_is_the_compiled_span(tile_kv):
    """``tile_kv`` takes None or the compiled span (128 keys): both
    launch and agree bitwise; any other value raises naming the span."""
    _need_cuda()
    nh, nkv, hd, bs, q_lens, kv_lens, MB, trash, _ = RAGGED["decode"]
    q, pool, bt, lens = _ragged(3, nh, nkv, hd, bs, q_lens, kv_lens, MB,
                                trash)
    if tile_kv in (None, 128):
        got = tpa.paged_attention_ragged(q, pool, bt, q_lens, lens,
                                         None, None, tile_kv)
        assert torch.equal(got, tpa.paged_attention_ragged(
            q, pool, bt, q_lens, lens))
    else:
        with pytest.raises(NotImplementedError, match="SPAN = 128"):
            tpa.paged_attention_ragged(q, pool, bt, q_lens, lens,
                                       tile_kv=tile_kv)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_recoverable_server_crashes_and_recovers_on_the_card(kv_dtype,
                                                             tmp_path):
    """A small RecoverableServer on the card under a token budget,
    crashed at post_journal, pre_journal and post_prefill and recovered
    each time from its snapshot and journal files (with a fresh
    collector, monitor and ledger): the streams equal an uninterrupted
    run on the card, every outcome is delivered exactly once, the
    engine audit holds after each restore, and the replayed rounds ran
    the ragged kernel."""
    _need_cuda()
    from paddle_tpu_torch.inference import (CostLedger, CrashInjector,
                                            EngineCrash, HealthMonitor,
                                            RecoverableServer,
                                            TraceCollector)
    D, H, FFN, LAYERS, V = 64, 4, 128, 2, 128
    rng = np.random.RandomState(7)
    emb = rng.randn(V, D).astype(np.float32)
    head = rng.randn(D, V).astype(np.float32)
    core = FusedMultiTransformer(D, H, FFN, num_layers=LAYERS,
                                 device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(0))
    tsm = TokenServingModel(core, emb, head)
    prompts = [list(rng.randint(0, V, n)) for n in (9, 14, 6, 11)]
    kw = dict(k=0, max_batch=3, block_size=4, num_blocks=30,
              chunk_tokens=8, prefill_token_budget=8, kv_dtype=kv_dtype)
    N = 10

    def serve(srv, jp=None, sp=None, inj=None):
        rids = [srv.submit(p) for p in prompts]
        done, delivered, restores = {}, [], 0
        for _ in range(200):
            if all(r in done for r in rids):
                break
            try:
                srv.step()
                delivered += [oc.rid for oc in srv.drain_outcomes()]
                for r in rids:
                    if r not in done and len(srv.generated(r)) >= N:
                        done[r] = srv.generated(r)[:N]
                        srv.release(r)
            except EngineCrash:
                srv = RecoverableServer.recover(
                    tsm, None, journal_path=jp, snapshot_path=sp,
                    injector=inj, collector=TraceCollector(),
                    monitor=HealthMonitor(), ledger=CostLedger())
                srv.check_invariants()
                restores += 1
        srv.step()
        delivered += [oc.rid for oc in srv.drain_outcomes()]
        return done, delivered, restores, srv

    jp0, sp0 = str(tmp_path / "base.wal"), str(tmp_path / "base.ckpt")
    base, base_del, _, _ = serve(RecoverableServer(
        SpeculativeEngine(tsm, None, **kw), journal_path=jp0,
        snapshot_path=sp0, snapshot_every=3))
    jp, sp = str(tmp_path / "req.wal"), str(tmp_path / "serve.ckpt")
    inj = CrashInjector(crash_at={3: "post_journal", 6: "pre_journal",
                                  9: "post_prefill"})
    tpa.reset_launch_count()
    got, delivered, restores, srv = serve(RecoverableServer(
        SpeculativeEngine(tsm, None, injector=inj, **kw),
        journal_path=jp, snapshot_path=sp, snapshot_every=3, sync=True),
        jp, sp, inj)
    assert restores == inj.crashes >= 2
    assert got == base
    assert sorted(delivered) == sorted(set(delivered)) == sorted(base_del)
    assert srv.replayed_rounds > 0 and tpa.launch_count() > 0
    assert srv.engine.ledger.conservation()["ok"]


def test_pipe_workers_on_the_card_survive_a_sigkill(tmp_path):
    """Two PipeWorker processes, each with its own CUDA context serving
    through the ragged kernel the parent built, behind one Router; a raw
    SIGKILL of one worker mid-stream resubmits its streams to the other,
    and every stream equals an uninterrupted in-process run on the card,
    each outcome delivered once."""
    _need_cuda()
    from paddle_tpu_torch.inference import (PipeWorker, RequestOutcome,
                                            Router, build_server_from_spec,
                                            token_chain_hashes)
    base = dict(d_model=64, heads=4, ffn=128, layers=2, vocab=128,
                head_roll=1, block_size=4, num_blocks=80,
                max_blocks_per_seq=10, device="cuda")

    def spec(name):
        return dict(base, journal_path=str(tmp_path / f"{name}.wal"),
                    snapshot_path=str(tmp_path / f"{name}.ckpt"))

    rng = np.random.RandomState(77)
    prompts = [[int(t) for t in rng.randint(0, 128, n)]
               for n in (6, 9, 13, 7)]
    n = 10
    _build.build_all()                 # the children load these
    srv = build_server_from_spec(spec("solo"))
    tpa.reset_launch_count()
    rids = [srv.submit(p) for p in prompts]
    want = {}
    for _ in range(200):
        if len(want) == len(rids):
            break
        srv.step()
        for i, r in enumerate(rids):
            if i not in want and len(srv.generated(r)) >= n:
                want[i] = srv.generated(r)[:n]
                srv.release(r)
    assert len(want) == len(rids) and tpa.launch_count() > 0
    model = srv.engine.target
    srv.close()
    workers = [PipeWorker(spec(f"p{i}"), name=f"p{i}", timeout=600.0,
                          wait_ready=False) for i in range(2)]
    try:
        r = Router(workers, hash_fn=lambda t: token_chain_hashes(
            model, t, 4), backoff_ticks=1)
        rids = [r.submit(p, max_new_tokens=n) for p in prompts]
        r.step()
        victim = r._reqs[rids[0]].worker
        {w.name: w for w in workers}[victim].kill()      # SIGKILL
        ocs = []
        for _ in range(80):
            r.step()
            ocs += r.drain_outcomes()
            if len(ocs) >= len(rids):
                break
        assert r.stats.worker_deaths == 1 and r.stats.resubmissions >= 1
        assert {i: r.generated(rid) for i, rid in enumerate(rids)} == want
        assert sorted(o.rid for o in ocs) == sorted(rids)
        assert all(o.status == RequestOutcome.FINISHED for o in ocs)
        assert r.check_invariants()
        r.close()
    finally:
        for w in workers:
            w.kill()


def _sharded_pair(kv_dtype="float32"):
    """(mp=1 surface, its embedding) of a small card model with a rolled
    readout, so greedy streams walk the vocabulary."""
    D, H, FFN, LAYERS, V = 64, 4, 128, 2, 128
    rng = np.random.RandomState(9)
    emb = rng.randn(V, D).astype(np.float32)
    core = FusedMultiTransformer(D, H, FFN, num_layers=LAYERS,
                                 device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(3))
    return TokenServingModel(core, emb, lm_head=np.roll(emb, -1, 0).T.copy())


def _serve_sharded(tsm, kv_dtype):
    rng = np.random.RandomState(4)
    eng = SpeculativeEngine(tsm, None, k=0, max_batch=3, block_size=4,
                            num_blocks=48, chunk_tokens=8,
                            prefill_token_budget=12, kv_dtype=kv_dtype)
    rids = [eng.submit(list(rng.randint(0, 128, n))) for n in (21, 6, 13)]
    for _ in range(14):
        eng.step()
    eng.check_invariants()
    return {r: eng.tokens(r) for r in rids}, eng


@pytest.mark.parametrize("mp,mode", [(2, "activations"), (4, "activations"),
                                     (2, "weights")])
def test_sharded_hidden_states_equal_mp1_on_the_card(mp, mode):
    """mp logical shards on the card against the unsharded core over the
    same pool state, one chunked prefill and one decode call: with the
    replicated projection every GEMM is mp=1's and each head's ragged
    work does not depend on the launch's head count, so the hidden
    states are bitwise equal; column-sliced qkv GEMMs ("weights") within
    1e-5 x max|h|. Each call launches the ragged kernel layers x mp
    times."""
    _need_cuda()
    t = _sharded_pair()
    core = t.shard(mp, qkv_shard=mode).core
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 37, 64).astype(np.float32)).cuda()
    xd = torch.from_numpy(rng.randn(2, 1, 64).astype(np.float32)).cuda()
    outs, launches = [], []
    for m in (t.core, core):
        c = m.gen_paged_cache(4, 24, 2)
        for slot in (0, 1):
            c.ensure(slot, 37, write_from=0)
        tpa.reset_launch_count()
        with torch.no_grad():
            h0, _ = m(x, caches=c.prefill_views(0), time_step=[0])
            m(x, caches=c.prefill_views(1), time_step=[0])
            for slot in (0, 1):
                c.ensure(slot, 38)
            h1, _ = m(xd, caches=c.views, time_step=np.array([37, 37]))
        launches.append(tpa.launch_count())
        outs.append((h0, h1))
    assert launches == [3 * 2, 3 * 2 * mp]
    for a, b in zip(*outs):
        if mode == "activations":
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= \
                1e-5 * float(a.abs().max())


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_sharded_serving_streams_and_launches_on_the_card(kv_dtype):
    """Token-budget serving through tsm.shard(2) on the card (qkv
    "weights", the CUDA default) emits the mp=1 greedy streams over a
    float and an int8 pool; every model call launches the ragged kernel
    layers x 2 times and all-reduces once per layer; the int8 pool's
    bytes per device are half its total."""
    _need_cuda()
    t = _sharded_pair()
    ref, _ = _serve_sharded(t, kv_dtype)
    t2 = t.shard(2)
    assert t2.core.qkv_shard == "weights"
    calls = []
    t2.core.register_forward_pre_hook(lambda m, a: calls.append(1))
    tpa.reset_launch_count()
    got, eng = _serve_sharded(t2, kv_dtype)
    assert got == ref
    assert tpa.launch_count() == 2 * 2 * len(calls) > 0
    assert t2.core.allreduce_count == 2 * len(calls)
    cache = eng.engine.cache
    assert cache.mp == 2 and cache.pool_bytes() * 2 == cache.pool_bytes_total()
    assert all(p.is_cuda for p in cache.pools)


# -- AMP and the nn training surface on the card -----------------------------

def test_rms_norm_layer_runs_the_kernel_in_bf16():
    """``nn.RMSNorm`` on a bf16 CUDA tensor launches the RMSNorm kernel
    (forward) and agrees with the plain version within one bf16 ulp of
    each element; inputs of two dtypes raise instead of falling back."""
    _need_cuda()
    from paddle_tpu_torch import nn
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 512, generator=g).to(torch.bfloat16)
    layer = nn.RMSNorm(512, 1e-5, device="cuda")
    with torch.no_grad():
        layer.weight.copy_(torch.rand(512, generator=g) + 0.5)
    layer.to(torch.bfloat16)
    xc = x.cuda().requires_grad_()
    before = tfn.launch_count("rms_norm")
    y = layer(xc)
    assert tfn.launch_count("rms_norm") == before + 1
    ref, _ = tfn.rms_fwd_reference(x, None, layer.weight.detach().cpu(),
                                   1e-5)
    err = (y.detach().cpu().float() - ref.float()).abs()
    assert bool((err <= 2.0 ** -7 * ref.float().abs().clamp_min(
        2.0 ** -6 * float(ref.float().abs().max()))).all())
    y.float().sum().backward()
    assert xc.grad.dtype == torch.bfloat16 and layer.weight.grad is not None
    with pytest.raises(ValueError):
        nn.functional.rms_norm(xc.detach(), layer.weight.detach().float())


def test_flash_kernel_decodes_against_a_cache():
    """The decode shape ``generate`` gives the flash kernel: one query
    row per sequence against a 131-key cache (not a multiple of the
    tile), bf16, head_dim 128, through ``F.scaled_dot_product_attention``
    (not causal). Each row within 3e-2 x its max|ref| of the float32
    dense path."""
    _need_cuda()
    from paddle_tpu_torch.nn.functional.attention import (
        _sdpa, scaled_dot_product_attention)
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(3, n, 8, 128, generator=g).to(torch.bfloat16)
               for n in (1, 131, 131))
    before = tfa.launch_count("fwd")
    out = scaled_dot_product_attention(q.cuda(), k.cuda(), v.cuda())
    assert tfa.launch_count("fwd") == before + 1
    ref = _sdpa(q.float(), k.float(), v.float(), None, False, None)
    err = (out.float().cpu() - ref).abs().amax(-1)
    assert bool((err <= 3e-2 * ref.abs().amax(-1)).all())


def test_bert_o2_step_on_the_card_matches_the_cpu():
    """A BERT step under O2 (decorate bf16, auto_cast O2, fused encoder,
    hidden dropout 0.1 with the hash mask the two devices share): the
    LayerNorm and dropout kernels run in bf16 on the card; the loss and
    every gradient (cosine) agree with the CPU's plain path from the same
    weights and seeds within bf16 bounds (2e-2 relative, cosine 0.99)."""
    _need_cuda()
    import paddle_tpu_torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    cfg = BertConfig.tiny(vocab=500, hidden=128, layers=2, heads=2,
                          inter=256)
    cfg.attention_probs_dropout_prob = 0.0
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 500, (4, 32))
    mlm = np.where(rng.rand(4, 32) < 0.3, rng.randint(0, 500, (4, 32)), -100)
    nsp = rng.randint(0, 2, (4,))
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": True})
    try:
        res, state = [], None
        for dev in ("cuda", "cpu"):
            m = BertForPretraining(cfg, device=dev,
                                   generator=torch.Generator().manual_seed(6))
            if state is None:
                state = {k: v.detach().cpu() for k, v in
                         m.state_dict().items()}
            else:
                m.load_state_dict(state)
            amp.decorate(m, level="O2", dtype="bfloat16")
            before = (tfn.launch_count("layer_norm"),
                      tfn.launch_count("dropout"))
            with amp.auto_cast(level="O2"):
                loss, _ = m(torch.from_numpy(ids).to(dev),
                            masked_lm_labels=torch.from_numpy(mlm).to(dev),
                            next_sentence_label=torch.from_numpy(nsp).to(dev))
            loss.backward()
            if dev == "cuda":
                assert loss.dtype == torch.bfloat16
                assert tfn.launch_count("layer_norm") == before[0] + 4
                assert tfn.launch_count("dropout") == before[1] + 2 * (
                    1 + 3 * 2)
            res.append((loss.float().item(),
                        {n: p.grad.float().cpu() for n, p in
                         m.named_parameters() if p.grad is not None}))
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": False})
    (lk, gk), (lp, gp) = res
    assert abs(lk - lp) <= 2e-2 * abs(lp)
    assert set(gk) == set(gp)
    for n in gp:
        if n.endswith("k_proj.bias"):      # exact gradient 0: noise
            continue
        cos = float((gk[n].flatten() @ gp[n].flatten())
                    / (gk[n].norm() * gp[n].norm()).clamp_min(1e-30))
        assert cos >= 0.99, (n, cos)


def test_llama_mp2_step_on_the_card_matches_mp1():
    """``fleet.init(mp_degree=2, device="cuda")``: a Llama (GQA, head_dim
    64, T 128: the flash kernels and the RMSNorm kernel) built from the
    mp 1 model's state takes one float32 step (TF32 off) on logical mp
    ranks: the loss within 1e-5 relative of mp 1's, every gradient
    within 1e-4 x its max|g| (summation order of the Row layers'
    rank-order sums), the same kernel launches, and the Megatron
    pairing's collectives (7 L + 2 all-reduces, one all-gather)."""
    _need_cuda()
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.topology import \
        set_hybrid_communicate_group
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.parallel import collective
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    cfg = LlamaConfig.tiny(vocab=512, hidden=256, layers=2, heads=4,
                           kv_heads=2, inter=512, seq=128)
    ids = torch.from_numpy(np.random.RandomState(6).randint(
        0, 512, (2, 128))).cuda()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    res, state = [], None
    try:
        for mp in (1, 2):
            if mp == 2:
                s = fleet.DistributedStrategy()
                s.hybrid_configs["mp_degree"] = 2
                s.tensor_parallel_configs["tensor_init_seed"] = 1
                fleet.init(strategy=s, device="cuda")
            m = LlamaForCausalLM(cfg, device="cuda",
                                 generator=torch.Generator().manual_seed(0))
            if state is None:
                state = {k: v.detach().clone()
                         for k, v in m.state_dict().items()}
            else:
                m.load_state_dict(state)
            tfa.reset_launch_count()
            tfn.reset_launch_count()
            collective.reset_counts()
            loss, _ = m(ids, labels=ids)
            loss.backward()
            torch.cuda.synchronize()
            res.append((loss.item(),
                        {n: p.grad.cpu() for n, p in m.named_parameters()},
                        (tfa.launch_count("fwd"), tfa.launch_count("bwd"),
                         tfn.launch_count("rms_norm")),
                        {k: v["calls"] for k, v in
                         collective.counts().items()}))
    finally:
        set_hybrid_communicate_group(None)
        mesh_mod.set_mesh(None)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (l1, g1, k1, c1), (l2, g2, k2, c2) = res
    assert abs(l2 - l1) <= 1e-5 * abs(l1)
    for n, g in g1.items():
        assert float((g2[n] - g).abs().max()) <= 1e-4 * max(
            float(g.abs().max()), 1e-30), n
    assert k1 == k2 == (2, 2, 5)
    assert c1 == {"all_reduce": 0, "ppermute": 0, "reduce_scatter": 0,
                  "all_gather": 0}
    assert c2 == dict(c1, all_reduce=7 * 2 + 2, all_gather=1)


def test_pipeline_zero1_step_on_the_card_matches_the_twin():
    """Phase 26 (a) at tiny widths on the card: PipelineParallel over a
    PipelineLayer of LlamaForCausalLM's modules at pp 2 x sharding 2
    (logical ranks) with DygraphShardingOptimizer, under O2, against
    LlamaForCausalLM accumulating the same 4 micro-batches by hand: the
    loss, every gradient and every master after the step bitwise (the
    same kernels on the same shapes), the flash and RMSNorm launches
    and the all-gathers exactly as fleet_hybrid_expected derives."""
    _need_cuda()
    import chip_smoke as cs
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import collective
    dev = torch.device("cuda")
    cfg = LlamaConfig.tiny(vocab=256, hidden=128, layers=2, heads=2,
                           kv_heads=2, inter=256, seq=128)
    ids = torch.randint(0, 256, (8, 128), generator=torch.Generator()
                        .manual_seed(0)).to(dev)
    strategy = cs._hybrid_init(torch, dev, pp_degree=2, sharding_degree=2)
    try:
        twin = LlamaForCausalLM(cfg, device=dev,
                                generator=torch.Generator().manual_seed(0))
        pipe, keys = cs._llama_pipe(torch, dev, cfg, 0, lambda o, l: (
            F.cross_entropy(o[:, :-1].reshape(-1, 256),
                            l[:, 1:].reshape(-1))))
        tsd = twin.state_dict()
        pipe.load_state_dict({k: tsd[keys[k]] for k in pipe.state_dict()})
        amp.decorate([twin, pipe], level="O2", dtype="bfloat16")
        model = fleet.distributed_model(pipe)
        opt = fleet.distributed_optimizer(AdamW(
            1e-3, parameters=pipe.parameters(), multi_precision=True),
            strategy)
        topt = AdamW(1e-3, parameters=twin.parameters(),
                     multi_precision=True)
        t_loss, t_grads = cs._twin_step(torch, twin, topt, ids, 4)
        cap = cs._GradCapture(opt, pipe, keys)
        tfa.reset_launch_count()
        tfn.reset_launch_count()
        collective.reset_counts()
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = float(model.train_batch([ids, ids], cap))
        torch.cuda.synchronize()
        assert (tfa.launch_count("fwd"), tfa.launch_count("bwd"),
                tfn.launch_count("rms_norm")) == (8, 8, 20)
        assert {k: (v["calls"], v["bytes"]) for k, v in
                collective.counts().items()} == cs.fleet_hybrid_expected(
            [(tuple(p.shape), 2) for p in pipe.parameters()], 2)
        assert loss == t_loss
        for n, g in t_grads.items():
            assert torch.equal(cap.grads[n], g), n
        got = cs._opt_masters(opt, pipe, keys)
        want = cs._opt_masters(topt, twin)
        for n, m in want.items():
            assert torch.equal(got[n], m), n
    finally:
        cs._hybrid_init(torch, dev)


def test_two_processes_all_reduce_on_the_card(tmp_path):
    """Phase 27 (a) on the card: two processes on cuda:0 over Gloo,
    spawned by the port's launcher; all_reduce of rank + 1 gives 3 and
    int32 stays int32, with every other eager collective, each checked
    exactly in the ranks (a rank exits non-zero on a wrong value)."""
    _need_cuda()
    import chip_smoke as cs
    rc, res, text = cs.mp_finish(cs.mp_start(
        dict(device="cuda", collectives=True), str(tmp_path), timeout=300))
    assert rc == 0, text[-4000:]
    for r in range(2):
        c = res[r, "collectives"]
        assert c["all_reduce"]["calls"] == 8, c
        assert c["all_reduce"]["bytes"] == 8 * 2 * 16, c


def test_paddle_ops_decoder_layer_on_the_card():
    """Phase 28 at a narrow width on the card (hidden 256, 2 heads of
    128, FFN 512, batch 2 x 256, bf16): (a) the decoder layer in Paddle
    ops on CUDA handles bitwise the torch-native LlamaDecoderLayer in
    output and every gradient, through the flash and RMSNorm kernels;
    (c) no host-device sync beyond the native layer's in a warm step;
    the launches of (b) and the op sweep of (d) as the phase checks
    them."""
    _need_cuda()
    import chip_smoke as cs
    cfg = dict(cs.FULL, paddle_ops=dict(hidden=256, heads=2, kv_heads=2,
                                        ffn=512, theta=10000.0, eps=1e-5,
                                        batch=2, seq=256))
    lines = []
    counts = cs.phase_paddle_ops(torch, torch.device("cuda"), cfg, 0,
                                 "[card]", lines.append)
    assert counts == cs.paddle_ops_expected()
    a = next(ln for ln in lines if "phase 28 (a)" in ln)
    assert "not bitwise: []" in a, a
    c = next(ln for ln in lines if "phase 28 (c)" in ln)
    assert "Paddle ops 0," in c, c
