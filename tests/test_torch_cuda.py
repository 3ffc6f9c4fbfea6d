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

from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.inference import SpeculativeEngine, TokenServingModel
from paddle_tpu_torch.ops.hopper import decode_attention as tda
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
