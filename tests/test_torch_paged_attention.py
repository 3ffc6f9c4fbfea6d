"""The PyTorch port's ragged paged attention
(paddle_tpu_torch/ops/hopper/paged_attention.py) held against the JAX
package's Pallas kernel, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it. Inputs come from numpy with a
seed and go through both packages; float32, atol = rtol = 1e-5 (the two
reduce in different orders). The CUDA kernel itself is checked against
the plain version by the ``cuda``-marked test, which needs the card."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.hopper import paged_attention as tpa

# the pallas package re-exports the function under the module's name
jpa = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, nh, nkv, hd, bs, q_lens, kv_lens, MB, trash_rows=()):
    """Pool, block tables (distinct pages per sequence, trash past the
    allocation; ``trash_rows`` get all-trash tables) and packed q."""
    rng = np.random.RandomState(seed)
    need = [-(-int(L) // bs) for L in kv_lens]
    NB = 1 + sum(need) + 2
    pool = rng.randn(NB, 2, nkv, bs, hd).astype(np.float32)
    bt = np.zeros((len(q_lens), MB), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    k = 0
    for s, n in enumerate(need):
        if s in trash_rows:
            continue
        bt[s, :n] = perm[k:k + n]
        k += n
    q = rng.randn(sum(q_lens), nh, hd).astype(np.float32)
    return q, pool, bt, np.asarray(kv_lens, np.int32)


CASES = {
    # name: (nh, nkv, hd, bs, q_lens, kv_lens, MB, trash_rows, tile_q)
    "decode": (4, 4, 16, 4, (1, 1, 1), (5, 16, 33), 9, (), None),
    "verify": (4, 4, 16, 4, (4, 4), (9, 20), 6, (), None),
    "prefill_chunk": (4, 4, 16, 4, (6,), (22,), 6, (), None),
    "mixed_zero_len_and_trash": (4, 4, 16, 4, (1, 6, 0, 1, 3),
                                 (1, 14, 4, 9, 3), 4, (0,), None),
    "gqa": (8, 2, 16, 8, (1, 5, 2), (12, 5, 17), 3, (), None),
    "partial_tail_tile": (4, 4, 16, 4, (1, 5, 1), (7, 11, 3), 3, (), 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_kernel(name):
    nh, nkv, hd, bs, q_lens, kv_lens, MB, trash, tile_q = CASES[name]
    q, pool, bt, lens = _case(1, nh, nkv, hd, bs, q_lens, kv_lens, MB,
                              trash)
    ref = np.asarray(jpa.paged_attention_ragged(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt), q_lens,
        jnp.asarray(lens), tile_q=tile_q))
    got = tpa.paged_attention_ragged(
        torch.from_numpy(q), torch.from_numpy(pool), bt, q_lens, lens,
        tile_q=tile_q).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.isfinite(got).all()
    r0 = sum(q_lens[:2])
    if name == "mixed_zero_len_and_trash":
        # the trash-table row at t = 0 stays finite and matches
        np.testing.assert_allclose(got[0], ref[0], **TOL)
        assert got[r0:r0].size == 0


def test_phase_wrappers_match_pallas():
    q, pool, bt, lens = _case(2, 4, 4, 16, 4, (3, 3), (7, 12), 4)
    jq, jp, jb = jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt)
    tq, tp = torch.from_numpy(q), torch.from_numpy(pool)
    # decode: one row per sequence
    np.testing.assert_allclose(
        tpa.paged_attention(tq[:2], tp, bt, lens).numpy(),
        np.asarray(jpa.paged_attention(jq[:2], jp, jb,
                                       jnp.asarray(lens))), **TOL)
    # verify: 3 rows per sequence
    np.testing.assert_allclose(
        tpa.paged_attention_multi(tq.reshape(2, 3, 4, 16), tp, bt,
                                  lens).numpy(),
        np.asarray(jpa.paged_attention_multi(
            jq.reshape(2, 3, 4, 16), jp, jb, jnp.asarray(lens))), **TOL)
    # prefill: chunk of 3 at start positions
    start = np.asarray([2, 9], np.int32)
    np.testing.assert_allclose(
        tpa.paged_attention_prefill(tq.reshape(2, 3, 4, 16), tp, bt,
                                    start).numpy(),
        np.asarray(jpa.paged_attention_prefill(
            jq.reshape(2, 3, 4, 16), jp, jb, jnp.asarray(start))), **TOL)


def test_gather_pages_is_exact():
    q, pool, bt, lens = _case(3, 4, 2, 16, 4, (1, 1), (9, 5), 3)
    jk, jv = jpa.gather_pages(jnp.asarray(pool), jnp.asarray(bt))
    tk, tv = tpa.gather_pages(torch.from_numpy(pool), bt)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tile_q", [1, 2, 4, 64])
def test_tile_descriptors_match_pallas_layout(tile_q):
    q_lens = (1, 5, 0, 3, 8)
    tiles = tpa.RaggedPlan(q_lens).tiles_host(tile_q)
    tile_seq, tile_off, tile_n, _, out_idx = jpa._tile_layout(q_lens,
                                                              tile_q)
    np.testing.assert_array_equal(tiles[:, 0], tile_seq)
    np.testing.assert_array_equal(tiles[:, 1], tile_off)
    np.testing.assert_array_equal(tiles[:, 2], tile_n)
    # first packed row of each tile == the Pallas unpad map's source row
    starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    np.testing.assert_array_equal(tiles[:, 3], starts[tile_seq] + tile_off)
    assert out_idx.shape[0] == sum(q_lens)


def test_empty_batch_is_no_launch():
    q = torch.zeros((0, 4, 16))
    pool = torch.zeros((3, 2, 4, 4, 16))
    before = tpa.launch_count()
    out = tpa.paged_attention_ragged(q, pool, np.zeros((2, 1), np.int32),
                                     (0, 0), [0, 0])
    assert out.shape == (0, 4, 16) and tpa.launch_count() == before
