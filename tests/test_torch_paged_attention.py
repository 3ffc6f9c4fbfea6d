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


@pytest.mark.parametrize("host_lens", [True, False])
@pytest.mark.parametrize("tile_q", [1, 5, 16])
def test_split_items_cover_each_visible_key_once(tile_q, host_lens):
    """The split-KV work list of a mixed step (prefill chunks, decode rows,
    a zero-length segment, a row at position 0, a row past the table):
    every (packed row, visible key position) lies in exactly one item of
    the row's tile, items start and end at absolute multiples of SPAN
    (or the tile's frontier), and the launch order is a permutation,
    heaviest (rows x keys) first."""
    span, bs, mb = tpa.SPAN, 16, 40
    width = bs * mb
    q_lens = (50, 1, 0, 128, 1, 3, 2)
    kv_lens = np.asarray([560, 610, 7, 384, 1, 260, 700], np.int32)
    plan = tpa.RaggedPlan(q_lens, kv_lens if host_lens else None)
    h = plan.split_host(tile_q, width)
    tiles, tspan, items = h["tiles"], h["tspan"], h["items"]
    np.testing.assert_array_equal(tiles, plan.tiles_host(tile_q))
    assert sorted(h["order"].tolist()) == list(range(items.shape[0]))
    # items of a tile are consecutive, span index = position in the run
    for t, (first, n) in enumerate(tspan):
        np.testing.assert_array_equal(items[first:first + n, 0], t)
        np.testing.assert_array_equal(items[first:first + n, 1],
                                      np.arange(n))
    assert tspan[:, 1].sum() == items.shape[0]
    starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    seen = 0
    for i in range(sum(q_lens)):
        t = h["row_tile"][i]
        s, off, n, r0 = tiles[t]
        assert r0 <= i < r0 + n and r0 == starts[s] + off
        qpos = int(kv_lens[s]) - q_lens[s] + (i - starts[s])
        visible = np.arange(min(qpos + 1, width))
        first, cnt = tspan[t]
        lo = items[first:first + cnt, 1] * span
        hi = np.minimum(lo + span, h["frontier"][t])
        assert (lo % span == 0).all() and (hi > lo).all()
        covered = ((visible[:, None] >= lo) & (visible[:, None] < hi)).sum(1)
        np.testing.assert_array_equal(covered, 1)
        seen += visible.size
    assert seen > 0
    rows_keys = [tiles[t, 2] * min(span, h["frontier"][t] - sp * span)
                 for t, sp in items[h["order"]]]
    assert all(a >= b for a, b in zip(rows_keys, rows_keys[1:]))
    if not host_lens:
        np.testing.assert_array_equal(h["frontier"], width)


@pytest.mark.parametrize("lens_as", ["numpy", "tensor"])
def test_plan_with_lengths_is_refused_for_other_lengths(lens_as):
    """A plan built with host kv_lens sizes its split-KV items from them,
    so it serves one step only: a call whose host lengths differ (a
    decode step later) raises instead of leaving the newest keys past
    the last span; the same lengths, and a plan built without lengths,
    are taken."""
    q_lens, kv_lens = (1, 3), (130, 9)
    q, pool, bt, lens = _case(5, 4, 4, 16, 4, q_lens, kv_lens, 40)
    q, pool = torch.from_numpy(q), torch.from_numpy(pool)
    as_arg = (lambda a: a) if lens_as == "numpy" else torch.from_numpy
    plan = tpa.RaggedPlan(q_lens, lens)
    want = tpa.paged_attention_ragged_reference(q, pool, bt, q_lens, lens)
    got = tpa.paged_attention_ragged(q, pool, bt, q_lens, as_arg(lens),
                                     plan=plan)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="other kv_lens"):
        tpa.paged_attention_ragged(q, pool, bt, q_lens, as_arg(lens + 1),
                                   plan=plan)
    tpa.paged_attention_ragged(q, pool, bt, q_lens, as_arg(lens + 1),
                               plan=tpa.RaggedPlan(q_lens))


class _RecordingLib:
    """Stands in for a kernel library on the CPU: records the arguments of
    each ``pt_paged_attention_split`` call and reports success."""

    def __init__(self, max_rows):
        self.calls = []
        self.pt_paged_attention_max_rows = lambda hd: max_rows
        self.pt_paged_attention_split = lambda *a: self.calls.append(a) or 0


@pytest.mark.parametrize("host_lens", [True, False])
def test_int8_pool_launches_from_the_split_work_list(host_lens):
    """The int8 pool goes through the float pool's launch path: the same
    plan, the same packed work list (split_tables) and workspace, with
    only the pool pointer and its scales added."""
    q_lens, kv_lens = (20, 1, 0, 3), (300, 700, 5, 130)
    q, pool, bt, lens = _case(6, 8, 2, 16, 16, q_lens, kv_lens, 44)
    q, pool = torch.from_numpy(q), torch.from_numpy(pool)
    qpool = torch.zeros(pool.shape, dtype=torch.int8)
    scales = torch.ones(pool.shape[:4])
    btt, lt = torch.from_numpy(bt), torch.from_numpy(lens)
    plan = tpa.RaggedPlan(q_lens, lens if host_lens else None)
    got = {}
    for name, p, sc in (("float", pool, None), ("int8", qpool, scales)):
        lib = _RecordingLib(max_rows=128)
        out = tpa._launch(lib, q, p, sc, btt, lt, q_lens,
                          lens if host_lens else None, plan, None, 0.25, 0)
        assert out.shape == q.shape and len(lib.calls) == 1
        got[name] = lib.calls[0]
    f, i = got["float"], got["int8"]
    # argument 4: the pool, 5: its scales (null for a float pool)
    assert f[4] == pool.data_ptr() and i[4] == qpool.data_ptr()
    assert f[5] is None and i[5] == scales.data_ptr()
    # every other argument alike but the workspace and output pointers
    # (13, 14): the tables tensor of the plan's cache (10), its tile and
    # item counts, the shapes and the tile rows
    assert f[:4] == i[:4] and f[6:13] == i[6:13] and f[15:] == i[15:]
    tile_q = min(tpa.DEFAULT_TILE_Q_CAP, max(q_lens))
    tables, n_tiles, n_items, _ = plan.split_tables(tile_q, 44 * 16, "cpu")
    assert f[10] == tables.data_ptr() and (f[11], f[12]) == (n_tiles,
                                                             n_items)
    h = plan.split_host(tile_q, 44 * 16)
    assert n_items == h["items"].shape[0] and n_tiles == h["tiles"].shape[0]
