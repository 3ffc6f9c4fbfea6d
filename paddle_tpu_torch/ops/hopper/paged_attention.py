"""ONE ragged paged-attention kernel over a block-paged KV cache, for
Hopper — the counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``.

K/V live in a shared pool of fixed-size blocks
``[num_blocks, 2, nkv, block_size, hd]``; each sequence owns an int32
block-table row. ``paged_attention_ragged`` scores a PACKED mixed batch
``q [R, nh, hd]`` (prefill chunks, decode rows and verify rows back to
back): query i of sequence s sits at position
``kv_lens[s] - q_lens[s] + i`` and attends causally over s's pages, whose
K/V — the new rows included — must already sit in the pool. The three
phase entry points (``paged_attention``, ``paged_attention_multi``,
``paged_attention_prefill``) are thin wrappers over it.

Dispatch: a CUDA tensor launches the hand-written kernel in
``csrc/paged_attention.cu`` — ``csrc/paged_attention_int8.cu`` for an int8
pool with ``kv_scales``, the same split-KV body over int8 pages — or
raises; a CPU tensor takes the plain PyTorch version
``paged_attention_ragged_reference``. The CUDA path never falls back.

Host descriptors: each sequence's rows are cut into tiles of ``tile_q``
rows; a ``RaggedPlan`` holds, per tile, (sequence, query offset, real
rows, first packed row), and cuts each tile's visible keys into split-KV
work items of ``SPAN`` absolute key positions, heaviest first; the
kernel merges a row's items in span order. Float and int8 pools launch
from the same work list. The positions follow on the device from ``kv_lens``, so a
serving step builds one plan and every layer's launch reuses it
(``PagedRaggedView`` in inference/paged_cache.py). The kernel writes
straight into the packed output — the Pallas path's pad/unpad gathers
do not exist here.

Int8 pools (``kv_scales=``, the JAX module's quantized path): the pool
holds int8 payload and ``kv_scales`` ``[num_blocks, 2, nkv, block_size]``
float32 holds one scale per (block, K|V, kv head, position); the kernel
dequantizes staged elements where it reads them, the plain version in
``gather_pages``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

NEG_INF = -1e30

# default query-tile cap: decode segments are 1-row tiles, prefill chunks
# cut into tiles of up to this many rows. The Pallas module caps at 64
# (wide tiles amortise each page DMA on the TPU's sequential grid); on
# the H100 a prefill tile is bound by CUDA-core arithmetic, and narrower
# tiles put more blocks on the 132 SMs (chip_smoke.py times both)
DEFAULT_TILE_Q_CAP = 16
# key positions per split-KV work item (kSpan of csrc/ragged_split.cuh):
# spans start at absolute multiples of it
SPAN = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launch count of the CUDA kernel (CPU calls run the plain version and
# are not counted)
_LAUNCHES = {"count": 0}
# the libraries once loaded and checked (``_lib``), by source name
_LIBS: Dict[str, ctypes.CDLL] = {}


def launch_count() -> int:
    return _LAUNCHES["count"]


def reset_launch_count() -> None:
    _LAUNCHES["count"] = 0


class RaggedPlan:
    """Host-built descriptors of one packed batch, uploaded once per
    device and shared by every launch over the same batch.

    ``tiles_host`` cuts each sequence's rows into query tiles (a function
    of the static ``q_lens`` and the tile width only). ``split_host`` cuts
    each tile's visible keys into work items of ``SPAN`` absolute key
    positions for the split-KV kernel (any pool type); it sizes them from
    the host ``kv_lens`` when the plan was built with them (the serving
    path has them before it copies them to the card), else from the table
    width, whose surplus items exit at once on the card. A plan built with
    ``kv_lens`` is for one step only: it serves launches over those
    lengths, and ``paged_attention_ragged`` refuses it where the call's
    lengths are on the host and differ (lengths on the card are not
    read back to check)."""

    def __init__(self, q_lens, kv_lens=None):
        self.q_lens = tuple(int(x) for x in q_lens)
        self.kv_lens = None if kv_lens is None else \
            np.asarray(kv_lens, np.int64).reshape(-1)
        if self.kv_lens is not None and \
                self.kv_lens.shape[0] != len(self.q_lens):
            raise ValueError("kv_lens needs one entry per sequence")
        self._dev: Dict[tuple, tuple] = {}

    def tiles_host(self, tile_q: int) -> np.ndarray:
        """[T, 4] int32: (sequence, query offset, real rows, first row)."""
        out = []
        r0 = 0
        for s, ql in enumerate(self.q_lens):
            for off in range(0, ql, tile_q):
                out.append((s, off, min(tile_q, ql - off), r0 + off))
            r0 += ql
        return np.asarray(out, np.int32).reshape(-1, 4)

    def split_host(self, tile_q: int, width: int) -> Dict[str, np.ndarray]:
        """The split-KV work list for tables ``width`` (= MB x block_size)
        positions wide, int32:

        - ``tiles`` [T, 4] as ``tiles_host``;
        - ``frontier`` [T]: keys [0, frontier) the tile sees (its last
          row's position + 1, within the table), the table width where
          the lengths are not on the host;
        - ``tspan`` [T, 2]: (first item, items) of each tile, items of a
          tile consecutive, span s covering [s SPAN, (s + 1) SPAN);
        - ``items`` [I, 2]: (tile, span);
        - ``order`` [I]: the launch order, heaviest (rows x keys) first;
        - ``row_tile`` [R]: the tile of each packed row."""
        tiles = self.tiles_host(tile_q)
        T = tiles.shape[0]
        if self.kv_lens is None:
            frontier = np.full(T, width, np.int64)
        else:
            ql = np.asarray(self.q_lens, np.int64)
            seq = tiles[:, 0]
            frontier = np.clip(self.kv_lens[seq] - ql[seq] + tiles[:, 1]
                               + tiles[:, 2], 0, width)
        nsp = -(-frontier // SPAN)
        first = np.concatenate([[0], np.cumsum(nsp)[:-1]]).astype(np.int64)
        tile_of = np.repeat(np.arange(T), nsp)
        sp = np.arange(tile_of.shape[0]) - first[tile_of]
        keys = np.minimum(SPAN, frontier[tile_of] - sp * SPAN)
        order = np.argsort(-(tiles[tile_of, 2].astype(np.int64) * keys),
                           kind="stable")
        row_tile = np.repeat(np.arange(T), tiles[:, 2])
        i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
        return dict(tiles=tiles, frontier=i32(frontier),
                    tspan=i32(np.stack([first, nsp], 1).reshape(-1, 2)),
                    items=i32(np.stack([tile_of, sp], 1).reshape(-1, 2)),
                    order=i32(order), row_tile=i32(row_tile))

    def split_tables(self, tile_q: int, width: int, device):
        """(packed tables, tiles, items, q_lens) on ``device``, one int32
        tensor (one copy to the card a batch): each launched block's item
        in launch order, (slot, sequence, query offset, rows, first packed
        row, span, 0, 0); then tiles, tspan and row_tile of
        ``split_host``."""
        key = (int(tile_q), str(device), int(width))
        got = self._dev.get(key)
        if got is None:
            h = self.split_host(tile_q, width)
            item = h["order"]
            tile, span = h["items"][item, 0], h["items"][item, 1]
            tl = h["tiles"][tile]
            zero = np.zeros_like(item)
            launch = np.stack([item, tl[:, 0], tl[:, 1], tl[:, 2], tl[:, 3],
                               span, zero, zero], 1).astype(np.int32)
            packed = np.concatenate([launch.reshape(-1)] + [
                h[k].reshape(-1) for k in ("tiles", "tspan", "row_tile")])
            got = self._dev[key] = (
                torch.from_numpy(packed).to(device), h["tiles"].shape[0],
                h["items"].shape[0],
                torch.tensor(self.q_lens, dtype=torch.int32, device=device))
        return got


def _lib(quant: bool) -> ctypes.CDLL:
    """The float-pool or int8-pool library, its kSpan checked against
    SPAN at first load (the host plan and the kernel must cut spans
    alike)."""
    name = "paged_attention_int8" if quant else "paged_attention"
    lib = _LIBS.get(name)
    if lib is None:
        from ._build import load
        lib = load(name)
        if lib.pt_paged_attention_span() != SPAN:
            raise RuntimeError(f"csrc/{name}.cu's kSpan is not "
                               f"SPAN = {SPAN}")
        ci = ctypes.c_int
        lib.pt_paged_attention_max_rows.restype = ci
        lib.pt_paged_attention_max_rows.argtypes = [ci]
        fn = lib.pt_paged_attention_split
        fn.restype = ci
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [ci, vp, ll, ll, vp, vp, vp, ci, vp, vp, vp, ci, ci,
                       vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
        _LIBS[name] = lib
    return lib


def rows_vectorizable(t: torch.Tensor, strides) -> bool:
    """Whether the decode kernel may read ``t``'s head_dim vectors four
    elements at a time: head_dim a multiple of 4, the given strides too,
    and the base aligned to four elements (16 bytes for float32, 8 for
    bfloat16)."""
    align = 4 * t.element_size()
    return t.shape[-1] % 4 == 0 and t.data_ptr() % align == 0 and \
        all(s % 4 == 0 for s in strides)


def _as_int32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def paged_attention_ragged(q, kv_pool, block_tables, q_lens, kv_lens,
                           sm_scale: Optional[float] = None,
                           tile_q: Optional[int] = None,
                           plan: Optional[RaggedPlan] = None,
                           kv_scales: Optional[torch.Tensor] = None):
    """THE kernel: one launch scores a mixed prefill+decode+verify batch.
    q: [R, nh, hd] packed rows (R == sum(q_lens)); kv_pool:
    [num_blocks, 2, nkv, bs, hd]; block_tables: int32 [n_seq, MB]
    (entries past an allocation point at a valid block, e.g. the trash
    block 0); q_lens: static per-sequence row counts; kv_lens: int32
    [n_seq] valid lengths INCLUDING each sequence's new rows. ``plan``
    (a ``RaggedPlan`` of the same q_lens, and of these kv_lens if it was
    built with lengths; ValueError where host lengths differ) lets
    callers share the descriptors across launches. ``kv_scales`` [num_blocks, 2, nkv, bs] float32 comes with
    an int8 pool. Returns [R, nh, hd]."""
    q_lens = tuple(int(x) for x in q_lens)
    R, nh, hd = q.shape
    if R != sum(q_lens):
        raise ValueError(f"packed q has {R} rows, q_lens sum to "
                         f"{sum(q_lens)}")
    if R == 0:
        return q
    nkv = kv_pool.shape[2]
    if nh % nkv:
        raise ValueError(f"query heads {nh} are not a multiple of the "
                         f"pool's kv heads {nkv}")
    quant = kv_pool.dtype == torch.int8
    if quant != (kv_scales is not None):
        raise ValueError("an int8 pool needs kv_scales, and kv_scales "
                         "need an int8 pool")
    if quant and tuple(kv_scales.shape) != tuple(kv_pool.shape[:4]):
        raise ValueError(f"kv_scales must be {tuple(kv_pool.shape[:4])}, "
                         f"got {tuple(kv_scales.shape)}")
    # lengths already on the host size the split-KV work items and hold
    # a plan built with lengths to them; lengths on the card are never
    # read back
    if isinstance(kv_lens, torch.Tensor):
        host_lens = None if kv_lens.is_cuda else kv_lens.numpy()
    else:
        host_lens = np.asarray(kv_lens)
    if plan is not None and plan.q_lens == q_lens and \
            plan.kv_lens is not None and host_lens is not None and \
            not np.array_equal(plan.kv_lens, host_lens.reshape(-1)):
        raise ValueError("plan was built for other kv_lens: a plan with "
                         "lengths serves one step only")
    if not q.is_cuda:
        return paged_attention_ragged_reference(
            q, kv_pool, block_tables, q_lens, kv_lens, sm_scale=sm_scale,
            kv_scales=kv_scales)
    dev = q.device
    if kv_pool.device != dev or (quant and kv_scales.device != dev):
        raise ValueError("q, kv_pool and kv_scales must be on the same "
                         "device")
    if q.dtype not in _DTYPES or (not quant and kv_pool.dtype != q.dtype):
        raise TypeError(f"kernel takes float32/bfloat16 q over a pool of "
                        f"the same dtype or an int8 pool, got {q.dtype} / "
                        f"{kv_pool.dtype}")
    if quant and (kv_scales.dtype != torch.float32 or
                  not kv_scales.is_contiguous()):
        raise TypeError("kv_scales must be contiguous float32")
    if q.stride(2) != 1:
        raise ValueError("q's head_dim axis must be contiguous")
    if not kv_pool.is_contiguous():
        raise ValueError("kv_pool must be contiguous")
    bt = _as_int32(block_tables, dev).contiguous()
    if bt.dim() != 2 or bt.shape[0] != len(q_lens):
        raise ValueError(f"block_tables must be [{len(q_lens)}, MB], got "
                         f"{tuple(bt.shape)}")
    lens = _as_int32(kv_lens, dev).reshape(-1).contiguous()
    if lens.shape[0] != len(q_lens):
        raise ValueError("kv_lens needs one entry per sequence")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    lib = _lib(quant)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = _launch(lib, q, kv_pool, kv_scales, bt, lens, q_lens,
                      host_lens, plan, tile_q, scale, stream)
    _LAUNCHES["count"] += 1
    return out


def _launch(lib, q, kv_pool, kv_scales, bt, lens, q_lens, host_lens, plan,
            tile_q, scale, stream):
    """One launch of ``lib``'s split-KV kernel, for either pool type: the
    tile width, the plan's work list on q's device, the partials'
    workspace and the output (returned). bt, lens: int32 on q's device;
    host_lens: the lengths on the host, or None."""
    R, nh, hd = q.shape
    nkv, bs = kv_pool.shape[2], kv_pool.shape[3]
    g = nh // nkv
    # query rows (tile rows x group) one block holds in shared memory
    max_rows = lib.pt_paged_attention_max_rows(hd)
    if max_rows < g:
        raise ValueError(f"head_dim {hd} with GQA group {g} does not fit "
                         f"one block (head_dim <= 256)")
    if tile_q is None:
        tile_q = min(DEFAULT_TILE_Q_CAP, max(q_lens))
    tile_q = max(1, min(int(tile_q), max_rows // g))
    if plan is None or plan.q_lens != q_lens:
        plan = RaggedPlan(q_lens, host_lens)
    tables, n_tiles, n_items, qlens_dev = plan.split_tables(
        tile_q, bt.shape[1] * bs, q.device)
    # each item's partial (acc [max_rows, hd], then m, l)
    ws = torch.empty(nkv * n_items * tile_q * g * (hd + 2),
                     dtype=torch.float32, device=q.device)
    out = torch.empty((R, nh, hd), dtype=q.dtype, device=q.device)
    from ._build import check
    err = lib.pt_paged_attention_split(
        _DTYPES[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
        kv_pool.data_ptr(),
        None if kv_scales is None else kv_scales.data_ptr(), bt.data_ptr(),
        bt.shape[1], qlens_dev.data_ptr(), lens.data_ptr(),
        tables.data_ptr(), n_tiles, n_items, ws.data_ptr(), out.data_ptr(),
        R, nh, nkv, hd, bs, tile_q * g, float(scale), stream)
    check(err, "paged_attention_ragged")
    return out


# --- the three phase entry points: thin wrappers over the ragged path -

def paged_attention(q, kv_pool, block_tables, seq_lens, sm_scale=None,
                    kv_scales=None):
    """Decode: q [B, nh, hd], one query per sequence at seq_lens - 1."""
    return paged_attention_ragged(q, kv_pool, block_tables,
                                  (1,) * q.shape[0], seq_lens,
                                  sm_scale=sm_scale, tile_q=1,
                                  kv_scales=kv_scales)


def paged_attention_multi(q, kv_pool, block_tables, seq_lens,
                          sm_scale=None, kv_scales=None):
    """Multi-query verify: q [B, n_q, nh, hd], query i of row b at
    seq_lens[b] - n_q + i (seq_lens include the n_q new tokens)."""
    B, n_q, nh, hd = q.shape
    out = paged_attention_ragged(q.reshape(B * n_q, nh, hd), kv_pool,
                                 block_tables, (n_q,) * B, seq_lens,
                                 sm_scale=sm_scale, tile_q=n_q,
                                 kv_scales=kv_scales)
    return out.reshape(B, n_q, nh, hd)


def paged_attention_prefill(q, kv_pool, block_tables, start_pos,
                            sm_scale=None, tile_q=None, kv_scales=None):
    """Chunked prefill: q [B, C, nh, hd], query i of row b at
    start_pos[b] + i; tiles of min(C, DEFAULT_TILE_Q_CAP) rows by
    default."""
    B, C, nh, hd = q.shape
    if tile_q is None:
        tile_q = min(C, DEFAULT_TILE_Q_CAP)
    lens = _as_int32(start_pos, q.device).reshape(-1) + C
    out = paged_attention_ragged(q.reshape(B * C, nh, hd), kv_pool,
                                 block_tables, (C,) * B, lens,
                                 sm_scale=sm_scale, tile_q=tile_q,
                                 kv_scales=kv_scales)
    return out.reshape(B, C, nh, hd)


# --- the plain version -------------------------------------------------

def gather_pages(kv_pool, block_tables, kv_scales=None):
    """Materialize the block-table indirection as dense K/V: returns
    (k, v) each [B, MB * bs, nkv, hd] (the decode_attention layout).
    Positions past a sequence's length hold whatever its pages hold.
    ``kv_scales`` (int8 pools) dequantizes the gathered pages to
    float32."""
    bt = torch.as_tensor(block_tables, device=kv_pool.device).long()
    pages = kv_pool[bt]                    # [B, MB, 2, nkv, bs, hd]
    if kv_scales is not None:
        pages = pages.float() * kv_scales[bt][..., None]
    k = pages[:, :, 0].transpose(2, 3)     # [B, MB, bs, nkv, hd]
    v = pages[:, :, 1].transpose(2, 3)
    B, MB, bs, nkv, hd = k.shape
    return (k.reshape(B, MB * bs, nkv, hd), v.reshape(B, MB * bs, nkv, hd))


def paged_attention_ragged_reference(q, kv_pool, block_tables, q_lens,
                                     kv_lens, sm_scale=None,
                                     kv_scales=None):
    """Plain PyTorch ragged attention (the Pallas module's
    ``paged_attention_ragged_reference``): gather pages dense
    (dequantizing int8 pages through ``kv_scales``), then a masked fp32
    softmax per sequence with query i at kv_lens[s] - q_lens[s] + i.
    Rows with no valid key give zeros."""
    q_lens = tuple(int(x) for x in q_lens)
    R, nh, hd = q.shape
    if R == 0:
        return q
    nkv = kv_pool.shape[2]
    g = nh // nkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    k, v = gather_pages(kv_pool, block_tables,
                        kv_scales=kv_scales)     # [n_seq, S, nkv, hd]
    S = k.shape[1]
    k = k.repeat_interleave(g, dim=2).float()
    v = v.repeat_interleave(g, dim=2).float()
    lens = torch.as_tensor(kv_lens, device=q.device).long().reshape(-1)
    kpos = torch.arange(S, device=q.device)[None, None, :]
    outs, r0 = [], 0
    for s, ql in enumerate(q_lens):
        if ql == 0:
            continue
        qs = q[r0:r0 + ql].float()                # [ql, nh, hd]
        scores = torch.einsum("qhd,shd->hqs", qs, k[s]) * scale
        qpos = (lens[s] - ql) + torch.arange(ql, device=q.device)[
            None, :, None]
        valid = kpos <= qpos
        p = torch.softmax(scores.masked_fill(~valid, NEG_INF), dim=-1)
        p = p * (valid & (qpos >= 0))
        outs.append(torch.einsum("hqs,shd->qhd", p, v[s]).to(q.dtype))
        r0 += ql
    return torch.cat(outs, dim=0)
