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
``csrc/paged_attention.cu`` (or raises); a CPU tensor takes the plain
PyTorch version ``paged_attention_ragged_reference``. The CUDA path never
falls back.

Host descriptors: each sequence's rows are cut into tiles of ``tile_q``
rows; a ``RaggedPlan`` holds, per tile, (sequence, query offset, real
rows, first packed row) as one int32 device table. The positions follow
on the device from ``kv_lens``, so a serving step builds one plan and
every layer's launch reuses it (``PagedRaggedView`` in
inference/paged_cache.py). The kernel writes straight into the packed
output — the Pallas path's pad/unpad gathers do not exist here.

Only float pools (float32, bfloat16) are in this slice; the int8
``kv_scales`` path of the Pallas kernel waits for a later one.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30

# default query-tile cap: decode segments are 1-row tiles, prefill chunks
# cut into tiles of up to this many rows. The Pallas module caps at 64
# (wide tiles amortise each page DMA on the TPU's sequential grid); on
# the H100 a prefill tile is bound by CUDA-core arithmetic, and narrower
# tiles put more blocks on the 132 SMs (chip_smoke.py times both)
DEFAULT_TILE_Q_CAP = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launch count of the CUDA kernel (CPU calls run the plain version and
# are not counted)
_LAUNCHES = {"count": 0}


def launch_count() -> int:
    return _LAUNCHES["count"]


def reset_launch_count() -> None:
    _LAUNCHES["count"] = 0


class RaggedPlan:
    """Host-built tile descriptors of one packed batch (a function of the
    static ``q_lens`` and the tile width only), uploaded once per device
    and tile width and shared by every launch over the same batch."""

    def __init__(self, q_lens):
        self.q_lens = tuple(int(x) for x in q_lens)
        self._dev: Dict[Tuple[int, str], Tuple[torch.Tensor,
                                               torch.Tensor]] = {}

    def tiles_host(self, tile_q: int) -> np.ndarray:
        """[T, 4] int32: (sequence, query offset, real rows, first row)."""
        out = []
        r0 = 0
        for s, ql in enumerate(self.q_lens):
            for off in range(0, ql, tile_q):
                out.append((s, off, min(tile_q, ql - off), r0 + off))
            r0 += ql
        return np.asarray(out, np.int32).reshape(-1, 4)

    def device_tables(self, tile_q: int, device) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
        key = (int(tile_q), str(device))
        got = self._dev.get(key)
        if got is None:
            tiles = torch.from_numpy(self.tiles_host(tile_q)).to(device)
            qlens = torch.tensor(self.q_lens, dtype=torch.int32,
                                 device=device)
            got = self._dev[key] = (tiles, qlens)
        return got


def rows_vectorizable(t: torch.Tensor, strides) -> bool:
    """Whether the kernels may read ``t``'s head_dim vectors four
    elements at a time: head_dim a multiple of 4, the given strides too,
    and the base aligned to four elements."""
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
                           plan: Optional[RaggedPlan] = None):
    """THE kernel: one launch scores a mixed prefill+decode+verify batch.
    q: [R, nh, hd] packed rows (R == sum(q_lens)); kv_pool:
    [num_blocks, 2, nkv, bs, hd]; block_tables: int32 [n_seq, MB]
    (entries past an allocation point at a valid block, e.g. the trash
    block 0); q_lens: static per-sequence row counts; kv_lens: int32
    [n_seq] valid lengths INCLUDING each sequence's new rows. ``plan``
    (a ``RaggedPlan`` of the same q_lens) lets callers share the tile
    descriptors across launches. Returns [R, nh, hd]."""
    q_lens = tuple(int(x) for x in q_lens)
    R, nh, hd = q.shape
    if R != sum(q_lens):
        raise ValueError(f"packed q has {R} rows, q_lens sum to "
                         f"{sum(q_lens)}")
    if R == 0:
        return q
    nkv, bs = kv_pool.shape[2], kv_pool.shape[3]
    if nh % nkv:
        raise ValueError(f"query heads {nh} are not a multiple of the "
                         f"pool's kv heads {nkv}")
    if not q.is_cuda:
        return paged_attention_ragged_reference(
            q, kv_pool, block_tables, q_lens, kv_lens, sm_scale=sm_scale)
    g = nh // nkv
    dev = q.device
    if kv_pool.device != dev:
        raise ValueError("q and kv_pool must be on the same device")
    if q.dtype not in _DTYPES or kv_pool.dtype != q.dtype:
        raise TypeError(f"kernel takes float32/bfloat16 q and a pool of "
                        f"the same dtype, got {q.dtype} / {kv_pool.dtype}")
    if q.stride(2) != 1:
        raise ValueError("q's head_dim axis must be contiguous")
    if not kv_pool.is_contiguous():
        raise ValueError("kv_pool must be contiguous")
    from ._build import check, load
    lib = load("paged_attention")
    # query rows (tile rows x group) one block holds in shared memory
    max_rows = lib.pt_paged_attention_max_rows(hd)
    if max_rows < g:
        raise ValueError(f"head_dim {hd} with GQA group {g} does not fit "
                         f"one block (head_dim <= 256)")
    bt = _as_int32(block_tables, dev).contiguous()
    if bt.dim() != 2 or bt.shape[0] != len(q_lens):
        raise ValueError(f"block_tables must be [{len(q_lens)}, MB], got "
                         f"{tuple(bt.shape)}")
    lens = _as_int32(kv_lens, dev).reshape(-1).contiguous()
    if lens.shape[0] != len(q_lens):
        raise ValueError("kv_lens needs one entry per sequence")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    if tile_q is None:
        tile_q = min(DEFAULT_TILE_Q_CAP, max(q_lens))
    tile_q = max(1, min(int(tile_q), max_rows // g))
    if plan is None or plan.q_lens != q_lens:
        plan = RaggedPlan(q_lens)
    tiles, qlens_dev = plan.device_tables(tile_q, dev)
    out = torch.empty((R, nh, hd), dtype=q.dtype, device=dev)
    fn = lib.pt_paged_attention_ragged
    fn.restype = ctypes.c_int
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ci, vp, ll, ll, vp, vp, ci, vp, vp, vp, ci, vp, ci, ci,
                   ci, ci, ci, ctypes.c_float, ci, vp]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
                 kv_pool.data_ptr(), bt.data_ptr(), bt.shape[1],
                 qlens_dev.data_ptr(), lens.data_ptr(), tiles.data_ptr(),
                 tiles.shape[0], out.data_ptr(), nh, nkv, hd, bs,
                 tile_q * g, float(scale),
                 int(rows_vectorizable(kv_pool, ())), stream)
    check(err, "paged_attention_ragged")
    _LAUNCHES["count"] += 1
    return out


# --- the three phase entry points: thin wrappers over the ragged path -

def paged_attention(q, kv_pool, block_tables, seq_lens, sm_scale=None):
    """Decode: q [B, nh, hd], one query per sequence at seq_lens - 1."""
    return paged_attention_ragged(q, kv_pool, block_tables,
                                  (1,) * q.shape[0], seq_lens,
                                  sm_scale=sm_scale, tile_q=1)


def paged_attention_multi(q, kv_pool, block_tables, seq_lens,
                          sm_scale=None):
    """Multi-query verify: q [B, n_q, nh, hd], query i of row b at
    seq_lens[b] - n_q + i (seq_lens include the n_q new tokens)."""
    B, n_q, nh, hd = q.shape
    out = paged_attention_ragged(q.reshape(B * n_q, nh, hd), kv_pool,
                                 block_tables, (n_q,) * B, seq_lens,
                                 sm_scale=sm_scale, tile_q=n_q)
    return out.reshape(B, n_q, nh, hd)


def paged_attention_prefill(q, kv_pool, block_tables, start_pos,
                            sm_scale=None, tile_q=None):
    """Chunked prefill: q [B, C, nh, hd], query i of row b at
    start_pos[b] + i; tiles of min(C, DEFAULT_TILE_Q_CAP) rows by
    default."""
    B, C, nh, hd = q.shape
    if tile_q is None:
        tile_q = min(C, DEFAULT_TILE_Q_CAP)
    lens = _as_int32(start_pos, q.device).reshape(-1) + C
    out = paged_attention_ragged(q.reshape(B * C, nh, hd), kv_pool,
                                 block_tables, (C,) * B, lens,
                                 sm_scale=sm_scale, tile_q=tile_q)
    return out.reshape(B, C, nh, hd)


# --- the plain version -------------------------------------------------

def gather_pages(kv_pool, block_tables):
    """Materialize the block-table indirection as dense K/V: returns
    (k, v) each [B, MB * bs, nkv, hd] (the decode_attention layout).
    Positions past a sequence's length hold whatever its pages hold."""
    bt = torch.as_tensor(block_tables, device=kv_pool.device).long()
    pages = kv_pool[bt]                    # [B, MB, 2, nkv, bs, hd]
    k = pages[:, :, 0].transpose(2, 3)     # [B, MB, bs, nkv, hd]
    v = pages[:, :, 1].transpose(2, 3)
    B, MB, bs, nkv, hd = k.shape
    return (k.reshape(B, MB * bs, nkv, hd), v.reshape(B, MB * bs, nkv, hd))


def paged_attention_ragged_reference(q, kv_pool, block_tables, q_lens,
                                     kv_lens, sm_scale=None):
    """Plain PyTorch ragged attention (the Pallas module's
    ``paged_attention_ragged_reference``): gather pages dense, then a
    masked fp32 softmax per sequence with query i at
    kv_lens[s] - q_lens[s] + i. Rows with no valid key give zeros."""
    q_lens = tuple(int(x) for x in q_lens)
    R, nh, hd = q.shape
    if R == 0:
        return q
    nkv = kv_pool.shape[2]
    g = nh // nkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    k, v = gather_pages(kv_pool, block_tables)   # [n_seq, S, nkv, hd]
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
