"""Cache-KV decode attention for Hopper — the counterpart of
``paddle_tpu/ops/pallas/decode_attention.py``.

One query step per batch row attends over a dense cache with per-row
valid lengths (online fp32 softmax; a row of length 0 returns zeros).
GQA folds query-head groups onto the kv-head axis inside the kernel.

Dispatch: a CUDA tensor launches ``csrc/decode_attention.cu`` (or
raises); a CPU tensor takes ``decode_attention_reference``. The kernel
reads the cache through its strides: the serving model passes the
``[2, B, H, max_len, D]`` layer cache as ``[B, S, H, D]`` transposed
views, never a transposed copy.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from .paged_attention import _DTYPES, NEG_INF, rows_vectorizable

# launch count of the CUDA kernel (CPU calls are not counted)
_LAUNCHES = {"count": 0}


def launch_count() -> int:
    return _LAUNCHES["count"]


def reset_launch_count() -> None:
    _LAUNCHES["count"] = 0


def decode_attention(q, k_cache, v_cache, seq_lens,
                     sm_scale: Optional[float] = None):
    """q: [B, nh, hd] (one decode step). k_cache / v_cache: [B, S, nkv,
    hd], any strides with a contiguous head_dim. seq_lens: int32 [B]
    valid cache lengths. Returns [B, nh, hd]."""
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    if nh % nkv:
        raise ValueError(f"query heads {nh} are not a multiple of kv "
                         f"heads {nkv}")
    if not q.is_cuda:
        return decode_attention_reference(q, k_cache, v_cache, seq_lens,
                                          sm_scale=sm_scale)
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
        if t.shape != (B, S, nkv, hd) or t.stride(3) != 1:
            raise ValueError(f"{name} must be [B, S, nkv, hd] with a "
                             f"contiguous head_dim, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32/bfloat16, got {q.dtype}")
    if q.stride(2) != 1:
        raise ValueError("q's head_dim axis must be contiguous")
    from ._build import check, load
    lib = load("decode_attention")
    if lib.pt_decode_attention_max_rows(hd) < nh // nkv:
        raise ValueError(f"head_dim {hd} with GQA group {nh // nkv} does "
                         f"not fit one block (head_dim <= 256)")
    if isinstance(seq_lens, torch.Tensor):
        lens = seq_lens.to(device=dev, dtype=torch.int32)
    else:
        lens = torch.as_tensor(np.asarray(seq_lens, np.int32), device=dev)
    lens = lens.reshape(-1).contiguous()
    if lens.shape[0] != B:
        raise ValueError("seq_lens needs one entry per row")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, nh, hd), dtype=q.dtype, device=dev)
    fn = lib.pt_decode_attention
    fn.restype = ctypes.c_int
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ci, vp, ll, ll, vp, ll, ll, ll, vp, ll, ll, ll, vp, vp,
                   ci, ci, ci, ci, ci, ctypes.c_float, ci, vp]
    vec = rows_vectorizable(k_cache, k_cache.stride()[:3]) and \
        rows_vectorizable(v_cache, v_cache.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
                 k_cache.data_ptr(), k_cache.stride(0), k_cache.stride(1),
                 k_cache.stride(2), v_cache.data_ptr(), v_cache.stride(0),
                 v_cache.stride(1), v_cache.stride(2), lens.data_ptr(),
                 out.data_ptr(), B, nh, nkv, hd, S, float(scale), int(vec),
                 stream)
    check(err, "decode_attention")
    _LAUNCHES["count"] += 1
    return out


def decode_attention_reference(q, k_cache, v_cache, seq_lens,
                               sm_scale=None):
    """Plain PyTorch decode attention (the Pallas module's
    ``decode_attention_reference``)."""
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    g = nh // nkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, nkv, g, hd).float()
    scores = torch.einsum("bngd,bsnd->bngs", qg, k_cache.float()) * scale
    lens = torch.as_tensor(seq_lens, device=q.device).long().reshape(-1)
    mask = torch.arange(S, device=q.device)[None, None, None, :] < \
        lens[:, None, None, None]
    # mask again after softmax so length-0 rows yield zeros
    p = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1) * mask
    out = torch.einsum("bngs,bsnd->bngd", p, v_cache.float())
    return out.reshape(B, nh, hd).to(q.dtype)
