"""Search / sort ops (counterpart of ``paddle_tpu/ops/search.py``).
Index outputs are int32, as the JAX package's are."""
from __future__ import annotations

import numpy as np
import torch

from ._helpers import (Tensor, apply, convert_dtype, long, nodiff_op,
                       normalize_axis, op, unwrap, wrap)

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "searchsorted", "kthvalue",
    "mode", "index_sample", "bucketize",
]


def _arg_extreme(name, fn, x, axis, keepdim, dtype):
    d = convert_dtype(dtype)
    ax = normalize_axis(axis)

    def impl(a):
        if ax is None:
            out = fn(a.reshape(-1))
            return (out.reshape((1,) * a.ndim) if keepdim else out).to(d)
        return fn(a, dim=ax, keepdim=keepdim).to(d)
    return nodiff_op(name, impl, x)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg_extreme("argmax", torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg_extreme("argmin", torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=True, name=None):
    return nodiff_op("argsort", lambda a: torch.argsort(
        a, dim=axis, descending=descending, stable=stable), x)


def sort(x, axis=-1, descending=False, stable=True, name=None):
    return op("sort", lambda a: torch.sort(
        a, dim=axis, descending=descending, stable=stable).values, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    kk = int(unwrap(k)) if isinstance(k, Tensor) else int(k)
    ax = -1 if axis is None else int(axis)

    def impl(a):
        vals, idx = torch.topk(a, kk, dim=ax, largest=largest, sorted=True)
        return vals, idx
    vals, idx = apply(impl, (x,), op_name="top_k")
    return vals, idx


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    def impl(seq, v):
        v = torch.as_tensor(v, device=seq.device)
        if seq.ndim > 1 and v.ndim == 0:
            v = v.reshape(1)
        return torch.searchsorted(seq.contiguous(), v.contiguous(),
                                  right=right, out_int32=out_int32)
    return nodiff_op("searchsorted", impl, sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def impl(a):
        vals = torch.sort(a, dim=axis).values.select(axis, k - 1)
        idx = torch.argsort(a, dim=axis, stable=True).select(axis, k - 1)
        if keepdim:
            vals = vals.unsqueeze(axis)
            idx = idx.unsqueeze(axis)
        return vals, idx
    return apply(impl, (x,), op_name="kthvalue")


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the index of its LAST occurrence, computed on the host as the JAX
    package does."""
    t = unwrap(x)
    a = Tensor._wrap(t).numpy()
    moved = np.moveaxis(a, axis, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(flat.shape[0], a.dtype)
    idxs = np.empty(flat.shape[0], np.int64)
    for i, row in enumerate(flat):
        uniq, counts = np.unique(row, return_counts=True)
        best = uniq[np.argmax(counts)]
        vals[i] = best
        idxs[i] = np.where(row == best)[0][-1]
    vals = vals.reshape(moved.shape[:-1])
    idxs = idxs.reshape(moved.shape[:-1])
    if keepdim:
        vals = np.expand_dims(vals, axis)
        idxs = np.expand_dims(idxs, axis)
    return (wrap(torch.from_numpy(vals).to(t.device, t.dtype)),
            wrap(torch.from_numpy(idxs).to(t.device)))


def index_sample(x, index, name=None):
    return op("index_sample",
              lambda a, idx: torch.gather(a, 1, long(idx)), x, index)
