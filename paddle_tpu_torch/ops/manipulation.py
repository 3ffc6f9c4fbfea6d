"""Shape / layout manipulation ops (counterpart of
``paddle_tpu/ops/manipulation.py``): the same 83 functions, in-place
variants included, over torch."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ._helpers import (Tensor, apply, apply_inplace, convert_dtype, long,
                       nodiff_op, normalize_axis, op, unwrap, wrap)

__all__ = [
    "cast", "reshape", "reshape_", "flatten", "squeeze", "squeeze_",
    "unsqueeze", "unsqueeze_", "concat", "stack", "split", "chunk",
    "vsplit", "hsplit", "dsplit", "tile", "expand", "expand_as",
    "broadcast_to", "broadcast_tensors", "transpose", "moveaxis", "flip", "reverse", "tolist",
    "roll", "gather", "gather_nd", "scatter", "scatter_", "scatter_nd",
    "scatter_nd_add", "index_select", "index_add", "index_add_", "index_put", "index_put_",
    "put_along_axis", "take_along_axis", "slice", "strided_slice", "pad",
    "repeat_interleave", "unbind", "unique", "unique_consecutive",
    "masked_select", "masked_fill", "where", "nonzero", "unstack",
    "tensordot", "einsum", "as_complex", "as_real", "view", "view_as",
    "unflatten", "atleast_1d", "atleast_2d", "atleast_3d", "row_stack",
    "column_stack", "hstack", "vstack", "dstack", "t", "shard_index",
    "crop", "unfold", "diagonal", "diagonal_scatter", "fill_diagonal_",
    "flatten_", "as_strided", "select_scatter", "slice_scatter",
]


def cast(x, dtype):
    d = convert_dtype(dtype)
    return op("cast", lambda a: a.to(d), x)


def _resolve_shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    return tuple(int(unwrap(s)) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _int(v):
    return int(unwrap(v)) if isinstance(v, Tensor) else int(v)


def _reshape_impl(sh):
    def impl(a):
        # Paddle: 0 copies the input's dim at that position
        return a.reshape(tuple(a.shape[i] if d == 0 else d
                               for i, d in enumerate(sh)))
    return impl


def reshape(x, shape, name=None):
    return op("reshape", _reshape_impl(_resolve_shape(shape)), x)


def reshape_(x, shape, name=None):
    return apply_inplace(x, _reshape_impl(_resolve_shape(shape)), (x,))


def _flatten_impl(start_axis, stop_axis):
    def impl(a):
        nd = a.ndim
        s = start_axis % nd if nd else 0
        e = stop_axis % nd if nd else 0
        return a.reshape(tuple(a.shape[:s]) + (-1,) + tuple(a.shape[e + 1:]))
    return impl


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return op("flatten", _flatten_impl(start_axis, stop_axis), x)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return apply_inplace(x, _flatten_impl(start_axis, stop_axis), (x,))


def _squeeze_impl(ax):
    def impl(a):
        if ax is None:
            return a.squeeze()
        axes = (ax,) if isinstance(ax, int) else ax
        axes = tuple(sorted({i % a.ndim for i in axes
                             if a.shape[i % a.ndim] == 1}))
        return a.squeeze(axes) if axes else a
    return impl


def squeeze(x, axis=None, name=None):
    return op("squeeze", _squeeze_impl(normalize_axis(axis)), x)


def squeeze_(x, axis=None, name=None):
    return apply_inplace(x, _squeeze_impl(normalize_axis(axis)), (x,))


def _unsqueeze_impl(axis):
    ax = normalize_axis(axis)
    axes = (ax,) if isinstance(ax, int) else tuple(ax)

    def impl(a):
        # Paddle: each axis indexes a position of the OUTPUT rank
        out_rank = a.ndim + len(axes)
        out = a
        for i in sorted(i % out_rank for i in axes):
            out = out.unsqueeze(i)
        return out
    return impl


def unsqueeze(x, axis, name=None):
    return op("unsqueeze", _unsqueeze_impl(axis), x)


def unsqueeze_(x, axis, name=None):
    return apply_inplace(x, _unsqueeze_impl(axis), (x,))


def concat(x, axis=0, name=None):
    ax = _int(axis)
    return apply(lambda *xs: torch.cat(xs, dim=ax), tuple(x),
                 op_name="concat")


def stack(x, axis=0, name=None):
    return apply(lambda *xs: torch.stack(xs, dim=axis), tuple(x),
                 op_name="stack")


def split(x, num_or_sections, axis=0, name=None):
    ax = _int(axis)
    dim = (x.shape if isinstance(x, Tensor) else unwrap(x).shape)[ax]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [_int(s) for s in num_or_sections]
        known = builtins.sum(s for s in sizes if s != -1)
        sizes = [dim - known if s == -1 else s for s in sizes]
    return list(apply(lambda a: torch.split(a, sizes, dim=ax), (x,),
                      op_name="split"))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def vsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, 0)


def hsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, 1)


def dsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, 2)


def tile(x, repeat_times, name=None):
    reps = _resolve_shape(repeat_times)
    return op("tile", lambda a: torch.tile(a, reps), x)


def _aligned(a, n):
    return a.reshape((1,) * (n - a.ndim) + tuple(a.shape))


def expand(x, shape, name=None):
    sh = _resolve_shape(shape)

    def impl(a):
        # Paddle: -1 keeps the input's dim
        al = _aligned(a, len(sh))
        return torch.broadcast_to(al, tuple(
            al.shape[i] if d == -1 else d for i, d in enumerate(sh)))
    return op("expand", impl, x)


def expand_as(x, y, name=None):
    target = tuple(y.shape if isinstance(y, Tensor) else unwrap(y).shape)
    return op("expand_as", lambda a: torch.broadcast_to(
        _aligned(a, len(target)), target), x)


def broadcast_to(x, shape, name=None):
    sh = _resolve_shape(shape)
    return op("broadcast_to", lambda a: torch.broadcast_to(a, sh), x)


def broadcast_tensors(inputs, name=None):
    sh = torch.broadcast_shapes(*[tuple(unwrap(t).shape) for t in inputs])
    return [op("broadcast_to", lambda a: torch.broadcast_to(a, sh), t)
            for t in inputs]


def transpose(x, perm, name=None):
    p = tuple(int(i) for i in perm)
    return op("transpose", lambda a: a.permute(p), x)


def t(x, name=None):
    return op("t", lambda a: a if a.ndim < 2 else a.t(), x)


def moveaxis(x, source, destination, name=None):
    return op("moveaxis", lambda a: torch.movedim(a, source, destination), x)


def flip(x, axis, name=None):
    ax = normalize_axis(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    return op("flip", lambda a: torch.flip(a, ax), x)


def roll(x, shifts, axis=None, name=None):
    ax = normalize_axis(axis)
    sh = normalize_axis(shifts)
    return op("roll", lambda a: torch.roll(a, sh, ax), x)


def gather(x, index, axis=0, name=None):
    ax = _int(axis)

    def impl(a, idx):
        idx = long(idx)
        if idx.ndim == 0:
            return torch.index_select(a, ax, idx.reshape(1)).squeeze(ax)
        return torch.index_select(a, ax, idx.reshape(-1))
    return op("gather", impl, x, index)


def _nd(idx):
    return tuple(long(idx).movedim(-1, 0))


def gather_nd(x, index, name=None):
    return op("gather_nd", lambda a, idx: a[_nd(idx)], x, index)


def _scatter_impl(overwrite):
    def impl(a, idx, upd):
        idx = (long(idx).reshape(-1),)
        upd = upd.to(a.dtype)
        if overwrite:
            return a.index_put(idx, upd)
        zeroed = a.index_put(idx, torch.zeros_like(upd))
        return zeroed.index_put(idx, upd, accumulate=True)
    return impl


def scatter(x, index, updates, overwrite=True, name=None):
    return op("scatter", _scatter_impl(overwrite), x, index, updates)


def scatter_(x, index, updates, overwrite=True, name=None):
    return apply_inplace(x, _scatter_impl(overwrite), (x, index, updates))


def scatter_nd(index, updates, shape, name=None):
    sh = _resolve_shape(shape)

    def impl(idx, upd):
        out = torch.zeros(sh, dtype=upd.dtype, device=upd.device)
        return out.index_put(_nd(idx), upd, accumulate=True)
    return op("scatter_nd", impl, index, updates)


def scatter_nd_add(x, index, updates, name=None):
    return op("scatter_nd_add", lambda a, idx, upd: a.index_put(
        _nd(idx), upd.to(a.dtype), accumulate=True), x, index, updates)


def index_select(x, index, axis=0, name=None):
    return op("index_select",
              lambda a, idx: torch.index_select(a, axis, long(idx)),
              x, index)


def _index_add_impl(axis):
    return lambda a, idx, v: a.index_add(axis, long(idx), v.to(a.dtype))


def index_add(x, index, axis, value, name=None):
    return op("index_add", _index_add_impl(axis), x, index, value)


def index_add_(x, index, axis, value, name=None):
    return apply_inplace(x, _index_add_impl(axis), (x, index, value))


def _index_put_impl(indices, accumulate):
    idx = [unwrap(i) for i in indices]

    def impl(a, v):
        ix = tuple(long(torch.as_tensor(i).to(a.device)) for i in idx)
        return a.index_put(ix, torch.as_tensor(v).to(a.device, a.dtype),
                           accumulate=accumulate)
    return impl


def index_put(x, indices, value, accumulate=False, name=None):
    return op("index_put", _index_put_impl(indices, accumulate), x, value)


def index_put_(x, indices, value, accumulate=False, name=None):
    return apply_inplace(x, _index_put_impl(indices, accumulate), (x, value))


def put_along_axis(x, indices, values, axis, reduce="assign", name=None):
    def impl(a, idx, v):
        idx = long(idx)
        v = torch.broadcast_to(torch.as_tensor(v).to(a.device, a.dtype),
                               idx.shape)
        if reduce == "assign":
            return a.scatter(axis, idx, v)
        if reduce in ("add", "sum"):
            return a.scatter_add(axis, idx, v)
        if reduce in ("mul", "multiply"):
            return a.scatter_reduce(axis, idx, v, "prod")
        raise ValueError(reduce)
    return op("put_along_axis", impl, x, indices, values)


def take_along_axis(x, indices, axis, broadcast=True, name=None):
    def impl(a, idx):
        idx = long(idx)
        if broadcast:
            target = list(idx.shape)
            for i in range(a.ndim):
                if i != axis % a.ndim:
                    target[i] = a.shape[i]
            idx = torch.broadcast_to(idx, tuple(target))
        return torch.gather(a, axis, idx)
    return op("take_along_axis", impl, x, indices)


def _mk_slices(ndim, axes, starts, ends):
    sls = [builtins.slice(None)] * ndim
    for ax, s, e in zip(axes, starts, ends):
        sls[ax] = builtins.slice(s, e)
    return tuple(sls)


def slice(x, axes, starts, ends, name=None):
    axes = [int(a) for a in axes]
    starts = [_int(s) for s in starts]
    ends = [_int(e) for e in ends]
    return op("slice", lambda a: a[_mk_slices(a.ndim, axes, starts, ends)],
              x)


def _strided(a, axes, starts, ends, strides):
    """``a`` sliced along ``axes`` by Python's slice rules, negative
    strides included (torch's own slicing takes positive steps only)."""
    out = a
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax, st = int(ax), int(st)
        n = out.shape[ax]
        if st > 0:
            sl = [builtins.slice(None)] * out.ndim
            sl[ax] = builtins.slice(int(s), int(e), st)
            out = out[tuple(sl)]
        else:
            keep = range(*builtins.slice(int(s), int(e), st).indices(n))
            out = out.index_select(ax, torch.as_tensor(
                list(keep), dtype=torch.long, device=out.device))
    return out


def strided_slice(x, axes, starts, ends, strides, name=None):
    return op("strided_slice",
              lambda a: _strided(a, axes, starts, ends, strides), x)


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a dim of ``n`` padded by (lo, hi)."""
    pos = np.arange(-lo, n + hi)
    if mode == "reflect":
        period = 2 * (n - 1)
        pos = np.abs(pos) % period if period else np.zeros_like(pos)
        pos = np.where(pos >= n, period - pos, pos)
    elif mode == "replicate":
        pos = np.clip(pos, 0, n - 1)
    else:  # circular
        pos = pos % n
    return torch.as_tensor(pos, dtype=torch.long, device=device)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if isinstance(pad, Tensor):
        pad = pad.numpy().tolist()
    pad = [int(p) for p in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unsupported pad mode {mode!r}")

    def impl(a):
        nd = a.ndim
        if len(pad) == 2 * nd:
            # Paddle's order: low/high per dim from dim 0
            widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        else:
            # a partial spec pads the spatial dims, NCHW / NHWC aware
            n_spatial = len(pad) // 2
            widths = [(0, 0)] * nd
            if data_format.endswith("C") and data_format.startswith("N"):
                ds = list(range(1, 1 + n_spatial))
            else:
                ds = list(range(nd - n_spatial, nd))
            for j, d in enumerate(ds):
                widths[d] = (pad[2 * j], pad[2 * j + 1])
        if mode == "constant":
            flat = [p for lo_hi in reversed(widths) for p in lo_hi]
            return torch.nn.functional.pad(a, flat, value=value)
        out = a
        for d, (lo, hi) in enumerate(widths):
            if lo or hi:
                out = out.index_select(d, _pad_index(out.shape[d], lo, hi,
                                                     mode, a.device))
        return out
    return op("pad", impl, x)


def repeat_interleave(x, repeats, axis=None, name=None):
    r = unwrap(repeats)
    return op("repeat_interleave", lambda a: torch.repeat_interleave(
        a, long(r.to(a.device)) if isinstance(r, torch.Tensor) else r,
        dim=axis), x)


def unbind(x, axis=0, name=None):
    return list(apply(lambda a: torch.unbind(a, axis), (x,),
                      op_name="unbind"))


def unstack(x, axis=0, num=None, name=None):
    return unbind(x, axis)


def _on(res, like):
    return wrap(torch.as_tensor(np.asarray(res)).to(like.device))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    a = unwrap(x)
    res = np.unique(Tensor._wrap(a).numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not (return_index or return_inverse or return_counts):
        return _on(res, a)
    return tuple(_on(r, a) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    t = unwrap(x)
    a = Tensor._wrap(t).numpy()
    if axis is None:
        a = a.reshape(-1)
        ax = 0
    else:
        ax = axis
    keep = np.ones(a.shape[ax], dtype=bool)
    if a.shape[ax] > 1:
        moved = np.moveaxis(a, ax, 0)
        eq = (moved[1:] == moved[:-1]).reshape(a.shape[ax] - 1, -1).all(1)
        keep[1:] = ~eq
    rets = [_on(np.compress(keep, a, axis=ax), t)]
    if return_inverse:
        rets.append(_on(np.cumsum(keep) - 1, t))
    if return_counts:
        idx = np.flatnonzero(keep)
        rets.append(_on(np.diff(np.append(idx, a.shape[ax])), t))
    return rets[0] if len(rets) == 1 else tuple(rets)


def masked_select(x, mask, name=None):
    return apply(lambda a, m: a[torch.broadcast_to(m.bool(), a.shape)],
                 (x, mask))


def masked_fill(x, mask, value, name=None):
    v = unwrap(value)
    return op("masked_fill",
              lambda a, m: torch.where(m.bool(), v, a), x, mask)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return op("where", lambda c, a, b: torch.where(c.bool(), a, b),
              condition, x, y)


def nonzero(x, as_tuple=False):
    def impl(a):
        nz = torch.nonzero(a)
        if as_tuple:
            return tuple(nz[:, i:i + 1] for i in range(nz.shape[1]))
        return nz
    return apply(impl, (x,), differentiable=False)


def tensordot(x, y, axes=2, name=None):
    ax = axes
    if isinstance(ax, Tensor):
        ax = ax.numpy().tolist()
    return op("tensordot", lambda a, b: torch.tensordot(a, b, dims=ax), x, y)


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply(lambda *xs: torch.einsum(equation, *xs), operands,
                 op_name="einsum")


def as_complex(x, name=None):
    return op("as_complex", lambda a: torch.complex(a[..., 0], a[..., 1]), x)


def as_real(x, name=None):
    return op("as_real", lambda a: torch.stack([a.real, a.imag], dim=-1), x)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    d = convert_dtype(shape_or_dtype)
    return op("view_dtype", lambda a: a.view(d), x)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def unflatten(x, axis, shape, name=None):
    sh = _resolve_shape(shape)

    def impl(a):
        ax = axis % a.ndim
        return a.reshape(tuple(a.shape[:ax]) + sh + tuple(a.shape[ax + 1:]))
    return op("unflatten", impl, x)


def atleast_1d(*inputs, name=None):
    outs = [op("atleast_1d", torch.atleast_1d, t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [op("atleast_2d", torch.atleast_2d, t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [op("atleast_3d", torch.atleast_3d, t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def hstack(x, name=None):
    return apply(lambda *xs: torch.hstack(xs), tuple(x), op_name="hstack")


def vstack(x, name=None):
    return apply(lambda *xs: torch.vstack(xs), tuple(x), op_name="vstack")


def dstack(x, name=None):
    return apply(lambda *xs: torch.dstack(xs), tuple(x), op_name="dstack")


row_stack = vstack


def column_stack(x, name=None):
    # not hstack: 1-D inputs become columns (numpy's column_stack)
    return apply(lambda *xs: torch.column_stack(xs), tuple(x),
                 op_name="column_stack")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = index_num // nshards

    def impl(idx):
        lower = shard_id * size
        in_shard = (idx >= lower) & (idx < lower + size)
        return torch.where(in_shard, idx - lower,
                           torch.full_like(idx, ignore_value))
    return nodiff_op("shard_index", impl, input)


def crop(x, shape=None, offsets=None, name=None):
    sh = _resolve_shape(shape)
    off = [0] * len(sh) if offsets is None else [_int(o) for o in offsets]

    def impl(a):
        return a[tuple(builtins.slice(o, o + (a.shape[i] if s == -1 else s))
                       for i, (o, s) in enumerate(zip(off, sh)))]
    return op("crop", impl, x)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: x [N, C, H, W] -> [N, C*kh*kw, L] (channel-major rows)."""
    if isinstance(paddings, int):
        pt = pb = pl = pr = paddings
    elif len(paddings) == 2:
        pt = pb = paddings[0]
        pl = pr = paddings[1]
    else:
        pt, pl, pb, pr = paddings

    def impl(a):
        a = torch.nn.functional.pad(a, (pl, pr, pt, pb))
        return torch.nn.functional.unfold(
            a, _pair(kernel_sizes), dilation=_pair(dilations),
            stride=_pair(strides))
    return op("unfold", impl, x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return op("diagonal", lambda a: torch.diagonal(a, offset, axis1, axis2),
              x)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return op("diagonal_scatter", lambda a, b: torch.diagonal_scatter(
        a, b.to(a.dtype), offset, axis1, axis2), x, y)


def fill_diagonal_(x, value, offset=0, wrap_=False, name=None):
    def impl(a):
        out = a.clone()
        out.diagonal(offset, -2, -1).fill_(value)
        return out
    return apply_inplace(x, impl, (x,))


def as_strided(x, shape, stride, offset=0, name=None):
    return op("as_strided", lambda a: a.contiguous().as_strided(
        tuple(shape), tuple(stride), offset), x)


def select_scatter(x, values, axis, index, name=None):
    return op("select_scatter", lambda a, v: torch.select_scatter(
        a, v.to(a.dtype), axis, index), x, values)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def impl(a, v):
        sls = [builtins.slice(None)] * a.ndim
        for ax, s, e, st in zip(axes, starts, ends, strides):
            sls[int(ax)] = builtins.slice(int(s), int(e), int(st))
        out = a.clone()
        out[tuple(sls)] = v.to(a.dtype)
        return out
    return op("slice_scatter", impl, x, value)


def reverse(x, axis, name=None):
    """The legacy name of ``flip``."""
    return flip(x, axis)


def tolist(x):
    """The tensor's values as a nested Python list."""
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x).tolist()
