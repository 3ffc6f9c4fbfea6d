"""Elementwise math and reductions (counterpart of
``paddle_tpu/ops/math.py``). Paddle's semantics: ``axis=None`` reduces
every axis, ``keepdim`` keeps them; the output dtypes are the JAX
package's (a mean of ints is float32, a sum of ints int32)."""
from __future__ import annotations

import torch

from ._helpers import (Tensor, apply, apply_inplace, convert_dtype, dims,
                       get_default_dtype, long, nodiff_op, normalize_axis,
                       op, unwrap)

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "floor_mod", "pow", "scale", "abs", "ceil", "floor", "round",
    "trunc", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "square", "reciprocal", "sign", "sgn", "sin", "cos", "tan", "asin",
    "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "erf", "erfinv", "sigmoid", "maximum", "minimum", "fmax", "fmin",
    "clip", "lerp", "addmm", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "prod", "sum", "mean", "max", "min", "amax", "amin",
    "logsumexp", "nanmean", "nansum", "std", "var", "median", "nanmedian",
    "kron", "outer", "inner", "dot", "cross", "isfinite", "isinf", "isnan",
    "nan_to_num", "angle", "conj", "real", "imag", "deg2rad", "rad2deg",
    "gcd", "lcm", "diff", "frac", "heaviside", "hypot", "logaddexp", "neg",
    "stanh", "add_n", "count_nonzero", "increment", "multiply_", "add_",
    "subtract_", "divide_", "clip_", "scale_", "exp_", "sqrt_", "rsqrt_",
    "reciprocal_", "round_", "ceil_", "floor_", "tanh_", "sigmoid_",
    "quantile", "nanquantile", "frexp", "trapezoid", "cumulative_trapezoid", "rot90", "logit",
    "log_normalize", "renorm", "inverse", "digamma", "lgamma", "polygamma",
    "nextafter", "ldexp", "copysign", "signbit", "i0", "i0e", "i1",
    "i1e", "multiplex", "sinc", "take",
    "broadcast_shape", "mm", "vander", "led_to_default",
]


def _float(a):
    """``a`` in the default float dtype when it is not floating (JAX
    promotes ints to float32 in the transcendental ops)."""
    return a if a.is_floating_point() or a.is_complex() else \
        a.to(get_default_dtype())


def _pair(b, a):
    """A Python or tensor second operand of a binary torch function that
    takes tensors only, as a tensor on ``a``'s device."""
    return b if isinstance(b, torch.Tensor) else \
        torch.as_tensor(b, dtype=a.dtype, device=a.device)


def add(x, y, name=None):
    return op("elementwise_add", lambda a, b: a + b, x, y)


def subtract(x, y, name=None):
    return op("elementwise_sub", lambda a, b: a - b, x, y)


def multiply(x, y, name=None):
    return op("elementwise_mul", lambda a, b: a * b, x, y)


def divide(x, y, name=None):
    return op("elementwise_div", torch.true_divide, x, y)


def floor_divide(x, y, name=None):
    return nodiff_op("floor_divide", torch.floor_divide, x, y)


def mod(x, y, name=None):
    return op("elementwise_mod", torch.remainder, x, y)


remainder = mod
floor_mod = mod


def pow(x, y, name=None):
    return op("pow", torch.pow, x, y)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    def impl(a, s, b):
        out = a * s + b if bias_after_scale else (a + b) * s
        return out.to(a.dtype)
    return op("scale", impl, x, unwrap(scale), bias)


def abs(x, name=None):
    return op("abs", torch.abs, x)


def ceil(x, name=None):
    return op("ceil", torch.ceil, x)


def floor(x, name=None):
    return op("floor", torch.floor, x)


def round(x, name=None):
    return op("round", torch.round, x)


def trunc(x, name=None):
    return op("trunc", torch.trunc, x)


def exp(x, name=None):
    return op("exp", lambda a: torch.exp(_float(a)), x)


def expm1(x, name=None):
    return op("expm1", lambda a: torch.expm1(_float(a)), x)


def log(x, name=None):
    return op("log", lambda a: torch.log(_float(a)), x)


def log2(x, name=None):
    return op("log2", lambda a: torch.log2(_float(a)), x)


def log10(x, name=None):
    return op("log10", lambda a: torch.log10(_float(a)), x)


def log1p(x, name=None):
    return op("log1p", lambda a: torch.log1p(_float(a)), x)


def sqrt(x, name=None):
    return op("sqrt", lambda a: torch.sqrt(_float(a)), x)


def rsqrt(x, name=None):
    return op("rsqrt", lambda a: torch.rsqrt(_float(a)), x)


def square(x, name=None):
    return op("square", torch.square, x)


def reciprocal(x, name=None):
    return op("reciprocal", lambda a: 1.0 / a, x)


def sign(x, name=None):
    return op("sign", torch.sign, x)


sgn = sign


def sin(x, name=None):
    return op("sin", lambda a: torch.sin(_float(a)), x)


def cos(x, name=None):
    return op("cos", lambda a: torch.cos(_float(a)), x)


def tan(x, name=None):
    return op("tan", lambda a: torch.tan(_float(a)), x)


def asin(x, name=None):
    return op("asin", lambda a: torch.asin(_float(a)), x)


def acos(x, name=None):
    return op("acos", lambda a: torch.acos(_float(a)), x)


def atan(x, name=None):
    return op("atan", lambda a: torch.atan(_float(a)), x)


def atan2(x, y, name=None):
    return op("atan2", lambda a, b: torch.atan2(_float(a), _pair(b, a)),
              x, y)


def sinh(x, name=None):
    return op("sinh", lambda a: torch.sinh(_float(a)), x)


def cosh(x, name=None):
    return op("cosh", lambda a: torch.cosh(_float(a)), x)


def tanh(x, name=None):
    return op("tanh", lambda a: torch.tanh(_float(a)), x)


def asinh(x, name=None):
    return op("asinh", lambda a: torch.asinh(_float(a)), x)


def acosh(x, name=None):
    return op("acosh", lambda a: torch.acosh(_float(a)), x)


def atanh(x, name=None):
    return op("atanh", lambda a: torch.atanh(_float(a)), x)


def erf(x, name=None):
    return op("erf", lambda a: torch.erf(_float(a)), x)


def erfinv(x, name=None):
    return op("erfinv", lambda a: torch.erfinv(_float(a)), x)


def sigmoid(x, name=None):
    return op("sigmoid", lambda a: torch.sigmoid(_float(a)), x)


def logit(x, eps=None, name=None):
    def impl(a):
        if eps is not None:
            a = torch.clamp(a, eps, 1 - eps)
        return torch.log(a / (1 - a))
    return op("logit", impl, x)


def maximum(x, y, name=None):
    return op("elementwise_max",
              lambda a, b: torch.maximum(a, _pair(b, a)), x, y)


def minimum(x, y, name=None):
    return op("elementwise_min",
              lambda a, b: torch.minimum(a, _pair(b, a)), x, y)


def fmax(x, y, name=None):
    return op("fmax", lambda a, b: torch.fmax(a, _pair(b, a)), x, y)


def fmin(x, y, name=None):
    return op("fmin", lambda a, b: torch.fmin(a, _pair(b, a)), x, y)


def clip(x, min=None, max=None, name=None):
    mn, mx = unwrap(min), unwrap(max)
    return op("clip", lambda a: torch.clamp(a, mn, mx), x)


def lerp(x, y, weight, name=None):
    if isinstance(weight, Tensor):
        return op("lerp", lambda a, b, w: a + w * (b - a), x, y, weight)
    return op("lerp", lambda a, b: a + weight * (b - a), x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return op("addmm", lambda i, a, b: beta * i + alpha * (a @ b),
              input, x, y)


def cumsum(x, axis=None, dtype=None, name=None):
    d = convert_dtype(dtype)

    def impl(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=d)
        return torch.cumsum(a, normalize_axis(axis), dtype=d)
    return op("cumsum", impl, x)


def cumprod(x, dim=None, dtype=None, name=None):
    d = convert_dtype(dtype)

    def impl(a):
        if dim is None:
            return torch.cumprod(a.reshape(-1), 0, dtype=d)
        return torch.cumprod(a, normalize_axis(dim), dtype=d)
    return op("cumprod", impl, x)


def _cum_extreme(scan, axis, dtype):
    """(running extreme, index of its LAST occurrence so far), as the JAX
    package computes them."""
    def impl(a):
        ax = normalize_axis(axis)
        if ax is None:
            a = a.reshape(-1)
            ax = 0
        ax %= a.ndim
        vals = scan(a, ax).values
        idx = torch.arange(a.shape[ax], device=a.device).reshape(
            [-1 if i == ax else 1 for i in range(a.ndim)])
        inds = torch.cummax(torch.where(a == vals, idx, -1), ax).values
        return vals, inds.to(convert_dtype(dtype))
    return impl


def cummax(x, axis=None, dtype="int64", name=None):
    return op("cummax", _cum_extreme(torch.cummax, axis, dtype), x)


def cummin(x, axis=None, dtype="int64", name=None):
    return op("cummin", _cum_extreme(torch.cummin, axis, dtype), x)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    def impl(a):
        ax = normalize_axis(axis)
        if ax is None:
            return torch.logcumsumexp(a.reshape(-1), 0)
        return torch.logcumsumexp(a, ax)
    return op("logcumsumexp", impl, x)


def _keep(out, a, ax, keepdim):
    """``out`` reduced over ``ax`` of ``a`` with the reduced axes put
    back when ``keepdim``."""
    if not keepdim:
        return out
    shape = [1 if i in {d % a.ndim for d in dims(ax, a.ndim)} else s
             for i, s in enumerate(a.shape)]
    return out.reshape(shape)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = convert_dtype(dtype)
    ax = normalize_axis(axis)

    def impl(a):
        out = torch.sum(a, dim=dims(ax, a.ndim), keepdim=keepdim)
        return out.to(d) if d is not None else out
    return op("reduce_sum", impl, x)


def mean(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return op("reduce_mean", lambda a: torch.mean(
        _float(a), dim=dims(ax, a.ndim), keepdim=keepdim), x)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    d = convert_dtype(dtype)
    ax = normalize_axis(axis)

    def impl(a):
        out = a
        for i in sorted({i % a.ndim for i in dims(ax, a.ndim)},
                        reverse=True):
            out = torch.prod(out, i)
        out = _keep(out, a, ax, keepdim)
        return out.to(d) if d is not None else out
    return op("reduce_prod", impl, x)


def max(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return op("reduce_max", lambda a: torch.amax(
        a, dim=dims(ax, a.ndim), keepdim=keepdim), x)


def min(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return op("reduce_min", lambda a: torch.amin(
        a, dim=dims(ax, a.ndim), keepdim=keepdim), x)


amax = max
amin = min


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return op("logsumexp", lambda a: torch.logsumexp(
        _float(a), dim=dims(ax, a.ndim), keepdim=keepdim), x)


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return op("nanmean", lambda a: torch.nanmean(
        _float(a), dim=dims(ax, a.ndim), keepdim=keepdim), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = convert_dtype(dtype)
    ax = normalize_axis(axis)

    def impl(a):
        out = torch.nansum(a, dim=dims(ax, a.ndim), keepdim=keepdim)
        return out.to(d) if d is not None else out
    return op("nansum", impl, x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return op("std", lambda a: torch.std(
        _float(a), dim=dims(ax, a.ndim), correction=1 if unbiased else 0,
        keepdim=keepdim), x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return op("var", lambda a: torch.var(
        _float(a), dim=dims(ax, a.ndim), correction=1 if unbiased else 0,
        keepdim=keepdim), x)


def _quantile(fn, a, q, ax, keepdim, interpolation):
    """numpy's quantile over ``ax`` (None: all; a tuple: those axes
    flattened together) through ``torch.quantile`` / ``nanquantile``."""
    a = _float(a)
    q = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    if ax is None:
        out = fn(a.reshape(-1), q, dim=0, interpolation=interpolation)
        if keepdim:
            out = out.reshape(tuple(q.shape) + (1,) * a.ndim)
        return out
    axes = sorted({i % a.ndim for i in dims(ax, a.ndim)})
    rest = [i for i in range(a.ndim) if i not in axes]
    moved = a.permute(rest + axes).reshape(
        [a.shape[i] for i in rest] + [-1])
    out = fn(moved, q, dim=-1, interpolation=interpolation)
    if keepdim:
        shape = [1 if i in axes else s for i, s in enumerate(a.shape)]
        out = out.reshape(tuple(q.shape) + tuple(shape))
    return out


def median(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return op("median", lambda a: _quantile(torch.quantile, a, 0.5, ax,
                                            keepdim, "linear"), x)


def nanmedian(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return op("nanmedian", lambda a: _quantile(torch.nanquantile, a, 0.5,
                                               ax, keepdim, "linear"), x)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    ax = normalize_axis(axis)
    qq = unwrap(q)
    return op("quantile", lambda a: _quantile(torch.quantile, a, qq, ax,
                                              keepdim, interpolation), x)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    """The quantile ignoring NaNs."""
    ax = normalize_axis(axis)
    qq = unwrap(q)
    return op("nanquantile", lambda a: _quantile(
        torch.nanquantile, a, qq, ax, keepdim, interpolation), x)


def kron(x, y, name=None):
    return op("kron", torch.kron, x, y)


def outer(x, y, name=None):
    return op("outer", lambda a, b: torch.outer(a.reshape(-1),
                                                b.reshape(-1)), x, y)


def inner(x, y, name=None):
    return op("inner", torch.inner, x, y)


def dot(x, y, name=None):
    def impl(a, b):
        if a.ndim == 1:
            return torch.dot(a, b)
        return torch.sum(a * b, dim=-1)
    return op("dot", impl, x, y)


def cross(x, y, axis=9, name=None):
    def impl(a, b):
        ax = axis
        if ax == 9:  # Paddle's default: the first axis of size 3
            ax = next(i for i, d in enumerate(a.shape) if d == 3)
        return torch.linalg.cross(a, b, dim=ax)
    return op("cross", impl, x, y)


def mm(x, y, name=None):
    return op("matmul", torch.matmul, x, y)


def isfinite(x, name=None):
    return nodiff_op("isfinite", torch.isfinite, x)


def isinf(x, name=None):
    return nodiff_op("isinf", torch.isinf, x)


def isnan(x, name=None):
    return nodiff_op("isnan", torch.isnan, x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return op("nan_to_num", lambda a: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf), x)


def angle(x, name=None):
    return op("angle", torch.angle, x)


def conj(x, name=None):
    return op("conj", torch.conj_physical, x)


def real(x, name=None):
    return op("real", torch.real, x)


def imag(x, name=None):
    return op("imag", torch.imag, x)


def deg2rad(x, name=None):
    return op("deg2rad", lambda a: torch.deg2rad(_float(a)), x)


def rad2deg(x, name=None):
    return op("rad2deg", lambda a: torch.rad2deg(_float(a)), x)


def gcd(x, y, name=None):
    return nodiff_op("gcd", lambda a, b: torch.gcd(a, _pair(b, a)), x, y)


def lcm(x, y, name=None):
    return nodiff_op("lcm", lambda a, b: torch.lcm(a, _pair(b, a)), x, y)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    pre, app = unwrap(prepend), unwrap(append)

    def impl(a):
        def edge(v):
            if v is None or isinstance(v, torch.Tensor):
                return v
            shape = list(a.shape)
            shape[axis] = 1
            return torch.full(shape, v, dtype=a.dtype, device=a.device)
        return torch.diff(a, n=n, dim=axis, prepend=edge(pre),
                          append=edge(app))
    return op("diff", impl, x)


def frac(x, name=None):
    return op("frac", lambda a: a - torch.trunc(a), x)


def heaviside(x, y, name=None):
    return op("heaviside", lambda a, b: torch.heaviside(a, _pair(b, a)),
              x, y)


def hypot(x, y, name=None):
    return op("hypot", lambda a, b: torch.hypot(a, _pair(b, a)), x, y)


def logaddexp(x, y, name=None):
    return op("logaddexp", lambda a, b: torch.logaddexp(a, _pair(b, a)),
              x, y)


def neg(x, name=None):
    return op("neg", torch.neg, x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return op("stanh", lambda a: scale_b * torch.tanh(scale_a * a), x)


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        inputs = [inputs]

    def impl(*xs):
        out = xs[0]
        for a in xs[1:]:
            out = out + a
        return out
    return apply(impl, tuple(inputs), op_name="add_n")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)
    return nodiff_op("count_nonzero", lambda a: _keep(
        torch.count_nonzero(a, dim=dims(ax, a.ndim)), a, ax, keepdim), x)


def increment(x, value=1.0, name=None):
    return apply_inplace(x, lambda a: a + value, (x,))


def digamma(x, name=None):
    return op("digamma", lambda a: torch.digamma(_float(a)), x)


def lgamma(x, name=None):
    return op("lgamma", lambda a: torch.lgamma(_float(a)), x)


def polygamma(x, n, name=None):
    return op("polygamma", lambda a: torch.polygamma(n, _float(a)), x)


def nextafter(x, y, name=None):
    return nodiff_op("nextafter",
                     lambda a, b: torch.nextafter(a, _pair(b, a)), x, y)


def ldexp(x, y, name=None):
    return op("ldexp",
              lambda a, b: a * torch.exp2(b.to(torch.float32)), x, y)


def copysign(x, y, name=None):
    return op("copysign", lambda a, b: torch.copysign(a, _pair(b, a)), x, y)


def signbit(x, name=None):
    return nodiff_op("signbit", torch.signbit, x)


def i0(x, name=None):
    return op("i0", lambda a: torch.i0(_float(a)), x)


def i0e(x, name=None):
    """Exponentially scaled modified Bessel function I0."""
    return op("i0e", lambda a: torch.special.i0e(_float(a)), x)


def i1(x, name=None):
    return op("i1", lambda a: torch.special.i1(_float(a)), x)


def i1e(x, name=None):
    return op("i1e", lambda a: torch.special.i1e(_float(a)), x)


def sinc(x, name=None):
    return op("sinc", lambda a: torch.sinc(_float(a)), x)


def take(x, index, mode="raise", name=None):
    def impl(a, idx):
        flat = a.reshape(-1)
        idx = long(idx)
        if mode == "wrap":
            idx = torch.remainder(idx, flat.shape[0])
        elif mode == "clip":
            idx = torch.clamp(idx, 0, flat.shape[0] - 1)
        return flat[idx]
    return op("take", impl, x, index)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return op("trapezoid", lambda a, b: torch.trapezoid(a, b, dim=axis),
                  y, x)
    return op("trapezoid", lambda a: torch.trapezoid(
        a, dx=dx if dx is not None else 1.0, dim=axis), y)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def impl(a, *rest):
        b = rest[0] if rest else None
        d = torch.diff(b, dim=axis) if b is not None else (dx or 1.0)
        n = a.shape[axis]
        avg = (a.narrow(axis, 1, n - 1) + a.narrow(axis, 0, n - 1)) / 2.0
        return torch.cumsum(avg * d, dim=axis)
    if x is not None:
        return op("cumulative_trapezoid", impl, y, x)
    return op("cumulative_trapezoid", impl, y)


def rot90(x, k=1, axes=(0, 1), name=None):
    return op("rot90", lambda a: torch.rot90(a, k, tuple(axes)), x)


def renorm(x, p, axis, max_norm, name=None):
    def impl(a):
        red = [i for i in range(a.ndim) if i != axis % a.ndim]
        norms = torch.sum(torch.abs(a) ** p, dim=red,
                          keepdim=True) ** (1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             1.0)
        return a * factor
    return op("renorm", impl, x)


def inverse(x, name=None):
    return op("inverse", torch.linalg.inv, x)


def log_normalize(x, axis=-1):
    return op("log_normalize",
              lambda a: a - torch.logsumexp(a, dim=axis, keepdim=True), x)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def vander(x, n=None, increasing=False, name=None):
    return op("vander", lambda a: torch.linalg.vander(
        a, N=n).flip(-1) if not increasing else torch.linalg.vander(a, N=n),
        x)


def led_to_default(x):  # internal helper, not public Paddle API
    return x


def multiplex(inputs, index, name=None):
    """Row-wise select among candidate tensors: out[i] =
    inputs[index[i]][i]."""
    def impl(idx, *xs):
        stacked = torch.stack(xs, dim=0)           # [K, B, ...]
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[long(idx.reshape(-1)), rows]
    return apply(impl, (index,) + tuple(inputs), op_name="multiplex")


def frexp(x, name=None):
    """Mantissa in [0.5, 1) and integer exponent with x = m * 2**e (the
    exponent in x's dtype, as the reference returns it)."""
    def impl(a):
        m, e = torch.frexp(a)
        return m, e.to(a.dtype)
    return apply(impl, (x,), op_name="frexp")


# -- in-place variants -----------------------------------------------------

def add_(x, y, name=None):
    return apply_inplace(x, lambda a, b: a + b, (x, y))


def subtract_(x, y, name=None):
    return apply_inplace(x, lambda a, b: a - b, (x, y))


def multiply_(x, y, name=None):
    return apply_inplace(x, lambda a, b: a * b, (x, y))


def divide_(x, y, name=None):
    return apply_inplace(x, torch.true_divide, (x, y))


def clip_(x, min=None, max=None, name=None):
    mn, mx = unwrap(min), unwrap(max)
    return apply_inplace(x, lambda a: torch.clamp(a, mn, mx), (x,))


def scale_(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
           name=None):
    return apply_inplace(x, lambda a: (
        a * scale + bias if bias_after_scale else (a + bias) * scale).to(
        a.dtype), (x,))


def exp_(x, name=None):
    return apply_inplace(x, torch.exp, (x,))


def sqrt_(x, name=None):
    return apply_inplace(x, torch.sqrt, (x,))


def rsqrt_(x, name=None):
    return apply_inplace(x, torch.rsqrt, (x,))


def reciprocal_(x, name=None):
    return apply_inplace(x, lambda a: 1.0 / a, (x,))


def round_(x, name=None):
    return apply_inplace(x, torch.round, (x,))


def ceil_(x, name=None):
    return apply_inplace(x, torch.ceil, (x,))


def floor_(x, name=None):
    return apply_inplace(x, torch.floor, (x,))


def tanh_(x, name=None):
    return apply_inplace(x, torch.tanh, (x,))


def sigmoid_(x, name=None):
    return apply_inplace(x, torch.sigmoid, (x,))

