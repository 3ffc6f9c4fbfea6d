"""Fused RMSNorm, LayerNorm and dropout for Hopper — the counterparts of
``_rms_fwd``, ``_ln_fwd_call`` and ``_fused_dropout`` in
``paddle_tpu/ops/pallas/fused_norm.py``.

``fused_rms_norm(x, w, eps)`` gives ``y = x * rsqrt(mean(x^2) + eps) * w``;
``fused_rms_norm_residual(x, residual, w, eps)`` gives ``(y, z)`` with
``z = x + residual`` (rounded to the input type: the next residual
stream) and ``y`` normalized from the fp32 ``z``. ``fused_layer_norm``
and ``fused_layer_norm_residual`` do the same with LayerNorm (mean, then
the centred variance, ``* w + b``). All four are
``torch.autograd.Function``s: the forward is the kernel, the backward is
plain PyTorch, line for line the JAX package's ``_rms_core_bwd`` /
``_ln_core_bwd`` (a jnp backward there too), working from the saved,
rounded ``z``.

``_fused_dropout(x, rate, seed)`` is inverted dropout whose mask is a
hash of ``(seed, flat element index)`` (the TPU kernel's on-core
generator has no counterpart elsewhere): the same seed draws the same
mask on the card and on the CPU. ``_dropout_via_vjp`` wraps it for
autograd; its backward is the same kernel applied to the cotangent, from
the saved int seed (no mask is stored). ``fused_layer_norm_residual_dropout``
and ``fused_rms_norm_residual_dropout`` compose the two, as in JAX.

Dispatch: a CUDA tensor launches ``csrc/fused_norm.cu`` (or raises); a
CPU tensor takes the plain version (``rms_fwd_reference``,
``ln_fwd_reference``, ``dropout_reference``). Each kernel has its own
launch counter: ``launch_count("rms_norm" | "layer_norm" | "dropout")``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .flash_attention import _M32, _hash_mix, _mul32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launch counts of the CUDA kernels (CPU calls are not counted)
_LAUNCHES = {"rms_norm": 0, "layer_norm": 0, "dropout": 0}


def launch_count(kind: str) -> int:
    """Launches of one kernel: "rms_norm", "layer_norm" or "dropout"."""
    return _LAUNCHES[kind]


def reset_launch_count() -> None:
    for kind in _LAUNCHES:
        _LAUNCHES[kind] = 0


def rms_fwd_reference(x, residual, w, eps):
    """Plain version of the Pallas ``_rms_fwd``: returns ``(y, z)``, where
    ``z`` is ``x + residual`` rounded to x's type, or ``x`` itself."""
    x32 = x.float()
    if residual is not None:
        x32 = x32 + residual.float()
        z = x32.to(x.dtype)
    else:
        z = x
    rstd = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rstd * w.float()).to(x.dtype), z


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch_norm(kind, x, residual, params, eps):
    """Run the RMSNorm (params = (w,)) or LayerNorm (params = (w, b))
    kernel on CUDA tensors: (y, z), z = x + residual or x itself."""
    h = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32/bfloat16, got {x.dtype}")
    for name, t in (("residual", residual),) + tuple(
            zip(("w", "b"), params)):
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise ValueError(f"{name} must match x's device and dtype")
    for t in params:
        if t.shape != (h,):
            raise ValueError(f"w and b must be [{h}], got {tuple(t.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError("residual must match x's shape")
    x2 = x.contiguous()
    r2 = residual.contiguous() if residual is not None else None
    p2 = [t.contiguous() for t in params]
    y = torch.empty_like(x2)
    z = torch.empty_like(x2) if residual is not None else None
    ts = [t for t in (x2, r2, *p2, y, z) if t is not None]
    n_vec = 16 // x.element_size()
    vec = h % n_vec == 0 and all(t.data_ptr() % 16 == 0 for t in ts)
    from ._build import check, load
    lib = load("fused_norm")
    fn = lib.pt_rms_norm if kind == "rms_norm" else lib.pt_layer_norm
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.restype = ci
    fn.argtypes = [ci] + [vp] * (4 + len(p2)) + [
        ctypes.c_longlong, ci, ctypes.c_float, ci, vp]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[x.dtype], x2.data_ptr(), _ptr(r2),
                 *(t.data_ptr() for t in p2), y.data_ptr(), _ptr(z),
                 x2.numel() // h if h else 0, h, float(eps), int(vec),
                 stream)
    check(err, f"fused {kind}")
    _LAUNCHES[kind] += 1
    return y, (z if z is not None else x)


def _rms_fwd(x, residual, w, eps):
    if not x.is_cuda:
        return rms_fwd_reference(x, residual, w, eps)
    return _launch_norm("rms_norm", x, residual, (w,), eps)


def _rms_core_bwd(eps, z, w, gy, gres):
    """``_rms_core_bwd`` of the JAX package: (gx, gresidual, gw)."""
    z32 = z.float()
    gy32 = gy.float()
    w32 = w.float()
    ms = (z32 * z32).mean(-1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    xhat = z32 * rstd
    gw = (gy32 * xhat).sum(tuple(range(z32.ndim - 1)))
    gxhat = gy32 * w32
    gz = rstd * (gxhat - xhat * (gxhat * xhat).mean(-1, keepdim=True))
    gz = gz + (0.0 if gres is None else gres.float())
    gz = gz.to(z.dtype)
    return gz, gz, gw.to(w.dtype)


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        y, _ = _rms_fwd(x, None, w, eps)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, _, gw = _rms_core_bwd(ctx.eps, x, w, gy, None)
        return gx, gw, None


class _RmsNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, w, eps):
        y, z = _rms_fwd(x, residual, w, eps)
        ctx.save_for_backward(z, w)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return y, z

    @staticmethod
    def backward(ctx, gy, gres):
        z, w = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(z)
        gx, gr, gw = _rms_core_bwd(ctx.eps, z, w, gy, gres)
        return gx, gr, gw, None


def fused_rms_norm(x, w, eps=1e-6):
    """y = x / sqrt(mean(x^2) + eps) * w — one read + one write."""
    return _RmsNorm.apply(x, w, float(eps))


def fused_rms_norm_residual(x, residual, w, eps=1e-6):
    """z = x + residual; y = rmsnorm(z) * w. Returns (y, z) — z feeds the
    next residual branch (the fused_layernorm_residual pattern)."""
    return _RmsNormResidual.apply(x, residual, w, float(eps))


# -- LayerNorm ---------------------------------------------------------------

def ln_fwd_reference(x, residual, w, b, eps):
    """Plain version of the Pallas ``_ln_fwd_call``: returns ``(y, z)``,
    where ``z`` is ``x + residual`` rounded to x's type, or ``x`` itself;
    ``y`` is normalized from the fp32 sum (mean, then centred variance)."""
    x32 = x.float()
    if residual is not None:
        x32 = x32 + residual.float()
        z = x32.to(x.dtype)
    else:
        z = x
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return (xc * rstd * w.float() + b.float()).to(x.dtype), z


def _ln_fwd_call(x, residual, w, b, eps):
    if not x.is_cuda:
        return ln_fwd_reference(x, residual, w, b, eps)
    return _launch_norm("layer_norm", x, residual, (w, b), eps)


def _ln_core_bwd(eps, z, w, gy, gres):
    """``_ln_core_bwd`` of the JAX package: (gx, gresidual, gw, gb)."""
    z32 = z.float()
    gy32 = gy.float()
    w32 = w.float()
    mu = z32.mean(-1, keepdim=True)
    xc = z32 - mu
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    red = tuple(range(z32.ndim - 1))
    gw = (gy32 * xhat).sum(red)
    gb = gy32.sum(red)
    gxhat = gy32 * w32
    gz = rstd * (gxhat - gxhat.mean(-1, keepdim=True)
                 - xhat * (gxhat * xhat).mean(-1, keepdim=True))
    gz = gz + (0.0 if gres is None else gres.float())
    gz = gz.to(z.dtype)
    return gz, gz, gw.to(w.dtype), gb.to(w.dtype)


class _LnNores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        y, _ = _ln_fwd_call(x, None, w, b, eps)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, _, gw, gb = _ln_core_bwd(ctx.eps, x, w, gy, None)
        return gx, gw, gb, None


class _LnCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, w, b, eps):
        y, z = _ln_fwd_call(x, residual, w, b, eps)
        ctx.save_for_backward(z, w)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return y, z

    @staticmethod
    def backward(ctx, gy, gres):
        z, w = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(z)
        gx, gr, gw, gb = _ln_core_bwd(ctx.eps, z, w, gy, gres)
        return gx, gr, gw, gb, None


def fused_layer_norm(x, w, b, eps=1e-5):
    return _LnNores.apply(x, w, b, float(eps))


def fused_layer_norm_residual(x, residual, w, b, eps=1e-5):
    """z = x + residual; y = layernorm(z) * w + b. Returns (y, z)."""
    return _LnCore.apply(x, residual, w, b, float(eps))


# -- dropout -----------------------------------------------------------------

def _divisor(rate):
    """(1 - rate) as a float32, rounded once (JAX's weak-typed float)."""
    return float(np.float32(1.0 - float(rate)))


def _seed_bits(seed):
    return int(seed) & _M32


def dropout_keep(n, seed, rate, device):
    """The kernel's mask for ``n`` flat elements: bool [n], True where
    ``(low 24 bits of the index hash) / 2**24 >= rate`` (float32)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    s = _hash_mix(torch.tensor((_seed_bits(seed) + 0x9E3779B9) & _M32,
                               dtype=torch.int64, device=device))
    h = _hash_mix(_mul32(i & _M32, 0x9E3779B9)
                  ^ _mul32(i >> 32, 0x85EBCA6B) ^ s)
    u = (h & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    return u >= torch.tensor(float(rate), dtype=torch.float32,
                             device=device)


def dropout_reference(x, rate, seed):
    """Plain version of the kernel: ``x.f32 * keep / (1 - rate)`` in x's
    type, bit for bit (a correctly rounded division by a device tensor,
    never a multiplication by the reciprocal)."""
    keep = dropout_keep(x.numel(), seed, rate, x.device).view(x.shape)
    div = torch.tensor(_divisor(rate), dtype=torch.float32, device=x.device)
    return ((x.float() * keep.to(torch.float32)) / div).to(x.dtype)


def _launch_dropout(x, rate, seed):
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32/bfloat16, got {x.dtype}")
    x2 = x.contiguous()
    y = torch.empty_like(x2)
    vec = x2.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    from ._build import check, load
    fn = load("fused_norm").pt_dropout
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.restype = ci
    fn.argtypes = [ci, vp, vp, ctypes.c_longlong, ctypes.c_uint32,
                   ctypes.c_float, ctypes.c_float, ci, vp]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[x.dtype], x2.data_ptr(), y.data_ptr(), x2.numel(),
                 _seed_bits(seed), float(rate), _divisor(rate), int(vec),
                 stream)
    check(err, "fused dropout")
    _LAUNCHES["dropout"] += 1
    return y


def _fused_dropout(x, rate, seed):
    """One-pass inverted dropout, mask from (seed, flat index)."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in (0, 1), got {rate}")
    if not x.is_cuda:
        return dropout_reference(x, rate, seed)
    return _launch_dropout(x, rate, seed)


class _DropoutViaVjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        return _fused_dropout(x, rate, seed)

    @staticmethod
    def backward(ctx, gy):
        # inverted dropout is elementwise-linear: the cotangent is the same
        # kernel applied to gy, the mask regenerated from the seed
        return _fused_dropout(gy, ctx.rate, ctx.seed), None, None


def _dropout_via_vjp(x, rate, seed):
    return _DropoutViaVjp.apply(x, float(rate), int(seed))


def fused_rms_norm_residual_dropout(x, residual, w, eps=1e-6,
                                    dropout_rate=0.0, seed=0):
    """z = dropout(x) + residual; y = rmsnorm(z) * w. Returns (y, z)."""
    if dropout_rate > 0.0:
        x = _dropout_via_vjp(x, dropout_rate, seed)
    return _RmsNormResidual.apply(x, residual, w, float(eps))


def fused_layer_norm_residual_dropout(x, residual, w, b, eps=1e-5,
                                      dropout_rate=0.0, seed=0):
    """z = dropout(x) + residual; y = layernorm(z) * w + b. Returns
    (y, z)."""
    if dropout_rate > 0.0:
        x = _dropout_via_vjp(x, dropout_rate, seed)
    return _LnCore.apply(x, residual, w, b, float(eps))
