"""Fused RMSNorm (optionally after a residual add) for Hopper — the
counterpart of ``_rms_fwd`` in ``paddle_tpu/ops/pallas/fused_norm.py``.

``fused_rms_norm(x, w, eps)`` gives ``y = x * rsqrt(mean(x^2) + eps) * w``;
``fused_rms_norm_residual(x, residual, w, eps)`` gives ``(y, z)`` with
``z = x + residual`` (rounded to the input type: the next residual
stream) and ``y`` normalized from the fp32 ``z``. Both are
``torch.autograd.Function``s: the forward is the kernel, the backward is
plain PyTorch, line for line the JAX package's ``_rms_core_bwd`` (a jnp
backward there too), working from the saved, rounded ``z``.

Dispatch: a CUDA tensor launches ``csrc/fused_norm.cu`` (or raises); a
CPU tensor takes the plain version ``rms_fwd_reference``. One launch
counter serves both entry points.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launch count of the CUDA kernel (CPU calls are not counted)
_LAUNCHES = {"count": 0}


def launch_count() -> int:
    return _LAUNCHES["count"]


def reset_launch_count() -> None:
    _LAUNCHES["count"] = 0


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


def _launch(x, residual, w, eps):
    h = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32/bfloat16, got {x.dtype}")
    for name, t in (("residual", residual), ("w", w)):
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise ValueError(f"{name} must match x's device and dtype")
    if w.shape != (h,):
        raise ValueError(f"w must be [{h}], got {tuple(w.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError("residual must match x's shape")
    x2 = x.contiguous()
    r2 = residual.contiguous() if residual is not None else None
    w2 = w.contiguous()
    y = torch.empty_like(x2)
    z = torch.empty_like(x2) if residual is not None else None
    ts = [t for t in (x2, r2, w2, y, z) if t is not None]
    n_vec = 16 // x.element_size()
    vec = h % n_vec == 0 and all(t.data_ptr() % 16 == 0 for t in ts)
    from ._build import check, load
    lib = load("fused_norm")
    fn = lib.pt_rms_norm
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.restype = ci
    fn.argtypes = [ci, vp, vp, vp, vp, vp, ctypes.c_longlong, ci,
                   ctypes.c_float, ci, vp]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[x.dtype], x2.data_ptr(),
                 r2.data_ptr() if r2 is not None else None, w2.data_ptr(),
                 y.data_ptr(), z.data_ptr() if z is not None else None,
                 x2.numel() // h if h else 0, h, float(eps), int(vec),
                 stream)
    check(err, "fused_rms_norm")
    _LAUNCHES["count"] += 1
    return y, (z if z is not None else x)


def _rms_fwd(x, residual, w, eps):
    if not x.is_cuda:
        return rms_fwd_reference(x, residual, w, eps)
    return _launch(x, residual, w, eps)


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
