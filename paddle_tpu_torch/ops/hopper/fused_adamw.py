"""Fused AdamW update for Hopper — the counterpart of
``paddle_tpu/ops/pallas/fused_adamw.py``.

``fused_adamw_update(p, g, m, v, master, lr, beta1, beta2, eps, wd, step)
-> (p, m, v, master)`` keeps the JAX signature and return order. The JAX
function returns new arrays; this one updates ``p``, ``m``, ``v`` and
``master`` IN PLACE (one read and one write of each buffer, and no second
copy of the optimizer state) and returns those same tensors. ``p`` and
``g`` are float32 or bfloat16, ``m``, ``v`` and ``master`` float32, all of
one shape and contiguous.

The scalars travel as one 7-float device tensor in the Pallas kernel's
order (lr, b1, b2, eps, wd, bc1, bc2), the bias corrections
``1 - beta^step`` computed in float32 as JAX does.

Dispatch: a CUDA tensor launches ``csrc/fused_adamw.cu`` (or raises); a
CPU tensor takes the plain version ``fused_adamw_reference``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launch count of the CUDA kernel (CPU calls are not counted)
_LAUNCHES = {"count": 0}


def launch_count() -> int:
    return _LAUNCHES["count"]


def reset_launch_count() -> None:
    _LAUNCHES["count"] = 0


def adamw_scalars(lr, beta1, beta2, eps, wd, step, device):
    """The 7 float32 scalars of the Pallas kernel as a tensor on
    ``device``: lr, b1, b2, eps, wd, 1 - b1^step, 1 - b2^step."""
    f = np.float32
    step_f = f(step)
    vals = np.array([lr, beta1, beta2, eps, wd,
                     f(1.0) - f(beta1) ** step_f,
                     f(1.0) - f(beta2) ** step_f], np.float32)
    return torch.from_numpy(vals).to(device)


def fused_adamw_reference(p, g, m, v, master, scal):
    """Plain version of ``_adamw_kernel``, in place, in its order."""
    lr, b1, b2, eps, wd, bc1, bc2 = scal.unbind()
    g32 = g.float()
    m.mul_(b1).add_((1.0 - b1) * g32)
    v.mul_(b2).add_((1.0 - b2) * g32 * g32)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * master
    master.sub_(lr * upd)
    p.copy_(master)
    return p, m, v, master


def _check(p, g, m, v, master):
    if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32/bfloat16 p and g, got "
                        f"{p.dtype} / {g.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v), ("master", master)):
        if t.device != p.device or t.shape != p.shape:
            raise ValueError(f"{name} must match p's device and shape")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("m", m), ("v", v), ("master", master)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")


def fused_adamw_update(p, g, m, v, master, lr, beta1, beta2, eps, wd,
                       step, scal=None):
    """One AdamW step over one parameter, in place; returns (p, m, v,
    master). ``scal``: the scalars from ``adamw_scalars`` when the caller
    shares one tensor across parameters (built here otherwise)."""
    _check(p, g, m, v, master)
    if scal is None:
        scal = adamw_scalars(lr, beta1, beta2, eps, wd, step, p.device)
    if not p.is_cuda:
        return fused_adamw_reference(p, g, m, v, master, scal)
    if scal.device != p.device or scal.dtype != torch.float32 or \
            scal.shape != (7,):
        raise ValueError("scal must be 7 float32 on p's device")
    n = p.numel()
    vec = all(t.data_ptr() % 16 == 0 for t in (p, g, m, v, master))
    from ._build import check, load, sm_count
    lib = load("fused_adamw")
    fn = lib.pt_fused_adamw
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.restype = ci
    fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ci,
                   ci, vp]
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(_DTYPES[p.dtype], _DTYPES[g.dtype], p.data_ptr(),
                 g.data_ptr(), m.data_ptr(), v.data_ptr(), master.data_ptr(),
                 scal.data_ptr(), n, int(vec), sm_count(p.device), stream)
    check(err, "fused_adamw_update")
    _LAUNCHES["count"] += 1
    return p, m, v, master
