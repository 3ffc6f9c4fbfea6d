"""Weight-only int8 matmul (w8a16) for Hopper — the counterpart of
``paddle_tpu/ops/pallas/int8_matmul.py``.

``w8a16_matmul(x [M, K] float32|bfloat16, w int8 [K, N]) -> float32
[M, N]`` is the UNSCALED product with fp32 accumulation: the caller
multiplies by the per-output-channel ``scale / qmax``
(``quantization.functional.quantized_matmul``), as the JAX package does.

Dispatch: a CUDA tensor launches the hand-written kernel in
``csrc/int8_matmul.cu`` (or raises); a CPU tensor takes the plain PyTorch
version ``w8a16_matmul_reference``. The CUDA path never falls back. The
Pallas module's tiling conditions (K and N multiples of its block sizes)
are TPU limits: the kernel takes any K and N.

Gradient: the CUDA path is a ``torch.autograd.Function`` whose backward
is the plain contraction ``g @ w.float().T`` — the JAX package's
``_w8a16_bwd`` is an XLA contraction, not a Pallas kernel. The int8
weight gets no gradient.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# SMs per device index (the split-K policy sizes the grid by it)
_SMS: Dict[int, int] = {}

# launch count of the CUDA kernel (CPU calls run the plain version and
# are not counted)
_LAUNCHES = {"count": 0}


def launch_count() -> int:
    return _LAUNCHES["count"]


def reset_launch_count() -> None:
    _LAUNCHES["count"] = 0


def w8a16_matmul_reference(x, w_int8):
    """Plain version: cast both operands to float32 and multiply."""
    return x.float() @ w_int8.float()


def _launch(x, w_int8):
    M, K = x.shape
    N = w_int8.shape[1]
    from ._build import check, load
    lib = load("int8_matmul")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.pt_w8a16_splits.restype = ci
    lib.pt_w8a16_splits.argtypes = [ci, ci, ci, ci]
    idx = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    splits = lib.pt_w8a16_splits(M, K, N, _SMS[idx])
    # partial tiles of a K split (summed in split order by the library)
    ws = torch.empty((splits, M, N), dtype=torch.float32,
                     device=x.device) if splits > 1 else None
    fn = lib.pt_w8a16_matmul
    fn.restype = ci
    fn.argtypes = [ci, vp, ll, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    vec = int(N % 4 == 0 and w_int8.data_ptr() % 4 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[x.dtype], x.data_ptr(), x.stride(0),
                 w_int8.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), M, K, N, splits,
                 vec, stream)
    check(err, "w8a16_matmul")
    _LAUNCHES["count"] += 1
    return out


class _W8A16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_int8):
        ctx.save_for_backward(w_int8)
        ctx.x_dtype = x.dtype
        return _launch(x, w_int8)

    @staticmethod
    def backward(ctx, g):
        (w_int8,) = ctx.saved_tensors
        return (g @ w_int8.float().T).to(ctx.x_dtype), None


def w8a16_matmul(x, w_int8):
    """x [M, K] float32/bfloat16 @ w_int8 [K, N] -> float32 [M, N],
    unscaled. Differentiable with respect to x."""
    if x.dim() != 2 or w_int8.dim() != 2:
        raise ValueError(f"w8a16_matmul takes x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w_int8.shape)}")
    if x.shape[1] != w_int8.shape[0]:
        raise ValueError(f"inner dims differ: x {tuple(x.shape)}, w "
                         f"{tuple(w_int8.shape)}")
    if w_int8.dtype != torch.int8:
        raise TypeError(f"weight must be int8, got {w_int8.dtype}")
    if not x.is_cuda:
        if w_int8.is_cuda:
            raise ValueError("x and w must be on the same device")
        return w8a16_matmul_reference(x, w_int8)
    if w_int8.device != x.device:
        raise ValueError("x and w must be on the same device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32/bfloat16 x, got {x.dtype}")
    if x.stride(1) != 1:
        raise ValueError("x's K axis must be contiguous")
    if not w_int8.is_contiguous():
        raise ValueError("w must be contiguous")
    if torch.is_grad_enabled() and x.requires_grad:
        return _W8A16.apply(x, w_int8)
    return _launch(x, w_int8)           # serving: no autograd record
