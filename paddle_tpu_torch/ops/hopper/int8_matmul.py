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

One launch a call: where column strips and row tiles leave SMs idle, the
kernel splits K over a thread-block cluster of up to 8 blocks and sums
the splits inside the launch; ``w8a16_tiling`` chooses the row tile and
the split on the host from the shapes and the SM count alone.

Gradient: the CUDA path is a ``torch.autograd.Function`` whose backward
is the plain contraction ``g @ w.float().T`` — the JAX package's
``_w8a16_bwd`` is an XLA contraction, not a Pallas kernel. The int8
weight gets no gradient.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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


# the kernel's tiling (csrc/int8_matmul.cu, checked at library load):
# output columns a block, K positions a ring stage, and the most blocks
# of one cluster (the K splits of a column strip); rows a block:
# ``row_tile``
BLOCK_N, BLOCK_K, MAX_SPLITS = 64, 128, 8
_LIB = {}


def row_tile(M: int) -> int:
    """Rows a block of the kernel holds for an M-row call: 1, 2, 4 or 8
    up to 8 rows (decode; fp32 FMA), 16 up to 16 (a verify batch), else
    32 (the tensor cores). Up to 32 rows, one row tile: each weight byte
    is read once."""
    for t in (1, 2, 4, 8, 16):
        if M <= t:
            return t
    return 32


def w8a16_tiling(M: int, K: int, N: int, sms: int) -> Tuple[int, int, int]:
    """(rows a block, splits, per): the kernel's tiling of an [M, K] x
    [K, N] call on a card of ``sms`` SMs. Split z takes K tiles (of
    BLOCK_K positions) [z per, min(tiles, (z + 1) per)). Enough splits for
    about one block an SM (at most MAX_SPLITS, a cluster), each owning at
    least one tile; 1 where the column strips and row tiles alone fill
    the SMs."""
    tm = row_tile(M)
    blocks = -(-N // BLOCK_N) * -(-M // tm)
    k_tiles = -(-K // BLOCK_K)
    want = 1 if blocks >= sms else -(-sms // blocks)
    splits = max(1, min(MAX_SPLITS, k_tiles, want))
    per = -(-k_tiles // splits)
    return tm, -(-k_tiles // per), per


def _lib():
    """The library, its tiling checked against this module's at first
    load (the host split and the kernel must cut K alike)."""
    lib = _LIB.get("lib")
    if lib is None:
        from ._build import load
        lib = load("int8_matmul")
        got = (lib.pt_w8a16_block_n(), lib.pt_w8a16_block_k(),
               lib.pt_w8a16_max_splits())
        want = (BLOCK_N, BLOCK_K, MAX_SPLITS)
        if got != want:
            raise RuntimeError(f"csrc/int8_matmul.cu tiles by {got}, this "
                               f"module by {want}")
        fn = lib.pt_w8a16_matmul
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.restype = ci
        fn.argtypes = [ci, vp, ll, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        _LIB["lib"] = lib
    return lib


def _launch(x, w_int8):
    M, K = x.shape
    N = w_int8.shape[1]
    from ._build import check, sm_count
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = _lib()
    tm, splits, per = w8a16_tiling(M, K, N, sm_count(x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_w8a16_matmul(_DTYPES[x.dtype], x.data_ptr(),
                                  x.stride(0), w_int8.data_ptr(),
                                  out.data_ptr(), M, K, N, tm, splits, per,
                                  stream)
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
