"""Grouped GEMM for MoE experts on Hopper — the counterpart of
``paddle_tpu/ops/pallas/grouped_gemm.py``.

``gmm(lhs [M, K], rhs [E, K, N], block_expert int32 [M // block_m],
block_m)`` multiplies row ``m`` by ``rhs[block_expert[m // block_m]]``
with float32 accumulation (the megablox layout: every ``block_m`` rows
share one expert; ``make_group_metadata`` pads per-expert groups to it).

Dispatch: a CUDA tensor launches the hand-written kernel in
``csrc/grouped_gemm.cu`` (or raises); a CPU tensor takes the plain
PyTorch version ``gmm_reference``. The CUDA path never falls back. The
Pallas module's halving of ``block_n``/``block_k`` to divisors of N and
K is a TPU tiling limit: the kernel takes any K and N, and picks its own
tiles. No gradient: the Pallas ``gmm`` has none, and MoE serving calls
it without one.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

# launch count of the CUDA kernel (CPU calls run the plain version and
# are not counted)
_LAUNCHES = {"count": 0}


def launch_count() -> int:
    return _LAUNCHES["count"]


def reset_launch_count() -> None:
    _LAUNCHES["count"] = 0


def make_group_metadata(group_sizes, block_m=128):
    """Host-side helper: given per-expert token counts, produce
    (padded_offsets, block_expert, padded_total) for the gmm layout —
    each expert's rows start at a block_m multiple."""
    sizes = np.asarray(group_sizes)
    padded = ((sizes + block_m - 1) // block_m) * block_m
    offsets = np.concatenate([[0], np.cumsum(padded)])
    block_expert = np.repeat(np.arange(len(sizes)), padded // block_m)
    return offsets, block_expert.astype(np.int32), int(offsets[-1])


def gmm_reference(lhs, rhs, block_expert, block_m=128):
    """Plain version: gather each m-block's expert weight and multiply
    block by block in float32; the result in lhs's dtype."""
    be = torch.as_tensor(np.asarray(block_expert) if not isinstance(
        block_expert, torch.Tensor) else block_expert,
        device=lhs.device).long()
    blocks = lhs.float().reshape(-1, block_m, lhs.shape[-1])
    out = torch.bmm(blocks, rhs.float()[be])
    return out.reshape(lhs.shape[0], rhs.shape[-1]).to(lhs.dtype)


def _launch(lhs, rhs, be, block_m):
    M, K = lhs.shape
    E, _, N = rhs.shape
    from ._build import check, load, sm_count
    lib = load("grouped_gemm")
    out = torch.empty((M, N), dtype=torch.float32, device=lhs.device)
    if M == 0 or N == 0:
        return out
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    plan = lib.pt_gmm_plan
    plan.restype = None
    plan.argtypes = [ci, ci, ci, ci, ci, ci, ctypes.POINTER(ci),
                     ctypes.POINTER(ci)]
    kind, splits = ci(), ci()
    plan(M, K, N, E, block_m, sm_count(lhs.device), ctypes.byref(kind),
         ctypes.byref(splits))
    # partial tiles of a K split (summed in split order by the library)
    ws = torch.empty((splits.value, M, N), dtype=torch.float32,
                     device=lhs.device) if splits.value > 1 else None
    fn = lib.pt_gmm
    fn.restype = ci
    fn.argtypes = [vp, ll, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                   vp]
    vec = int(N % 4 == 0 and rhs.data_ptr() % 16 == 0)
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        err = fn(lhs.data_ptr(), lhs.stride(0), rhs.data_ptr(),
                 be.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), M, K, N, E,
                 block_m, kind.value, splits.value, vec, stream)
    check(err, "gmm")
    _LAUNCHES["count"] += 1
    return out


def gmm(lhs, rhs, block_expert, block_m=128):
    """lhs: [M, K] tokens grouped by expert and padded so each block_m
    rows share one expert. rhs: [E, K, N] expert weights. block_expert:
    int32 [M // block_m] expert id per m-block, each in [0, E) (a tensor
    on lhs's device avoids a host-to-device copy per call). Returns
    [M, N]."""
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"gmm takes lhs [M, K] and rhs [E, K, N], got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    M, K = lhs.shape
    if rhs.shape[1] != K:
        raise ValueError(f"inner dims differ: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)}")
    block_m = int(block_m)
    if block_m < 1 or M % block_m:
        raise ValueError(f"M = {M} is not a multiple of block_m = "
                         f"{block_m}")
    n_blocks = int(np.prod(np.shape(block_expert))) \
        if not isinstance(block_expert, torch.Tensor) \
        else block_expert.numel()
    if n_blocks != M // block_m:
        raise ValueError(f"block_expert holds {n_blocks} ids for "
                         f"{M // block_m} m-blocks")
    if not lhs.is_cuda:
        if rhs.is_cuda:
            raise ValueError("lhs and rhs must be on the same device")
        return gmm_reference(lhs, rhs, block_expert, block_m)
    if rhs.device != lhs.device:
        raise ValueError("lhs and rhs must be on the same device")
    if lhs.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 lhs and rhs, got "
                        f"{lhs.dtype} and {rhs.dtype}")
    if lhs.stride(1) != 1:
        raise ValueError("lhs's K axis must be contiguous")
    if not rhs.is_contiguous():
        raise ValueError("rhs must be contiguous")
    be = block_expert if isinstance(block_expert, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(block_expert, np.int32))
    be = be.to(device=lhs.device, dtype=torch.int32).contiguous()
    return _launch(lhs, rhs, be, block_m)
