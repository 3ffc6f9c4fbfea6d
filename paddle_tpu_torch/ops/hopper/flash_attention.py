"""Flash attention, forward and backward, for Hopper — the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``.

- ``_flash_fwd(q, k, v, causal, sm_scale, return_lse, dropout_rate,
  seed)``: q, k, v ``[BH, T, D]`` -> out ``[BH, t_q, D]`` (and lse
  ``[BH, t_q]`` float32): online-softmax attention, causal masking
  bottom-right for ``t_k >= t_q``, masked scores -1e30 (a fully masked
  row becomes uniform attention, as in Pallas), optional probability
  dropout from the position hash ``_keep_scale`` (bit for bit the JAX
  mask), the normalizer over the undropped probabilities.
- ``_flash_bwd(q, k, v, o, lse, do, causal, sm_scale, dropout_rate,
  seed)`` -> (dq, dk, dv): FlashAttention-2's backward from lse and
  ``delta = rowsum(dO * O)``, the same dropout mask.
- ``flash_attention_blhd(q, k, v, causal, sm_scale, dropout_rate,
  seed)``: differentiable, Paddle's ``[B, L, H, D]`` layout, read through
  its strides (no transposed copy). It keeps the JAX routing: causal
  with ``t_q > t_k`` goes to the dense ``_mha_reference`` (the kernels'
  backward zeroes fully masked rows that the forward makes uniform),
  dropout needs a seed, a rate of 1 returns zeros. The JAX function's
  branch to jax's tuned TPU kernel has no counterpart: the port has one
  kernel, its own, for every case.

Dispatch: CUDA tensors launch ``csrc/flash_attention.cu`` (head_dim 64
or 128; bfloat16 on wgmma kernels fed by TMA, float32 on SIMT kernels;
anything else raises); CPU tensors take the
plain versions ``flash_fwd_reference`` / ``flash_bwd_reference``, which
repeat the Pallas arithmetic: the forward's online softmax over key
blocks of the Pallas block width, lse, and the rounding of p (forward),
dS and P*mask (backward) to the input type before their products.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

# launch counts of the CUDA kernels (CPU calls are not counted); "bwd"
# counts backward calls, each of which runs the delta, dQ and dK/dV
# kernels of csrc/flash_attention.cu
_LAUNCHES = {"fwd": 0, "bwd": 0}


def launch_count(kind: str) -> int:
    """Launches of the "fwd" or "bwd" kernel so far."""
    return _LAUNCHES[kind]


def reset_launch_count() -> None:
    _LAUNCHES["fwd"] = _LAUNCHES["bwd"] = 0


# -- the position-hash dropout mask ------------------------------------
# JAX computes in int32 with wraparound and logical shifts; here the same
# bits are carried as non-negative int64 values below 2**32.
_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a constant c, in
    16-bit halves so no int64 product overflows."""
    c &= _M32
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash_mix(x):
    """The murmur3 finalizer of the JAX module's ``_hash_mix`` on uint32
    values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, -2048144789)      # 0x85ebca6b
    x = x ^ (x >> 13)
    x = _mul32(x, -1028477387)      # 0xc2b2ae35
    x = x ^ (x >> 16)
    return x


def _keep_scale(row, col, bh, seed, rate):
    """keep / (1 - rate) as float32 for each (row, col, bh) — the JAX
    module's ``_keep_scale`` bit for bit (``seed`` any int32 value,
    negative ones included)."""
    def u32(t):
        return torch.as_tensor(t, dtype=torch.int64) & _M32
    h = (_mul32(u32(row), -1640531527) ^ _mul32(u32(col), 1013904223)
         ^ _mul32(u32(bh), 374761393))
    h = (h + (int(seed) & _M32)) & _M32
    h = _hash_mix(h)
    u = (h & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return torch.where(u >= torch.tensor(rate, dtype=torch.float32),
                       keep, torch.zeros((), dtype=torch.float32))


def _drop_scale(bh_n, rows, cols, seed, rate, device):
    """[bh_n, len(rows), len(cols)] keep scales for absolute positions."""
    return _keep_scale(rows[None, :, None].to(device),
                       cols[None, None, :].to(device),
                       torch.arange(bh_n, device=device)[:, None, None],
                       seed, rate)


def _block_k(t_k, block_k=128):
    # the Pallas wrapper's key block: min(block_k, t_k rounded up to 16)
    return min(block_k, -(-t_k // 16) * 16)


# -- plain versions ------------------------------------------------------
def flash_fwd_reference(q, k, v, causal=False, sm_scale=None,
                        dropout_rate=0.0, seed=None):
    """Plain forward: (out [BH, t_q, D], lse [BH, t_q]), the Pallas
    kernel's online softmax over key blocks of its width."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float()
    off = t_k - t_q
    m = torch.full((bh, t_q, 1), NEG_INF, device=dev)
    l = torch.zeros((bh, t_q, 1), device=dev)
    acc = torch.zeros((bh, t_q, d), device=dev)
    rows = torch.arange(t_q, device=dev)
    bk = _block_k(t_k)
    for k0 in range(0, t_k, bk):
        kb = k[:, k0:k0 + bk].float()
        vb = v[:, k0:k0 + bk]
        cols = torch.arange(k0, k0 + kb.shape[1], device=dev)
        s = (qf @ kb.transpose(1, 2)) * scale
        if causal:
            s = torch.where(rows[:, None] + off >= cols[None, :], s,
                            torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        if dropout_rate > 0.0:
            p = p * _drop_scale(bh, rows, cols, seed, dropout_rate, dev)
        acc = acc * alpha + p.to(q.dtype).float() @ vb.float()
        m = m_new
    lc = l.clamp_min(1e-30)
    return (acc / lc).to(q.dtype), (m + torch.log(lc))[..., 0]


def flash_bwd_reference(q, k, v, o, lse, do, causal, sm_scale,
                        dropout_rate=0.0, seed=None):
    """Plain backward: (dq, dk, dv), the Pallas dq and dk/dv kernels'
    arithmetic on whole rows."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    dev = q.device
    dt = q.dtype
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    s = (q.float() @ k.float().transpose(1, 2)) * sm_scale
    rows = torch.arange(t_q, device=dev)
    cols = torch.arange(t_k, device=dev)
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        valid = rows[:, None] + (t_k - t_q) >= cols[None, :]
        p = torch.where(valid, p, torch.zeros((), device=dev))
    del s
    dp = do.float() @ v.float().transpose(1, 2)
    p_v = p
    if dropout_rate > 0.0:
        ks = _drop_scale(bh, rows, cols, seed, dropout_rate, dev)
        p_v = p * ks
        dp = dp * ks
        del ks
    ds = (p * (dp - delta) * sm_scale).to(dt).float()
    del dp
    dv = (p_v.to(dt).float().transpose(1, 2) @ do.float()).to(dt)
    dq = (ds @ k.float()).to(dt)
    dk = (ds.transpose(1, 2) @ q.float()).to(dt)
    return dq, dk, dv


def _mha_reference(q, k, v, causal, sm_scale, dropout_rate=0.0, seed=None):
    """Dense attention in [B, H, T, D] (the JAX module's ``_mha_jnp``)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and seed is not None:
        b, h, tq, tk = p.shape
        ks = _drop_scale(b * h, torch.arange(tq), torch.arange(tk), seed,
                         dropout_rate, q.device).reshape(b, h, tq, tk)
        p = (p * ks).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


# -- the kernels -------------------------------------------------------
def _loadable(t):
    """t itself when the kernel can read it (head_dim contiguous, the
    other strides and the base 16-byte friendly, no axis of extent > 1
    broadcast with stride 0, which a TMA tensor map does not take), else
    a contiguous copy."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s % 8 == 0 and (s > 0 or n == 1)
        for s, n in zip(t.stride()[:-1], t.shape[:-1]))
    return t if ok else t.contiguous()


def _strides(t):
    """(batch, head, position) strides of a [B, L, H, D] tensor."""
    return [t.stride(0), t.stride(2), t.stride(1)]


def _seed_bits(dropout_rate, seed):
    if dropout_rate <= 0.0:
        return 0.0, 1.0, 0
    return (float(dropout_rate), 1.0 / (1.0 - dropout_rate),
            int(seed) & _M32)


def _check_kernel_inputs(*ts):
    q = ts[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32/bfloat16, got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    for t in ts[1:]:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v (and o, dO) must share device and "
                             "dtype")


def _wgmma_probe(a, b, transpose_b):
    """The bf16 kernels' building blocks alone on one warpgroup (TMA into
    128-byte-swizzled tiles, wgmma descriptors, the accumulator and
    register-operand layouts), for a card test against ``torch.matmul``:
    ``a [64, 128] @ b.T`` for ``b [N, 128]`` (N 64 or 128; the score
    products' K-major operands) when ``transpose_b``, else ``a [64, R] @ b``
    for ``b [R, 128]`` (R 64 or 128; A from registers, b read MN-major as V
    in P.V). Returns float32 [64, N]."""
    a, b = a.contiguous(), b.contiguous()
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 \
            or not a.is_cuda:
        raise ValueError("the probe takes bfloat16 CUDA tensors")
    mode, n, rows = (0, b.shape[0], 64) if transpose_b else \
        (1, b.shape[1], b.shape[0])
    c = torch.empty((64, n), dtype=torch.float32, device=a.device)
    from ._build import check, load
    fn = load("flash_attention").pt_flash_wgmma_probe
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.restype = ci
    fn.argtypes = [ci, ci, ci, vp, vp, vp, vp]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(mode, n, rows, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 stream)
    check(err, "wgmma probe")
    return c


def _fwd_kernel(q, k, v, causal, scale, dropout_rate, seed):
    """q [B, t_q, H, D], k, v [B, t_k, H, D] (any strides, head_dim
    contiguous) -> (out [B, t_q, H, D], lse [B * H, t_q])."""
    _check_kernel_inputs(q, k, v)
    q, k, v = (_loadable(t) for t in (q, k, v))
    B, t_q, H, D = q.shape
    t_k = k.shape[1]
    out = torch.empty((B, t_q, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, t_q), dtype=torch.float32, device=q.device)
    rate, keep, bits = _seed_bits(dropout_rate, seed)
    st = (ctypes.c_longlong * 24)(*(_strides(q) + _strides(k) + _strides(v)
                                    + [0] * 6 + _strides(out) + [0] * 6))
    from ._build import check, load
    fn = load("flash_attention").pt_flash_fwd
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.restype = ci
    fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, ci,
                   cf, cf, ctypes.c_uint, vp]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse.data_ptr(), st, B, H,
                 t_q, t_k, float(scale), int(causal), rate, keep, bits,
                 stream)
    check(err, "flash attention forward")
    _LAUNCHES["fwd"] += 1
    return out, lse


def _bwd_kernel(q, k, v, o, lse, do, causal, scale, dropout_rate, seed):
    """The backward of ``_fwd_kernel`` in the same layout: (dq, dk, dv),
    each [B, T, H, D] contiguous."""
    _check_kernel_inputs(q, k, v, o, do)
    q, k, v, o, do = (_loadable(t) for t in (q, k, v, o, do))
    B, t_q, H, D = q.shape
    t_k = k.shape[1]
    lse = lse.float().contiguous()
    dq = torch.empty((B, t_q, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, t_k, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B * H, t_q), dtype=torch.float32, device=q.device)
    rate, keep, bits = _seed_bits(dropout_rate, seed)
    st = (ctypes.c_longlong * 24)(*(
        _strides(q) + _strides(k) + _strides(v) + _strides(o)
        + _strides(do) + _strides(dq) + _strides(dk) + _strides(dv)))
    from ._build import check, load
    fn = load("flash_attention").pt_flash_bwd
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.restype = ci
    fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                   ci, ci, ci, cf, ci, cf, cf, ctypes.c_uint, vp]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), st, B, H, t_q, t_k, float(scale),
                 int(causal), rate, keep, bits, stream)
    check(err, "flash attention backward")
    _LAUNCHES["bwd"] += 1
    if t_k and not t_q:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _flash_fwd(q, k, v, causal=False, sm_scale=None, return_lse=False,
               dropout_rate=0.0, seed=None):
    """q, k, v: [BH, T, D] -> o [BH, t_q, D] (and lse [BH, t_q])."""
    scale = _scale(q, sm_scale)
    if q.is_cuda:
        o, lse = _fwd_kernel(q[:, :, None], k[:, :, None], v[:, :, None],
                             causal, scale, dropout_rate, seed)
        o = o[:, :, 0]
    else:
        o, lse = flash_fwd_reference(q, k, v, causal, scale, dropout_rate,
                                     seed)
    return (o, lse) if return_lse else o


def _flash_bwd(q, k, v, o, lse, do, causal, sm_scale, dropout_rate=0.0,
               seed=None):
    """FlashAttention-2 backward. q, k, v, o, do: [BH, T, D]; lse:
    [BH, t_q]. Returns (dq, dk, dv)."""
    scale = _scale(q, sm_scale)
    if q.is_cuda:
        grads = _bwd_kernel(*(t[:, :, None] for t in (q, k, v, o)), lse,
                            do[:, :, None], causal, scale, dropout_rate,
                            seed)
        return tuple(g[:, :, 0] for g in grads)
    return flash_bwd_reference(q, k, v, o, lse, do, causal, scale,
                               dropout_rate, seed)


def _to_bhtd(t):
    B, L, H, D = t.shape
    return t.transpose(1, 2).reshape(B * H, L, D)


def _from_bhtd(t, B, H):
    BH, L, D = t.shape
    return t.reshape(B, H, L, D).transpose(1, 2)


def _fwd_blhd(q, k, v, causal, scale, dropout_rate, seed):
    """(out [B, t_q, H, D], lse [B * H, t_q]): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return _fwd_kernel(q, k, v, causal, scale, dropout_rate, seed)
    o, lse = flash_fwd_reference(_to_bhtd(q), _to_bhtd(k), _to_bhtd(v),
                                 causal, scale, dropout_rate, seed)
    return _from_bhtd(o, q.shape[0], q.shape[2]), lse


def _bwd_blhd(q, k, v, o, lse, do, causal, scale, dropout_rate, seed):
    """(dq, dk, dv) in [B, T, H, D]: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.is_cuda:
        return _bwd_kernel(q, k, v, o, lse, do, causal, scale, dropout_rate,
                           seed)
    grads = flash_bwd_reference(*(_to_bhtd(t) for t in (q, k, v, o)), lse,
                                _to_bhtd(do), causal, scale, dropout_rate,
                                seed)
    return tuple(_from_bhtd(g, q.shape[0], q.shape[2]) for g in grads)


class _FlashBLHD(torch.autograd.Function):
    """The kernel pair as one differentiable op in [B, L, H, D]."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_rate, seed):
        o, lse = _fwd_blhd(q, k, v, causal, scale, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, dropout_rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return _bwd_blhd(q, k, v, o, lse, do, *ctx.args) + (None,) * 4


def flash_attention_blhd(q, k, v, causal=False, sm_scale=None,
                         dropout_rate=0.0, seed=None):
    """Differentiable flash attention, Paddle layout [B, L, H, D].
    dropout_rate > 0 applies in-kernel attention-probability dropout
    (needs an int32 ``seed``)."""
    scale = _scale(q, sm_scale)
    if dropout_rate > 0.0:
        if not 0.0 < dropout_rate < 1.0:
            # rate 1.0 drops every probability: the output is zeros
            return torch.zeros_like(q)
        if seed is None:
            raise ValueError(
                "flash_attention_blhd: dropout_rate > 0 needs a seed")
    if causal and q.shape[1] > k.shape[1]:
        # t_q > t_k causal has fully masked rows whose forward degrades to
        # uniform attention; the kernels' backward zeroes them instead, so
        # take the dense path, where autograd matches the primal exactly
        # (with the kernels' position-hash dropout mask)
        out = _mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), True, scale,
                             dropout_rate=dropout_rate,
                             seed=None if dropout_rate == 0.0 else seed)
        return out.transpose(1, 2)
    return _FlashBLHD.apply(q, k, v, bool(causal), float(scale),
                            float(dropout_rate), seed)
