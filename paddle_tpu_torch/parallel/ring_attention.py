"""Ring attention over the 'sep' (sequence) mesh axis — the counterpart
of paddle_tpu/parallel/ring_attention.py (:34-130).

Each sep rank holds one sequence chunk of q, k and v. The K/V blocks go
around the ring, one ``ppermute`` hop per step (``n - 1`` hops of K and
of V, ``2 (n - 1)`` sends a call), while every rank folds each block into
an online softmax in float32 with causal masking by global positions: the
result is exact softmax(QK^T)V over the whole sequence, and no rank ever
holds more than one foreign K/V block (no gather of the sequence). The
GQA group is folded into the score einsum. Differentiable: the backward
of each hop is the reverse hop (``collective.ppermute``), so the backward
is itself a ring schedule.

The math is the reference's plain ``jnp`` (no Pallas kernel there), so
it stays plain PyTorch here; running each block through the flash kernel
is later speed work.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

from . import collective
from . import mesh as mesh_mod

__all__ = ["ring_attention"]

_NEG = -1e30  # finite mask value: keeps exp() well-defined for masked rows


def _ring_local(q, k, v, *, causal, sm_scale):
    """One ring over the sep ranks. q, k, v: lists over the ranks of
    [B, Tq, nh, hd] / [B, Tk, nkv, hd] local chunks (rank order = chunk
    order along T); returns the list of [B, Tq, nh, hd] outputs."""
    n = len(q)
    devices = [x.device for x in q]
    B, Tq, nh, hd = q[0].shape
    Tk, nkv = k[0].shape[1], k[0].shape[2]
    g = nh // nkv  # GQA group size; == 1 for MHA
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    perm = [(i, (i + 1) % n) for i in range(n)]
    qg = [x.reshape(B, Tq, nkv, g, hd) for x in q]
    o = [torch.zeros((B, Tq, nkv, g, hd), dtype=torch.float32, device=d)
         for d in devices]
    m = [torch.full((B, nkv, g, Tq), _NEG, dtype=torch.float32, device=d)
         for d in devices]
    l = [torch.zeros((B, nkv, g, Tq), dtype=torch.float32, device=d)
         for d in devices]
    k, v = list(k), list(v)
    for s in range(n):
        for i in range(n):
            j = (i - s) % n  # the rank whose K/V block rank i holds now
            # jnp.einsum(..., preferred_element_type=float32): bf16
            # products are exact in float32
            scores = torch.einsum("bqngd,bknd->bngqk", qg[i].float(),
                                  k[i].float()) * scale
            if causal:
                qpos = i * Tq + torch.arange(Tq, device=devices[i])
                kpos = j * Tk + torch.arange(Tk, device=devices[i])
                mask = qpos[:, None] >= kpos[None, :]
                scores = torch.where(mask, scores,
                                     torch.full((), _NEG,
                                                device=devices[i]))
            m_new = torch.maximum(m[i], scores.amax(-1))
            corr = torch.exp(m[i] - m_new)
            p = torch.exp(scores - m_new[..., None])
            l[i] = l[i] * corr + p.sum(-1)
            o[i] = o[i] * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bngqk,bknd->bqngd", p, v[i].float())
            m[i] = m_new
        if s < n - 1:
            k = collective.ppermute(k, perm, devices)
            v = collective.ppermute(v, perm, devices)
    return [(o[i] / l[i].permute(0, 3, 1, 2)[..., None]).reshape(
        B, Tq, nh, hd).to(q[i].dtype) for i in range(n)]


def ring_attention(q, k, v, axis: str = "sep", causal: bool = True,
                   sm_scale=None):
    """Exact full-sequence attention with K/V ring-circulated over `axis`.

    q, k, v: the ranks' local chunks along `axis`, as lists of
    [B, T_local, nh, hd] / [B, T_local, nkv, hd] tensors in rank order
    (one list entry per rank of the installed mesh's `axis`); returns the
    list of [B, T_local, nh, hd] outputs. A single tensor (not a list) is
    one rank's chunk: at `axis` size 1 that is the whole sequence, and
    the result is a tensor."""
    if isinstance(q, torch.Tensor):
        if mesh_mod.mesh_axis_size(axis) != 1:
            raise ValueError(f"ring_attention over a {axis!r} axis of "
                             f"{mesh_mod.mesh_axis_size(axis)} ranks takes "
                             f"one chunk per rank (lists)")
        return _ring_local([q], [k], [v], causal=causal,
                           sm_scale=sm_scale)[0]
    n = mesh_mod.mesh_axis_size(axis)
    if not len(q) == len(k) == len(v) == n:
        raise ValueError(f"{len(q)} q / {len(k)} k / {len(v)} v chunks for "
                         f"a {axis!r} axis of {n} ranks")
    return _ring_local(q, k, v, causal=causal, sm_scale=sm_scale)


def _dense_reference(q, k, v, causal=True, sm_scale=None):
    """O(T^2) single-device reference used by parity tests."""
    B, T, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, T, nkv, g, hd)
    scores = torch.einsum("bqngd,bknd->bngqk", qg.float(), k.float()) * scale
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, None, None], scores,
                             torch.full((), _NEG, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", probs, v.float())
    return out.reshape(B, T, nh, hd).to(q.dtype)
