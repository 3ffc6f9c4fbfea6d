"""Fused decoder stack with preallocated or paged KV caches (counterpart
of paddle_tpu/incubate/nn/fused_transformer.py ``FusedMultiTransformer``).

``forward(src, caches=..., time_step=...)`` speaks the same cache
protocol as the JAX class:

* ``caches`` of paged views (``is_paged``, inference/paged_cache.py):
  each layer's view appends K/V through its block table and returns the
  attention — the ragged paged-attention kernel on CUDA, its plain
  version on the CPU;
* dense per-layer caches ``[2, B, H, max_len, D]`` (``gen_cache``): the
  step's K/V are written IN PLACE into the cache (the JAX class returns
  updated copies; here ``new_caches`` holds the same tensors), then a
  one-token step attends through the decode-attention kernel on CUDA
  (plain version on the CPU), and a multi-token step (a prompt prefill)
  through the masked attention functional over the cache's full extent
  — one reduction extent for every prompt length;
* ``caches=None``: causal (or ``attn_mask``) attention over the call's
  own rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layer import LayerNorm, Linear
from ...ops.hopper.decode_attention import decode_attention

__all__ = ["FusedMultiTransformer"]


class _Block(torch.nn.Module):
    def __init__(self, d, ffn, eps, **kw):
        super().__init__()
        gen = kw.pop("generator")
        self.ln = LayerNorm(d, eps, **kw)
        self.qkv = Linear(d, 3 * d, generator=gen, **kw)
        self.out_proj = Linear(d, d, generator=gen, **kw)
        self.ffn_ln = LayerNorm(d, eps, **kw)
        self.ffn1 = Linear(d, ffn, generator=gen, **kw)
        self.ffn2 = Linear(ffn, d, generator=gen, **kw)


class FusedMultiTransformer(torch.nn.Module):
    """Pre-LN (default) decoder stack: per layer ``ln -> qkv -> attention
    -> out_proj -> +residual -> ffn_ln -> ffn1 -> act -> ffn2 ->
    +residual``. Parameter names match the JAX class's ``state_dict``
    (``layers.{i}.{ln,qkv,out_proj,ffn_ln,ffn1,ffn2}.{weight,bias}``,
    Linear weights [in, out]), so weights move across by name
    (paddle_tpu_torch/weights.py)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 activation="gelu", normalize_before=True, epsilon=1e-5,
                 num_layers=1, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.device = resolve_device(device)
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.head_dim = self.embed_dim // self.num_heads
        self.num_layers = int(num_layers)
        self.normalize_before = bool(normalize_before)
        self._act_name = activation
        self.activation = getattr(F, activation)
        self.layers = torch.nn.ModuleList(
            _Block(self.embed_dim, dim_feedforward, epsilon,
                   device=self.device, dtype=dtype, generator=generator)
            for _ in range(self.num_layers))

    def gen_cache(self, batch, max_len, dtype=torch.float32):
        """Dense per-layer caches [2, batch, H, max_len, D]; max_len is
        rounded up to a multiple of 128 past 128, as the JAX class does
        for its 128-wide decode blocks."""
        if max_len > 128:
            max_len = -(-max_len // 128) * 128
        return [torch.zeros((2, batch, self.num_heads, max_len,
                             self.head_dim), dtype=dtype,
                            device=self.device)
                for _ in range(self.num_layers)]

    def gen_paged_cache(self, block_size, num_blocks, max_seqs,
                        max_blocks_per_seq=None, dtype=torch.float32,
                        prefix_cache=False):
        """Block-paged alternative to gen_cache: a PagedKVCache whose
        ``views`` ride in the same ``caches=`` argument."""
        from ...inference.paged_cache import PagedKVCache
        return PagedKVCache.for_model(
            self, block_size, num_blocks, max_seqs,
            max_blocks_per_seq=max_blocks_per_seq, dtype=dtype,
            prefix_cache=prefix_cache)

    def _proj(self, i, blk, name, x):
        """Linear-projection seam (the JAX int8 subclass overrides it)."""
        return getattr(blk, name)(x)

    def _ffn_block(self, i, blk, x):
        """Post-attention FFN sub-block, residual and LN included (the
        seam an MoE core overrides)."""
        residual = x
        h = blk.ffn_ln(x) if self.normalize_before else x
        h = self._proj(i, blk, "ffn2", self.activation(
            self._proj(i, blk, "ffn1", h)))
        x = residual + h
        if not self.normalize_before:
            x = blk.ffn_ln(x)
        return x

    def _dense_step(self, cache, q, k, v, time_step):
        """Dense-cache branch: write k/v [b, l, H, D] at each row's
        time step into ``cache`` in place, then attend."""
        b, l = q.shape[0], q.shape[1]
        tv = time_step.cpu().numpy() if isinstance(
            time_step, torch.Tensor) else np.asarray(time_step)
        tv = tv.astype(np.int64)
        # per-row positions only for a [b] vector with b > 1 (the JAX
        # class keeps a shape-[1] time_step a scalar)
        ragged = tv.ndim == 1 and b > 1 and tv.shape[0] == b
        rows = np.broadcast_to(tv.reshape(-1) if ragged
                               else tv.reshape(()), (b,))
        dev = cache.device
        t = torch.tensor(rows, device=dev)
        pos = t[:, None] + torch.arange(l, device=dev)[None]       # [b, l]
        bi = torch.arange(b, device=dev)[:, None].expand(b, l)
        cache[0][bi, :, pos, :] = k.to(cache.dtype)
        cache[1][bi, :, pos, :] = v.to(cache.dtype)
        kc = cache[0].transpose(1, 2)                  # [B, S, H, D] views
        vc = cache[1].transpose(1, 2)
        if l == 1:
            return decode_attention(q[:, 0], kc, vc,
                                    (t + 1).to(torch.int32))[:, None]
        # the full extent with a per-row validity mask
        S = kc.shape[1]
        qpos = t[:, None, None, None] + torch.arange(l, device=dev)[
            None, None, :, None]
        kpos = torch.arange(S, device=dev)[None, None, None, :]
        mask = torch.where(kpos <= qpos, 0.0, -1e30)      # additive
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)

    def forward(self, src, attn_mask=None, caches=None, time_step=None):
        x = src
        b, l = x.shape[0], x.shape[1]
        H, D = self.num_heads, self.head_dim
        new_caches = [] if caches is not None else None
        for i, blk in enumerate(self.layers):
            residual = x
            h = blk.ln(x) if self.normalize_before else x
            q, k, v = self._proj(i, blk, "qkv", h).split(self.embed_dim,
                                                        dim=-1)
            q = q.reshape(b, l, H, D)
            k = k.reshape(b, l, H, D)
            v = v.reshape(b, l, H, D)
            if caches is not None and time_step is not None and \
                    getattr(caches[i], "is_paged", False):
                # paged-cache protocol: the view appends through its
                # block table and attends over the sequence's pages
                attn = caches[i].decode(q, k, v, time_step)
                new_caches.append(caches[i])
            elif caches is not None and time_step is not None:
                attn = self._dense_step(caches[i], q, k, v, time_step)
                new_caches.append(caches[i])
            else:
                attn = F.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask,
                    is_causal=attn_mask is None)
                if caches is not None:
                    new_caches.append(caches[i])
            attn = self._proj(i, blk, "out_proj",
                              attn.reshape(b, l, self.embed_dim))
            x = residual + attn
            if not self.normalize_before:
                x = blk.ln(x)
            x = self._ffn_block(i, blk, x)
        if caches is not None:
            return x, new_caches
        return x
