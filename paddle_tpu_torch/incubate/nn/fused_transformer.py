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

``FusedMultiTransformerInt8`` (counterpart of the JAX class of the same
name) stores the four projections of every layer as int8 with
per-output-channel scales and runs them through
``quantization.quantized_matmul`` (the w8a16 kernel on CUDA).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from ...framework.unported import require_defaults
from ...nn import functional as F
from ...nn.layer import LayerNorm, Linear
from ...ops.hopper.decode_attention import decode_attention

__all__ = ["FusedMultiTransformer", "FusedMultiTransformerInt8"]


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
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None,
                 epsilon=1e-5, num_layers=1, nranks=1, trans_qkvw=True,
                 ring_id=-1, name=None, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        # the reference's order; dropout, parameter attributes and tensor
        # parallelism are not ported (``name`` is accepted and unused)
        attrs = (ln_scale_attrs, ln_bias_attrs, qkv_weight_attrs,
                 qkv_bias_attrs, linear_weight_attrs, linear_bias_attrs,
                 ffn_ln_scale_attrs, ffn_ln_bias_attrs, ffn1_weight_attrs,
                 ffn1_bias_attrs, ffn2_weight_attrs, ffn2_bias_attrs)
        require_defaults(type(self).__name__,
                         dropout_rate=(dropout_rate, 0.0),
                         attrs=(None if all(x is None for x in attrs)
                                else attrs, None),
                         nranks=(nranks, 1), trans_qkvw=(trans_qkvw, True),
                         ring_id=(ring_id, -1))
        if num_layers == -1:          # the reference's "from the attrs"
            num_layers = 1
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

    def truncated(self, num_layers):
        """First-``num_layers`` twin sharing this stack's block modules,
        and so its Parameters (no copy): the cheapest speculative
        draft."""
        if not (0 < num_layers <= self.num_layers):
            raise ValueError(f"num_layers must be in [1, {self.num_layers}]")
        twin = self._empty_twin()
        twin.layers = torch.nn.ModuleList(self.layers[:num_layers])
        twin.num_layers = int(num_layers)
        return twin

    def _empty_twin(self):
        """A stack of this configuration with no layers (``truncated``
        hands it this stack's blocks)."""
        return FusedMultiTransformer(
            self.embed_dim, self.num_heads, 0, activation=self._act_name,
            normalize_before=self.normalize_before, num_layers=0,
            device=self.device)

    def _proj(self, i, blk, name, x):
        """Linear-projection seam (FusedMultiTransformerInt8 overrides
        it)."""
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


_PROJ = ("qkv", "out_proj", "ffn1", "ffn2")


class FusedMultiTransformerInt8(FusedMultiTransformer):
    """Int8 weight-quantized decoder stack: per-output-channel abs-max
    int8 weights for the four projections of every layer, float
    activations (weight-only). Construct with float weights (same
    signature as FusedMultiTransformer) and call ``quantize_weights()``,
    or build from a float model with ``from_float(model)``. The forward
    schedule is inherited; only ``_proj`` changes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._quantized = False
        self._bits = 8

    def quantize_weights(self, bits=8):
        """Snapshot int8 weights and DROP the float projection weights.
        The int8 weights and their scales become buffers
        (``weight_int8`` [in, out] int8, ``weight_scale`` [out] float32)
        on each projection, so ``state_dict`` carries the quantized
        model under the JAX class's names."""
        from ...quantization.functional import quantize
        if self._quantized:
            raise RuntimeError(
                "already quantized: the float weights were dropped at "
                "quantize time; rebuild via from_float(model, bits=...)")
        self._bits = int(bits)
        with torch.no_grad():
            for blk in self.layers:
                for name in _PROJ:
                    lin = getattr(blk, name)
                    w = lin.weight.detach()
                    # all-zero channels would give scale 0 -> NaN int8
                    scale = torch.clamp_min(w.abs().amax(dim=0), 1e-8)
                    wq = quantize(w, scale, bits=bits, axis=-1)
                    del lin.weight
                    lin.register_buffer("weight_int8", wq)
                    lin.register_buffer("weight_scale", scale)
        self._quantized = True
        return self

    @classmethod
    def from_float(cls, model: FusedMultiTransformer, bits: int = 8):
        """Quantized copy of a float model (the source stays as it is)."""
        m = cls(model.embed_dim, model.num_heads,
                model.layers[0].ffn1.weight.shape[1],
                activation=model._act_name,
                normalize_before=model.normalize_before,
                epsilon=model.layers[0].ln._epsilon,
                num_layers=model.num_layers, device=model.device)
        m.load_state_dict(model.state_dict())
        return m.quantize_weights(bits=bits)

    def _empty_twin(self):
        twin = FusedMultiTransformerInt8(
            self.embed_dim, self.num_heads, 0, activation=self._act_name,
            normalize_before=self.normalize_before, num_layers=0,
            device=self.device)
        twin._quantized, twin._bits = self._quantized, self._bits
        return twin

    def _proj(self, i, blk, name, x):
        if not self._quantized:
            raise RuntimeError("call quantize_weights() (or from_float) "
                               "before forward")
        from ...quantization.functional import quantized_matmul
        lin = getattr(blk, name)
        out = quantized_matmul(x, lin.weight_int8, lin.weight_scale,
                               bits=self._bits, out_dtype=x.dtype)
        return out + lin.bias
