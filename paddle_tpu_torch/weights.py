"""Weights from the JAX package, handed over as numpy arrays.

``fused_multi_transformer`` builds the port's FusedMultiTransformer from
a JAX ``FusedMultiTransformer.state_dict()`` given as ``{name:
np.ndarray}`` (the caller converts: ``{k: v.numpy() for k, v in
model.state_dict().items()}``) — or a FusedMultiTransformerInt8 from the
state of a quantized JAX model, whose projections carry
``weight_int8``/``weight_scale`` buffers instead of ``weight``;
``token_serving_model`` wraps it with an embedding table (and an
optional untied head, or the JAX model's own int8 head). Names and
layouts are the same in both packages (Linear weights [in, out]), so the
copy is by name and the int8 bytes are taken as they are, never
re-quantized. This module never imports JAX: the caller hands it numpy.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .incubate.nn import FusedMultiTransformer, FusedMultiTransformerInt8
from .inference.speculative import TokenServingModel

__all__ = ["fused_multi_transformer", "token_serving_model"]


def fused_multi_transformer(state: Dict[str, np.ndarray], num_heads: int,
                            *, activation: str = "gelu",
                            normalize_before: bool = True,
                            epsilon: float = 1e-5, bits: int = 8,
                            device=None) -> FusedMultiTransformer:
    """Port model holding ``state``'s parameters (geometry read off the
    shapes; ``num_heads`` and the options are not in a state dict). A
    state with ``weight_int8`` projections gives a
    FusedMultiTransformerInt8 (``bits`` is the JAX model's bit width)."""
    quant = "layers.0.qkv.weight_int8" in state
    w = "weight_int8" if quant else "weight"
    layers = {int(m.group(1)) for k in state
              if (m := re.match(rf"layers\.(\d+)\.qkv\.{w}$", k))}
    if not layers or layers != set(range(len(layers))):
        raise ValueError(f"state holds no layers.{{i}}.qkv.{w} sequence")
    d = state[f"layers.0.qkv.{w}"].shape[0]
    ffn = state[f"layers.0.ffn1.{w}"].shape[1]
    cls = FusedMultiTransformerInt8 if quant else FusedMultiTransformer
    model = cls(d, num_heads, ffn, activation=activation,
                normalize_before=normalize_before, epsilon=epsilon,
                num_layers=len(layers), device=device)
    if quant:
        # the buffers to load into: quantize the random initial weights
        model.quantize_weights(bits=bits)
    own = model.state_dict()
    if set(own) != set(state):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(own) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(own))}")
    model.load_state_dict({k: torch.from_numpy(np.array(
        v, np.int8 if k.endswith("weight_int8") else np.float32))
        for k, v in state.items()})
    return model


def token_serving_model(state: Dict[str, np.ndarray], embedding,
                        num_heads: int, *, lm_head: Optional[np.ndarray]
                        = None, head_int8: Optional[np.ndarray] = None,
                        head_scale: Optional[np.ndarray] = None,
                        device=None, **model_kw) -> TokenServingModel:
    """``fused_multi_transformer`` behind the token surface (tied head
    when ``lm_head`` is None). ``head_int8``/``head_scale``: a JAX
    TokenServingModel's ``_head_int8``/``_head_scale`` as numpy; the
    port then serves that int8 head as it is."""
    core = fused_multi_transformer(state, num_heads, device=device,
                                   **model_kw)
    quant_head = head_int8 is not None
    if quant_head != (head_scale is not None):
        raise ValueError("head_int8 and head_scale come together")
    tsm = TokenServingModel(core, np.asarray(embedding, np.float32),
                            lm_head,
                            weight_dtype="int8" if quant_head
                            else "float32")
    if quant_head:
        q = np.asarray(head_int8, np.int8)
        sc = np.asarray(head_scale, np.float32)
        if q.shape != tuple(tsm.lm_head.shape) or sc.shape != q.shape[1:]:
            raise ValueError(f"int8 head {q.shape} / scale {sc.shape} do "
                             f"not fit the head {tuple(tsm.lm_head.shape)}")
        tsm._head_int8 = torch.from_numpy(q.copy()).to(core.device)
        tsm._head_scale = torch.from_numpy(sc.copy()).to(core.device)
    return tsm
