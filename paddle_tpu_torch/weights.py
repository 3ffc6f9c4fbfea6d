"""Weights from the JAX package, handed over as numpy arrays.

``fused_multi_transformer`` builds the port's FusedMultiTransformer from
a JAX ``FusedMultiTransformer.state_dict()`` given as ``{name:
np.ndarray}`` (the caller converts: ``{k: v.numpy() for k, v in
model.state_dict().items()}``); ``token_serving_model`` wraps it with an
embedding table (and an optional untied head). Names and layouts are
the same in both packages (Linear weights [in, out]), so the copy is by
name. This module never imports JAX: the caller hands it numpy.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .incubate.nn import FusedMultiTransformer
from .inference.speculative import TokenServingModel

__all__ = ["fused_multi_transformer", "token_serving_model"]


def fused_multi_transformer(state: Dict[str, np.ndarray], num_heads: int,
                            *, activation: str = "gelu",
                            normalize_before: bool = True,
                            epsilon: float = 1e-5,
                            device=None) -> FusedMultiTransformer:
    """Port model holding ``state``'s parameters (geometry read off the
    shapes; ``num_heads`` and the options are not in a state dict)."""
    layers = {int(m.group(1)) for k in state
              if (m := re.match(r"layers\.(\d+)\.qkv\.weight$", k))}
    if not layers or layers != set(range(len(layers))):
        raise ValueError("state holds no layers.{i}.qkv.weight sequence")
    d = state["layers.0.qkv.weight"].shape[0]
    ffn = state["layers.0.ffn1.weight"].shape[1]
    model = FusedMultiTransformer(
        d, num_heads, ffn, activation=activation,
        normalize_before=normalize_before, epsilon=epsilon,
        num_layers=len(layers), device=device)
    own = model.state_dict()
    if set(own) != set(state):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(own) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(own))}")
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                           for k, v in state.items()})
    return model


def token_serving_model(state: Dict[str, np.ndarray], embedding,
                        num_heads: int, *, lm_head: Optional[np.ndarray]
                        = None, device=None, **model_kw
                        ) -> TokenServingModel:
    """``fused_multi_transformer`` behind the token surface (tied head
    when ``lm_head`` is None)."""
    core = fused_multi_transformer(state, num_heads, device=device,
                                   **model_kw)
    return TokenServingModel(core, np.asarray(embedding, np.float32),
                             lm_head)
