"""Weights from the JAX package, handed over as numpy arrays.

``fused_multi_transformer`` builds the port's FusedMultiTransformer from
a JAX ``FusedMultiTransformer.state_dict()`` given as ``{name:
np.ndarray}`` (the caller converts: ``{k: v.numpy() for k, v in
model.state_dict().items()}``) — or a FusedMultiTransformerInt8 from the
state of a quantized JAX model, whose projections carry
``weight_int8``/``weight_scale`` buffers instead of ``weight``;
``token_serving_model`` wraps it with an embedding table (and an
optional untied head, or the JAX model's own int8 head).
``moe_serving_core`` builds the port's MoeServingCore from a JAX
``MoeServingCore.state_dict()`` (router ``gate``, expert stacks
``moe_w1 [E, d, f]``, ``moe_b1``, ``moe_w2 [E, f, d]``, ``moe_b2``,
beside the attention and LayerNorm weights). Names and
layouts are the same in both packages (Linear weights [in, out]), so the
copy is by name and the int8 bytes are taken as they are, never
re-quantized. ``llama_spmd_trainer`` builds the port's LlamaSpmdTrainer
holding a JAX ``LlamaSpmdTrainer``'s parameter tree (and optionally its
optimizer state), given as nested dicts of numpy arrays with the same
keys. This module never imports JAX: the caller hands it numpy.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .incubate.nn import FusedMultiTransformer, FusedMultiTransformerInt8
from .inference.moe_serving import MoeServingCore
from .inference.speculative import TokenServingModel
from .models.llama_spmd import LlamaSpmdTrainer, tree_get, tree_paths

__all__ = ["fused_multi_transformer", "llama_spmd_trainer",
           "moe_serving_core", "token_serving_model"]


def _layer_count(state, name: str) -> int:
    layers = {int(m.group(1)) for k in state
              if (m := re.match(rf"layers\.(\d+)\.{name}$", k))}
    if not layers or layers != set(range(len(layers))):
        raise ValueError(f"state holds no layers.{{i}}.{name} sequence"
                         .replace("\\", ""))
    return len(layers)


def _load(model, state):
    own = model.state_dict()
    if set(own) != set(state):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(own) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(own))}")
    model.load_state_dict({k: torch.from_numpy(np.array(
        v, np.int8 if k.endswith("weight_int8") else np.float32))
        for k, v in state.items()})
    return model


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
    n_layers = _layer_count(state, rf"qkv\.{w}")
    d = state[f"layers.0.qkv.{w}"].shape[0]
    ffn = state[f"layers.0.ffn1.{w}"].shape[1]
    cls = FusedMultiTransformerInt8 if quant else FusedMultiTransformer
    model = cls(d, num_heads, ffn, activation=activation,
                normalize_before=normalize_before, epsilon=epsilon,
                num_layers=n_layers, device=device)
    if quant:
        # the buffers to load into: quantize the random initial weights
        model.quantize_weights(bits=bits)
    return _load(model, state)


def moe_serving_core(state: Dict[str, np.ndarray], num_heads: int, *,
                     top_k: int = 2, capacity_factor: float = 1.25,
                     block_m: int = 8, use_kernel=None,
                     activation: str = "gelu",
                     normalize_before: bool = True, epsilon: float = 1e-5,
                     device=None) -> MoeServingCore:
    """Port MoeServingCore holding ``state``'s parameters (experts,
    widths and depth read off the shapes; the routing options are not in
    a state dict and default to the JAX class's)."""
    n_layers = _layer_count(state, "moe_w1")
    E, d, ffn = state["layers.0.moe_w1"].shape
    model = MoeServingCore(d, num_heads, ffn, num_experts=E, top_k=top_k,
                           capacity_factor=capacity_factor,
                           activation=activation,
                           normalize_before=normalize_before,
                           epsilon=epsilon, num_layers=n_layers,
                           use_kernel=use_kernel, block_m=block_m,
                           device=device)
    return _load(model, state)


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


def llama_spmd_trainer(params_np, config, *, opt_state_np=None, step=0,
                       device=None, **trainer_kw) -> LlamaSpmdTrainer:
    """A port trainer holding ``params_np`` (the JAX trainer's parameter
    tree as numpy, e.g. ``jax.tree_util.tree_map(np.asarray,
    trainer.params)``) and, when given, ``opt_state_np`` (its
    ``opt_state`` the same way, ``m``/``v``/``master`` per leaf; else
    zero moments and the parameters as fp32 master), at step ``step``.
    ``trainer_kw`` are the trainer's options (compute_dtype,
    moments_dtype, remat, ...)."""
    tr = LlamaSpmdTrainer(config, device=device, **trainer_kw)
    with torch.no_grad():
        for path in tree_paths(tr.params):
            p = tree_get(tr.params, path)
            src = np.array(tree_get(params_np, path), np.float32)
            if src.shape != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: shape {src.shape} is "
                                 f"not the trainer's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(src))
            st = tree_get(tr.opt_state, path)
            if opt_state_np is None:
                st["master"].copy_(p.float())
                continue
            for k in ("m", "v", "master"):
                st[k].copy_(torch.from_numpy(np.array(
                    tree_get(opt_state_np, path)[k], np.float32)))
    tr._stepno = int(step)
    return tr
