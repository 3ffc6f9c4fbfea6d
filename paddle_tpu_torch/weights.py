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
keys. ``bert_for_pretraining`` builds the port's BertForPretraining
from a JAX ``BertForPretraining.state_dict()`` as numpy (``bert.*``,
``cls.*``, ``nsp.*``; the tied decoder reads the word embeddings).
``llama_for_causal_lm`` and ``gpt_for_causal_lm`` build the port's
causal LMs from the JAX models' state dicts (the rotary tables are not
in them, in either package); under ``fleet.init`` with ``mp_degree`` >
1 they build the mpu layers, which hold full logical weights under the
same names, so a JAX fleet model's state dict carries over
unchanged; ``transformer`` and ``moe_layer`` load a JAX ``nn``
transformer layer's (``MultiHeadAttention`` up to
``Transformer``) or ``MoELayer``'s state (experts in expert order,
whatever the ep degree) into a port module the caller built with the
same arguments; ``pipeline_layer`` does so for a ``PipelineLayer`` built
from the same ``LayerDesc``s (``run_function.<i>.*``).
``carry_param_names`` gives a port module's parameters the JAX
parameters' names, and ``optimizer_state`` turns a JAX optimizer's
``state_dict()`` (as numpy) into one the port's optimizers load;
``tensor_from_jax`` turns a JAX package ``Tensor`` (its numpy value,
dtype name and ``stop_gradient``) into a port ``Tensor`` handle. Every
loader keeps the port module's
dtypes: a bf16 JAX model's arrays (after ``paddle.amp.decorate``) go
into a port model exactly (bf16 -> float32 -> bf16 is exact), which
``amp.decorate`` then casts back. This module never imports JAX: the
caller hands it numpy.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device

from .incubate.moe import MoELayer
from .incubate.nn import FusedMultiTransformer, FusedMultiTransformerInt8
from .inference.moe_serving import MoeServingCore
from .inference.speculative import TokenServingModel
from .models.bert import BertConfig, BertForPretraining
from .models.gpt import GPTConfig, GPTForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM
from .models.llama_spmd import LlamaSpmdTrainer, tree_get, tree_paths

__all__ = ["bert_for_pretraining", "carry_param_names", "tensor_from_jax",
           "fused_multi_transformer", "gpt_for_causal_lm",
           "llama_for_causal_lm", "llama_spmd_state_np",
           "llama_spmd_trainer", "moe_layer", "moe_serving_core",
           "optimizer_state", "pipeline_layer", "token_serving_model",
           "transformer"]


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
        v, np.int8 if k.endswith("weight_int8") else np.float32)).to(
        own[k].dtype) for k, v in state.items()})
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
    trainer.params)``: the global arrays, block leaves in the staged
    ``[pp, v, ...]`` layout when ``n_virtual > 1``) and, when given,
    ``opt_state_np`` (its ``opt_state`` the same way, ``m``/``v``/
    ``master`` per leaf; else zero moments and the parameters as fp32
    master), at step ``step``. Without ``device`` the trainer runs on the
    installed port mesh and each rank takes its shard (and its ZeRO chunk
    of the optimizer state). ``trainer_kw`` are the trainer's options
    (compute_dtype, moments_dtype, remat, n_micro, ...)."""
    tr = LlamaSpmdTrainer(config, device=device, **trainer_kw)
    with torch.no_grad():
        for path in tree_paths(tr.params):
            shape = tr._specs[path][0]
            src = torch.from_numpy(np.array(tree_get(params_np, path),
                                            np.float32))
            if tuple(src.shape) != shape:
                raise ValueError(f"{'/'.join(path)}: shape "
                                 f"{tuple(src.shape)} is not the trainer's "
                                 f"{shape}")
            shards = tr._shards(tree_get(tr.params, path))
            for c, p in shards.items():
                p.copy_(src[tr._local_slices(path, c)])
            if opt_state_np is None:
                # zero moments, the parameters as stored as the master
                state = {"master": src.to(next(iter(shards.values())).dtype)
                         .float()}
            else:
                state = {k: torch.from_numpy(np.array(
                    tree_get(opt_state_np, path)[k], np.float32))
                    for k in ("m", "v", "master")}
            for k, v in tree_get(tr.opt_state, path).items():
                for c, t in tr._shards(v).items():
                    if k in state:
                        t.copy_(state[k][tr._owned_slices(path, c)])
                    else:
                        t.zero_()
    tr._stepno = int(step)
    return tr


def llama_spmd_state_np(trainer: LlamaSpmdTrainer):
    """(params, opt_state) of a port trainer as the JAX trainer's global
    numpy trees (the JAX layout: block leaves ``[pp * v, lps, ...]``, or
    staged ``[pp, v, lps, ...]`` when ``n_virtual > 1``), assembled from
    the ranks' shards and ZeRO chunks."""
    params, opt = {}, {}
    for path in tree_paths(trainer.params):
        p = trainer.assemble(path, tree_get(trainer.params, path))
        st = tree_get(trainer.opt_state, path)
        node_p, node_o = params, opt
        for k in path[:-1]:
            node_p = node_p.setdefault(k, {})
            node_o = node_o.setdefault(k, {})
        node_p[path[-1]] = p.float().cpu().numpy()
        node_o[path[-1]] = {k: trainer.assemble(path, v, owned=True)
                            .float().cpu().numpy() for k, v in st.items()}
    return params, opt


def save_tree(path, tree) -> None:
    """Write a nested dict of arrays (``llama_spmd_trainer``'s
    ``params_np``) to an ``.npz`` file, keys the '/'-joined paths: the
    hand-off of a trainer's weights to the processes of a world."""
    flat = {}

    def walk(node, pre):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, pre + (k,))
            else:
                flat["/".join(pre + (k,))] = np.asarray(v)
    walk(tree, ())
    np.savez(path, **flat)


def load_tree(path):
    """``save_tree``'s nested dict of numpy arrays."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = z[key]
    return out


def bert_for_pretraining(state_np: Dict[str, np.ndarray], config: BertConfig,
                         *, device=None, generator=None) -> BertForPretraining:
    """A port BertForPretraining holding ``state_np`` (the JAX model's
    ``state_dict()`` as ``{name: np.ndarray}``); ``generator`` draws its
    dropout seeds."""
    return _load(BertForPretraining(config, device=device,
                                    generator=generator), state_np)


def llama_for_causal_lm(state_np: Dict[str, np.ndarray], config: LlamaConfig,
                        *, device=None, generator=None) -> LlamaForCausalLM:
    """A port LlamaForCausalLM holding ``state_np`` (the JAX model's
    ``state_dict()`` as numpy). The JAX state dict also holds the rotary
    tables (``rotary.cos_cached``/``sin_cached``, registered
    ``persistable=False`` there) and, with ``tie_word_embeddings``, no
    ``lm_head.weight``: the tables are checked against the port's own
    buffers and dropped, the tied head reads the embedding table."""
    model = LlamaForCausalLM(config, device=device, generator=generator)
    state = dict(state_np)
    buffers = dict(model.named_buffers())
    for k in [k for k in state if k.endswith(("cos_cached", "sin_cached"))]:
        mine = buffers[k].cpu().numpy()
        if not np.allclose(np.asarray(state.pop(k), np.float32), mine,
                           rtol=0, atol=1e-6):
            raise ValueError(f"{k} is not the port's rotary table")
    if config.tie_word_embeddings:
        state.setdefault("lm_head.weight",
                         state["llama.embed_tokens.weight"])
    return _load(model, state)


def gpt_for_causal_lm(state_np: Dict[str, np.ndarray], config: GPTConfig,
                      *, device=None, generator=None) -> GPTForCausalLM:
    """A port GPTForCausalLM holding ``state_np``; ``generator`` draws
    its dropout seeds."""
    return _load(GPTForCausalLM(config, device=device, generator=generator),
                 state_np)


def transformer(state_np: Dict[str, np.ndarray], module):
    """``module`` (a port ``nn`` transformer layer built with the JAX
    layer's arguments) holding ``state_np``."""
    return _load(module, state_np)


def moe_layer(state_np: Dict[str, np.ndarray], layer: MoELayer) -> MoELayer:
    """``layer`` (a port MoELayer built with the JAX layer's arguments)
    holding ``state_np`` (``experts.*``, ``gate.gate.*``)."""
    return _load(layer, state_np)


def pipeline_layer(state_np: Dict[str, np.ndarray], layer):
    """``layer`` (a port PipelineLayer of the JAX one's descriptors)
    holding ``state_np``."""
    return _load(layer, state_np)


def carry_param_names(names, module):
    """Name ``module``'s parameters (``named_parameters`` order) by
    ``names``, the JAX module's parameter names in its own order, so
    that optimizer state dicts cross between the packages by key."""
    params = [p for _, p in module.named_parameters()]
    if len(params) != len(names):
        raise ValueError(f"{len(names)} names for {len(params)} parameters")
    for p, n in zip(params, names):
        p.param_name = n
    return module


def optimizer_state(state_np):
    """A JAX optimizer's ``state_dict()`` (tensors as numpy, nested
    ``master_weights`` too) with torch tensors, for the port's
    ``set_state_dict``."""
    if isinstance(state_np, dict):
        return {k: optimizer_state(v) for k, v in state_np.items()}
    if isinstance(state_np, np.ndarray):
        return torch.from_numpy(np.array(state_np, np.float32))
    return state_np


def tensor_from_jax(t, device=None):
    """A port ``Tensor`` of a JAX package ``Tensor``: its value (through
    ``t.numpy()``; bfloat16 by its bit pattern), its dtype by name and
    its ``stop_gradient``, on ``device`` (``cuda`` unless named)."""
    from .framework.device import parse_place
    from .framework.tensor import Tensor
    dev = resolve_device(device)
    return Tensor(np.asarray(t.numpy()), dtype=np.dtype(t.dtype).name,
                  stop_gradient=bool(t.stop_gradient),
                  place=parse_place(str(dev)))
