"""The port's public signatures against the JAX package's.

A positional call that is right for ``paddle_tpu`` must bind the same
parameters in ``paddle_tpu_torch``: for every public name that both
packages export from ``nn``, ``nn.functional``, ``optimizer``,
``inference`` and ``incubate.nn``, the port's positional parameter names
are the reference's, in order (the port may stop early: a longer
positional call then fails loudly). The port's own extras (``device``,
``generator``) are keyword-only. A reference parameter the port does not
implement is accepted and raises NotImplementedError for any value but
its default.
"""
import importlib
import inspect

import pytest
import torch

from paddle_tpu_torch import inference, nn, optimizer
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.hopper.paged_attention import \
    paged_attention_ragged

MODULES = ("nn", "nn.functional", "optimizer", "inference", "incubate.nn")
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in _POSITIONAL]


def _twins():
    """(module, name) of every public callable both packages export from
    MODULES whose signatures inspect can read."""
    out = []
    for mod in MODULES:
        ref = importlib.import_module("paddle_tpu." + mod)
        port = importlib.import_module("paddle_tpu_torch." + mod)
        for name in sorted(set(dir(ref)) & set(dir(port))):
            r, p = getattr(ref, name), getattr(port, name)
            if name.startswith("_") or inspect.ismodule(p) \
                    or not (callable(r) and callable(p)):
                continue
            try:
                inspect.signature(r), inspect.signature(p)
            except (TypeError, ValueError):
                continue
            out.append((mod, name))
    return out


@pytest.mark.parametrize("mod,name", _twins(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_positional_parameters_keep_the_reference_order(mod, name):
    ref = _positional(getattr(importlib.import_module("paddle_tpu." + mod),
                              name))
    port = _positional(getattr(importlib.import_module(
        "paddle_tpu_torch." + mod), name))
    assert port == ref[:len(port)], (port, ref)
    assert not {"device", "generator"} & set(port), port


def _logits():
    return torch.zeros(4, 3), torch.zeros(4, dtype=torch.long)


UNPORTED = {
    "cross_entropy weight": lambda: F.cross_entropy(
        *_logits(), torch.ones(3)),
    "cross_entropy soft_label": lambda: F.cross_entropy(
        *_logits(), soft_label=True),
    "cross_entropy label_smoothing": lambda: F.cross_entropy(
        *_logits(), label_smoothing=0.1),
    "TransformerEncoderLayer normalize_before (8th)": lambda:
        nn.TransformerEncoderLayer(8, 2, 16, 0.1, "relu", None, None, True),
    "TransformerEncoderLayer weight_attr": lambda:
        nn.TransformerEncoderLayer(8, 2, 16, weight_attr=object()),
    "Adam grad_clip (7th)": lambda: optimizer.Adam(
        0.1, 0.9, 0.999, 1e-8, [], None, object()),
    "AdamW lr_ratio": lambda: optimizer.AdamW(lr_ratio=lambda p: 1.0),
    "AdamW apply_decay_param_fun": lambda: optimizer.AdamW(
        apply_decay_param_fun=lambda n: True),
    "PagedKVCache mp (10th)": lambda: inference.PagedKVCache(
        1, 2, 8, 4, 10, 3, None, "float32", False, 2),
    "FusedMultiTransformer dropout_rate (4th)": lambda:
        FusedMultiTransformer(8, 2, 16, 0.1),
    "FusedMultiTransformer attrs": lambda: FusedMultiTransformer(
        8, 2, 16, qkv_weight_attrs=[object()]),
    "MoeServingCore dropout_rate (7th)": lambda: inference.MoeServingCore(
        8, 2, 16, 2, 1, 1.25, 0.1),
}
for _name in ("collector", "monitor", "ledger"):
    UNPORTED[f"PagedServingEngine {_name}"] = (
        lambda n=_name: inference.PagedServingEngine(
            None, 1, 4, 8, **{n: object()}))
    UNPORTED[f"SpeculativeEngine {_name}"] = (
        lambda n=_name: inference.SpeculativeEngine(
            None, max_batch=1, block_size=4, num_blocks=8,
            **{n: object()}))
UNPORTED["paged_attention_ragged tile_kv (8th) other than the span"] = (
    lambda: paged_attention_ragged(
        torch.zeros(1, 2, 8), torch.zeros(3, 2, 2, 4, 8),
        torch.zeros(1, 1, dtype=torch.int32), (1,), [1], None, None, 64))
UNPORTED["PagedKVCache.restore mp"] = lambda: inference.PagedKVCache.restore(
    {}, mp=2)


def _engines(**kw):
    core = FusedMultiTransformer(8, 2, 16, device="cpu")
    tsm = inference.TokenServingModel(core, torch.zeros(5, 8))
    return (inference.PagedServingEngine(core, 2, 4, 8, **kw),
            inference.SpeculativeEngine(tsm, k=0, max_batch=2,
                                        block_size=4, num_blocks=8, **kw))


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_parameters_raise(case):
    with pytest.raises(NotImplementedError):
        UNPORTED[case]()


# reference parameters that raised until the serving stack's resilience,
# tenants and ragged-step knobs were ported: each is accepted and takes
# effect (``check(engine or outcome)`` holds)
PORTED = {
    "PagedServingEngine injector (11th)": (
        lambda: inference.PagedServingEngine(
            FusedMultiTransformer(8, 2, 16, device="cpu"), 1, 4, 8, None,
            "float32", 0, False, None, None,
            inference.FaultInjector()),
        lambda e: e.numeric_guard and e.cache.allocator.fault_hook),
    "PagedServingEngine numeric_guard": (
        lambda: _engines(numeric_guard=True)[0],
        lambda e: e.numeric_guard is True),
    "PagedServingEngine tenants": (
        lambda: _engines(tenants={"a": {"quota_blocks": 4}})[0],
        lambda e: e.tenants["a"].quota_blocks == 4),
    "PagedServingEngine ragged_step tile_q tile_kv (18th-20th)": (
        lambda: inference.PagedServingEngine(
            FusedMultiTransformer(8, 2, 16, device="cpu"), 1, 4, 8, None,
            "float32", 0, False, None, None, None, None, None, None, None,
            None, None, False, 8, 128),
        lambda e: (e.ragged_step, e.tile_q, e.tile_kv) == (False, 8, 128)),
    "SpeculativeEngine injector": (
        lambda: _engines(injector=inference.FaultInjector())[1],
        lambda e: e.engine.numeric_guard),
    "SpeculativeEngine numeric_guard": (
        lambda: _engines(numeric_guard=False)[1],
        lambda e: e.engine.numeric_guard is False),
    "SpeculativeEngine tenants": (
        lambda: _engines(tenants={"a": {}})[1],
        lambda e: "a" in e.tenant_report()),
}
for _name, _value in (("deadline_steps", 3), ("deadline_s", 1.0),
                      ("tenant_id", "a")):
    PORTED[f"PagedServingEngine.submit {_name}"] = (
        lambda n=_name, v=_value: _engines()[0].submit(
            torch.zeros(3, 8), **{n: v}),
        lambda rid: rid == 0)
for _name, _value in (("deadline_steps", 3), ("deadline_s", 1.0),
                      ("tenant_id", "a"), ("resume", True)):
    PORTED[f"SpeculativeEngine.submit {_name}"] = (
        lambda n=_name, v=_value: _engines()[1].submit(
            [1, 2, 3], **{n: v}),
        lambda rid: rid == 0)


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_parameters_are_accepted(case):
    make, check = PORTED[case]
    assert check(make())


@pytest.mark.parametrize("cls,method", [
    ("PagedServingEngine", "__init__"), ("PagedServingEngine", "submit"),
    ("PagedServingEngine", "fork_stream"), ("PagedServingEngine", "cancel"),
    ("PagedServingEngine", "set_tenant"), ("PagedServingEngine", "restore"),
    ("PagedServingEngine", "export_request_slice"),
    ("PagedServingEngine", "import_slice"),
    ("SpeculativeEngine", "__init__"), ("SpeculativeEngine", "submit"),
    ("SpeculativeEngine", "fork_stream"), ("SpeculativeEngine", "cancel"),
    ("SpeculativeEngine", "group"), ("SpeculativeEngine", "restore"),
    ("SpeculativeEngine", "export_slice"),
    ("PagedKVCache", "snapshot"), ("PagedKVCache", "restore"),
    ("PagedKVCache", "export_slice"), ("PagedKVCache", "import_slice"),
    ("PagedKVCache", "quarantine_seq"), ("PagedKVCache", "ragged_views"),
    ("FaultInjector", "__init__"), ("FaultInjector", "storm"),
    ("CrashInjector", "__init__"), ("CrashInjector", "storm"),
    ("Tenant", "__init__"), ("TokenServingModel", "sample")])
def test_serving_methods_take_the_reference_parameters(cls, method):
    """The serving methods' parameters (keyword-only ones included) are
    the reference's names, kinds and defaults, in order; the port's own
    keyword-only ``device`` is left out of the comparison."""
    ref = importlib.import_module("paddle_tpu.inference")
    sig = lambda c: [(p.name, p.kind, p.default)  # noqa: E731
                     for p in inspect.signature(
                         getattr(getattr(c, cls), method)).parameters
                     .values()
                     if not (p.name == "device" and
                             p.kind == inspect.Parameter.KEYWORD_ONLY)]
    assert sig(inference) == sig(ref)


def test_paged_attention_ragged_keeps_the_reference_positional_order():
    """``tile_kv`` sits between ``tile_q`` and ``kv_scales`` as in the
    Pallas module, so a positional call in the reference's order binds
    the same parameters; the port's ``plan`` is keyword-only."""
    ref = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")
    assert _positional(paged_attention_ragged) == \
        _positional(ref.paged_attention_ragged)
    plan = inspect.signature(paged_attention_ragged).parameters["plan"]
    assert plan.kind == inspect.Parameter.KEYWORD_ONLY


def test_positional_calls_bind_the_reference_parameters():
    """Positional calls that used to bind a different parameter in the
    port now bind as in the reference."""
    layer = nn.TransformerEncoderLayer(8, 2, 16, 0.0, "relu", None, None,
                                       False, None, None, 1e-3,
                                       device="cpu")
    assert layer.norm1._epsilon == 1e-3
    p = torch.nn.Parameter(torch.zeros(2, dtype=torch.bfloat16))
    opt = optimizer.AdamW(1e-3, 0.9, 0.999, 1e-8, [p], 0.01, None, None,
                          None, False, True)
    assert opt._multi_precision
    opt = optimizer.Adam(1e-3, 0.9, 0.999, 1e-8, [p], None, None, False,
                         True)
    assert opt._multi_precision
    assert float(F.cross_entropy(*_logits(), None, -100, "sum")) \
        == pytest.approx(4 * float(torch.log(torch.tensor(3.0))))
    x = torch.ones(64)
    assert F.dropout(x, 0.5, None, True, "upscale_in_train", "d",
                     generator=torch.Generator().manual_seed(0)).shape \
        == x.shape


# Public attributes of a shared class that the port still lacks against
# the reference, each tied to the ROADMAP Queue A item that ports it. A
# port that drops a ported attribute (as the speculative engine's
# ``registry`` and ``logits_of`` once were) fails the test below, and so
# does a port that adds one without taking it off this list.
_LAYER = {"add_parameter", "add_sublayer", "astype", "clear_gradients",
          "create_parameter", "full_name", "load_dict", "named_sublayers",
          "register_forward_post_hook", "set_dict", "set_state_dict",
          "sublayers"}                   # item 12: the nn.Layer surface
_OPT = {"apply_gradients", "backward", "clear_gradients", "minimize",
        "prebuild_fused", "set_dict", "set_lr", "set_lr_scheduler",
        "set_state_dict", "state_dict"}  # item 12: the rest of optimizer
_GAPS = {
    **{("nn", c): {a: 12 for a in _LAYER}
       for c in ("Dropout", "Embedding", "GELU", "LayerNorm", "Linear",
                 "Tanh")},
    # item 11: the encoder gaps (the MultiHeadAttention cache path)
    ("nn", "MultiHeadAttention"): dict({a: 12 for a in _LAYER},
                                       Cache=11, StaticCache=11,
                                       gen_cache=11),
    ("nn", "TransformerEncoder"): dict({a: 12 for a in _LAYER},
                                       gen_cache=11),
    ("nn", "TransformerEncoderLayer"): dict({a: 12 for a in _LAYER},
                                            gen_cache=11),
    **{("optimizer", c): {a: 12 for a in _OPT}
       for c in ("Adam", "AdamW", "Optimizer")},
    # item 8: the telemetry registry's own counters and histograms
    ("inference", "MetricsRegistry"): {
        a: 8 for a in ("HIST_WINDOW", "count", "delta_since", "gauge",
                       "hist_marks", "hist_names", "hist_total",
                       "histogram", "last_value", "observe",
                       "percentiles_since", "scrape", "values_since")},
    ("inference", "MoeServingCore"): {a: 12 for a in _LAYER},
    # item 10: sharded serving (tensor-parallel pools and views)
    ("inference", "PagedKVCache"): {
        "heads_per_shard": 10, "pool_bytes_total": 10, "pool_index": 10,
        "rebind_shard_pools": 10,
        # item 12: the dense-scratch -> pages path of the long tail
        "write_prefill": 12},
    ("inference", "PagedLayerCache"): {"shard": 10},
    ("inference", "PagedPrefillView"): {"shard": 10},
    ("inference", "TokenServingModel"): {"shard": 10},
    # item 8: the trace collector, the cost ledger, the health monitor
    ("inference", "SpeculativeEngine"): {"collector": 8, "ledger": 8,
                                         "monitor": 8},
    ("incubate.nn", "FusedMultiTransformer"): {a: 12 for a in _LAYER},
    ("incubate.nn", "FusedMultiTransformerInt8"): {a: 12 for a in _LAYER},
}


def _shared_classes():
    out = []
    for mod in MODULES:
        ref = importlib.import_module("paddle_tpu." + mod)
        port = importlib.import_module("paddle_tpu_torch." + mod)
        for name in sorted(set(dir(ref)) & set(dir(port))):
            if not name.startswith("_") and \
                    inspect.isclass(getattr(ref, name)) and \
                    inspect.isclass(getattr(port, name)):
                out.append((mod, name))
    return out


@pytest.mark.parametrize("mod,name", _shared_classes(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_public_attribute_gap_is_the_listed_one(mod, name):
    ref = getattr(importlib.import_module("paddle_tpu." + mod), name)
    port = getattr(importlib.import_module("paddle_tpu_torch." + mod),
                   name)
    missing = {a for a in set(dir(ref)) - set(dir(port))
               if not a.startswith("_")}
    assert missing == set(_GAPS.get((mod, name), {})), \
        sorted(missing ^ set(_GAPS.get((mod, name), {})))
