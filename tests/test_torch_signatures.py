"""The port's public signatures against the JAX package's.

A positional call that is right for ``paddle_tpu`` must bind the same
parameters in ``paddle_tpu_torch``: for every public name that both
packages export from ``nn``, ``nn.functional``, ``optimizer``,
``inference``, ``incubate.nn``, ``amp``, ``models``, ``incubate``,
``nn.initializer``, ``distributed.fleet``,
``distributed.fleet.meta_parallel``, ``distributed.fleet.meta_optimizers``,
``distributed.fleet.utils``, ``distributed.checkpoint``,
``distributed.sharding``, ``parallel.train_step``, ``framework.io``,
``distributed``, ``distributed.communication``, ``distributed.launch``,
``distributed.fleet.elastic``, ``distributed.rpc``, ``framework``,
``tensor`` and the op modules ``ops.creation``, ``math``,
``manipulation``, ``linalg``, ``logic`` and ``search``,
the port's positional parameter names
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

MODULES = ("nn", "nn.functional", "optimizer", "inference", "incubate.nn",
           "amp", "models", "incubate", "models.llama_spmd", "nn.initializer",
           "distributed.fleet", "distributed.fleet.meta_parallel",
           "distributed.fleet.meta_optimizers", "distributed.fleet.utils",
           "distributed.checkpoint", "distributed.sharding",
           "parallel.train_step", "framework.io", "distributed",
           "distributed.communication", "distributed.launch",
           "distributed.fleet.elastic", "distributed.rpc", "framework",
           "tensor", "ops.creation", "ops.math", "ops.manipulation",
           "ops.linalg", "ops.logic", "ops.search")
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
    # the port's own extras are keyword-only (a reference parameter of
    # the same name, set_device's ``device``, is the reference's)
    assert not {"device", "generator"} & (set(port) - set(ref)), port


# the training mesh's entry points, which their modules do not share
# whole with the reference (jax's Mesh class, the port's serving keyword)
MESH_API = [("parallel.mesh", n) for n in (
    "build_mesh", "get_mesh", "set_mesh", "mesh_axis_size")] + [
    ("parallel.pipeline", n) for n in (
        "spmd_pipeline", "interleave_stage_params", "stack_stage_params")] + [
    ("parallel.ring_attention", n) for n in (
        "ring_attention", "_dense_reference")] + [
    ("models.llama_spmd", "_zero_spec")]


@pytest.mark.parametrize("mod,name", MESH_API,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_mesh_api_keeps_the_reference_order(mod, name):
    ref = getattr(importlib.import_module("paddle_tpu." + mod), name)
    port = getattr(importlib.import_module("paddle_tpu_torch." + mod), name)
    assert _positional(port) == _positional(ref)


def _logits():
    return torch.zeros(4, 3), torch.zeros(4, dtype=torch.long)


UNPORTED = {
    "cross_entropy weight": lambda: F.cross_entropy(
        *_logits(), torch.ones(3)),
    "cross_entropy soft_label": lambda: F.cross_entropy(
        *_logits(), soft_label=True),
    "cross_entropy label_smoothing": lambda: F.cross_entropy(
        *_logits(), label_smoothing=0.1),
    "TransformerEncoderLayer weight_attr": lambda:
        nn.TransformerEncoderLayer(8, 2, 16, weight_attr=object()),
    "Adam grad_clip (7th)": lambda: optimizer.Adam(
        0.1, 0.9, 0.999, 1e-8, [], None, object()),
    "AdamW lr_ratio": lambda: optimizer.AdamW(lr_ratio=lambda p: 1.0),
    "AdamW apply_decay_param_fun": lambda: optimizer.AdamW(
        apply_decay_param_fun=lambda n: True),
    "FusedMultiTransformer dropout_rate (4th)": lambda:
        FusedMultiTransformer(8, 2, 16, 0.1),
    "FusedMultiTransformer attrs": lambda: FusedMultiTransformer(
        8, 2, 16, qkv_weight_attrs=[object()]),
    "MoeServingCore dropout_rate (7th)": lambda: inference.MoeServingCore(
        8, 2, 16, 2, 1, 1.25, 0.1),
}
UNPORTED["paged_attention_ragged tile_kv (8th) other than the span"] = (
    lambda: paged_attention_ragged(
        torch.zeros(1, 2, 8), torch.zeros(3, 2, 2, 4, 8),
        torch.zeros(1, 1, dtype=torch.int32), (1,), [1], None, None, 64))


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
    # tensor-parallel pools: the pool splits over heads; a restore
    # rebuilds at the width asked for
    "PagedKVCache mp (10th)": (
        lambda: inference.PagedKVCache(1, 2, 8, 4, 10, 3, None, "float32",
                                       False, 2, device="cpu"),
        lambda c: c.mp == 2 and tuple(c.pools[1].shape) == (10, 2, 1, 4, 8)),
    "PagedKVCache.restore mp": (
        lambda: inference.PagedKVCache.restore(inference.PagedKVCache(
            1, 2, 8, 4, 10, 3, device="cpu").snapshot(), mp=2,
            device="cpu"),
        lambda c: c.mp == 2 and len(c.pools) == 2),
}
# the trace collector, the health monitor and the cost ledger: wired
# onto the engine (the ledger and the monitor bind to its registry)
_OBSERVERS = {"collector": (inference.TraceCollector, None),
              "monitor": (inference.HealthMonitor, "pool.active"),
              "ledger": (inference.CostLedger, "work.total_tokens")}
for _name, (_cls, _key) in _OBSERVERS.items():
    for _i, _eng in enumerate(("PagedServingEngine", "SpeculativeEngine")):
        PORTED[f"{_eng} {_name}"] = (
            lambda n=_name, c=_cls, i=_i: (_engines(**{n: c()})[i], n),
            lambda en, k=_key: getattr(en[0], en[1]) is not None and (
                k is None or k in en[0].registry.as_dict()))
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
    ("Tenant", "__init__"), ("TokenServingModel", "sample"),
    # the fleet (router.py, net.py, fleet.py and the two injectors)
    ("Router", "__init__"), ("Router", "submit"), ("Router", "recover"),
    ("Router", "register_respawn"), ("EngineWorker", "__init__"),
    ("InProcWorker", "__init__"), ("PipeWorker", "__init__"),
    ("SocketWorker", "__init__"), ("FleetSupervisor", "__init__"),
    ("FleetSupervisor", "restore"), ("MigrationPolicy", "__init__"),
    ("MigrationPolicy", "should_move"), ("ReplyCache", "__init__"),
    ("SocketHost", "__init__"), ("ResilientTransport", "__init__"),
    ("ResilientTransport", "call"), ("RouterFaultInjector", "__init__"),
    ("RouterFaultInjector", "kill_storm"),
    ("NetworkFaultInjector", "__init__"),
    ("NetworkFaultInjector", "storm")])
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
_GAPS = {
    # item 12: optimizer/lr.py and its scheduler hook
    **{("optimizer", c): {"set_lr_scheduler": 12}
       for c in ("Adam", "AdamW", "Momentum", "Optimizer", "SGD")},
    **{("distributed.fleet.meta_optimizers", c): {"set_lr_scheduler": 12}
       for c in ("DGCMomentum", "LarsMomentum")},
    # item 12: the dense-scratch -> pages path of the long tail
    ("inference", "PagedKVCache"): {"write_prefill": 12},
    # item 12.8: paddle.sparse installs these Tensor methods
    **{(m, c): {"to_sparse_coo": "12.8", "to_sparse_csr": "12.8"}
       for m in ("framework", "framework.io", "ops.creation", "ops.math",
                 "ops.manipulation", "ops.logic", "ops.search")
       for c in ("Tensor", "Parameter") if c == "Tensor" or
       m == "framework"},
    # never ported: a Place resolves to a jax.Device in the reference;
    # the port's Place has torch_device()
    **{("framework", c): {"jax_device": "none (JAX's device)"}
       for c in ("CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "CustomPlace",
                 "Place", "TPUPlace", "XPUPlace")},
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
