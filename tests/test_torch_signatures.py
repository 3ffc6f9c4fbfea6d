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
    "PagedServingEngine injector (11th)": lambda: inference.PagedServingEngine(
        None, 1, 4, 8, None, "float32", 0, False, None, None, object()),
    "FusedMultiTransformer dropout_rate (4th)": lambda:
        FusedMultiTransformer(8, 2, 16, 0.1),
    "FusedMultiTransformer attrs": lambda: FusedMultiTransformer(
        8, 2, 16, qkv_weight_attrs=[object()]),
    "MoeServingCore dropout_rate (7th)": lambda: inference.MoeServingCore(
        8, 2, 16, 2, 1, 1.25, 0.1),
}
for _name, _value in (("numeric_guard", True), ("tenants", {}),
                      ("collector", object()), ("monitor", object()),
                      ("ledger", object())):
    UNPORTED[f"PagedServingEngine {_name}"] = (
        lambda n=_name, v=_value: inference.PagedServingEngine(
            None, 1, 4, 8, **{n: v}))
for _name, _value in (("injector", object()), ("numeric_guard", False),
                      ("tenants", {"a": {}}), ("collector", object()),
                      ("monitor", object()), ("ledger", object())):
    UNPORTED[f"SpeculativeEngine {_name}"] = (
        lambda n=_name, v=_value: inference.SpeculativeEngine(
            None, max_batch=1, block_size=4, num_blocks=8, **{n: v}))


def _engines():
    core = FusedMultiTransformer(8, 2, 16, device="cpu")
    tsm = inference.TokenServingModel(core, torch.zeros(5, 8))
    return (inference.PagedServingEngine(core, 2, 4, 8),
            inference.SpeculativeEngine(tsm, k=0, max_batch=2,
                                        block_size=4, num_blocks=8))


for _name, _value in (("deadline_steps", 3), ("deadline_s", 1.0),
                      ("tenant_id", "a")):
    UNPORTED[f"PagedServingEngine.submit {_name}"] = (
        lambda n=_name, v=_value: _engines()[0].submit(
            torch.zeros(3, 8), **{n: v}))
for _name, _value in (("deadline_steps", 3), ("deadline_s", 1.0),
                      ("tenant_id", "a"), ("resume", True)):
    UNPORTED[f"SpeculativeEngine.submit {_name}"] = (
        lambda n=_name, v=_value: _engines()[1].submit(
            [1, 2, 3], **{n: v}))


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_parameters_raise(case):
    with pytest.raises(NotImplementedError):
        UNPORTED[case]()


@pytest.mark.parametrize("cls,method", [
    ("PagedServingEngine", "__init__"), ("PagedServingEngine", "submit"),
    ("PagedServingEngine", "fork_stream"), ("PagedServingEngine", "cancel"),
    ("SpeculativeEngine", "__init__"), ("SpeculativeEngine", "submit"),
    ("SpeculativeEngine", "fork_stream"), ("SpeculativeEngine", "cancel"),
    ("SpeculativeEngine", "group"), ("TokenServingModel", "sample")])
def test_serving_methods_take_the_reference_parameters(cls, method):
    """The serving methods' parameters (keyword-only ones included) are
    the reference's names, kinds and defaults, in order; the port's
    PagedServingEngine stops before the reference's ragged-step tuning
    knobs."""
    ref = importlib.import_module("paddle_tpu.inference")
    sig = lambda c: [(p.name, p.kind, p.default)  # noqa: E731
                     for p in inspect.signature(
                         getattr(getattr(c, cls), method)).parameters
                     .values()]
    want, got = sig(ref), sig(inference)
    if (cls, method) == ("PagedServingEngine", "__init__"):
        assert [p[0] for p in want[len(got):]] == [
            "ragged_step", "tile_q", "tile_kv"]
        want = want[:len(got)]
    assert got == want


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
