"""A reference serving suite's own code, run against the port.

``load_on_port("tests/test_monitor.py")`` compiles the reference test
module's source with its imports pointed at ``paddle_tpu_torch``:

* ``paddle_tpu.inference`` (and its submodules) becomes
  ``paddle_tpu_torch.inference``, at module level and inside test bodies;
* ``paddle`` becomes a small stand-in whose ``to_tensor`` makes a CPU
  torch tensor and whose ``seed`` seeds both packages; a parameter's
  ``set_value(t)`` becomes ``.data.copy_(t)``;
* ``FusedMultiTransformer`` and ``MoeServingCore`` build the JAX model
  the reference test would build (same seed, same arguments) and return
  the port's model holding its weights (``paddle_tpu_torch.weights``).

Every test class, test function and fixture of the reference then runs
its own assertions on the port's engines, collectors, monitors, ledgers
and recovery host, at the reference's sizes and seeds.

The fleet suites (``spec_models=True``: router, fleet, net) build their
workers from data-only specs (``build_server_from_spec``), which the
port seeds with a CPU ``torch.Generator``, not jax's PRNG. For them the
suite's own ``paddle.seed`` + ``FusedMultiTransformer`` builder makes
the model the port's ``build_model_from_spec`` makes (so its hashes and
streams agree with the spawned workers'), every spec ``_spec`` returns
carries ``device="cpu"`` (spawned children too), children run one
thread each, and ``from tests.test_<x> import ...`` reaches the port
twin of that suite (a module ``tests._port_test_<x>``). The module's
``counting_clock`` fixture counts the port's clock reads instead of the
JAX package's, and ``_on_cpu`` makes a pool built without a device
(``PagedKVCache(...)`` in a test body) a CPU pool, as a caller on the CPU
asks for. Nothing of the JAX package runs but the model builders.
"""
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.incubate.nn import FusedMultiTransformer as _JaxFMT
from paddle_tpu.inference import MoeServingCore as _JaxMoe
from paddle_tpu_torch import device as _device
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer as _PortFMT
from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import paged_cache as _paged
from paddle_tpu_torch.inference import scheduler as _sched
from paddle_tpu_torch.inference import telemetry as _tele
from tests.conftest import CountingTime

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(model) -> dict:
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


class _Paddle:
    """The slice of ``paddle`` the reference serving suites call."""

    last_seed = 0

    @staticmethod
    def seed(s):
        paddle_tpu.seed(s)
        torch.manual_seed(s)
        _Paddle.last_seed = int(s)

    @staticmethod
    def to_tensor(x, dtype=None):
        a = np.asarray(x) if dtype is None else np.asarray(x, dtype)
        return torch.from_numpy(np.array(a, copy=True))


def _fused_multi_transformer(embed_dim, num_heads, dim_feedforward,
                             *args, **kw):
    """The port's FusedMultiTransformer holding the weights of the JAX
    one built from the same arguments (under the current JAX seed)."""
    jm = _JaxFMT(embed_dim, num_heads, dim_feedforward, *args, **kw)
    opts = {k: kw[k] for k in ("activation", "normalize_before",
                               "epsilon") if k in kw}
    return weights.fused_multi_transformer(_state(jm), num_heads,
                                           device="cpu", **opts)


def _spec_fused_multi_transformer(embed_dim, num_heads, dim_feedforward,
                                  *args, **kw):
    """The port's FusedMultiTransformer as ``build_model_from_spec``
    builds it: weights from a CPU generator seeded with the last
    ``paddle.seed``, on the CPU."""
    return _PortFMT(embed_dim, num_heads, dim_feedforward, *args,
                    device="cpu", generator=torch.Generator(
                        "cpu").manual_seed(_Paddle.last_seed), **kw)


def _moe_serving_core(embed_dim, num_heads, dim_feedforward, num_experts=4,
                      top_k=2, capacity_factor=1.25, *args, **kw):
    """The port's MoeServingCore holding the weights of the JAX one."""
    jm = _JaxMoe(embed_dim, num_heads, dim_feedforward, num_experts,
                 top_k, capacity_factor, *args, **kw)
    opts = {k: kw[k] for k in ("block_m", "activation",
                               "normalize_before", "epsilon") if k in kw}
    return weights.moe_serving_core(_state(jm), num_heads, top_k=top_k,
                                    capacity_factor=capacity_factor,
                                    device="cpu", **opts)


_SUBS = (
    ("import paddle_tpu as paddle\n", "paddle = _port_paddle\n"),
    ("from paddle_tpu.incubate.nn import FusedMultiTransformer\n",
     "FusedMultiTransformer = _port_fmt\n"),
    ("from paddle_tpu.incubate.nn.fused_transformer import "
     "FusedMultiTransformer\n", "FusedMultiTransformer = _port_fmt\n"),
    # a reference suite that sets weights by hand (tests/test_sharded.py)
    (".set_value(", ".data.copy_("),
    ("from paddle_tpu.inference import MoeServingCore\n",
     "MoeServingCore = _port_moe\n"),
    ("paddle_tpu.inference", "paddle_tpu_torch.inference"),
)


def _port_module(stem: str) -> types.ModuleType:
    """The fleet twin of reference suite ``tests/<stem>.py`` as module
    ``tests._port_<stem>`` (loaded once per process)."""
    name = f"tests._port_{stem}"
    mod = sys.modules.get(name)
    if mod is None:
        mod = types.ModuleType(name)
        sys.modules[name] = mod
        load_on_port(f"tests/{stem}.py", name, spec_models=True,
                     ns=mod.__dict__)
    return mod


def _cpu_specs(make_spec):
    def _spec(*args, **kw):
        return dict(make_spec(*args, **kw), device="cpu")
    return _spec


def load_on_port(ref_file: str, name: str, spec_models: bool = False,
                 ns: dict = None) -> dict:
    """The namespace of reference test module ``ref_file`` (a path
    relative to the repository root) compiled against the port, as
    module ``name`` (into ``ns`` when given)."""
    path = os.path.join(_ROOT, ref_file)
    with open(path) as f:
        src = f.read()
    for a, b in _SUBS:
        src = src.replace(a, b)
    if spec_models:
        for stem in sorted(set(re.findall(r"from tests\.(test_\w+) import",
                                          src))):
            _port_module(stem)
            src = src.replace(f"from tests.{stem} import",
                              f"from tests._port_{stem} import")
    left = [m for m in re.findall(r"paddle_tpu(?!_torch)\.\w+", src)
            if m != "paddle_tpu.report"]     # the tools' schema name
    assert not left, f"{ref_file}: unported reference imports {left}"
    ns = {} if ns is None else ns
    ns.update({"__name__": name, "__file__": path,
               "_port_paddle": _Paddle,
               "_port_fmt": (_spec_fused_multi_transformer if spec_models
                             else _fused_multi_transformer),
               "_port_moe": _moe_serving_core})
    exec(compile(src, path, "exec"), ns)
    if spec_models and "_spec" in ns:
        ns["_spec"] = _cpu_specs(ns["_spec"])
    return ns


def _is_fixture(v) -> bool:
    return type(v).__name__ == "FixtureFunctionDefinition" or \
        hasattr(v, "_pytestfixturefunction")


def suite(ref_file: str, name: str, only=None,
          spec_models: bool = False) -> dict:
    """What a twin module puts in its globals: the reference module's
    test classes, test functions, fixtures and module marks
    (``load_on_port``), plus a ``counting_clock`` that counts the port's
    clock reads and the ``_on_cpu`` pool default. ``only`` names the
    tests to take instead (``"TestClass"``, ``"TestClass.test_x"``,
    ``"test_fn"``; the module marks stay behind). ``spec_models``: a
    fleet suite (see the module docstring)."""
    ns = load_on_port(ref_file, name, spec_models)
    out = {k: v for k, v in ns.items() if _is_fixture(v)}
    if only is None:
        out.update({k: v for k, v in ns.items()
                    if k.startswith(("Test", "test_")) or k == "pytestmark"})
    else:
        for want in only:
            cls_name, _, meth = want.partition(".")
            cls = ns[cls_name]
            if meth:
                # hide the class's other tests, keep its helpers
                cls = type(cls_name, (cls,), {
                    a: None for a in dir(cls)
                    if a.startswith("test_") and a != meth})
            out[cls_name] = cls
    out["counting_clock"] = counting_clock
    out["_on_cpu"] = _on_cpu
    if spec_models:
        out["_one_thread_children"] = _one_thread_children
    return out


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(
        _paged, "resolve_device",
        lambda device=None: _device.resolve_device(
            "cpu" if device is None else device))


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    """Spawned worker processes inherit the environment: one intra-op
    thread each, as this process runs."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture
def counting_clock(monkeypatch):
    """CountingTime patched over the port's serving modules that own
    hot-path clock reads (the scheduler and the collector)."""
    fake = CountingTime()
    monkeypatch.setattr(_sched, "time", fake)
    monkeypatch.setattr(_tele, "time", fake)
    return fake
