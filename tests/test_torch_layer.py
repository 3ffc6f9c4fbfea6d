"""The port's ``nn.Layer`` surface (``paddle_tpu_torch/nn/layer/
layers.py``) and ``nn.initializer`` held against the JAX package's on
the same little models: the sublayer walk (order, prefixes, a shared
sublayer once), ``set_state_dict`` from a JAX state dict (values,
``(missing, unexpected)``, the shape-mismatch error), ``astype``,
``clear_gradients``, forward post hooks and their removal,
``create_parameter`` with a ``ParamAttr``, ``attr=False`` and
``is_bias``, ``add_parameter`` / ``add_sublayer``; then each
initializer's shape, dtype and moments over a seeded draw.

Tolerances: values copied from the JAX package equal exactly; outputs
of the two packages' float32 forwards within 1e-5 x max|ref| (summation
order); an initializer's sample mean within 5 standard errors of the
distribution's and its sample standard deviation within 2% (65536
draws: the standard deviation's relative standard error is ~0.3%), the
same checks applied to the JAX package's draw.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.nn import initializer as I
from tests.torch_twins import no_fleet, shared_jax_cache  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_fleet():
    """Each test starts from no HybridCommunicateGroup and no mesh in
    either package (a JAX fleet left at mp > 1 by an earlier test file
    makes the JAX models build their mpu layers); both packages' state
    is restored after."""
    with no_fleet():
        yield


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


MODELS = {
    "llama": (lambda: JaxLlama(JaxLlamaConfig.tiny()),
              lambda: LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")),
    "gpt": (lambda: JaxGPT(JaxGPTConfig.tiny()),
            lambda: GPTForCausalLM(GPTConfig.tiny(), device="cpu")),
    "transformer": (lambda: jnn.Transformer(16, 2, 1, 1, 32),
                    lambda: nn.Transformer(16, 2, 1, 1, 32, device="cpu")),
}


def _walk(layer, **kw):
    return [(n, type(l).__name__) for n, l in layer.named_sublayers(**kw)]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_sublayer_walk_matches_jax(kind):
    jm, pm = (make() for make in MODELS[kind])
    for kw in ({}, dict(include_self=True), dict(prefix="m"),
               dict(prefix="m", include_self=True)):
        assert _walk(pm, **kw) == _walk(jm, **kw), kw
    assert [type(l).__name__ for l in pm.sublayers()] == \
        [type(l).__name__ for l in jm.sublayers()]
    assert pm.sublayers(include_self=True)[0] is pm
    assert pm.full_name() == jm.full_name()


def _shared(pkg, device_kw):
    """A layer holding one Linear under two names, and a list."""
    class Net(pkg.Layer):
        def __init__(self):
            super().__init__(**device_kw)
            self.a = pkg.Linear(4, 4, **device_kw)
            self.b = self.a
            self.c = pkg.LayerList([pkg.Linear(4, 2, **device_kw),
                                    self.a])

        def forward(self, x):
            return self.c[0](self.b(self.a(x)))
    return Net()


def test_shared_sublayer_is_walked_once_and_add_apis_match_jax():
    jm, pm = _shared(jnn, {}), _shared(nn, dict(device="cpu"))
    assert _walk(pm) == _walk(jm) == [("a", "Linear"), ("c", "LayerList"),
                                      ("c.0", "Linear")]
    seen = {id(pm.a)}
    assert [n for n, _ in pm.named_sublayers(layers_set=seen)] == \
        ["c", "c.0"]
    for m, pkg, kw in ((jm, jnn, {}), (pm, nn, dict(device="cpu"))):
        sub = m.add_sublayer("extra", pkg.Linear(2, 3, **kw))
        assert m.extra is sub
        p = m.create_parameter([3], is_bias=True)
        assert m.add_parameter("scale", p) is p
    assert _walk(pm) == _walk(jm)
    assert [n for n, _ in pm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    with pytest.raises(TypeError):
        pm.add_sublayer("bad", object())


def test_set_state_dict_from_jax():
    """A JAX Llama's state dict into a port Llama built from another
    seed: every value equal, ``unexpected`` the JAX dict's rotary tables
    (``persistable=False`` buffers its walk keeps), ``missing`` what the
    dict lacks; a shape mismatch raises; set_dict and load_dict are the
    same method."""
    paddle.seed(1)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    pm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    state = jm.state_dict()
    missing, unexpected = pm.set_state_dict(state)
    assert missing == []
    assert sorted(unexpected) == sorted(k for k in state if "cached" in k)
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), _np(state[k]), err_msg=k)
    part = {k: _np(v) for k, v in state.items()
            if k != "lm_head.weight" and "cached" not in k}
    assert pm.set_dict(part) == (["lm_head.weight"], [])
    assert pm.load_dict(part) == (["lm_head.weight"], [])
    jmissing, _ = jm.set_state_dict(part)
    assert [k for k in jmissing if "cached" not in k] == ["lm_head.weight"]
    bad = dict(part, **{"llama.norm.weight": np.zeros(3, np.float32)})
    for m in (pm, jm):
        with pytest.raises(ValueError, match="shape mismatch"):
            m.set_state_dict(bad)


def test_astype_clear_gradients_and_post_hooks_match_jax():
    paddle.seed(2)
    jm = jnn.Linear(6, 3)
    pm = nn.Linear(6, 3, device="cpu")
    pm.set_state_dict(jm.state_dict())
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    xj, xp = paddle.to_tensor(x), torch.from_numpy(x)

    def double(layer, inputs, out):
        return out * 2
    hj, hp = (m.register_forward_post_hook(double) for m in (jm, pm))
    yj, yp = _np(jm(xj)), pm(xp).detach().numpy()
    np.testing.assert_allclose(yp, yj, atol=1e-5 * np.abs(yj).max())
    np.testing.assert_allclose(yp, 2 * (x @ pm.weight.detach().numpy()
                                        + pm.bias.detach().numpy()),
                               rtol=1e-6)
    hj.remove()
    hp.remove()
    hp.remove()                      # a second remove is a no-op
    np.testing.assert_allclose(pm(xp).detach().numpy(), yp / 2, rtol=1e-6)
    pm(xp).sum().backward()
    assert pm.weight.grad is not None
    pm.clear_gradients()
    assert all(p.grad is None for p in pm.parameters())
    for m in (jm, pm):
        assert m.astype("bfloat16") is m
    assert {str(p.dtype).split(".")[-1] for p in pm.parameters()} == \
        {"bfloat16"} == {str(p.dtype) for p in jm.parameters()}
    pm.astype(torch.float32)
    assert pm.weight.dtype == torch.float32 and pm._dtype == torch.float32


def _attr_layer(pkg, **kw):
    class Holder(pkg.Layer):
        def __init__(self):
            super().__init__(**kw)
            self.w = self.create_parameter(
                [2, 3], attr=pkg.ParamAttr(
                    name="w0", initializer=pkg.initializer.Constant(0.5),
                    learning_rate=0.1, trainable=False))
            self.b = self.create_parameter([3], is_bias=True)
            self.none = self.create_parameter([3], attr=False)
            self.by_init = self.create_parameter(
                [2, 2], attr=pkg.initializer.Assign([[1, 2], [3, 4]]))
            self.f16 = self.create_parameter([4], dtype="float16")
    return Holder()


def test_create_parameter_attrs_match_jax():
    jl = _attr_layer(jnn)
    pl = _attr_layer(nn, device="cpu", generator=torch.Generator()
                     .manual_seed(0))
    assert pl.none is None and jl.none is None
    for n in ("w", "b", "by_init"):
        np.testing.assert_array_equal(getattr(pl, n).detach().numpy(),
                                      _np(getattr(jl, n)), err_msg=n)
    assert pl.w.param_name == jl.w.name == "w0"
    assert pl.w.requires_grad is False and jl.w.stop_gradient is True
    assert pl.w.optimize_attr == jl.w.optimize_attr == {"learning_rate": 0.1}
    assert pl.f16.dtype == torch.float16 and str(jl.f16.dtype) == "float16"
    assert pl.b.dtype == torch.float32 and list(pl.b.shape) == jl.b.shape
    with pytest.raises(TypeError):
        nn.ParamAttr._to_attr(3)


# name: (port initializer, JAX initializer, mean, std) at shape [256, 256]
_FAN = 256
_GAIN = math.sqrt(2.0)
INITS = {
    "Normal": (lambda m: m.Normal(0.5, 2.0), 0.5, 2.0),
    "TruncatedNormal": (lambda m: m.TruncatedNormal(0.0, 1.0, -2.0, 2.0),
                        0.0, 0.8796),
    "Uniform": (lambda m: m.Uniform(-1.0, 3.0), 1.0, 4 / math.sqrt(12)),
    "XavierNormal": (lambda m: m.XavierNormal(), 0.0,
                     math.sqrt(2.0 / (2 * _FAN))),
    "XavierUniform": (lambda m: m.XavierUniform(gain=2.0), 0.0,
                      2.0 * math.sqrt(6.0 / (2 * _FAN)) / math.sqrt(3)),
    "KaimingNormal": (lambda m: m.KaimingNormal(), 0.0, _GAIN / 16),
    "KaimingUniform": (lambda m: m.KaimingUniform(
        negative_slope=0.1, nonlinearity="leaky_relu"), 0.0,
        math.sqrt(2.0 / 1.01) * math.sqrt(3.0 / _FAN) / math.sqrt(3)),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_moments_match_jax(name):
    make, mean, std = INITS[name]
    g = torch.Generator().manual_seed(11)
    got = make(I)([_FAN, _FAN], "float32", generator=g, device="cpu")
    paddle.seed(11)
    want = _np(make(paddle.nn.initializer)([_FAN, _FAN], "float32"))
    assert got.shape == (_FAN, _FAN) and got.dtype == torch.float32
    assert want.shape == (_FAN, _FAN)
    for sample in (got.numpy().astype(np.float64), want.astype(np.float64)):
        assert abs(sample.mean() - mean) <= 5 * std / _FAN, name
        assert abs(sample.std() / std - 1) <= 0.02, name
    if name == "TruncatedNormal":
        assert float(got.abs().max()) <= 2.0
    # the same generator state draws the same values on every call
    again = make(I)([_FAN, _FAN], generator=torch.Generator().manual_seed(11),
                    device="cpu")
    assert torch.equal(again, got)
    assert make(I)([3], "bfloat16", device="cpu").dtype == torch.bfloat16


def test_deterministic_initializers_and_gains_match_jax():
    for mk in (lambda m: m.Constant(2.5), lambda m: m.Assign(
            np.arange(6, dtype=np.float32))):
        np.testing.assert_array_equal(
            mk(I)([2, 3], device="cpu").numpy(),
            _np(mk(paddle.nn.initializer)([2, 3])))
    for nl, param in (("sigmoid", None), ("linear", None), ("conv2d", None),
                      ("tanh", None), ("relu", None), ("leaky_relu", None),
                      ("leaky_relu", 0.2), ("selu", None)):
        assert I.calculate_gain(nl, param) == \
            paddle.nn.initializer.calculate_gain(nl, param)
    with pytest.raises(ValueError):
        I.calculate_gain("swish")
    I.set_global_initializer(I.Constant(1.0), I.Constant(0.0))
    try:
        assert isinstance(I._global_weight_init, I.Constant)
    finally:
        I.set_global_initializer(None)
    # fans of a conv kernel [out, in, kh, kw]
    assert I._compute_fans([8, 4, 3, 3]) == \
        paddle.nn.initializer._compute_fans([8, 4, 3, 3]) == (36, 72)
