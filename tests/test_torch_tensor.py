"""Paddle's Tensor on the port against the JAX package.

- The reference's ``tests/test_tensor.py`` and the Tensor tests of
  ``tests/test_top_level_api.py`` (``test_tensor_namespace``,
  ``test_c_ops_shim``) run against ``paddle_tpu_torch``: the functions
  that pass as they stand are rebound (``paddle`` the port's); the four
  that assert a reference behaviour the port changes have twins here,
  each beside a test of the difference (ROADMAP Queue C).
- Autograd on handles against the JAX tape: ``backward`` twice,
  ``paddle.grad``, ``no_grad``, hooks, ``retain_grads``,
  ``stop_gradient`` on leaves and non-leaves, ``set_value`` on a leaf.
- ``to_tensor`` and the creation ops raise on a machine without a card
  until ``set_device("cpu")``.
- A port ``Layer`` called with handles, ``loss.backward()`` and an AdamW
  step against the JAX package.
- ``chip_smoke.paddle_decoder_layer`` (phase 28's decoder layer in
  Paddle ops) under both packages at hidden 64, 4 heads, 2 KV heads,
  L 16, batch 2, float32; its JAX output against the reference's own
  ``LlamaDecoderLayer``.
"""
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
import tests.test_tensor as ref_tensor
import tests.test_top_level_api as ref_api
from paddle_tpu_torch import weights
from paddle_tpu_torch.framework import device as tdevice
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)

# float32 twins of the same ops: summation order only
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    before = tdevice._CURRENT_DEVICE
    tpaddle.set_device("cpu")
    tpaddle.seed(0)
    yield
    tdevice._CURRENT_DEVICE = before


# -- the reference's tests, rebound to the port ------------------------------

_REBOUND = [(ref_tensor, n) for n in (
    "test_arith_dunders", "test_matmul", "test_getitem_setitem",
    "test_inplace_ops", "test_shape_utils", "test_creation_ops",
    "test_concat_split_stack", "test_comparisons_and_logic",
    "test_search_ops", "test_linalg", "test_einsum")] + [
    (ref_api, "test_tensor_namespace"), (ref_api, "test_c_ops_shim")]
# the reference tests with a twin below (their assertions name numpy
# dtypes, or a detached tensor that shares nothing)
_TWINNED = {"test_to_tensor_basic", "test_int_default_dtype",
            "test_methods_installed", "test_cast_clone_detach"}


def test_every_reference_tensor_test_is_rebound_or_twinned():
    names = {n for n in dir(ref_tensor) if n.startswith("test_")}
    assert names == {n for m, n in _REBOUND if m is ref_tensor} | _TWINNED


@pytest.mark.parametrize("mod,name", _REBOUND, ids=[n for _, n in _REBOUND])
def test_reference_test_on_the_port(mod, name):
    fn = getattr(mod, name)
    types.FunctionType(fn.__code__, {**fn.__globals__, "paddle": tpaddle},
                       name)()


def test_to_tensor_basic_twin():
    t = tpaddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert t.shape == [2, 2]
    assert t.dtype == tpaddle.float32
    np.testing.assert_allclose(t.numpy(), [[1, 2], [3, 4]])


def test_int_default_dtype_twin():
    # the JAX package's int32 (64-bit types off), by name
    assert tpaddle.to_tensor([1, 2, 3]).dtype == tpaddle.int32
    assert jpaddle.to_tensor([1, 2, 3]).dtype == np.int32


def test_methods_installed_twin():
    a = tpaddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    np.testing.assert_allclose(a.sum().numpy(), 10.0)
    np.testing.assert_allclose(a.mean(axis=0).numpy(), [2, 3])
    np.testing.assert_allclose(a.reshape([4]).numpy(), [1, 2, 3, 4])
    np.testing.assert_allclose(a.t().numpy(), [[1, 3], [2, 4]])
    assert a.astype("int32").dtype == tpaddle.int32


def test_dtypes_are_torch_dtypes():
    """Queue C: the port's dtypes are torch dtypes, so ``Tensor.dtype``
    equals ``paddle.float32`` and not ``np.float32`` (the reference's
    ``test_tensor.py:10``); names agree with the JAX package's."""
    t = tpaddle.to_tensor([1.0])
    assert t.dtype == tpaddle.float32 and t.dtype != np.float32
    assert jpaddle.to_tensor([1.0]).dtype == np.float32
    for name in ("int64", "float64", "complex128"):
        got = tpaddle.to_tensor(np.zeros(2, name)).dtype
        want = jpaddle.to_tensor(np.zeros(2, name)).dtype
        assert tpaddle.framework.dtype.dtype_name(got) == \
            np.dtype(want).name, name


def test_cast_clone_detach_twin():
    a = tpaddle.to_tensor([1.5, 2.5])
    assert a.clone().shape == [2]
    d = a.detach()
    assert d.stop_gradient
    a.set_value(np.array([9.0, 9.0], np.float32))
    np.testing.assert_allclose(a.numpy(), [9, 9])
    # Queue C: set_value writes in place, and a detached tensor shares
    # its storage (Paddle's and torch's detach); the JAX package's
    # set_value rebinds an immutable array, so its detached copy keeps
    # the old values
    np.testing.assert_allclose(d.numpy(), [9, 9])
    j = jpaddle.to_tensor([1.5, 2.5])
    jd = j.detach()
    j.set_value(np.array([9.0, 9.0], np.float32))
    np.testing.assert_allclose(jd.numpy(), [1.5, 2.5])


# -- autograd on handles against the JAX tape -----------------------------

X0 = np.array([[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]], np.float32)


def _leaf(pkg):
    return pkg.to_tensor(X0, stop_gradient=False)


def _both(scenario):
    """``scenario(paddle)`` under both packages; its results as numpy."""
    out = []
    for pkg in (jpaddle, tpaddle):
        res = scenario(pkg)
        out.append([None if r is None else np.asarray(
            r.numpy() if hasattr(r, "numpy") else r, np.float32)
            for r in res])
    return out


def _agree(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_allclose(y, x, **TOL)


def test_backward_twice_accumulates():
    def scenario(paddle):
        x = _leaf(paddle)
        (x * x).sum().backward()
        first = x.grad.numpy().copy()
        (x * x * x).sum().backward()
        return [first, x.grad]
    _agree(*_both(scenario))


def test_paddle_grad_leaves_dot_grad_alone():
    def scenario(paddle):
        x = _leaf(paddle)
        y = paddle.to_tensor(X0 * 2, stop_gradient=False)
        z = (x * x * y).sum()
        gx, gy = paddle.grad(z, [x, y])
        return [gx, gy, x.grad]
    _agree(*_both(scenario))


def test_no_grad_and_grad_mode():
    for paddle in (jpaddle, tpaddle):
        x = _leaf(paddle)
        with paddle.no_grad():
            y = x * 2
        assert y.stop_gradient
        assert not (x * 2).stop_gradient

        @paddle.no_grad()
        def f(t):
            return t * 3
        assert f(x).stop_gradient
    assert tpaddle.is_grad_enabled()


def test_hooks_scale_the_leaf_gradient():
    def scenario(paddle):
        x = _leaf(paddle)
        x.register_hook(lambda g: g * 2)
        (x * x).sum().backward()
        return [x.grad]
    _agree(*_both(scenario))


def test_retain_grads_on_a_non_leaf():
    def scenario(paddle):
        x = _leaf(paddle)
        h = x * 3
        h.retain_grads()
        (h * h).sum().backward()
        return [h.grad, x.grad]
    _agree(*_both(scenario))


def test_stop_gradient_on_leaves_and_non_leaves():
    def scenario(paddle):
        x = _leaf(paddle)
        w = paddle.to_tensor(X0 + 1)
        assert w.stop_gradient
        h = x * 2
        h.stop_gradient = True      # cuts the path through h
        (h * x * w).sum().backward()
        return [x.grad, w.grad]
    _agree(*_both(scenario))


def test_set_value_on_a_leaf():
    def scenario(paddle):
        x = _leaf(paddle)
        x.set_value(X0 * 3)
        (x * x).sum().backward()
        return [x, x.grad]
    _agree(*_both(scenario))
    x = _leaf(tpaddle)
    x.set_value(X0 * 3)
    assert x.is_leaf and not x.stop_gradient


def test_inplace_on_a_leaf_that_needs_grad_raises():
    """Queue C: Paddle's rule, which the JAX package does not enforce
    (its in-place ops rebind and record)."""
    x = _leaf(tpaddle)
    with pytest.raises(ValueError, match="inplace"):
        x.add_(tpaddle.ones([2, 3]))
    with tpaddle.no_grad():
        x.add_(tpaddle.ones([2, 3]))
    np.testing.assert_allclose(x.numpy(), X0 + 1)
    h = x * 1
    h.scale_(2.0)           # a non-leaf may change in place
    h.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.full_like(X0, 2.0))


def test_setitem_records_the_gradient():
    def scenario(paddle):
        x = _leaf(paddle)
        h = x * 1
        v = paddle.to_tensor(np.array([7.0, 8.0, 9.0], np.float32),
                             stop_gradient=False)
        h[1] = v
        (h * h).sum().backward()
        return [h, x.grad, v.grad]
    _agree(*_both(scenario))


# -- the default device ------------------------------------------------------

def test_creation_raises_without_a_card_until_set_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tdevice._CURRENT_DEVICE = "gpu:0"
    assert tpaddle.get_device() == "gpu:0"
    for make in (lambda: tpaddle.to_tensor([1.0]),
                 lambda: tpaddle.zeros([2]), lambda: tpaddle.arange(3),
                 lambda: tpaddle.rand([2])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    tpaddle.set_device("cpu")
    assert tpaddle.get_device() == "cpu"
    assert tpaddle.to_tensor([1.0]).place == tpaddle.CPUPlace()
    assert tpaddle.zeros([2]).place.kind == "cpu"


# -- Parameter, tensor_from_jax ---------------------------------------------

def test_parameter_and_create_parameter():
    """``paddle.Parameter`` is a handle as in the reference; a port
    ``Layer``'s parameters stay ``torch.nn.Parameter`` (Queue C)."""
    p = tpaddle.create_parameter([3, 4], "float32")
    assert isinstance(p, tpaddle.Parameter) and not p.stop_gradient
    assert p.persistable
    lin = tpaddle.nn.Linear(4, 2, device="cpu")
    assert isinstance(lin.weight, torch.nn.Parameter)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tensor_from_jax(dtype):
    j = jpaddle.to_tensor(X0 * 4).astype(dtype)
    j.stop_gradient = dtype == "int32"
    t = weights.tensor_from_jax(j, device="cpu")
    assert tpaddle.framework.dtype.dtype_name(t.dtype) == dtype
    assert t.stop_gradient == j.stop_gradient
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(j.numpy()).astype(t.numpy().dtype))


# -- a port Layer called with handles -----------------------------------------

def test_port_layer_with_handles_trains_like_the_jax_package():
    rng = np.random.RandomState(3)
    w1, w2 = rng.randn(8, 16).astype(np.float32), \
        rng.randn(16, 4).astype(np.float32)
    x = rng.randn(5, 8).astype(np.float32)

    def run(paddle, layers, make):
        net = layers(make)
        net.set_state_dict({"0.weight": w1, "1.weight": w2})
        opt = paddle.optimizer.AdamW(learning_rate=0.1,
                                     parameters=net.parameters())
        xt = paddle.to_tensor(x)
        out = net(xt)
        assert isinstance(out, paddle.Tensor)
        loss = (out * out).mean()
        loss.backward()
        opt.step()
        return float(loss), net(xt).numpy()

    class PortSeq(tpaddle.nn.Layer):
        def __init__(self, make):
            super().__init__()
            self.layers = torch.nn.ModuleList([make(8, 16), make(16, 4)])

        def forward(self, t):
            for lay in self.layers:
                t = torch.tanh(lay(t))
            return t

        def set_state_dict(self, state):
            return super().set_state_dict(
                {f"layers.{k}": v for k, v in state.items()})

    class JaxSeq(jpaddle.nn.Layer):
        def __init__(self, make):
            super().__init__()
            self.l0, self.l1 = make(8, 16), make(16, 4)

        def forward(self, t):
            return jpaddle.tanh(self.l1(jpaddle.tanh(self.l0(t))))

        def set_state_dict(self, state):
            return super().set_state_dict(
                {k.replace("0.", "l0.").replace("1.", "l1."): v
                 for k, v in state.items()})

    nb = dict(bias_attr=False)
    jl, jo = run(jpaddle, JaxSeq, lambda i, o: jpaddle.nn.Linear(i, o, **nb))
    tl, to = run(tpaddle, PortSeq, lambda i, o: tpaddle.nn.Linear(
        i, o, **nb, device="cpu"))
    assert tl == pytest.approx(jl, rel=1e-6)
    np.testing.assert_allclose(to, jo, **TOL)


# -- phase 28's decoder layer under both packages ------------------------------

D, HEADS, KV, FFN, L, B, EPS, THETA = 64, 4, 2, 128, 16, 2, 1e-5, 10000.0


def _decoder_state():
    rng = np.random.RandomState(28)
    hd = D // HEADS
    shapes = {"self_attn.q_proj.weight": (D, D),
              "self_attn.k_proj.weight": (D, KV * hd),
              "self_attn.v_proj.weight": (D, KV * hd),
              "self_attn.o_proj.weight": (D, D),
              "mlp.gate_proj.weight": (D, FFN),
              "mlp.up_proj.weight": (D, FFN),
              "mlp.down_proj.weight": (FFN, D)}
    state = {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
             for k, s in shapes.items()}
    for k in ("input_layernorm.weight", "post_attention_layernorm.weight"):
        state[k] = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    inv = 1.0 / (THETA ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    emb = np.concatenate([np.outer(np.arange(L, dtype=np.float32), inv)] * 2,
                         axis=-1)
    x = rng.randn(B, L, D).astype(np.float32)
    return state, np.cos(emb), np.sin(emb), x


def _decoder_run(paddle, state, cos, sin, x):
    w = {k: paddle.to_tensor(v, stop_gradient=False)
         for k, v in state.items()}
    xt = paddle.to_tensor(x, stop_gradient=False)
    out = cs.paddle_decoder_layer(paddle, xt, w, paddle.to_tensor(cos),
                                  paddle.to_tensor(sin), HEADS, KV, EPS)
    probe = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    paddle.sum(out * paddle.to_tensor(probe)).backward()
    return out.numpy(), {"x": xt.grad.numpy(),
                         **{k: w[k].grad.numpy() for k in w}}


def test_decoder_layer_in_paddle_ops_matches_across_packages():
    """Output and the gradients of x and every weight within 1e-5
    (float32, the same ops: summation order only); the JAX package's
    output equals its own LlamaDecoderLayer's on the same weights."""
    state, cos, sin, x = _decoder_state()
    jout, jgrads = _decoder_run(jpaddle, state, cos, sin, x)
    tout, tgrads = _decoder_run(tpaddle, state, cos, sin, x)
    np.testing.assert_allclose(tout, jout, **TOL)
    assert set(tgrads) == set(jgrads) == set(state) | {"x"}
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k], jgrads[k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    from paddle_tpu.models.llama import LlamaConfig, LlamaDecoderLayer
    layer = LlamaDecoderLayer(LlamaConfig(
        hidden_size=D, intermediate_size=FFN, num_attention_heads=HEADS,
        num_key_value_heads=KV, max_position_embeddings=L,
        rms_norm_eps=EPS, rope_theta=THETA))
    layer.set_state_dict(state)
    ref = layer(jpaddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(jout, ref, **TOL)
    np.testing.assert_allclose(tout, ref, **TOL)


def test_phase_28_on_the_cpu():
    """``phase_paddle_ops`` at tiny widths on the CPU: the handle layer
    bitwise the torch-native one, the op sweep over every op family."""
    cfg = dict(cs.FULL, paddle_ops=dict(hidden=64, heads=4, kv_heads=2,
                                        ffn=128, theta=THETA, eps=EPS,
                                        batch=2, seq=16))
    lines = []
    cs.phase_paddle_ops(torch, torch.device("cpu"), cfg, 0, "[cpu]",
                        lines.append)
    assert "11 of 11 tensors bitwise" in lines[0]
    assert "failures []" in lines[1]
