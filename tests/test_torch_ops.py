"""The reference's op specs (``tests/op``) run against the port.

Every spec of ``test_creation_ops``, ``test_math_ops``,
``test_math_ops2``, ``test_manipulation_ops``, ``test_reduction_ops``,
``test_linalg_ops`` and ``test_sweep_ops`` whose ``fn`` resolves in the
port runs here; no file under ``tests/op`` is edited. A spec's ``fn`` is
rebound to ``paddle_tpu_torch``: a lambda or a function of the spec's
module through its globals (``paddle`` and ``F`` the port's, the
module's helpers rebound the same way), any other function by its name
in the port's module of the same path.

Each spec runs the port's forward on CPU handles against the numpy
``ref`` under the spec's own tolerance, and against the JAX package's
forward (the same tolerance, the same dtype names); bfloat16 where the
spec checks it (against ``ref`` under its bf16 tolerance); the port's
gradients of ``grad_inputs`` against the JAX package's (the harness's
loss, ``sum(out * w)``, under the spec's gradient tolerance). Random ops
(``stat_check``) keep the moment check, and their output's shape and
dtype name must be the JAX package's.

``_GAPS`` lists the specs the port cannot run yet, each with the ROADMAP
Queue A item that ports what it needs: each must still fail on the port
for want of it (``test_gaps_still_lack_their_port``), so a gap that
starts to run has to move into the twins. ``_REFERENCE_ONLY`` lists the
specs that drive the JAX package's own internals.
"""
import importlib
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.framework.dtype import dtype_name
from tests.op import op_test as OT
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)

SPEC_FILES = ("test_creation_ops", "test_math_ops", "test_math_ops2",
              "test_manipulation_ops", "test_reduction_ops",
              "test_linalg_ops", "test_sweep_ops")

# specs whose fn needs what the port does not have yet, with the ROADMAP
# Queue A item that ports it
_NN_F = "12.2 (the nn.functional OpSpec families)"
_GAPS = {
    "test_creation_ops::dirichlet": "12.8 (distribution)",
    "test_manipulation_ops::pad_2d": _NN_F,
    "test_manipulation_ops::pad_reflect": _NN_F,
    "test_manipulation_ops::one_hot": _NN_F,
    "test_manipulation_ops::unfold_im2col": _NN_F,
    "test_manipulation_ops::signal_frame": "12.8 (signal)",
    "test_manipulation_ops::index_fill": _NN_F,
    **{f"test_sweep_ops::{n}": _NN_F for n in (
        "log_softmax/last", "log_softmax/axis0", "log_softmax/mid",
        "log_softmax/size1", "pad/2d",
        "sigmoid/1d", "sigmoid/3d", "sigmoid/size1",
        "leaky_relu/slope", "hardtanh/range", "elu/alpha",
        "mse_loss/mean", "mse_loss/sum", "mse_loss/none",
        "l1_loss/mean", "l1_loss/sum", "l1_loss/none",
        "max_pool2d/k2s2", "max_pool2d/k3s1", "avg_pool2d/k2s2",
        "avg_pool2d/k3s1")},
    **{f"test_sweep_ops::conv2d/{t}": _NN_F for t in (
        "plain", "stride2", "pad1", "dilate2", "groups", "k1")},
    # the optimizers take torch parameters, not Tensor handles
    "test_sweep_ops::merged_adam_step": "12.3 (optimizer on handles)",
    "test_sweep_ops::merged_momentum_step": "12.3 (optimizer on handles)",
}
# specs that run the JAX package's own kernels: the port's counterpart is
# held against them elsewhere
_REFERENCE_ONLY = {
    "test_sweep_ops::fused_adam_step":
        "the Pallas AdamW itself (tests/test_torch_fused_adamw.py)",
}


def _module(name):
    return importlib.import_module(f"tests.op.{name}")


def _port_globals(mod):
    """The spec module's globals with ``paddle`` / ``F`` the port's and
    its own functions rebound over them."""
    g = dict(vars(mod))
    g["paddle"] = tpaddle
    if "F" in g:
        g["F"] = tpaddle.nn.functional
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == mod.__name__:
            g[k] = _rebind(v, g)
    return g


def _rebind(fn, g):
    f = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                           fn.__closure__)
    f.__kwdefaults__ = fn.__kwdefaults__
    return f


def _port_fn(fn, mod, g):
    """``fn`` rebound to the port (AttributeError where the port has no
    function of that name)."""
    if isinstance(fn, types.FunctionType) and fn.__module__ == mod.__name__:
        return _rebind(fn, g)
    path = fn.__module__.replace("paddle_tpu", "paddle_tpu_torch", 1)
    if path.startswith("paddle_tpu_torch.nn.functional"):
        path = "paddle_tpu_torch.nn.functional"
    try:
        port_mod = importlib.import_module(path)
    except ImportError as e:
        raise AttributeError(f"no port module {path}") from e
    return getattr(port_mod, fn.__name__)


def _all_specs():
    out = []
    for name in SPEC_FILES:
        mod = _module(name)
        g = _port_globals(mod)
        for spec in mod.SPECS:
            out.append((f"{name}::{spec.name}", spec, mod, g))
    return out


ALL = _all_specs()
TWINS = [s for s in ALL if s[0] not in _GAPS and s[0] not in _REFERENCE_ONLY]


@pytest.fixture(autouse=True)
def _cpu_and_seed():
    from paddle_tpu_torch.framework import device
    before = device._CURRENT_DEVICE
    tpaddle.set_device("cpu")
    tpaddle.seed(0)
    yield
    device._CURRENT_DEVICE = before


def _port_tensors(inputs, dtype=None, stop_gradient=True):
    """op_test._to_tensors on the port (CPU handles)."""
    out = {}
    for name, arr in inputs.items():
        t = tpaddle.to_tensor(arr)
        if dtype == "bfloat16" and np.issubdtype(arr.dtype, np.floating):
            t = t.astype(tpaddle.bfloat16)
        t.stop_gradient = stop_gradient
        out[name] = t
    return out


def _listed(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _dtype_names(outs, jax_side):
    names = []
    for o in _listed(outs):
        if not hasattr(o, "dtype"):
            names.append(type(o).__name__)
        elif jax_side:
            names.append(np.dtype(o.dtype).name)
        else:
            names.append(dtype_name(o.dtype))
    return names


def _forward(fn, to_tensors, spec):
    """(inputs, output) of one forward, the spec's ``grad_inputs``
    needing gradients."""
    ts = to_tensors(spec.inputs)
    for n in spec.grad_inputs:
        ts[n].stop_gradient = False
    return ts, fn(*ts.values(), **spec.kwargs)


def _grads(ts, out, names, to_w):
    """The gradients of the harness's loss, ``sum(out * w)``."""
    w = np.random.default_rng(0).standard_normal(
        OT._np(out).shape).astype(np.float32)
    (out * to_w(w)).sum().backward()
    return [OT._np(ts[n].grad) for n in names]


@pytest.mark.parametrize("key,spec,mod,g", TWINS, ids=[s[0] for s in TWINS])
def test_spec_on_the_port(key, spec, mod, g):
    fn = _port_fn(spec.fn, mod, g)
    pts, got = _forward(fn, _port_tensors, spec)
    jts, jgot = _forward(spec.fn, OT._to_tensors, spec)
    assert _dtype_names(got, False) == _dtype_names(jgot, True), key
    if spec.stat_check:
        OT._compare_stats(spec, got)
        assert OT._np(got).shape == OT._np(jgot).shape
        return
    want = spec.ref(*spec.inputs.values(), **spec.kwargs)
    OT._compare(key + "/port", got, want, spec.atol, spec.rtol)
    OT._compare(key + "/port vs jax", got,
                [OT._np(j) for j in _listed(jgot)] if isinstance(
                    jgot, (tuple, list)) else OT._np(jgot),
                spec.atol, spec.rtol)
    if spec.check_bf16:
        got16 = fn(*_port_tensors(spec.inputs, "bfloat16").values(),
                   **spec.kwargs)
        OT._compare(key + "/port bf16", got16, want, spec.bf16_atol,
                    spec.bf16_rtol)
    if spec.grad_inputs:
        gp = _grads(pts, got, spec.grad_inputs, tpaddle.to_tensor)
        gj = _grads(jts, jgot, spec.grad_inputs, jpaddle.to_tensor)
        for n, a, b in zip(spec.grad_inputs, gp, gj):
            np.testing.assert_allclose(a, b, atol=spec.grad_atol,
                                       rtol=spec.grad_rtol,
                                       err_msg=f"{key}: grad of {n}")


def test_the_twins_cover_the_listed_files():
    """Every spec of the seven files is a twin, a gap or reference-only,
    and every listed name is a spec of those files."""
    keys = {s[0] for s in ALL}
    assert set(_GAPS) <= keys and set(_REFERENCE_ONLY) <= keys
    assert len(TWINS) + len(_GAPS) + len(_REFERENCE_ONLY) == len(ALL)


@pytest.mark.parametrize("key", sorted(_GAPS))
def test_gaps_still_lack_their_port(key):
    """A gap's fn still fails on the port for want of what its item
    ports (a missing name, or a handle where a torch tensor is taken)."""
    _, spec, mod, g = next(s for s in ALL if s[0] == key)
    with pytest.raises((AttributeError, TypeError, NotImplementedError)):
        fn = _port_fn(spec.fn, mod, g)
        fn(*_port_tensors(spec.inputs).values(), **spec.kwargs)
