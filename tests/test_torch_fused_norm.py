"""The PyTorch port's fused RMSNorm, LayerNorm and dropout
(paddle_tpu_torch/ops/hopper/fused_norm.py) held against the JAX
package's ``fused_norm`` module (Pallas in interpret mode on the CPU),
from the same seeded numpy inputs. 13 rows (not a multiple of 8), width
64.

RMSNorm: forward and the gradients of x, residual and w for one random
cotangent; float32 within 1e-5 (summation order only); bfloat16 I/O
within 1e-2 (the outputs and gradients are bfloat16, one ulp is 2**-8
relative, and the two frameworks sum the row statistics in other
orders, which can flip a rounding).

LayerNorm against ``_ln_fwd_call``: float32 ``y`` within 1e-5, the
residual stream ``z`` (one rounded add) bitwise, bfloat16 ``y`` within one
bfloat16 ulp of the JAX value; gradients against ``jax.grad`` of
``fused_layer_norm`` / ``fused_layer_norm_residual`` at 2e-4 / 1e-4 (the
bound of the JAX package's own test).

Dropout: the TPU kernel's mask comes from its on-core generator, which
no other device reproduces, so the port's mask (a hash of the seed and
the flat index) is recovered from its output and handed to JAX:
``fused_layer_norm_residual(x * m / (1 - p), r, w, b)`` must equal the
port's ``fused_layer_norm_residual_dropout(x, r, w, b, p, seed)`` within
1e-5, and its x-gradient within 2e-4 / 1e-4. The mask itself: keep rate,
determinism, another seed another mask, and the backward regenerating
it from the seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_norm as jfn
from paddle_tpu_torch.ops.hopper import fused_norm as tfn
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
EPS = 1e-5


def _inputs(seed, rows=13, h=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((rows, h), (rows, h), (h,), (rows, h), (rows, h))]


@pytest.mark.parametrize("residual", [False, True],
                         ids=["plain", "residual"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_grads_match_pallas_version(dtype, residual):
    x, r, w, gy, gz = _inputs(3 + residual)
    w = 1.0 + 0.1 * w
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else \
        dict(atol=1e-2, rtol=1e-2)
    jx, jr, jw = (jnp.asarray(a, jdt) for a in (x, r, w))
    tx, tr, tw = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (x, r, w))
    if residual:
        (jy, jz), vjp = jax.vjp(
            lambda a, b, c: jfn.fused_rms_norm_residual(a, b, c, EPS),
            jx, jr, jw)
        want_g = vjp((jnp.asarray(gy, jdt), jnp.asarray(gz, jdt)))
        ty, tz = tfn.fused_rms_norm_residual(tx, tr, tw, EPS)
        got_g = torch.autograd.grad(
            (ty.float() * torch.from_numpy(gy).to(tdt).float()).sum()
            + (tz.float() * torch.from_numpy(gz).to(tdt).float()).sum(),
            (tx, tr, tw))
        np.testing.assert_allclose(tz.detach().float().numpy(),
                                   np.asarray(jz, np.float32), **tol)
    else:
        jy, vjp = jax.vjp(lambda a, c: jfn.fused_rms_norm(a, c, EPS),
                          jx, jw)
        want_g = vjp(jnp.asarray(gy, jdt))
        ty = tfn.fused_rms_norm(tx, tw, EPS)
        got_g = torch.autograd.grad(
            (ty.float() * torch.from_numpy(gy).to(tdt).float()).sum(),
            (tx, tw))
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(jy, np.float32), **tol)
    for g, want in zip(got_g, want_g):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_cpu_tensors_take_the_plain_version():
    x, r, w, _, _ = _inputs(0)
    before = {k: tfn.launch_count(k)
              for k in ("rms_norm", "layer_norm", "dropout")}
    y, z = tfn.fused_rms_norm_residual(*(torch.from_numpy(a)
                                         for a in (x, r, w)), EPS)
    ry, rz = tfn.rms_fwd_reference(*(torch.from_numpy(a)
                                     for a in (x, r, w)), EPS)
    assert torch.equal(y, ry) and torch.equal(z, rz)
    b = torch.from_numpy(w[::-1].copy())
    y, z = tfn.fused_layer_norm_residual(*(torch.from_numpy(a)
                                           for a in (x, r, w)), b, EPS)
    ry, rz = tfn.ln_fwd_reference(*(torch.from_numpy(a)
                                    for a in (x, r, w)), b, EPS)
    assert torch.equal(y, ry) and torch.equal(z, rz)
    d = tfn._dropout_via_vjp(torch.from_numpy(x), 0.1, 5)
    assert torch.equal(d, tfn.dropout_reference(torch.from_numpy(x), 0.1, 5))
    assert {k: tfn.launch_count(k) for k in before} == before


def _bf16_ulp(a):
    """One bfloat16 ulp at each value of ``a`` (float32)."""
    a = np.abs(np.asarray(a, np.float32))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(
        a, 1e-30))) - 7), 2.0 ** -133)


def _ln_inputs(seed):
    x, r, w, _, _ = _inputs(seed)
    b = np.random.RandomState(seed + 100).randn(*w.shape).astype(np.float32)
    return x, r, 1.0 + 0.1 * w, 0.1 * b


@pytest.mark.parametrize("residual", [False, True],
                         ids=["plain", "residual"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_pallas_version(dtype, residual):
    x, r, w, b = _ln_inputs(11 + residual)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jz = jfn._ln_fwd_call(*(jnp.asarray(a, jdt) for a in (x,)),
                              jnp.asarray(r, jdt) if residual else None,
                              jnp.asarray(w, jdt), jnp.asarray(b, jdt), EPS)
    tx, tr, tw, tb = (torch.from_numpy(a).to(tdt) for a in (x, r, w, b))
    if residual:
        ty, tz = tfn.fused_layer_norm_residual(tx, tr, tw, tb, EPS)
    else:
        ty, tz = tfn.fused_layer_norm(tx, tw, tb, EPS), tx
    assert ty.dtype == tdt and tz.dtype == tdt
    got, want = ty.float().numpy(), np.asarray(jy, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    np.testing.assert_array_equal(tz.float().numpy(),
                                  np.asarray(jz, np.float32))


@pytest.mark.parametrize("residual", [False, True],
                         ids=["plain", "residual"])
def test_layer_norm_grads_match_jax(residual):
    x, r, w, b = _ln_inputs(21 + residual)
    tx, tr, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                      for a in (x, r, w, b))
    if residual:
        def f(a, c, d, e):
            y, z = jfn.fused_layer_norm_residual(a, c, d, e, EPS)
            return (y ** 2).sum() + (z ** 3).sum()
        want = jax.grad(f, argnums=(0, 1, 2, 3))(x, r, w, b)
        ty, tz = tfn.fused_layer_norm_residual(tx, tr, tw, tb, EPS)
        got = torch.autograd.grad((ty ** 2).sum() + (tz ** 3).sum(),
                                  (tx, tr, tw, tb))
    else:
        want = jax.grad(lambda a, d, e: (jfn.fused_layer_norm(
            a, d, e, EPS) ** 2).sum(), argnums=(0, 1, 2))(x, w, b)
        got = torch.autograd.grad(
            (tfn.fused_layer_norm(tx, tw, tb, EPS) ** 2).sum(),
            (tx, tw, tb))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=2e-4,
                                   rtol=1e-4)


def test_dropout_layer_norm_matches_jax_on_the_recovered_mask():
    """The port's dropout + residual + LayerNorm against JAX's LayerNorm
    of x * m / (1 - p), m the mask read off the port's dropout output;
    then the x-gradient, which the port gets by regenerating the mask."""
    x, r, w, b = _ln_inputs(31)
    p, seed = 0.25, 1234
    tx, tr, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                      for a in (x, r, w, b))
    ty, tz = tfn.fused_layer_norm_residual_dropout(tx, tr, tw, tb, EPS, p,
                                                   seed)
    m = (tfn._fused_dropout(torch.from_numpy(x), p, seed) != 0).numpy()
    assert 0 < m.mean() < 1
    div = np.float32(1.0 - p)

    def f(a):
        y, z = jfn.fused_layer_norm_residual(a * m / div, r, w, b, EPS)
        return y, z

    jy, jz = f(x)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz),
                               atol=1e-5, rtol=1e-5)
    want = jax.grad(lambda a: (f(a)[0] ** 2).sum())(x)
    got, = torch.autograd.grad((ty ** 2).sum(), (tx,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_keep_rate_determinism_and_seed(dtype):
    tdt = getattr(torch, dtype)
    x = torch.ones(4096, 768, dtype=tdt)
    y = tfn._fused_dropout(x, 0.1, 7)
    assert y.dtype == tdt
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.9) < 1e-3
    # kept entries are x / (1 - p) rounded once to the type
    assert torch.equal(y[y != 0], torch.full((), 1 / np.float32(0.9),
                                             dtype=torch.float32).to(tdt)
                       .expand(int((y != 0).sum())))
    assert torch.equal(y, tfn._fused_dropout(x, 0.1, 7))
    assert not torch.equal(y, tfn._fused_dropout(x, 0.1, 8))
    # the mask is a function of (seed, flat index) only: any shape, any
    # negative seed's bits
    flat = tfn._fused_dropout(x.reshape(-1)[:600], 0.1, 7)
    assert torch.equal(flat, y.reshape(-1)[:600])
    assert torch.equal(tfn._fused_dropout(x[:2], 0.3, -5),
                       tfn._fused_dropout(x[:2], 0.3, 2 ** 32 - 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_backward_regenerates_the_mask(dtype):
    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(41)
    x = torch.from_numpy(rng.randn(13, 64).astype(np.float32)).to(tdt)
    gy = torch.from_numpy(rng.randn(13, 64).astype(np.float32)).to(tdt)
    x.requires_grad_(True)
    y = tfn._dropout_via_vjp(x, 0.2, 99)
    gx, = torch.autograd.grad(y, (x,), gy)
    keep = tfn.dropout_keep(x.numel(), 99, 0.2, "cpu").view(13, 64)
    assert torch.equal(y.detach() != 0, keep)
    want = ((gy.float() * keep.float())
            / torch.tensor(np.float32(0.8))).to(tdt)
    assert torch.equal(gx, want)
