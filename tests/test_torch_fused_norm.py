"""The PyTorch port's fused RMSNorm (paddle_tpu_torch/ops/hopper/
fused_norm.py) held against the JAX package's ``fused_rms_norm`` and
``fused_rms_norm_residual`` (Pallas in interpret mode on the CPU), from
the same seeded numpy inputs: forward and the gradients of x, residual
and w for one random cotangent. 13 rows (not a multiple of 8), width 64.

Tolerances: float32 within 1e-5 (summation order only); bfloat16 I/O
within 1e-2 (the outputs and gradients are bfloat16, one ulp is 2**-8
relative, and the two frameworks sum the row statistics in other
orders, which can flip a rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_norm as jfn
from paddle_tpu_torch.ops.hopper import fused_norm as tfn

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
    before = tfn.launch_count()
    y, z = tfn.fused_rms_norm_residual(*(torch.from_numpy(a)
                                         for a in (x, r, w)), EPS)
    ry, rz = tfn.rms_fwd_reference(*(torch.from_numpy(a)
                                     for a in (x, r, w)), EPS)
    assert torch.equal(y, ry) and torch.equal(z, rz)
    assert tfn.launch_count() == before
