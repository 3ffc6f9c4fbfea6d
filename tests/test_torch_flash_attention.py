"""The PyTorch port's flash attention
(paddle_tpu_torch/ops/hopper/flash_attention.py) held against the JAX
package's Pallas kernels in interpret mode on the CPU, from the same
seeded numpy inputs, float32 unless said otherwise.

- The position-hash dropout mask equals JAX's ``_keep_scale`` bit for bit.
- The plain forward (out, lse) and backward (dq, dk, dv) repeat the
  Pallas arithmetic: within 1e-5 (summation order only). In bfloat16,
  where both round p, dS and P*mask to bf16 before their products and
  write bf16, within one bf16 rounding (2**-7 relative, plus 1e-5 for
  the summation order; the runs read at most one ulp in a few entries).
- ``flash_attention_blhd``'s gradients equal ``jax.grad`` of the JAX
  module's dense ``_mha_jnp`` within 1e-5, on the kernel route and on the
  dense route that causal ``t_q > t_k`` takes.

Pallas's causal dropout cannot run in interpret mode on the CPU (its
``program_id`` sits under ``pl.when``), so the dropout cases against the
kernels are non-causal; causal dropout is held against ``_mha_jnp``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.hopper import flash_attention as tfa

# the pallas package re-exports the function under the module's name
fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


@pytest.mark.parametrize("seed", [0, 12345, -5, 2 ** 31 - 1])
def test_keep_scale_matches_jax_bit_for_bit(seed):
    row = np.arange(300)[:, None]
    col = np.arange(300)[None]
    for bh in (0, 7, 1000):
        want = np.asarray(fa._keep_scale(
            jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32),
            jnp.int32(bh), jnp.int32(seed), 0.1))
        got = tfa._keep_scale(torch.from_numpy(row), torch.from_numpy(col),
                              bh, seed, 0.1).numpy()
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


CASES = {
    # name: (t_q, t_k, causal, dropout rate)
    "causal": (64, 64, True, 0.0),
    "causal_tail": (100, 100, True, 0.0),
    "causal_cross_length": (64, 192, True, 0.0),
    "non_causal_129_37": (129, 37, False, 0.0),
    "dropout": (64, 64, False, 0.1),
}


def _qkv(t_q, t_k, d=32, bh=3, seed=0):
    rng = np.random.RandomState(seed + t_q + t_k)
    return (rng.randn(bh, t_q, d).astype(np.float32),
            rng.randn(bh, t_k, d).astype(np.float32),
            rng.randn(bh, t_k, d).astype(np.float32),
            rng.randn(bh, t_q, d).astype(np.float32))


def _assert_close(got, want, dtype):
    got, want = _np(got.float()), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)


def _check_forward(name, dtype):
    t_q, t_k, causal, rate = CASES[name]
    q, k, v, _ = _qkv(t_q, t_k)
    seed = 7 if rate else None
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    o, lse = fa._flash_fwd_pallas(jq, jk, jv, causal, 0.3, interpret=True,
                                  return_lse=True, dropout_rate=rate,
                                  seed=seed)
    got_o, got_lse = tfa._flash_fwd(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal, 0.3, True, rate, seed)
    assert got_o.dtype == getattr(torch, dtype)
    _assert_close(got_o, o.astype(jnp.float32), dtype)
    np.testing.assert_allclose(_np(got_lse), np.asarray(lse), **TOL)


def _check_backward(name, dtype):
    t_q, t_k, causal, rate = CASES[name]
    q, k, v, do = _qkv(t_q, t_k, seed=1)
    seed = 11 if rate else None
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    o, lse = fa._flash_fwd_pallas(jq, jk, jv, causal, 0.3, interpret=True,
                                  return_lse=True, dropout_rate=rate,
                                  seed=seed)
    want = fa._flash_bwd_pallas(jq, jk, jv, o, lse, jdo, causal, 0.3,
                                interpret=True, dropout_rate=rate, seed=seed)
    tdt = getattr(torch, dtype)
    got = tfa._flash_bwd(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(np.array(o.astype(jnp.float32))).to(tdt),
        torch.from_numpy(np.array(lse)), torch.from_numpy(do).to(tdt),
        causal, 0.3, rate, seed)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _assert_close(g, w.astype(jnp.float32), dtype)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_matches_pallas_kernel(name):
    _check_forward(name, "float32")


@pytest.mark.parametrize("name", ["causal_tail", "dropout"])
def test_plain_backward_matches_pallas_kernel(name):
    _check_backward(name, "float32")


def test_plain_forward_bf16_matches_pallas_kernel():
    _check_forward("causal_cross_length", "bfloat16")


def test_plain_backward_bf16_matches_pallas_kernel():
    _check_backward("causal_tail", "bfloat16")


BLHD = {
    # name: (t_q, t_k, causal, dropout rate)
    "causal": (48, 48, True, 0.0),
    "non_causal_cross_length": (40, 56, False, 0.0),
    "causal_t_q_above_t_k_dense_route": (56, 40, True, 0.0),
    "causal_dropout": (48, 48, True, 0.25),
}


@pytest.mark.parametrize("name", sorted(BLHD))
def test_blhd_grads_match_jax_dense_attention(name):
    t_q, t_k, causal, rate = BLHD[name]
    rng = np.random.RandomState(t_q * t_k)
    B, H, D = 2, 3, 16
    q = rng.randn(B, t_q, H, D).astype(np.float32)
    k, v = (rng.randn(B, t_k, H, D).astype(np.float32) for _ in range(2))
    cot = rng.randn(B, t_q, H, D).astype(np.float32)
    seed = 9 if rate else None
    scale = 0.25

    def jax_loss(q_, k_, v_):
        out = fa._mha_jnp(*(jnp.moveaxis(t, 1, 2) for t in (q_, k_, v_)),
                          causal, scale, dropout_rate=rate,
                          seed=None if seed is None else jnp.int32(seed))
        return jnp.sum(jnp.moveaxis(out, 1, 2) * cot)

    # one compiled program (op by op, each primitive of the dense
    # attention and its gradient compiled on its own)
    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = tfa.flash_attention_blhd(tq, tk, tv, causal=causal,
                                   sm_scale=scale, dropout_rate=rate,
                                   seed=seed)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_blhd_dropout_routing():
    x = torch.ones((1, 4, 2, 16))
    assert not tfa.flash_attention_blhd(x, x, x, dropout_rate=1.0).any()
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_attention_blhd(x, x, x, dropout_rate=0.5)
