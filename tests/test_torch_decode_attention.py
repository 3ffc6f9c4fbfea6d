"""The PyTorch port's dense decode attention
(paddle_tpu_torch/ops/hopper/decode_attention.py) held against the JAX
package's Pallas kernel in interpret mode on the CPU, from the same
seeded numpy inputs; float32, atol = rtol = 1e-5. The port reads the
cache through strides, so the inputs are the [B, S, H, D] transposed
views of a [2, B, H, S, D] layer cache, as the serving model passes
them."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.hopper import decode_attention as tda

# the pallas package re-exports the function under the module's name
jda = importlib.import_module("paddle_tpu.ops.pallas.decode_attention")

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, B, nh, nkv, hd, S):
    rng = np.random.RandomState(seed)
    cache = rng.randn(2, B, nkv, S, hd).astype(np.float32)
    q = rng.randn(B, nh, hd).astype(np.float32)
    return q, cache


@pytest.mark.parametrize("nh,nkv,S,lens", [
    (4, 4, 32, [0, 1, 17, 32]),       # length 0 -> zeros, full row
    (8, 2, 48, [5, 48, 0]),           # GQA, S not a block multiple
    (4, 4, 200, [199, 3]),            # JAX pads the cache axis to 256
])
def test_plain_version_matches_pallas_kernel(nh, nkv, S, lens):
    B = len(lens)
    q, cache = _case(len(lens) + S, B, nh, nkv, 16, S)
    lens = np.asarray(lens, np.int32)
    ref = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.swapaxes(jnp.asarray(cache[0]), 1, 2),
        jnp.swapaxes(jnp.asarray(cache[1]), 1, 2), jnp.asarray(lens),
        block_s=16))
    tc = torch.from_numpy(cache)
    got = tda.decode_attention(torch.from_numpy(q), tc[0].transpose(1, 2),
                               tc[1].transpose(1, 2), lens).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[lens == 0].any()


def test_matches_jax_reference():
    q, cache = _case(0, 3, 4, 2, 16, 24)
    lens = np.asarray([24, 7, 1], np.int32)
    k, v = (np.swapaxes(c, 1, 2) for c in cache)
    ref = np.asarray(jda.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    got = tda.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lens).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
