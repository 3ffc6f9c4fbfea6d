"""The PyTorch port's fused AdamW (paddle_tpu_torch/ops/hopper/
fused_adamw.py) held against the JAX package's ``fused_adamw_update``
(Pallas in interpret mode on the CPU) over three steps, from the same
seeded numpy state and gradients. 3000 elements (not a multiple of the
Pallas 1024-lane rows), p in float32 and in bfloat16.

Tolerance: m, v and master within 1e-6 relative (+1e-9 absolute): the
same float32 formula in the same order; the scalars' float32 powers
(1 - beta^step) and the division by sqrt(v) may differ by an ulp. p is
master rounded to p's type: exact for float32 up to that, and one
bfloat16 ulp (2**-8 relative) where master sits on a rounding tie."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_adamw import fused_adamw_update as jadamw
from paddle_tpu_torch.ops.hopper import fused_adamw as tfw
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
HYPER = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_three_steps_match_pallas_version(pdtype):
    n = 3000
    rng = np.random.RandomState(1)
    master = (0.02 * rng.randn(n)).astype(np.float32)
    jdt, tdt = getattr(jnp, pdtype), getattr(torch, pdtype)
    js = [jnp.asarray(master, jdt), jnp.zeros(n, jnp.float32),
          jnp.zeros(n, jnp.float32), jnp.asarray(master)]
    t = [torch.from_numpy(master).to(tdt), torch.zeros(n), torch.zeros(n),
         torch.from_numpy(master.copy())]
    before = tfw.launch_count()
    for step in (1, 2, 3):
        g = (1e-2 * rng.randn(n)).astype(np.float32)
        p, m, v, ma = js
        js = list(jadamw(p, jnp.asarray(g, jdt), m, v, ma, step=step,
                         **HYPER))
        out = tfw.fused_adamw_update(t[0], torch.from_numpy(g).to(tdt),
                                     t[1], t[2], t[3], step=step, **HYPER)
        assert all(a is b for a, b in zip(out, t))      # in place
    assert tfw.launch_count() == before                 # CPU: plain version
    for got, want in zip(t[1:], js[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(t[0].float().numpy(),
                               np.asarray(js[0], np.float32),
                               rtol=1e-6 if pdtype == "float32" else 2 ** -8,
                               atol=1e-9)


def test_refuses_mismatched_state():
    p = torch.zeros(8)
    with pytest.raises(TypeError, match="float32"):
        tfw.fused_adamw_update(p, p, p.double(), p, p, step=1, **HYPER)
    with pytest.raises(ValueError, match="shape"):
        tfw.fused_adamw_update(p, torch.zeros(9), p, p, p, step=1, **HYPER)
