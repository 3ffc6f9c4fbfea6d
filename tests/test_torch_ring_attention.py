"""The port's ring attention (paddle_tpu_torch/parallel/ring_attention.py)
against the JAX package's ``ring_attention`` on a dp 2 x sep 4 mesh of
the conftest's virtual CPU devices and against ``_dense_reference``:
causal and not, GQA and MHA, forward and gradients; the collective
counters (2 (n - 1) sends a call, no all-gather); sep 1.

Tolerances (the JAX twins'): forward 2e-5, gradients 5e-4 absolute /
1e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.parallel.ring_attention import ring_attention as jax_ring
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import mesh as port_mesh
from paddle_tpu_torch.parallel.ring_attention import (_dense_reference,
                                                      ring_attention)

torch.set_num_threads(1)
SEP = 4


@pytest.fixture
def sep_mesh():
    jax_mesh.build_mesh(dp=2, sep=SEP)
    port_mesh.build_mesh(dp=2, sep=SEP, devices=["cpu"] * (2 * SEP))
    yield
    port_mesh.set_mesh(None)
    jax_mesh.build_mesh(dp=1, devices=jax.devices()[:1])


def _qkv(B=2, T=32, nh=8, nkv=4, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, n, hd)).astype(np.float32)
                 for n in (nh, nkv, nkv))


def _ring(q, k, v, causal=True, grad=False):
    """The port's ring over the sep chunks of each dp rank's rows; the
    gradient of sum(out ** 2) when ``grad``."""
    ts = [torch.from_numpy(a).requires_grad_(grad) for a in (q, k, v)]
    rows = []
    for d in range(2):
        half = [t[d:d + 1] for t in ts]
        chunks = [list(t.chunk(SEP, dim=1)) for t in half]
        rows.append(torch.cat(ring_attention(*chunks, causal=causal), 1))
    out = torch.cat(rows, 0)
    if not grad:
        return out.detach().numpy()
    return [g.numpy() for g in torch.autograd.grad((out ** 2).sum(), ts)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(8, 4), (4, 4)], ids=["gqa", "mha"])
def test_forward_matches_jax_and_dense(causal, heads, sep_mesh):
    q, k, v = _qkv(nh=heads[0], nkv=heads[1])
    got = _ring(q, k, v, causal)
    want = np.asarray(jax.jit(lambda a, b, c: jax_ring(
        a, b, c, causal=causal))(q, k, v))
    dense = _dense_reference(*map(torch.from_numpy, (q, k, v)),
                             causal=causal).numpy()
    for ref in (want, dense):
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_grads_match_jax_and_dense(sep_mesh):
    q, k, v = _qkv()
    got = _ring(q, k, v, grad=True)
    want = jax.jit(jax.grad(lambda a, b, c: (jax_ring(a, b, c) ** 2).sum(),
                            argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    dense = torch.autograd.grad((_dense_reference(*ts) ** 2).sum(), ts)
    for g, w, dn in zip(got, want, dense):
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(g, dn.numpy(), atol=5e-4, rtol=1e-3)


def test_sends_and_no_gather(sep_mesh):
    """One call: 2 (n - 1) ppermutes forward (K and V each hop) and as
    many in the backward, no all-gather, no all-reduce."""
    q, k, v = _qkv(B=1, T=64, nh=4, nkv=4, hd=8)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    collective.reset_counts()
    out = ring_attention(*[list(t.chunk(SEP, dim=1)) for t in ts])
    c = collective.counts()
    assert c["ppermute"]["calls"] == 2 * (SEP - 1)
    # each hop moves every rank's block: K and V of [1, 16, 4, 8] float32
    assert c["ppermute"]["bytes"] == 2 * (SEP - 1) * SEP * 16 * 4 * 8 * 4
    torch.autograd.grad(sum((o ** 2).sum() for o in out), ts)
    c = collective.counts()
    assert c["ppermute"]["calls"] == 4 * (SEP - 1)
    assert c["all_gather"]["calls"] == c["all_reduce"]["calls"] == 0
    # every rank's output row block stays its own [1, 16, 4, 8]
    assert [tuple(o.shape) for o in out] == [(1, 16, 4, 8)] * SEP


def test_sep1_is_the_local_body():
    port_mesh.set_mesh(None)
    port_mesh.build_mesh(dp=1, devices=["cpu"])
    try:
        q, k, v = map(torch.from_numpy, _qkv(T=16))
        collective.reset_counts()
        out = ring_attention(q, k, v, causal=True)
        np.testing.assert_allclose(out.numpy(),
                                   _dense_reference(q, k, v).numpy(),
                                   atol=2e-5, rtol=2e-5)
        assert collective.counts()["ppermute"]["calls"] == 0
        port_mesh.build_mesh(sep=2, devices=["cpu"] * 2)
        with pytest.raises(ValueError, match="one chunk per rank"):
            ring_attention(q, k, v)
    finally:
        port_mesh.set_mesh(None)
