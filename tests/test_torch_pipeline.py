"""The port's SPMD pipeline (paddle_tpu_torch/parallel/pipeline.py)
against the JAX package's ``spmd_pipeline`` on the conftest's virtual CPU
devices and against the serial map of the stages, outputs and
gradients; the schedule's ticks, bubbles and sends; the interleave's
divisibility error; and remat_stage's saved bytes (the twin of
``test_remat_stage_reduces_activation_memory``, counted by
``torch.autograd.graph.saved_tensors_hooks``).

Tolerances (the JAX twins'): outputs 1e-5 (pp 4 x dp 2: 1e-5 relative
too), gradients 1e-4 against JAX and the serial map.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.parallel.pipeline import spmd_pipeline as jax_pipeline
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import mesh as port_mesh
from paddle_tpu_torch.parallel.pipeline import (interleave_stage_params,
                                                schedule, spmd_pipeline,
                                                stack_stage_params)
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)


def _meshes(**deg):
    n = int(np.prod(list(deg.values())))
    jax_mesh.build_mesh(**deg, devices=jax.devices()[:n])
    port_mesh.build_mesh(**deg, devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _restore_meshes():
    yield
    port_mesh.set_mesh(None)
    jax_mesh.build_mesh(dp=1, devices=jax.devices()[:1])


def _setup(n_chunks=8, n_micro=8, mb=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    Ws = (rng.standard_normal((n_chunks, d, d)) * 0.2).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return Ws, x


def _serial(Ws, xm):
    out = []
    for x in xm:
        for W in Ws:
            x = torch.tanh(x @ W)
        out.append(x)
    return torch.stack(out)


def _jax(Ws, xm, **kw):
    """The JAX pipeline's outputs and the gradient of sum(out ** 2)."""
    def loss(W, x):
        return (jax_pipeline(lambda p, xb: jnp.tanh(xb @ p["w"]), {"w": W},
                             x, **kw) ** 2).sum()
    out = jax.jit(lambda W, x: jax_pipeline(
        lambda p, xb: jnp.tanh(xb @ p["w"]), {"w": W}, x, **kw))(
        jnp.asarray(Ws), jnp.asarray(xm))
    g = jax.jit(jax.grad(loss))(jnp.asarray(Ws), jnp.asarray(xm))
    return np.asarray(out), np.asarray(g)


def _port(Ws, xm, **kw):
    W = torch.from_numpy(Ws).requires_grad_(True)
    out = spmd_pipeline(lambda p, xb: torch.tanh(xb @ p["w"]), {"w": W},
                        torch.from_numpy(xm), **kw)
    (g,) = torch.autograd.grad((out ** 2).sum(), [W])
    return out.detach().numpy(), g.numpy()


def _serial_ref(Ws, xm):
    W = torch.from_numpy(Ws).requires_grad_(True)
    out = _serial(W, torch.from_numpy(xm))
    (g,) = torch.autograd.grad((out ** 2).sum(), [W])
    return out.detach().numpy(), g.numpy()


def test_pp2_matches_jax_and_serial():
    _meshes(pp=2)
    Ws, x = _setup(n_chunks=2, n_micro=4, d=8)
    got, want, ser = _port(Ws, x), _jax(Ws, x), _serial_ref(Ws, x)
    for ref in (want, ser):
        np.testing.assert_allclose(got[0], ref[0], atol=1e-6)
        np.testing.assert_allclose(got[1], ref[1], atol=1e-5)


@pytest.mark.parametrize("n_micro", [4, 8, 12])
@pytest.mark.parametrize("remat", [False, True])
def test_interleave_matches_jax_and_serial(n_micro, remat):
    _meshes(pp=4, dp=2)
    Ws, x = _setup(n_micro=n_micro)
    kw = dict(n_virtual=2, remat_stage=remat)
    got, want, ser = _port(Ws, x, **kw), _jax(Ws, x, **kw), \
        _serial_ref(Ws, x)
    for ref in (want, ser):
        np.testing.assert_allclose(got[0], ref[0], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[1], ref[1], atol=1e-4, rtol=1e-4)


def test_staged_layout_equals_logical():
    _meshes(pp=4, dp=2)
    Ws, x = _setup()
    staged = interleave_stage_params({"w": torch.from_numpy(Ws)}, 4, 2)
    assert tuple(staged["w"].shape) == (4, 2, 16, 16)
    a = spmd_pipeline(lambda p, xb: torch.tanh(xb @ p["w"]), staged,
                      torch.from_numpy(x), n_virtual=2,
                      params_layout="staged")
    b = spmd_pipeline(lambda p, xb: torch.tanh(xb @ p["w"]),
                      {"w": torch.from_numpy(Ws)}, torch.from_numpy(x),
                      n_virtual=2)
    assert torch.equal(a, b)
    stacked = stack_stage_params([{"w": torch.ones(2)}, {"w": torch.zeros(2)}])
    assert tuple(stacked["w"].shape) == (2, 2)


@pytest.mark.parametrize("n,n_micro,v", [(2, 4, 1), (4, 8, 1), (4, 8, 2),
                                         (4, 12, 2), (2, 6, 3)])
def test_schedule_ticks_bubbles_sends(n, n_micro, v):
    """The reference's tick counts; every stage runs each micro-batch
    once per chunk; bubbles are the n (n - 1) fill/drain slots; each slot
    but the last chunk's last stage sends one activation; one ppermute a
    tick with a send."""
    sched = schedule(n, n_micro, v)
    ticks = (n_micro // n) * v * n + n - 1 if v > 1 else n_micro + n - 1
    assert len(sched) == ticks
    slots = [sl for t in sched for sl in t]
    assert len(slots) == n * v * n_micro
    assert ticks * n - len(slots) == n * (n - 1)
    assert sorted((sl.stage, sl.chunk, sl.micro) for sl in slots) == sorted(
        (s, c, m) for s in range(n) for c in range(v)
        for m in range(n_micro))
    assert sum(sl.emit for sl in slots) == n_micro
    assert sum(sl.feed for sl in slots) == n_micro
    port_mesh.build_mesh(pp=n, devices=["cpu"] * n)
    Ws = torch.zeros((v * n, 4, 4))
    collective.reset_counts()
    spmd_pipeline(lambda p, xb: xb @ p["w"], {"w": Ws},
                  torch.zeros((n_micro, 1, 4)), n_virtual=v)
    sends = sum(1 for t in sched if any(not sl.emit for sl in t))
    assert collective.counts()["ppermute"]["calls"] == sends


def test_interleave_rejects_bad_micro():
    _meshes(pp=4, dp=2)
    Ws, x = _setup(n_micro=6)  # 6 % 4 != 0
    with pytest.raises(ValueError, match="divisible"):
        spmd_pipeline(lambda p, xb: torch.tanh(xb @ p["w"]),
                      {"w": torch.from_numpy(Ws)}, torch.from_numpy(x),
                      n_virtual=2)
    with pytest.raises(ValueError, match="divisible"):
        schedule(4, 6, 2)


def test_remat_stage_reduces_activation_memory():
    """Bytes the autograd graph saves for the backward: with per-slot
    checkpoints only each slot's input activation, below the
    store-everything schedule."""
    _meshes(pp=4, dp=2)
    Ws, x = _setup(n_chunks=4, n_micro=8, d=32)

    def saved(remat):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        W = torch.from_numpy(Ws).requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = spmd_pipeline(lambda p, xb: torch.tanh(xb @ p["w"]),
                                {"w": W}, torch.from_numpy(x),
                                remat_stage=remat)
        torch.autograd.grad((out ** 2).sum(), [W])
        return total[0]

    plain, remat = saved(False), saved(True)
    assert remat < plain, (remat, plain)


def test_build_mesh_like_the_reference():
    """The reference's build_mesh contract on repeated (logical) devices:
    AXIS_ORDER, dp=-1 fills, a product above the device count raises;
    on_device places an installed mesh's ranks on one device; the
    serving shards take the training mesh's first mp row."""
    cpu = torch.device("cpu")
    m = port_mesh.build_mesh(pp=2, mp=2, dp=-1, devices=["cpu"] * 8)
    assert tuple(m.shape) == port_mesh.AXIS_ORDER == tuple(
        jax_mesh.AXIS_ORDER)
    assert m.shape == {"dp": 2, "pp": 2, "sharding": 1, "sep": 1, "mp": 2}
    assert port_mesh.mesh_axis_size("mp") == 2 and m.size == 8
    assert port_mesh.serving_shard_devices(2) == [cpu, cpu]
    assert port_mesh.on_device("cpu").shape == m.shape
    with pytest.raises(ValueError, match="needs 16 devices"):
        port_mesh.build_mesh(dp=2, pp=2, mp=4, devices=["cpu"] * 8)
    port_mesh.set_mesh(None)
    assert port_mesh.on_device("cpu").size == 1
