"""The port's LlamaSpmdTrainer on a mesh of logical CPU ranks
(paddle_tpu_torch/models/llama_spmd.py, parallel/) held against the JAX
package's hybrid trainer on the conftest's 8 virtual CPU devices, from
the JAX trainer's weights, and against the port's one-device trainer.

Meshes: the two of the JAX package's
``test_hybrid_forward_and_grads_match_serial`` (dp 2 x pp 2 x mp 2;
pp 2 x sharding 2 x sep 2, ring attention at T 64), batch 8 (the port's
dp ranks each run n_micro micro-batches of their own rows, so the batch
per dp rank must divide n_micro: the JAX twin's batch 4 does not at
dp 2). Each JAX result is built once per mesh (module-scoped fixtures).
float32 compute.

Tolerances (the JAX twin's own): logits 2e-4, the loss 1e-5, every
gradient leaf 3e-4; after three ``train_step``s the loss sequence 1e-5
relative, and params / m / v / master by ``test_torch_llama_spmd.py``'s
bound formula (AdamW divides by sqrt(v): a gradient difference d moves a
step's update by ~lr d / sqrt(v)). Remat policies and the interleaved
schedule against their plain twins: 1e-6 / 1e-5 (the same arithmetic in
another grouping).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import llama_spmd as jax_spmd
from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import LlamaConfig, LlamaSpmdTrainer
from paddle_tpu_torch.models import llama_spmd as port_spmd
from paddle_tpu_torch.models.llama_spmd import tree_get, tree_paths
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import mesh as port_mesh
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
LR = 1e-3
WIDTHS = dict(vocab=128, hidden=32, layers=4, heads=4, kv_heads=2, inter=64)
MESHES = {
    "dp2_pp2_mp2": {"dp": 2, "pp": 2, "sharding": 1, "sep": 1, "mp": 2},
    "pp2_sharding2_sep2": {"dp": 1, "pp": 2, "sharding": 2, "sep": 2,
                           "mp": 1},
}
BATCH = 8


def _seq(deg):
    return 32 * deg["sep"]


def _ids(deg):
    return np.random.default_rng(0).integers(0, WIDTHS["vocab"],
                                             (BATCH, _seq(deg)))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _install(deg):
    n = int(np.prod(list(deg.values())))
    return port_mesh.build_mesh(**deg, devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _restore_meshes():
    yield
    port_mesh.set_mesh(None)
    jax_mesh.build_mesh(dp=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def jax_runs():
    """Per mesh: the JAX hybrid trainer's weights, logits, loss and
    gradients, and (dp 2 x pp 2 x mp 2) three train_steps (on the other
    mesh JAX compiles its step twice: ZeRO's sharding test below holds
    the port's steps to the one-device trainer's)."""
    out = {}
    for name, deg in MESHES.items():
        jax_mesh.build_mesh(**deg)
        cfg = JaxLlamaConfig.tiny(seq=_seq(deg), **WIDTHS)
        tr = jax_spmd.LlamaSpmdTrainer(cfg, lr=LR, n_micro=2 * deg["pp"],
                                       compute_dtype=jnp.float32, seed=0)
        ids = jnp.asarray(_ids(deg))
        # one program for the logits and the gradients: one compile
        logits, (loss, grads) = jax.jit(lambda p, i: (
            tr.forward(p, i), jax.value_and_grad(tr.loss_fn)(p, i, i)))(
            tr.params, ids)
        run = {"params": _np_tree(tr.params), "logits": np.asarray(logits),
               "loss": float(loss), "grads": _np_tree(grads)}
        run["specs"] = {
            tuple(k.key for k in p): tuple(leaf["m"].sharding.spec)
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                tr.opt_state, is_leaf=lambda x: isinstance(x, dict)
                and "m" in x)[0]}
        if deg["mp"] > 1:
            run["losses"] = [float(tr.train_step(_ids(deg)))
                             for _ in range(3)]
            run["after"] = (_np_tree(tr.params), _np_tree(tr.opt_state))
        out[name] = run
    jax_mesh.build_mesh(dp=1, devices=jax.devices()[:1])
    return out


def _port(name, params_np, **kw):
    deg = MESHES[name]
    _install(deg)
    return weights.llama_spmd_trainer(
        params_np, LlamaConfig.tiny(seq=_seq(deg), **WIDTHS), lr=LR,
        n_micro=2 * deg["pp"], compute_dtype=torch.float32, **kw)


def _global_grads(tr, ids):
    """(loss, {path: global summed gradient}) through the trainer's own
    reduction (reduce-scatter / all-reduce over each shard's replicas)."""
    loss, grads = tr.grads(ids)
    return loss.item(), {p: g.numpy() for p, g in grads.items()}


def _serial(params_np, deg, **kw):
    """The port's one-device trainer holding the same weights (block
    leaves collapsed to [1, L, ...] in logical layer order)."""
    def serial(path, a):
        if path[0] != "blocks":
            return a
        return a.reshape((1, -1) + a.shape[2:])
    port_mesh.set_mesh(None)
    flat = {p: serial(p, tree_get(params_np, p))
            for p in tree_paths(params_np)}
    tree = {"blocks": {}}
    for p, a in flat.items():
        (tree if len(p) == 1 else tree["blocks"])[p[-1]] = a
    return weights.llama_spmd_trainer(
        tree, LlamaConfig.tiny(seq=_seq(deg), **WIDTHS), device="cpu",
        lr=LR, compute_dtype=torch.float32, **kw)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_hybrid_matches_jax_hybrid_and_one_device(name, jax_runs):
    run, deg = jax_runs[name], MESHES[name]
    ids = _ids(deg)
    tr = _port(name, run["params"])
    collective.reset_counts()
    with torch.no_grad():
        logits = tr.forward(tr.params, ids).numpy()
    np.testing.assert_allclose(logits, run["logits"], atol=2e-4, rtol=2e-4)
    loss, grads = _global_grads(tr, ids)
    np.testing.assert_allclose(loss, run["loss"], atol=1e-5, rtol=1e-5)
    for path in tree_paths(tr.params):
        np.testing.assert_allclose(grads[path], tree_get(run["grads"], path),
                                   atol=3e-4, rtol=3e-4, err_msg=str(path))
    # the collectives the mesh needs, and only those
    c = collective.counts()
    assert c["all_gather"]["calls"] == 0
    assert (c["ppermute"]["calls"] > 0) == (deg["pp"] > 1 or deg["sep"] > 1)
    assert (c["reduce_scatter"]["calls"] > 0) == (deg["sharding"] > 1)
    # the one-device trainer on the same weights
    one = _serial(run["params"], deg)
    with torch.no_grad():
        np.testing.assert_allclose(logits, one.forward(one.params, ids)
                                   .numpy(), atol=2e-4, rtol=2e-4)
    l1, g1 = _global_grads(one, ids)
    np.testing.assert_allclose(loss, l1, atol=1e-5, rtol=1e-5)
    for path in tree_paths(tr.params):
        np.testing.assert_allclose(grads[path].reshape(g1[path].shape),
                                   g1[path], atol=3e-4, rtol=3e-4,
                                   err_msg=str(path))


def test_train_steps_match_jax_hybrid(jax_runs):
    name = "dp2_pp2_mp2"
    run, deg = jax_runs[name], MESHES[name]
    tr = _port(name, run["params"])
    losses = [float(tr.train_step(_ids(deg))) for _ in range(3)]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    params, opt = weights.llama_spmd_state_np(tr)
    jparams, jopt = run["after"]
    for path in tree_paths(params):
        jst = tree_get(jopt, path)
        bound = 1e-6 + 2 * LR * np.minimum(
            1.0, 3e-6 / np.maximum(np.sqrt(jst["v"]), 1e-30))
        for what, got, want in (("param", tree_get(params, path),
                                 tree_get(jparams, path)),
                                ("master", tree_get(opt, path)["master"],
                                 jst["master"])):
            err = np.abs(got - want)
            assert (err <= bound).all(), (path, what, err.max())
        np.testing.assert_allclose(tree_get(opt, path)["m"], jst["m"],
                                   atol=1e-6, rtol=0, err_msg=str(path))
        np.testing.assert_allclose(tree_get(opt, path)["v"], jst["v"],
                                   atol=1e-8, rtol=0, err_msg=str(path))


def test_zero_spec_is_the_reference_s(jax_runs):
    """_zero_spec for every leaf: the JAX trainer's opt-state specs on the
    pp 2 x sharding 2 x sep 2 mesh, and the reference function at
    sharding 4 and 3, on the port trainer's (shape, spec) of each leaf."""
    run = jax_runs["pp2_sharding2_sep2"]
    tr = _port("pp2_sharding2_sep2", run["params"])
    for path, (shape, spec, _) in tr._specs.items():
        assert port_spmd._zero_spec(shape, spec) == run["specs"][path]
    for n in (4, 3):
        jax_mesh.build_mesh(sharding=n, devices=jax.devices()[:n])
        _install({"sharding": n})
        for shape, spec, _ in tr._specs.values():
            for s in (shape, (n * 3, 5) + shape[2:]):
                assert port_spmd._zero_spec(s, spec) == tuple(
                    jax_spmd._zero_spec(s, spec))


def test_zero_partitions_the_optimizer_state():
    """At sharding 4 each rank holds under half of the replicated m / v /
    master bytes, and three steps equal the one-device trainer's."""
    cfg = LlamaConfig.tiny(seq=32, **WIDTHS)
    one = LlamaSpmdTrainer(cfg, lr=LR, compute_dtype=torch.float32, seed=2,
                           device="cpu")
    _install({"sharding": 4})
    # device= places the installed mesh's ranks on that device
    tr = LlamaSpmdTrainer(cfg, lr=LR, compute_dtype=torch.float32, seed=2,
                          device="cpu")
    assert tr.mesh.shape == port_mesh.get_mesh().shape and tr.sharding == 4
    full = 3 * 4 * tr.param_count()
    for s in range(4):
        mine = sum(t.numel() * t.element_size()
                   for path in tree_paths(tr.params)
                   for v in tree_get(tr.opt_state, path).values()
                   for c, t in v.items() if c[2] == s)
        assert mine < full / 2, (s, mine, full)
    ids = _ids({"sep": 1})
    np.testing.assert_allclose([float(tr.train_step(ids)) for _ in range(3)],
                               [float(one.train_step(ids)) for _ in range(3)],
                               rtol=1e-6)
    got, _ = weights.llama_spmd_state_np(tr)
    want, _ = weights.llama_spmd_state_np(one)
    for path in tree_paths(got):
        np.testing.assert_allclose(tree_get(got, path), tree_get(want, path),
                                   atol=1e-6, rtol=0, err_msg=str(path))


def test_interleave_matches_the_plain_schedule():
    """pp 2 x mp 2 x dp 2, 8 layers: n_virtual 2 with remat_stage against
    n_virtual 1 from the same seed (the same logical layers)."""
    _install({"dp": 2, "pp": 2, "mp": 2})
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=8, heads=4,
                           kv_heads=2, inter=64, seq=16)
    ids = np.random.default_rng(0).integers(0, 64, (8, 16))
    plain = LlamaSpmdTrainer(cfg, remat=False, compute_dtype=torch.float32,
                             seed=3, n_micro=4)
    inter = LlamaSpmdTrainer(cfg, remat=False, compute_dtype=torch.float32,
                             seed=3, n_micro=4, n_virtual=2,
                             remat_stage=True)
    assert inter.layers_per_stage == 2 and plain.layers_per_stage == 4
    l1, g1 = _global_grads(plain, ids)
    l2, g2 = _global_grads(inter, ids)
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for path in g1:
        a = g2[path]
        if path[0] == "blocks":
            # staged [pp, v, lps, ...] -> logical layer order
            a = a.swapaxes(0, 1).reshape(g1[path].shape)
        np.testing.assert_allclose(a, g1[path], atol=1e-5, err_msg=str(path))
    assert inter.pipeline_stats.ticks == (4 // 2) * 2 * 2 + 2 - 1
    first = float(inter.train_step(ids))
    assert float(inter.train_step(ids)) < first


@pytest.mark.parametrize("deg", [{"dp": 2, "mp": 2}, {"sep": 2, "mp": 2}],
                         ids=["dp2_mp2", "sep2_mp2"])
def test_remat_policies_equal_full(deg):
    seq = 32 * deg.get("sep", 1)
    cfg = LlamaConfig.tiny(seq=seq, **WIDTHS)
    ids = np.random.default_rng(2).integers(0, WIDTHS["vocab"], (4, seq))
    _install(deg)
    out = {}
    for pol in ("full", "save_dots", "save_attn"):
        tr = LlamaSpmdTrainer(cfg, compute_dtype=torch.float32, seed=0,
                              remat_policy=pol)
        out[pol] = _global_grads(tr, ids)
    for pol in ("save_dots", "save_attn"):
        assert out[pol][0] == pytest.approx(out["full"][0], rel=1e-7)
        for path, g in out["full"][1].items():
            np.testing.assert_allclose(out[pol][1][path], g, atol=1e-6,
                                       err_msg=f"{pol} {path}")


def test_kernel_path_on_a_mesh():
    """``_fused`` forced on (the kernels' plain versions: RMSNorm, flash at
    hd 64 and T 128, AdamW) against the jnp branches on dp 2 x mp 2."""
    cfg = LlamaConfig.tiny(vocab=64, hidden=128, layers=2, heads=2,
                           kv_heads=2, inter=128, seq=128)
    ids = np.random.default_rng(4).integers(0, 64, (2, 128))
    _install({"dp": 2, "mp": 2})
    trs = []
    for fused in (True, False):
        tr = LlamaSpmdTrainer(cfg, lr=LR, compute_dtype=torch.float32,
                              seed=1)
        tr._fused = fused
        trs.append(tr)
    (la, ga), (lb, gb) = (_global_grads(t, ids) for t in trs)
    assert la == pytest.approx(lb, rel=1e-6)
    for path in ga:
        np.testing.assert_allclose(ga[path], gb[path], atol=2e-5,
                                   err_msg=str(path))
    losses = [[float(t.train_step(ids)) for _ in range(2)] for t in trs]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
