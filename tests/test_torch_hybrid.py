"""The rest of the port's fleet hybrid training held against the JAX
package on the CPU: ``PipelineLayer`` / ``PipelineParallel``, ZeRO
stages 1 and 3 over LOGICAL sharding ranks, the four meta-optimizers
with ``SGD`` / ``Momentum``, ``fleet.utils``, ``MoELayer`` over an
expert-parallel axis and ``TrainStep``.

The twins of ``tests/test_distributed.py:167-231`` (partition,
``train_batch`` against serial, stage 1, stage 3) and of
``tests/test_fleet_utils.py`` (5 cases). Every model is built by the
JAX package from ``paddle.seed`` and copied into the port through numpy
(``paddle_tpu_torch.weights``); inputs come from seeded numpy.

Tolerances (float32, summation order only): losses and parameters
within 1e-5 relative (``_close``: 1e-5 x max(1, max|ref|)); routing,
``segment_parts``, bytes per rank and collective counts exactly; MoE at
ep 2 within 1e-5 relative of the JAX layer with ``ep_axis="dp"`` on a
dp 2 mesh of the CPU devices.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from chip_smoke import fleet_hybrid_expected, moe_ep_expected
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import meta_parallel as jmp
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import fleet as pfleet
from paddle_tpu_torch.distributed.fleet import meta_parallel as pmp
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import mesh as pmesh
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)

_STATE = {
    "jax": ("paddle_tpu.distributed.fleet.topology",
            "paddle_tpu.distributed.env", "paddle_tpu.parallel.mesh",
            "paddle_tpu.distributed.fleet.fleet"),
    "port": ("paddle_tpu_torch.distributed.fleet.topology",
             "paddle_tpu_torch.distributed.env",
             "paddle_tpu_torch.parallel.mesh",
             "paddle_tpu_torch.distributed.fleet.fleet"),
}


def _snapshot(pkg):
    topo, env, mesh, fl = (importlib.import_module(m) for m in _STATE[pkg])
    return (topo, topo._HYBRID_PARALLEL_GROUP, env, dict(env._state), mesh,
            mesh._global_mesh, fl, dict(vars(fl._fleet)))


def _restore(saved):
    topo, hcg, env, env_state, mesh, m, fl, fleet_state = saved
    topo._HYBRID_PARALLEL_GROUP = hcg
    env._state.clear()
    env._state.update(env_state)
    mesh._global_mesh = m
    vars(fl._fleet).clear()
    vars(fl._fleet).update(fleet_state)


@pytest.fixture(autouse=True)
def _isolated():
    """Both packages' topology, mesh and fleet state as before each
    test."""
    saved = [_snapshot(p) for p in _STATE]
    yield
    for s in saved:
        _restore(s)


def _strategy(mod, **deg):
    s = mod.DistributedStrategy()
    s.hybrid_configs.update({f"{k}_degree": v for k, v in deg.items()})
    s.pipeline_configs["accumulate_steps"] = 4
    return s


def _init(**deg):
    """The same topology in both packages (the port's ranks logical on
    the CPU); returns the two strategies."""
    sj, sp = _strategy(jfleet, **deg), _strategy(pfleet, **deg)
    jfleet.init(is_collective=True, strategy=sj)
    pfleet.init(is_collective=True, strategy=sp, device="cpu")
    return sj, sp


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t.numpy(), np.float32)


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol, what


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _copy(jmod, pmod):
    """The port module holding the JAX module's weights, and its
    parameters named as the JAX module's."""
    pmod.set_state_dict({k: v.numpy() for k, v in jmod.state_dict().items()})
    weights.carry_param_names([p.name for p in jmod.parameters()], pmod)
    return pmod


def _close_params(jmod, pmod):
    for (n, jp), pp in zip(jmod.named_parameters(), pmod.parameters()):
        _close(_np(pp), _np(jp), n)


# -- PipelineLayer / PipelineParallel (test_distributed.py:167-201) ---------

@pytest.mark.parametrize("stages,seg", [(2, "uniform"), (3, "uniform"),
                                        (2, "layer:Linear"),
                                        (3, "layer:Linear")])
def test_pipeline_layer_segments_and_forward_equal_jax(stages, seg):
    """segment_parts exactly the reference's (7 entries: uniform splits
    unevenly, layer:Linear balances the 4 Linears), stage_layers' sizes,
    and the forward from the same weights within 1e-5."""
    _init(pp=2)
    kinds = [("Linear", 8), ("Tanh",), ("Linear", 8), ("Tanh",),
             ("Linear", 8), ("Linear", 8), ("Tanh",)]

    def descs(mod, nn_, **kw):
        return [mod.LayerDesc(nn_.Linear, 8, 8, **kw) if k[0] == "Linear"
                else mod.LayerDesc(nn_.Tanh) for k in kinds]
    paddle.seed(1)
    jp = jmp.PipelineLayer(layers=descs(jmp, jnn), num_stages=stages,
                           seg_method=seg)
    pp = _copy(jp, pmp.PipelineLayer(descs(pmp, pnn, device="cpu"),
                                     num_stages=stages, seg_method=seg))
    assert pp.segment_parts == jp.segment_parts
    assert [len(pp.stage_layers(s)) for s in range(stages)] == \
        [len(jp.stage_layers(s)) for s in range(stages)]
    assert [pp.get_stage_from_index(i) for i in range(len(kinds))] == \
        [jp.get_stage_from_index(i) for i in range(len(kinds))]
    x = _rand(2, 8)
    _close(_np(pp(torch.from_numpy(x))), _np(jp(paddle.to_tensor(x))))


def test_pipeline_train_batch_equals_jax_and_serial():
    """PipelineParallel (pp 2, accumulate_steps 4, SGD) through
    distributed_model / distributed_optimizer: three train_batch losses
    and the weights after them equal the JAX package's, and the port's
    own serial steps (the whole batch at once: the mean of equal-sized
    micro-batch losses is the batch's)."""
    sj, sp = _init(pp=2)
    layers = [("Linear", 4, 8), ("Tanh",), ("Linear", 8, 4), ("Tanh",)]

    def descs(mod, nn_, **kw):
        return [mod.LayerDesc(nn_.Linear, *a[1:], **kw) if a[0] == "Linear"
                else mod.LayerDesc(nn_.Tanh) for a in layers]
    paddle.seed(3)
    jp = jmp.PipelineLayer(layers=descs(jmp, jnn), num_stages=2,
                           loss_fn=lambda o, l: paddle.nn.functional
                           .mse_loss(o, l))

    def mse(o, l):
        return ((o - l) ** 2).mean()
    pp = _copy(jp, pmp.PipelineLayer(descs(pmp, pnn, device="cpu"),
                                     num_stages=2, loss_fn=mse))
    serial = _copy(jp, pmp.PipelineLayer(descs(pmp, pnn, device="cpu"),
                                         num_stages=2, loss_fn=mse))
    jm = jfleet.distributed_model(jp)
    pm = pfleet.distributed_model(pp)
    assert type(pm).__name__ == "PipelineParallel" and \
        pm.accumulate_steps == 4
    jo = jfleet.distributed_optimizer(
        paddle.optimizer.SGD(0.05, parameters=jp.parameters()), sj)
    po = pfleet.distributed_optimizer(
        popt.SGD(0.05, parameters=pp.parameters()), sp)
    so = popt.SGD(0.05, parameters=serial.parameters())
    x, y = _rand(8, 4, seed=1), _rand(8, 4, seed=2)
    for _ in range(3):
        lj = float(jm.train_batch([paddle.to_tensor(x), paddle.to_tensor(y)],
                                  jo))
        lp = float(pm.train_batch([torch.from_numpy(x), torch.from_numpy(y)],
                                  po))
        ls = serial.loss(serial(torch.from_numpy(x)), torch.from_numpy(y))
        ls.backward()
        so.step()
        so.clear_grad()
        _close(lp, lj)
        _close(lp, float(ls))
    _close_params(jp, pp)
    for a, b in zip(pp.parameters(), serial.parameters()):
        _close(_np(a), _np(b))
    _close(float(pm.eval_batch([torch.from_numpy(x), torch.from_numpy(y)])),
           float(jm.eval_batch([paddle.to_tensor(x), paddle.to_tensor(y)])))


# -- ZeRO stages 1 and 3 (test_distributed.py:203-231) ---------------------

def _shard_bytes(arr):
    sh = arr.addressable_shards[0]
    return int(np.prod(sh.data.shape)) * arr.dtype.itemsize


def test_sharding_stage1_equals_jax():
    """DygraphShardingOptimizer at sharding 8: each leaf's placement is
    the reference's _shard_spec, rank 0 holds exactly the bytes of the
    JAX package's first shard, three AdamW steps equal the JAX
    package's, and the state dict is the global view under the
    reference's keys."""
    from paddle_tpu.distributed.fleet.meta_parallel import sharding as js
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        sharding as ps
    _init(sharding=8)
    paddle.seed(4)
    jnet = jnn.Linear(16, 16)
    pnet = _copy(jnet, pnn.Linear(16, 16, device="cpu"))
    jo = paddle.optimizer.AdamW(0.01, parameters=jnet.parameters())
    jsh = jmp.DygraphShardingOptimizer(jo)
    po = popt.AdamW(0.01, parameters=pnet.parameters())
    psh = pmp.DygraphShardingOptimizer(po)
    for s in ((16, 16), (16,), (3, 8), (5,)):
        want = js._shard_spec(s)
        assert ps._shard_spec(s) == (None if want is None else tuple(want))
    x = _rand(4, 16, seed=5)
    collective.reset_counts()
    for _ in range(3):
        (jnet(paddle.to_tensor(x)).sum()).backward()
        jsh.step()
        jo.clear_grad()
        (pnet(torch.from_numpy(x)).sum()).backward()
        psh.step()
        po.clear_grad()
    _close_params(jnet, pnet)
    jbytes = sum(_shard_bytes(v) for st in jo._accumulators.values()
                 for v in st.values())
    assert psh.bytes_per_rank() == [jbytes] * 8
    leaves = [(tuple(p.shape), 4) for p in pnet.parameters()]
    want_c = fleet_hybrid_expected(leaves, 8)
    assert {k: (v["calls"], v["bytes"]) for k, v in
            collective.counts().items()} == {
        k: (3 * c, 3 * b) for k, (c, b) in want_c.items()}
    jsd, psd = jo.state_dict(), po.state_dict()
    assert sorted(psd) == sorted(jsd)
    for k, v in jsd.items():
        if k != "global_step":
            _close(_np(psd[k]), _np(v), k)


def test_group_sharded_stage3_equals_jax():
    """group_sharded_parallel(level "p_g_os") at sharding 8: parameter
    bytes per rank are the JAX package's first shards', the forward's
    all-gathers are counted, three steps equal the JAX package's."""
    from paddle_tpu.distributed.sharding import group_sharded_parallel \
        as jgsp
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    _init(sharding=8)
    paddle.seed(6)
    jnet = jnn.Linear(16, 16)
    pnet = _copy(jnet, pnn.Linear(16, 16, device="cpu"))
    jm, jo, _ = jgsp(jnet, paddle.optimizer.AdamW(
        0.001, parameters=jnet.parameters()), "p_g_os")
    pm, po, _ = group_sharded_parallel(pnet, popt.AdamW(
        0.001, parameters=pnet.parameters()), "p_g_os")
    assert pm.param_bytes_per_rank() == \
        [sum(_shard_bytes(p.data) for p in jnet.parameters())] * 8
    assert all(p.numel() == 0 for p in pnet.parameters())
    x = _rand(4, 16, seed=7)
    collective.reset_counts()
    for _ in range(3):
        jm(paddle.to_tensor(x)).sum().backward()
        jo.step()
        jo.clear_grad()
        pm(torch.from_numpy(x)).sum().backward()
        po.step()
        po.clear_grad()
    assert collective.counts()["all_gather"] == {
        "calls": 6, "bytes": 3 * (16 * 16 + 16) * 4}
    for jp_, pp_ in zip(jnet.parameters(), pm.get_all_parameters()):
        _close(_np(pp_), _np(jp_))


# -- SGD, Momentum and the meta-optimizers ----------------------------------

META = {
    "sgd": lambda m: (m.SGD(0.1, parameters=None), {}),
    "momentum": lambda m: (m.Momentum(0.1, 0.9, None), {}),
    "nesterov": lambda m: (m.Momentum(0.1, 0.9, None, True), {}),
    "lars": lambda m: (m.Momentum(0.1, 0.9, None),
                       {"lars": True, "lars_configs": dict(
                           lars_coeff=0.01, lars_weight_decay=0.001,
                           epsilon=1e-9, exclude_from_weight_decay=[])}),
    "dgc": lambda m: (m.Momentum(0.1, 0.9, None),
                      {"dgc": True, "dgc_configs": dict(
                          rampup_begin_step=1, rampup_step=2,
                          sparsity=[0.5, 0.75])}),
    "gradient_merge": lambda m: (m.Momentum(0.1, 0.9, None),
                                 {"gradient_merge": True,
                                  "gradient_merge_configs": dict(
                                      k_steps=2, avg=True)}),
    "localsgd": lambda m: (m.SGD(0.1, parameters=None),
                           {"localsgd": True,
                            "localsgd_configs": dict(k_steps=2,
                                                     begin_step=1)}),
}


@pytest.mark.parametrize("name", sorted(META))
def test_optimizers_and_meta_optimizers_equal_jax(name):
    """Each rule through fleet.distributed_optimizer (its strategy flag
    on) over a Linear + tanh + Linear net: four calls of backward, step
    and clear_grad (two merged steps under gradient_merge) give the JAX
    package's weights within 1e-5, and the same wrapper classes."""
    _init()
    paddle.seed(8)
    jnet = [jnn.Linear(6, 8), jnn.Linear(8, 3)]
    pnet = [_copy(j, pnn.Linear(j.weight.shape[0], j.weight.shape[1],
                                device="cpu")) for j in jnet]
    opts = []
    for mod, fl, net in ((paddle.optimizer, jfleet, jnet),
                         (popt, pfleet, pnet)):
        opt, flags = META[name](mod)
        opt._parameter_list = [p for layer in net
                               for p in layer.parameters()]
        s = fl.DistributedStrategy()
        for k, v in flags.items():
            if k.endswith("_configs"):
                getattr(s, k).update(v)
            else:
                setattr(s, k, v)
        opts.append(fl.distributed_optimizer(opt, s))
    jo, po = opts
    assert type(po._inner_opt).__name__ == type(jo._inner_opt).__name__
    x = _rand(5, 6, seed=9)
    for _ in range(4):
        h = jnet[1](paddle.tanh(jnet[0](paddle.to_tensor(x))))
        (h ** 2).mean().backward()
        jo.step()
        jo.clear_grad()
        h = pnet[1](torch.tanh(pnet[0](torch.from_numpy(x))))
        (h ** 2).mean().backward()
        po.step()
        po.clear_grad()
    for j, p in zip(jnet, pnet):
        _close_params(j, p)


# -- fleet.utils (test_fleet_utils.py) ---------------------------------------

def test_mix_precision_layer_accumulates_fp32_main_grad():
    """Two backwards add into one fp32 main_grad equal to the JAX
    package's, and MixPrecisionOptimizer's SGD step from it (through
    fp32 masters) gives its weights; clear_grad drops main_grad."""
    from paddle_tpu.distributed.fleet.utils import mix_precision_utils as jm
    from paddle_tpu_torch.distributed.fleet.utils import \
        mix_precision_utils as pm
    paddle.seed(0)
    jnet = jnn.Linear(4, 4)
    pnet = _copy(jnet, pnn.Linear(4, 4, device="cpu"))
    jw, pw = jm.MixPrecisionLayer(jnet), pm.MixPrecisionLayer(pnet)
    assert pnet.weight.dtype == torch.bfloat16
    jo = jm.MixPrecisionOptimizer(paddle.optimizer.SGD(
        0.1, parameters=jnet.parameters()))
    po = pm.MixPrecisionOptimizer(popt.SGD(0.1, parameters=pnet.parameters()))
    x = np.ones((2, 4), np.float32)
    for _ in range(2):
        (jw(paddle.to_tensor(x).astype("bfloat16")) ** 2).mean().backward()
        (pw(torch.from_numpy(x).bfloat16()) ** 2).mean().backward()
    assert pnet.weight.main_grad.dtype == torch.float32
    _close(_np(pnet.weight.main_grad), _np(jnet.weight.main_grad))
    jo.step()
    jo.clear_grad()
    po.step()
    po.clear_grad()
    assert pnet.weight.main_grad is None
    _close(_np(pnet.weight.float()), _np(jnet.weight.astype("float32")))


@pytest.mark.parametrize("main_grad", [False, True])
def test_fused_allreduce_gradients_leaves_global_gradients(main_grad):
    """The gradient helpers on the global view change no gradient (nor
    main_grad), and count no collective, at dp 2."""
    from paddle_tpu_torch.distributed.fleet.utils import (
        hybrid_parallel_util as hpu, mix_precision_utils as pm)
    _init(dp=2)
    net = pnn.Linear(4, 2, device="cpu")
    if main_grad:
        pm.MixPrecisionLayer(net)
    x = torch.ones(2, 4, dtype=net.weight.dtype)
    (net(x) ** 2).mean().backward()
    before = [(p.main_grad if main_grad else p.grad).clone()
              for p in net.parameters()]
    collective.reset_counts()
    hpu.fused_allreduce_gradients(list(net.parameters()), None)
    hpu.sharding_reduce_gradients(list(net.parameters()), None)
    hpu.broadcast_dp_parameters(net, None)
    after = [(p.main_grad if main_grad else p.grad) for p in net.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(v["calls"] == 0 for v in collective.counts().values())


def test_local_fs_and_log_util_equal_jax(tmp_path):
    """LocalFS's listing, moves and errors and the fleet logger's levels
    and layer_to_str as the JAX package's."""
    from paddle_tpu.distributed.fleet import utils as ju
    from paddle_tpu_torch.distributed.fleet import utils as pu
    seen = []
    for mod, root in ((ju, tmp_path / "j"), (pu, tmp_path / "p")):
        fs = mod.LocalFS()
        d = str(root / "a")
        fs.mkdirs(d)
        fs.touch(str(root / "a" / "x.txt"))
        fs.mkdirs(str(root / "a" / "sub"))
        listing = fs.ls_dir(d)
        fs.mv(str(root / "a" / "x.txt"), str(root / "a" / "y.txt"))
        with pytest.raises(mod.fs.FSFileNotExistsError):
            fs.mv(str(root / "nope"), str(root / "z"))
        with pytest.raises(mod.fs.FSFileExistsError):
            fs.touch(str(root / "a" / "y.txt"), exist_ok=False)
        moved = (fs.is_file(str(root / "a" / "y.txt")), fs.list_dirs(d))
        fs.delete(d)
        with pytest.raises(NotImplementedError):
            mod.HDFSClient()
        mod.set_log_level("DEBUG")
        lv = mod.logger.level
        mod.set_log_level(30)
        seen.append((listing, moved, fs.is_exist(d), lv, mod.logger.level,
                     mod.log_util.layer_to_str("Linear", 4, 2, bias=True)))
    assert seen[0] == seen[1]


# -- MoELayer over an expert-parallel axis ------------------------------------

def test_moe_ep2_equals_jax_ep2():
    """MoELayer(16, 4 experts, 32, top 2) over 32 tokens at ep 2 (the
    port's logical dp ranks; the JAX layer with ep_axis "dp" on a dp 2
    mesh of CPU devices) from the JAX layer's weights: the combine
    tensor's routing (experts, capacity positions, kept slots) exactly the JAX
    package's (its weights within 1e-5), the output and every gradient
    within 1e-5 relative, and
    the all-gathers and all-to-alls exactly as moe_ep_expected."""
    from paddle_tpu.incubate.moe import MoELayer as JMoE
    from paddle_tpu_torch.incubate.moe import MoELayer as PMoE
    jmesh.build_mesh(dp=2, devices=jax.devices()[:2])
    pmesh.build_mesh(dp=2, devices=["cpu"] * 2)
    paddle.seed(10)
    jl = JMoE(16, num_expert=4, d_hidden=32, top_k=2)
    pl = weights.moe_layer({k: v.numpy() for k, v in
                            jl.state_dict().items()},
                           PMoE(16, num_expert=4, d_hidden=32, top_k=2,
                                device="cpu"))
    assert jl.ep_axis == pl.ep_axis == "dp"
    x, proj = _rand(32, 16, seed=11), _rand(32, 16, seed=12)
    cap = max(int(1.25 * 32 * 2 / 4), 2)
    lg = jl.gate(paddle.to_tensor(x))[0]
    want = np.asarray(JMoE._gshard_combine(lg.data, 2, 4, cap, np.float32))
    got = torch.cat(PMoE._ep_combine(
        list(torch.from_numpy(_np(lg)).chunk(2, 0)), 2, 4, cap,
        torch.float32), 0)
    # the same experts, positions and kept slots; the kept weights within
    # an ulp (the two softmaxes round apart)
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    _close(got.numpy(), want)
    jx = paddle.to_tensor(x, stop_gradient=False)
    out = jl(jx)
    ((out * paddle.to_tensor(proj)).sum() + jl.l_aux).backward()
    px = torch.from_numpy(x).requires_grad_()
    collective.reset_counts()
    pout = pl(px)
    ((pout * torch.from_numpy(proj)).sum() + pl.l_aux).backward()
    assert {k: (v["calls"], v["bytes"]) for k, v in
            collective.counts().items()} == moe_ep_expected(4, cap, 16, 2, 2,
                                                            4)
    _close(_np(pout), _np(out))
    _close(_np(px.grad), _np(jx.grad))
    for (n, jp), pp in zip(jl.named_parameters(), pl.parameters()):
        _close(_np(pp.grad), _np(jp.grad), n)


# -- TrainStep ----------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_equals_jax(accum):
    """TrainStep(layer, AdamW, loss_fn) over 3 optimizer steps (3 x
    ``accum`` calls, grad_accum_avg): every call's loss and the weights
    after within 1e-5 of the JAX TrainStep's (its compiled step)."""
    from paddle_tpu.parallel.train_step import TrainStep as JTS
    from paddle_tpu_torch.parallel.train_step import TrainStep as PTS
    paddle.seed(12)
    jnet = jnn.Linear(6, 3)
    pnet = _copy(jnet, pnn.Linear(6, 3, device="cpu"))
    jts = JTS(jnet, paddle.optimizer.AdamW(0.01, parameters=jnet.parameters()),
              loss_fn=lambda m, x, y: ((m(x) - y) ** 2).mean(),
              grad_accum_steps=accum)
    pts = PTS(pnet, popt.AdamW(0.01, parameters=pnet.parameters()),
              loss_fn=lambda m, x, y: ((m(x) - y) ** 2).mean(),
              grad_accum_steps=accum)
    for i in range(3 * accum):
        x, y = _rand(4, 6, seed=20 + i), _rand(4, 3, seed=40 + i)
        lj = float(jts(paddle.to_tensor(x), paddle.to_tensor(y)))
        lp = float(pts(torch.from_numpy(x), torch.from_numpy(y)))
        _close(lp, lj)
    jts.sync_to_layer()
    pts.sync_to_layer()
    _close_params(jnet, pnet)
    assert pts.optimizer._step_count == jts.optimizer._step_count == 3
