"""ZeRO state placement and offload, distributed checkpoints and
``paddle.save`` / ``paddle.load`` of the port held against the JAX
package on the CPU.

The twins of ``tests/test_zero_memory.py`` (6 cases: bytes per LOGICAL
sharding rank in place of a device's addressable shard, host-resident
offload states, the multi-rank offload refusal) and of
``tests/test_checkpoint_reshard.py`` (6 cases: a global-view checkpoint
restored INTO targets on another mesh, the orbax error, the pickle
dispatch, ``PPParallelAdaptor``), plus checkpoints and ``paddle.save``
files crossing the packages both ways. Models come from the JAX
package's ``paddle.seed`` through numpy; inputs from seeded numpy.

Tolerances: files and restored tensors bit for bit (float32 and int64;
bfloat16 through its float32 values); optimizer steps within 1e-6 x
max(1, max|ref|) of the JAX package's (float32, summation order only);
the offload step equal to the on-device step exactly; bytes per rank
exactly.
"""
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.framework import io as jio
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import checkpoint as pckpt
from paddle_tpu_torch.distributed.fleet.meta_parallel import sharding as psh
from paddle_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _meshes():
    """Both packages' meshes, and the port's topology, as before each
    test."""
    from paddle_tpu_torch.distributed.fleet import topology
    saved = (jmesh._global_mesh, pmesh._global_mesh,
             topology._HYBRID_PARALLEL_GROUP)
    yield
    jmesh._global_mesh, pmesh._global_mesh, \
        topology._HYBRID_PARALLEL_GROUP = saved


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * max(1.0, float(
        np.abs(want).max()))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nets(seed):
    """The JAX Linear-GELU-Linear net of test_zero_memory and its port
    twin with the same weights and parameter names."""
    paddle.seed(seed)
    j = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.GELU(),
                             paddle.nn.Linear(32, 16))
    p = torch.nn.Sequential(pnn.Linear(16, 32, device="cpu"), pnn.GELU(),
                            pnn.Linear(32, 16, device="cpu"))
    p.load_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                       for k, v in j.state_dict().items()})
    weights.carry_param_names([q.name for q in j.parameters()], p)
    return j, p


def _steps(jnet, jopt, pnet, popt_, x, n=3):
    losses = []
    for _ in range(n):
        lj = (jnet(paddle.to_tensor(x)) ** 2).mean()
        lj.backward()
        jopt.step()
        jopt.clear_grad()
        lp = (pnet(torch.from_numpy(x)) ** 2).mean()
        lp.backward()
        popt_.step()
        popt_.clear_grad()
        losses.append((float(lj), float(lp)))
    return losses


def _shard_bytes(arr):
    sh = arr.addressable_shards[0]
    return int(np.prod(sh.data.shape)) * arr.dtype.itemsize


# -- ZeRO and offload (test_zero_memory.py) ---------------------------------

def test_trainer_opt_state_sharded_over_zero_axis():
    """LlamaSpmdTrainer at sharding 4 x dp 2: every sharding rank holds
    exactly the JAX trainer's first-shard bytes of m / v / master, under
    half of the replicated state."""
    from paddle_tpu.models.llama import LlamaConfig as JCfg
    from paddle_tpu.models.llama_spmd import LlamaSpmdTrainer as JTr
    from paddle_tpu_torch.models import LlamaConfig, LlamaSpmdTrainer
    from paddle_tpu_torch.models.llama_spmd import tree_get, tree_paths
    widths = dict(vocab=64, hidden=64, layers=2, heads=4, kv_heads=4,
                  inter=128, seq=16)
    jmesh.build_mesh(sharding=4, dp=2)
    jtr = JTr(JCfg.tiny(**widths), remat=False,
              compute_dtype=jax.numpy.float32)
    want = sum(_shard_bytes(a) for a in jax.tree_util.tree_leaves(
        jtr.opt_state))
    full = sum(a.size * a.dtype.itemsize
               for a in jax.tree_util.tree_leaves(jtr.opt_state))
    pmesh.build_mesh(sharding=4, dp=2, devices=["cpu"] * 8)
    tr = LlamaSpmdTrainer(LlamaConfig.tiny(**widths), remat=False,
                          compute_dtype=torch.float32, device="cpu")
    for s in range(4):
        mine = sum(t.numel() * t.element_size()
                   for path in tree_paths(tr.params)
                   for v in tree_get(tr.opt_state, path).values()
                   for c, t in v.items() if c[2] == s and c[0] == 0)
        assert mine == want < 0.5 * full, (s, mine, want, full)


def test_fleet_shard_accumulators_partitions_states():
    """shard_accumulators after a step: each rank keeps the JAX
    package's first-shard bytes (at most half), and two more steps on
    the shards equal the JAX package's."""
    from paddle_tpu.distributed.fleet.meta_parallel.sharding import \
        shard_accumulators as jshard
    jmesh.build_mesh(sharding=4, dp=2)
    pmesh.build_mesh(sharding=4, dp=2, devices=["cpu"] * 8)
    paddle.seed(2)
    jl = paddle.nn.Linear(64, 64)
    pl = pnn.Linear(64, 64, device="cpu")
    pl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    jo = paddle.optimizer.AdamW(parameters=jl.parameters(),
                                learning_rate=1e-3)
    po = popt.AdamW(parameters=pl.parameters(), learning_rate=1e-3)
    x = _x(0, 4, 64)
    _steps(jl, jo, pl, po, x, 1)
    full = sum(v.numel() * 4 for st in po._accumulators.values()
               for v in st.values())
    jshard(jo, axis="sharding")
    psh.shard_accumulators(po, axis="sharding")
    want = sum(_shard_bytes(v) for st in jo._accumulators.values()
               for v in st.values())
    assert po._accumulators == {}
    sharder = po.step.__self__
    assert sharder.bytes_per_rank() == [want] * 4 and want <= full // 2
    _steps(jl, jo, pl, po, x, 2)
    _close(pl.weight.detach().numpy(), jl.weight.numpy())


def test_offload_states_on_host_and_parity():
    """offload=True: the states live with the wrapper on the host (none
    in the inner optimizer), three steps equal the plain optimizer's
    exactly and the JAX offload optimizer's within 1e-6."""
    from paddle_tpu.distributed.fleet.meta_parallel.sharding import \
        DygraphShardingOptimizer as JDSO
    jmesh.build_mesh(dp=1, devices=jax.devices()[:1])
    j, p = _nets(7)
    _, plain = _nets(7)
    jo = JDSO(paddle.optimizer.AdamW(1e-2, parameters=j.parameters(),
                                     weight_decay=0.01), offload=True)
    po = psh.DygraphShardingOptimizer(
        popt.AdamW(1e-2, parameters=p.parameters(), weight_decay=0.01),
        offload=True)
    ao = popt.AdamW(1e-2, parameters=plain.parameters(), weight_decay=0.01)
    x = _x(1, 4, 16)
    _steps(j, jo, p, po, x)
    for _ in range(3):
        (plain(torch.from_numpy(x)) ** 2).mean().backward()
        ao.step()
        ao.clear_grad()
    assert po._inner_opt._accumulators == {} and po._leaves
    assert all(t.device.type == "cpu" for leaf in po._leaves.values()
               for per in leaf.states.values() for t in per)
    for a, b, c in zip(p.parameters(), plain.parameters(), j.parameters()):
        assert torch.equal(a, b)
        _close(a.detach().numpy(), c.numpy())


def test_offload_multi_rank_mesh_raises():
    pmesh.build_mesh(sharding=4, dp=2, devices=["cpu"] * 8)
    lin = pnn.Linear(8, 8, device="cpu")
    opt = popt.AdamW(parameters=lin.parameters())
    with pytest.raises(NotImplementedError, match="offload"):
        psh.DygraphShardingOptimizer(opt, offload=True)


def test_group_sharded_parallel_offload_trains():
    """group_sharded_parallel(level "os_g", offload=True) on one rank:
    five losses fall and equal the JAX package's."""
    from paddle_tpu.distributed.sharding import group_sharded_parallel \
        as jgsp
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    jmesh.build_mesh(dp=1, devices=jax.devices()[:1])
    pmesh.set_mesh(None)
    j, p = _nets(3)
    jm, jo, _ = jgsp(j, paddle.optimizer.AdamW(1e-2,
                                               parameters=j.parameters()),
                     "os_g", offload=True)
    pm, po, _ = group_sharded_parallel(
        p, popt.AdamW(1e-2, parameters=p.parameters()), "os_g",
        offload=True)
    losses = _steps(jm, jo, pm, po, _x(2, 4, 16), 5)
    assert losses[-1][1] < losses[0][1]
    _close([b for _, b in losses], [a for a, _ in losses])


def test_offload_direct_inner_step_streams():
    """A caller holding the ORIGINAL optimizer after GroupShardedStage3
    with offload steps through the host states too."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        GroupShardedStage3
    pmesh.set_mesh(None)
    _, p = _nets(9)
    _, plain = _nets(9)
    opt = popt.AdamW(1e-2, parameters=p.parameters())
    ao = popt.AdamW(1e-2, parameters=plain.parameters())
    wrapped = GroupShardedStage3(p, opt, offload=True)
    x = torch.from_numpy(_x(5, 4, 16))
    for _ in range(2):
        (wrapped(x) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
        (plain(x) ** 2).mean().backward()
        ao.step()
        ao.clear_grad()
    assert opt._accumulators == {} and wrapped._opt._leaves
    for a, b in zip(p.parameters(), plain.parameters()):
        assert torch.equal(a, b)


# -- checkpoints (test_checkpoint_reshard.py) --------------------------------

def _fleet_llama(mp, dp, seed):
    """A tiny port LlamaForCausalLM under fleet.init(mp, dp) on logical
    CPU ranks (the mpu layers at mp > 1)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(mp_degree=mp, dp_degree=dp)
    fleet.init(is_collective=True, strategy=s, device="cpu")
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                            generator=torch.Generator().manual_seed(seed))


def test_save_mp2_restore_dp2(tmp_path):
    """An mp 2 model's checkpoint restored INTO a dp 2 model's tensors
    (their storage kept) bit for bit; the JAX package reads the same file bit
    for bit."""
    src = _fleet_llama(2, 1, 0)
    dst = _fleet_llama(1, 2, 1)
    assert type(src.lm_head).__name__ == "ColumnParallelLinear"
    path = str(tmp_path / "ckpt")
    pckpt.save_state_dict(src.state_dict(), path)
    ptrs = {k: v.data_ptr() for k, v in dst.state_dict().items()}
    out = pckpt.load_state_dict(path, target_state_dict=dst.state_dict())
    for k, v in src.state_dict().items():
        assert torch.equal(out[k], v) and out[k].data_ptr() == ptrs[k]
        assert torch.equal(dst.state_dict()[k], v)
    jout = jckpt.load_state_dict(path)
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(np.asarray(jout[k].numpy()),
                                      v.numpy())


def test_save_mp2_restore_into_sharding4_optimizer(tmp_path):
    """AdamW states saved at mp 2 (the global view) set into a ZeRO-1
    optimizer at sharding 4: each rank's chunks are the saved tensors'
    quarters bit for bit and the state dict gives them back."""
    src = _fleet_llama(2, 1, 0)
    opt = popt.AdamW(1e-3, parameters=src.parameters())
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                        .manual_seed(0))
    src(ids, labels=ids)[0].backward()
    opt.step()
    path = str(tmp_path / "opt")
    pckpt.save_state_dict(opt.state_dict(), path)
    pmesh.build_mesh(sharding=4, devices=["cpu"] * 4)
    dst = popt.AdamW(1e-3, parameters=src.parameters())
    sh = psh.DygraphShardingOptimizer(dst)
    dst.set_state_dict(pckpt.load_state_dict(path))
    saved = opt.state_dict()
    w = src.llama.embed_tokens.weight
    leaf = sh._leaves[w]
    for r, chunk in enumerate(leaf.states["moment1"]):
        assert torch.equal(chunk, saved[f"{w.param_name}_moment1"]
                           .chunk(4, leaf.dim)[r])
    back = dst.state_dict()
    assert sorted(back) == sorted(saved)
    for k, v in saved.items():
        assert v == back[k] if k == "global_step" else torch.equal(v,
                                                                   back[k])


def test_orbax_error_not_swallowed(tmp_path):
    """A missing checkpoint raises (not a KeyError / AttributeError);
    an orbax checkpoint the JAX package wrote raises an ImportError
    naming the format."""
    with pytest.raises(Exception) as ei:
        pckpt.load_state_dict(str(tmp_path / "nope"))
    assert not isinstance(ei.value, (KeyError, AttributeError))
    path = str(tmp_path / "orbax")
    jckpt.save_state_dict({"w": paddle.to_tensor(np.ones((2, 2),
                                                         np.float32))}, path)
    assert os.path.isdir(path) and not os.path.exists(
        os.path.join(path, "state.pdparams"))
    with pytest.raises(ImportError, match="orbax"):
        pckpt.load_state_dict(path)


def test_pickle_format_crosses_both_ways(tmp_path):
    """A checkpoint in the pickle layout written by the JAX package
    (float32 and int64) loads in the port bit for bit, and one the port
    writes loads in the JAX package bit for bit, through its
    ``_pickle_path`` dispatch."""
    state = {"w": _x(3, 3, 3), "step": np.arange(5, dtype=np.int64)}
    jpath = str(tmp_path / "legacy")
    os.makedirs(jpath)
    jio.save({k: paddle.to_tensor(v) for k, v in state.items()},
             os.path.join(jpath, "state.pdparams"))
    got = pckpt.load_state_dict(jpath)
    for k, v in state.items():
        written = np.asarray(paddle.to_tensor(v).numpy())  # int64 -> int32
        assert got[k].dtype == torch.from_numpy(written).dtype
        np.testing.assert_array_equal(got[k].numpy(), written)
    ppath = str(tmp_path / "port")
    pckpt.save_state_dict({k: torch.from_numpy(v) for k, v in
                           state.items()}, ppath)
    back = jckpt.load_state_dict(ppath)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(back[k].numpy()), v)


def test_paddle_save_load_crosses_both_ways_with_bf16(tmp_path):
    """paddle.save / paddle.load across the packages: nested dicts and
    lists, names and stop_gradient kept; a JAX bfloat16 tensor loads as
    bfloat16 bit for bit, a port bfloat16 tensor loads in the JAX
    package as its exact float32 values and back in the port as
    bfloat16."""
    import paddle_tpu_torch as pt
    w = _x(4, 4, 4)
    jt = paddle.to_tensor(w)
    jt.name, jt.stop_gradient = "linear_9.w_0", False
    jio.save({"a": jt, "b": [paddle.to_tensor(w).astype("bfloat16"), 3]},
             str(tmp_path / "j.pdparams"))
    got = pt.load(str(tmp_path / "j.pdparams"))
    assert got["a"].param_name == "linear_9.w_0" and got["a"].requires_grad
    np.testing.assert_array_equal(got["a"].detach().numpy(), w)
    assert got["b"][1] == 3 and got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["b"][0], torch.from_numpy(w).bfloat16())
    pt.save({"a": torch.from_numpy(w), "b": [torch.from_numpy(w).bfloat16()]},
            str(tmp_path / "p.pdparams"))
    back = jio.load(str(tmp_path / "p.pdparams"))
    np.testing.assert_array_equal(np.asarray(back["a"].numpy()), w)
    np.testing.assert_array_equal(
        np.asarray(back["b"][0].numpy()),
        torch.from_numpy(w).bfloat16().float().numpy())
    again = pt.load(str(tmp_path / "p.pdparams"))
    assert torch.equal(again["b"][0], torch.from_numpy(w).bfloat16())


def _layer_sd(indices, prefix="layers"):
    return {f"{prefix}.{i}.w": np.full((2,), float(i), np.float32)
            for i in indices}


def test_pp_adaptor_global_to_stages():
    """The global view to 4 stages: the JAX adaptor's dicts exactly."""
    sd = _layer_sd(range(8))
    sd["embed.w"] = np.zeros((4,), np.float32)
    got = pckpt.PPParallelAdaptor.convert(sd, src_pp=1, dst_pp=4)
    want = jckpt.PPParallelAdaptor.convert(sd, src_pp=1, dst_pp=4)
    assert [sorted(s) for s in got] == [sorted(s) for s in want]
    assert all(g[k] is w[k] for g, w in zip(got, want) for k in g)
    for s, stage_sd in enumerate(got):
        for j in range(2):
            np.testing.assert_array_equal(
                stage_sd[f"layers.{j}.w"],
                np.full((2,), float(2 * s + j), np.float32))
    assert "embed.w" in got[0]


def test_pp_adaptor_stages_roundtrip():
    """1 -> 2 -> 3 -> 1 stages over an uneven split: the JAX adaptor's
    dicts at every hop and the global view back exactly."""
    sd = _layer_sd(range(7))
    sd["head.b"] = np.ones((1,), np.float32)
    hops = [(1, 2), (2, 3), (3, 1)]
    got, want = sd, sd
    for a, b in hops:
        got = pckpt.PPParallelAdaptor.convert(got, src_pp=a, dst_pp=b)
        want = jckpt.PPParallelAdaptor.convert(want, src_pp=a, dst_pp=b)
        gl = got if isinstance(got, list) else [got]
        wl = want if isinstance(want, list) else [want]
        assert [sorted(s) for s in gl] == [sorted(s) for s in wl]
    assert sorted(got) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k])
