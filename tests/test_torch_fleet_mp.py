"""The port's Paddle dygraph tensor parallelism (``paddle_tpu_torch.
distributed``: ``fleet.init`` and its HybridCommunicateGroup, the mpu
layers over LOGICAL mp ranks with counted collectives, the mp branches
of Llama and GPT) held against the JAX package on its 8-device CPU mesh.

The twins of ``tests/test_distributed.py:31-116`` (topology rank math,
``fleet.init`` and the HCG, Column against dense, the Megatron pair's
backward with full-shape gradients, the vocab embedding,
``ParallelCrossEntropy``), each from the JAX layer's weights; then
``LlamaForCausalLM`` (GQA, kv heads 2) and ``GPTForCausalLM`` at mp 2
and tiny widths (2 layers, hidden 32, 4 heads, FFN 64; batch 2 x 12),
three AdamW steps from the JAX fleet model's weights against the JAX
fleet model and against the port's own mp 1 model; the collectives per
kind and their bytes, exactly as the Megatron pairing derives them
(``chip_smoke.fleet_mp_expected``, which the card run holds too); the
RNG tracker's seeds; ``distributed_model``'s modes and refusals; the
refusal of an mp row over distinct devices.

Tolerances (float32, summation order only: the port sums the ranks'
partial products in rank order, XLA contracts in one GEMM): layer
outputs and gradients within 1e-5 x max|ref| (with ``max(1, .)``), the
vocab-parallel lookup exactly, the causal LMs' losses within 1e-5
relative at every step.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from chip_smoke import fleet_mp_expected
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import fleet as pfleet
from paddle_tpu_torch.distributed.fleet import meta_parallel as pmp
from paddle_tpu_torch.distributed.fleet.layers.mpu import random as prandom
from paddle_tpu_torch.models import GPTConfig, LlamaConfig
from paddle_tpu_torch.models import LlamaForCausalLM as PortLlama
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import collective
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
SEED = 1234               # tensor_init_seed of every fleet.init here
LLAMA = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
             seq=32)
GPT = dict(vocab=128, hidden=32, layers=2, heads=4, inter=64, seq=32)
B, T = 2, 12

# the module-level state of both packages that fleet.init replaces
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
    vars(fl._fleet).update(fleet_state)


@pytest.fixture(scope="module", autouse=True)
def _isolated():
    """Both packages' topology, mesh and fleet state, and torch's
    default generator, as they were before this module."""
    saved = [_snapshot(p) for p in _STATE]
    gen = torch.default_generator.get_state()
    yield
    for s in saved:
        _restore(s)
    torch.default_generator.set_state(gen)


def _strategy(mod, dp=1, mp=1, pp=1, sharding=1):
    s = mod.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=dp, mp_degree=mp, pp_degree=pp,
                            sharding_degree=sharding)
    s.tensor_parallel_configs["tensor_init_seed"] = SEED
    return s


def _init(**deg):
    """The same topology in both packages (the port's ranks logical on
    the CPU)."""
    jfleet.init(is_collective=True, strategy=_strategy(jfleet, **deg))
    pfleet.init(is_collective=True, strategy=_strategy(pfleet, **deg),
                device="cpu")


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close(got, want, what=""):
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert np.abs(np.asarray(got) - want).max() <= tol, what


def _calls():
    return {k: v["calls"] for k, v in collective.counts().items()}


def test_topology_rank_math():
    names = ["data", "pipe", "sharding", "sep", "model"]
    dims = [2, 2, 1, 1, 2]
    jt = jfleet.CommunicateTopology(names, dims)
    pt = pfleet.CommunicateTopology(names, dims)
    assert pt.world_size == jt.world_size == 8
    assert pt.get_rank(data=1, pipe=1, sharding=0, sep=0, model=1) == 7
    for r in range(8):
        assert tuple(pt.get_coord(r)) == tuple(jt.get_coord(r))
        assert pt.get_rank_from_stage(r, pipe=0) == \
            jt.get_rank_from_stage(r, pipe=0)
    for name in names:
        assert pt.get_comm_list(name) == jt.get_comm_list(name)
        assert pt.get_dim(name) == jt.get_dim(name)
        assert pt.get_axis_list(name, 0) == jt.get_axis_list(name, 0)


_GETTERS = (
    "get_parallel_mode", "get_global_rank", "get_world_size",
    "get_data_parallel_rank", "get_data_parallel_world_size",
    "get_data_parallel_group_src_rank", "get_model_parallel_rank",
    "get_model_parallel_world_size", "get_model_parallel_group_src_rank",
    "get_stage_id", "get_pipe_parallel_rank", "get_pipe_parallel_world_size",
    "get_p2p_groups", "is_first_stage", "is_last_stage",
    "get_sharding_parallel_rank", "get_sharding_parallel_world_size",
    "get_sharding_parallel_group_src_rank", "get_sep_parallel_rank",
    "get_sep_parallel_world_size")


@pytest.mark.parametrize("deg", [dict(dp=2, mp=2, pp=2),
                                 dict(sharding=2, mp=4), dict(dp=8)],
                         ids=["dp2_mp2_pp2", "sharding2_mp4", "dp8"])
def test_fleet_init_and_hcg(deg):
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.parallel import mesh as jmesh
    from paddle_tpu_torch.parallel import mesh as pmesh
    _init(**deg)
    jh, ph = jfleet.get_hybrid_communicate_group(), \
        pfleet.get_hybrid_communicate_group()
    for g in _GETTERS:
        assert getattr(ph, g)() == getattr(jh, g)(), g
    for g in ("data", "model", "pipe", "sharding", "sep", "check"):
        jg = getattr(jh, f"get_{g}_parallel_group")()
        pg = getattr(ph, f"get_{g}_parallel_group")()
        assert (pg.ranks, pg.axis, pg.nranks) == (jg.ranks, jg.axis,
                                                  jg.nranks), g
    assert pmesh.get_mesh().shape == dict(jmesh.get_mesh().shape)
    assert {d.type for d in pmesh.get_mesh().devices.flat} == {"cpu"}
    for f in ("get_rank", "get_world_size", "get_data_rank",
              "get_data_world_size"):
        assert getattr(pdist.env, f)() == getattr(jenv, f)(), f
    assert (pfleet.worker_index(), pfleet.worker_num(),
            pfleet.is_first_worker(), pfleet.is_initialized()) == \
        (jfleet.worker_index(), jfleet.worker_num(),
         jfleet.is_first_worker(), jfleet.is_initialized())


def _pair_layer(jcls, pcls, *args, seed=7, **kw):
    """A JAX mpu layer from ``paddle.seed(seed)`` and the port's twin
    holding its weights (through ``Layer.set_state_dict``)."""
    paddle.seed(seed)
    jl = jcls(*args, **kw)
    pl = pcls(*args, **kw)
    missing, unexpected = pl.set_state_dict(jl.state_dict())
    assert missing == [] and unexpected == []
    return jl, pl


def test_column_parallel_linear_matches_dense():
    from paddle_tpu.distributed.fleet import meta_parallel as jmp
    _init(mp=4)
    col_j, col_p = _pair_layer(jmp.ColumnParallelLinear,
                               pmp.ColumnParallelLinear, 8, 16,
                               gather_output=True)
    assert col_p.local_shape == col_j.local_shape == [8, 4]
    x = np.random.RandomState(0).rand(4, 8).astype(np.float32)
    collective.reset_counts()
    y = col_p(torch.from_numpy(x))
    assert _calls()["all_gather"] == 1
    w, b = col_p.weight.detach().numpy(), col_p.bias.detach().numpy()
    _close(y.detach().numpy(), x @ w + b)
    _close(y.detach().numpy(), _np(col_j(paddle.to_tensor(x))))
    row_j, row_p = _pair_layer(jmp.RowParallelLinear,
                               pmp.RowParallelLinear, 16, 8,
                               input_is_parallel=False)
    assert row_p.local_shape == row_j.local_shape == [4, 8]
    z = row_p(y)
    wr, br = row_p.weight.detach().numpy(), row_p.bias.detach().numpy()
    _close(z.detach().numpy(), y.detach().numpy() @ wr + br)
    _close(z.detach().numpy(), _np(row_j(paddle.to_tensor(
        y.detach().numpy()))))


def test_megatron_pair_backward():
    """Column (no gather) -> Row (parallel input): full-shape gradients
    equal the JAX layers'; one all-reduce forward (the Row's partials),
    one backward (the Column's ``_c_identity``), each of the 4 ranks'
    [4, 8] float32 tensors."""
    from paddle_tpu.distributed.fleet import meta_parallel as jmp
    _init(mp=4)
    col_j, col_p = _pair_layer(jmp.ColumnParallelLinear,
                               pmp.ColumnParallelLinear, 8, 16,
                               gather_output=False)
    row_j, row_p = _pair_layer(jmp.RowParallelLinear,
                               pmp.RowParallelLinear, 16, 8,
                               input_is_parallel=True, seed=8)
    x = np.random.RandomState(1).rand(4, 8).astype(np.float32)
    xj = paddle.to_tensor(x)
    xj.stop_gradient = False
    row_j(col_j(xj)).sum().backward()
    xp = torch.from_numpy(x).requires_grad_(True)
    collective.reset_counts()
    row_p(col_p(xp)).sum().backward()
    assert collective.counts()["all_reduce"] == {"calls": 2,
                                                 "bytes": 2 * 4 * 4 * 8 * 4}
    assert col_p.weight.grad.shape == (8, 16)
    for pl, jl in ((col_p, col_j), (row_p, row_j)):
        for n, p in pl.named_parameters():
            _close(p.grad.numpy(), _np(getattr(jl, n).grad), n)
    _close(xp.grad.numpy(), _np(xj.grad))


def test_vocab_parallel_embedding():
    from paddle_tpu.distributed.fleet import meta_parallel as jmp
    _init(mp=4)
    emb_j, emb_p = _pair_layer(jmp.VocabParallelEmbedding,
                               pmp.VocabParallelEmbedding, 16, 8)
    assert emb_p.local_shape == emb_j.local_shape == [4, 8]
    idx = np.array([[0, 5], [9, 15]])
    collective.reset_counts()
    out = emb_p(torch.from_numpy(idx))
    assert _calls()["all_reduce"] == 1
    ref = emb_p.weight.detach()[torch.from_numpy(idx)]
    assert torch.equal(out.detach(), ref)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  _np(emb_j(paddle.to_tensor(idx))))
    out.sum().backward()
    want = np.zeros((16, 8), np.float32)
    np.add.at(want, idx.reshape(-1), 1.0)
    np.testing.assert_array_equal(emb_p.weight.grad.numpy(), want)


def test_parallel_cross_entropy():
    from paddle_tpu.distributed.fleet import meta_parallel as jmp
    _init(mp=4)
    la = np.random.RandomState(2).randn(4, 16).astype(np.float32)
    labels = np.array([1, 3, 7, -100])
    lj = paddle.to_tensor(la)
    lj.stop_gradient = False
    jl = jmp.ParallelCrossEntropy()(lj, paddle.to_tensor(labels))
    jl.sum().backward()
    lp = torch.from_numpy(la).requires_grad_(True)
    collective.reset_counts()
    loss = pmp.ParallelCrossEntropy()(lp, torch.from_numpy(labels))
    assert _calls()["all_reduce"] == 3          # max, sum of exp, target
    assert loss.shape == (4, 1)
    _close(loss.detach().numpy(), _np(jl))
    ref = torch.nn.functional.cross_entropy(
        torch.from_numpy(la), torch.from_numpy(labels), reduction="none")
    _close(loss.detach().numpy()[:, 0], ref.numpy())
    assert float(loss[3].detach()) == 0.0
    loss.sum().backward()
    _close(lp.grad.numpy(), _np(lj.grad))


def _jax_model(kind):
    paddle.seed(3)
    if kind == "llama":
        jm = JaxLlama(JaxLlamaConfig.tiny(**LLAMA))
    else:
        cfg = JaxGPTConfig.tiny(**GPT)
        cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
        jm = JaxGPT(cfg)
    for n, p in jm.named_parameters():
        p.name = n
    return jm


def _port_model(kind, state):
    if kind == "llama":
        return weights.llama_for_causal_lm(state, LlamaConfig.tiny(**LLAMA),
                                           device="cpu")
    cfg = GPTConfig.tiny(**GPT)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return weights.gpt_for_causal_lm(state, cfg, device="cpu")


def _port_losses(tm, ids, steps=3):
    opt = AdamW(1e-3, parameters=tm.parameters())
    x = torch.from_numpy(ids)
    out, counts = [], []
    for _ in range(steps):
        collective.reset_counts()
        loss, _ = tm(x, labels=x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(loss.item())
        counts.append({k: (v["calls"], v["bytes"])
                       for k, v in collective.counts().items()})
    return out, counts


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_causal_lm_at_mp2_matches_jax_fleet_and_mp1(kind):
    """Three AdamW(1e-3) steps from the JAX fleet model's weights: the
    port at mp 2 against the JAX model at mp 2 and against the port at
    mp 1 (losses within 1e-5 relative), with exactly the collectives
    that ``chip_smoke.fleet_mp_expected`` derives (the card run's
    requirement) each step; the mp layers in the models' places."""
    _init(mp=2)
    jm = _jax_model(kind)
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    tm = _port_model(kind, state)
    if kind == "llama":
        attn = tm.llama.layers[0].self_attn
        assert isinstance(tm.llama.embed_tokens, pmp.VocabParallelEmbedding)
        assert isinstance(attn.k_proj, pmp.ColumnParallelLinear)
        assert isinstance(attn.o_proj, pmp.RowParallelLinear)
        assert tm.lm_head.gather_output and not attn.q_proj.gather_output
    else:
        blk = tm.gpt.h[0]
        assert isinstance(tm.gpt.wte, pmp.VocabParallelEmbedding)
        assert isinstance(blk.qkv, pmp.ColumnParallelLinear)
        assert isinstance(blk.fc_out, pmp.RowParallelLinear)
    ids = np.random.RandomState(5).randint(0, (LLAMA if kind == "llama"
                                               else GPT)["vocab"], (B, T))
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters())
    jl = []
    for _ in range(3):
        x = paddle.to_tensor(ids)
        loss, _ = jm(x, labels=x)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(_np(loss)))
    pl, counts = _port_losses(tm, ids)
    pfleet.topology.set_hybrid_communicate_group(None)
    t1 = _port_model(kind, state)
    assert type(t1.llama.embed_tokens if kind == "llama"
                else t1.gpt.wte).__name__ == "Embedding"
    l1, c1 = _port_losses(t1, ids)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pl, l1, rtol=1e-5)
    want = fleet_mp_expected(kind, 2, 2, B * T, 32, (
        LLAMA if kind == "llama" else GPT)["vocab"], 4)
    assert counts == [want] * 3
    assert all(v == (0, 0) for c in c1 for v in c.values())


def test_rng_tracker_seeds():
    """``model_parallel_rng`` is seeded ``tensor_init_seed + 1024 +
    mp_rank`` and the global generator ``tensor_init_seed`` in both
    packages; a draw inside ``rng_state`` comes from the tracked stream,
    which keeps its state across entries, and the default stream
    resumes outside."""
    from paddle_tpu.distributed.fleet.layers.mpu import random as jrandom
    _init(mp=2)
    jt, pt = jrandom.get_rng_state_tracker(), prandom.get_rng_state_tracker()
    assert sorted(pt.states_) == sorted(jt.states_) == [
        prandom.MODEL_PARALLEL_RNG]
    np.testing.assert_array_equal(
        np.asarray(jt.states_[prandom.MODEL_PARALLEL_RNG]),
        np.asarray(jax.random.PRNGKey(SEED + 1024)))
    assert pt.states_[prandom.MODEL_PARALLEL_RNG].initial_seed() == \
        SEED + 1024
    assert torch.initial_seed() == SEED
    ref = torch.Generator().manual_seed(SEED + 1024)
    outside = torch.rand(3)
    with pt.rng_state():
        a = torch.rand(4)
    with pt.rng_state():
        b = torch.rand(4)
    assert torch.equal(torch.cat([a, b]), torch.rand(8, generator=ref))
    torch.manual_seed(SEED)
    assert torch.equal(torch.rand(3), outside)
    for tracker in (jt, pt):
        with pytest.raises(ValueError):
            tracker.add("other", SEED + 1024)
    saved = pt.get_states_tracker()
    pt.set_states_tracker(saved)
    with pt.rng_state():
        assert torch.equal(torch.rand(2), torch.rand(2, generator=ref))


def test_distributed_model_dispatch_and_refusals():
    from paddle_tpu.nn import Linear as JaxLinear
    from paddle_tpu_torch.nn import Linear
    x = torch.randn(3, 4)
    for deg, cls in ((dict(mp=2), "TensorParallel"),
                     (dict(dp=2), "DataParallel")):
        _init(**deg)
        net = Linear(4, 2, device="cpu")
        wrapped = pfleet.distributed_model(net)
        assert type(wrapped).__name__ == cls == type(
            jfleet.distributed_model(JaxLinear(4, 2))).__name__
        assert torch.equal(wrapped(x), net(x))
        assert list(wrapped.state_dict()) == list(net.state_dict())
        assert [id(p) for p in wrapped.parameters()] == \
            [id(p) for p in net.parameters()]
        opt = pfleet.distributed_optimizer(AdamW(
            1e-3, parameters=net.parameters()))
        before = net.weight.detach().clone()
        opt.minimize(wrapped(x).sum())
        assert not torch.equal(net.weight.detach(), before)
        opt.clear_grad()
        assert net.weight.grad is None
    # the pipeline and sharding modes (ported since; their numerics are
    # tests/test_torch_hybrid.py's) wrap as the reference's do
    for deg, cls in ((dict(pp=2), "PipelineParallel"),
                     (dict(sharding=2), "ShardingParallel")):
        _init(**deg)
        assert type(pfleet.distributed_model(
            Linear(4, 2, device="cpu"))).__name__ == cls == type(
            jfleet.distributed_model(JaxLinear(4, 2))).__name__
    opt = pfleet.distributed_optimizer(AdamW(1e-3, parameters=[]),
                                       _strategy(pfleet, sharding=2))
    assert type(opt._sharding).__name__ == "DygraphShardingOptimizer"
    # lars rewrites a Momentum only; an AdamW passes through, as there
    s = _strategy(pfleet)
    s.lars = True
    assert type(pfleet.distributed_optimizer(
        AdamW(1e-3, parameters=[]), s)._inner_opt).__name__ == "AdamW"


def test_mp_row_of_distinct_devices_is_refused():
    """A mesh whose mp row names distinct devices (here ``cpu:0`` and
    ``cpu:1``, as two cards would be) is refused by every mpu layer and
    so by the models; a layer on another device than its group's
    raises; so does a Llama whose kv heads do not divide by mp."""
    topo = pfleet.CommunicateTopology(
        ["data", "pipe", "sharding", "sep", "model"], [1, 1, 1, 1, 2])
    hcg = pfleet.HybridCommunicateGroup(
        topo, devices=[torch.device("cpu", 0), torch.device("cpu", 1)])
    pfleet.topology.set_hybrid_communicate_group(hcg)
    for make in (lambda: pmp.ColumnParallelLinear(8, 8),
                 lambda: pmp.RowParallelLinear(8, 8),
                 lambda: pmp.VocabParallelEmbedding(8, 8),
                 lambda: PortLlama(LlamaConfig.tiny(**LLAMA),
                                              device="cpu")):
        with pytest.raises(NotImplementedError, match="10b"):
            make()
    pfleet.init(strategy=_strategy(pfleet, mp=2), device="cpu")
    with pytest.raises(ValueError, match="device"):
        pmp.ColumnParallelLinear(8, 8, device="meta")
    # GQA shards the kv heads: 2 of them do not divide over mp 4
    pfleet.init(strategy=_strategy(pfleet, mp=4), device="cpu")
    with pytest.raises(ValueError, match="num_key_value_heads"):
        PortLlama(LlamaConfig.tiny(**dict(LLAMA, heads=8)), device="cpu")
