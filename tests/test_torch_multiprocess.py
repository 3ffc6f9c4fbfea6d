"""The port's training across processes held against the JAX package
on the CPU, over Gloo: the twins of ``tests/test_multiprocess.py`` (two
processes, ``all_reduce`` of float32 and int32, a data-parallel step),
``tests/test_multiprocess_tp.py`` (``LlamaSpmdTrainer`` with mp 2 split
across two processes; the three elastic tests),
``tests/test_distributed.py::test_collective_api_eager`` and the four
rpc tests of ``tests/test_incubate_tail.py:128-250``, with a launch
twin and every eager collective of ``communication/ops.py`` across two
processes.

The two ranks are spawned ONCE for the module, through the port's
launcher (``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 2``), and run every scenario of
``chip_smoke.mp_child`` (phase 27's rank, here on the CPU), each
writing a ``RESULT`` line the tests read; the elastic supervisors run
on threads beside them. Every child is guarded as the reference's
parent guards its workers (``communicate(timeout=)`` then kill): the
launcher kills its ranks past its timeout and ``chip_smoke.mp_finish``
kills the launcher's whole session past that.

Tolerances: the collectives exactly (the ranks check each value and
dtype themselves and exit non-zero otherwise); the data-parallel step's
parameters within 1e-6 of the JAX package's same step (float32, one
product and a sum of two ranks); the mp 2 trainer's losses bitwise
equal across the two ranks and bitwise the port's one-process logical
mp 2 run (every shard and fp32 master too, by sha256), and within
rtol 2e-4 of the JAX mp 2 trainer's (the reference's own tolerance,
``tests/test_multiprocess_tp.py:125``).
"""
import os
import signal
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import fleet as pfleet
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import mesh as pmesh
from tests.test_multiprocess_tp import (_ELASTIC_WORKER, _EXIT0_WORKER,
                                        _HUNG_WORKER)
from tests.torch_twins import no_fleet, shared_jax_cache  # noqa: F401

torch.set_num_threads(1)

# tests/test_multiprocess_tp.py:27-34
TRAINER = dict(vocab=64, hidden=32, ffn=64, heads=4, kv_heads=4, layers=2,
               seq=16, batch=2, seed=3, dtype="float32", remat=False,
               steps=3)
CHILD_TIMEOUT = 120


def _jax_trainer(tmp):
    """The JAX mp 2 trainer on two of the virtual devices: its initial
    parameters written for the ranks; returns its 3 steps."""
    from paddle_tpu.models.llama import LlamaConfig as JCfg
    from paddle_tpu.models.llama_spmd import LlamaSpmdTrainer as JTrainer
    saved = jmesh._global_mesh
    try:
        jmesh.build_mesh(mp=2, devices=jax.devices()[:2])
        cfg = JCfg.tiny(vocab=64, hidden=32, layers=2, heads=4, kv_heads=4,
                        inter=64, seq=16)
        tr = JTrainer(cfg, remat=False, compute_dtype=jnp.float32, seed=3)
        path = os.path.join(tmp, "trainer.npz")
        weights.save_tree(path + ".part.npz", jax.tree_util.tree_map(
            np.asarray, tr.params))
        os.replace(path + ".part.npz", path)      # the ranks wait for it
        return lambda ids: [float(tr.train_step(ids)) for _ in range(3)]
    finally:
        jmesh._global_mesh = saved


def _jax_linear(tmp):
    """The reference's ``paddle.seed(0); Linear(4, 2)`` written for the
    ranks; returns the JAX package's data-parallel step of the two
    ranks' data (mean of the two gradients, SGD at 0.1)."""
    paddle.seed(0)
    lin = paddle.nn.Linear(4, 2)
    w, b = np.asarray(lin.weight.numpy()), np.asarray(lin.bias.numpy())
    path = os.path.join(tmp, "linear.npz")
    np.savez(path + ".part.npz", weight=w, bias=b)
    os.replace(path + ".part.npz", path)
    grads = []
    for rank in range(2):
        x = paddle.to_tensor(np.random.default_rng(rank).standard_normal(
            (2, 4)).astype(np.float32))
        lin.clear_gradients()
        loss = (lin(x) ** 2).mean()
        loss.backward()
        grads.append((np.asarray(lin.weight.grad.numpy()),
                      np.asarray(lin.bias.grad.numpy())))
    gw = (grads[0][0] + grads[1][0]) * np.float32(0.5)
    gb = (grads[0][1] + grads[1][1]) * np.float32(0.5)
    return w - np.float32(0.1) * gw, b - np.float32(0.1) * gb


def _one_process(tcfg, ids, degrees):
    """The port's trainer with ``degrees`` as LOGICAL ranks of one
    process, from the same weights."""
    saved = pmesh._global_mesh
    try:
        pmesh.build_mesh(**degrees, devices=["cpu", "cpu"])
        tr = cs._mp_trainer(torch, torch.device("cpu"), tcfg)
        return cs._mp_train_run(torch, torch.device("cpu"), tr, ids, 3)
    finally:
        pmesh._global_mesh = saved


def _elastic(tmp, name, script, run_secs=None, kill=False, **sup_kw):
    """One reference elastic scenario under the port's supervisor, on a
    thread; returns a function giving (rc, supervisor, pids per rank)."""
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticSupervisor
    wd = os.path.join(tmp, name)
    os.makedirs(wd)
    path = os.path.join(wd, "worker.py")
    with open(path, "w") as f:
        f.write(script)
    beats = os.path.join(wd, "beats")
    envs = []
    for r in range(2):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(r), ELASTIC_TEST_DIR=wd,
                   PADDLE_ELASTIC_DIR=beats)
        if run_secs:
            env["ELASTIC_RUN_SECS"] = run_secs
        envs.append(env)
    sup = ElasticSupervisor([[sys.executable, path]] * 2, envs,
                            heartbeat_dir=beats, log=lambda *a: None,
                            **sup_kw)
    box = {}

    def body():
        th = threading.Thread(target=lambda: box.setdefault("rc", sup.run()))
        th.start()
        if kill:
            deadline = time.time() + 30
            marks = [os.path.join(wd, f"started_rank{r}") for r in range(2)]
            while time.time() < deadline and not all(
                    map(os.path.exists, marks)):
                time.sleep(0.05)
            box["started"] = all(map(os.path.exists, marks))
            if box["started"]:
                # kill worker 1 mid-flight: the pod must relaunch
                sup._procs[1].send_signal(signal.SIGKILL)
        th.join(timeout=60)
        if th.is_alive():
            sup.max_restarts = 0
            sup._kill_all()
            th.join(timeout=10)
        box["alive"] = th.is_alive()

    runner = threading.Thread(target=body)
    runner.start()

    def result():
        runner.join(timeout=90)
        pids = {}
        for r in range(2):
            m = os.path.join(wd, f"started_rank{r}")
            if os.path.exists(m):
                with open(m) as f:
                    pids[r] = [ln for ln in f.read().splitlines() if ln]
        return box, sup, pids
    return result


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results, the elastic scenarios' and the references
    computed in this process meanwhile."""
    tmp = str(tmp_path_factory.mktemp("world"))
    ids = np.random.default_rng(11).integers(0, 64, (2, 16))
    # the ranks start first and wait for the JAX weights written below
    tpath, lpath = (os.path.join(tmp, n) for n in ("trainer.npz",
                                                   "linear.npz"))
    mp2 = dict(TRAINER, ids=ids.tolist(), params=tpath)
    child = dict(device="cpu", refusals=True, collectives=True,
                 wait_for=[tpath, lpath], wait_s=CHILD_TIMEOUT / 2,
                 dp_weights=lpath, trainers={
                     "trainer": mp2,
                     "trainer_sharding": dict(mp2, mesh=dict(sharding=2),
                                              remat=True)},
                 rpc=f"127.0.0.1:{cs._free_port()}")
    handle = cs.mp_start(child, tmp, timeout=CHILD_TIMEOUT)
    with no_fleet():
        jax_steps = _jax_trainer(tmp)
        jax_dp = _jax_linear(tmp)
    elastic = {
        "killed": _elastic(tmp, "killed", _ELASTIC_WORKER, run_secs="4",
                           kill=True, interval=0.2, max_restarts=2),
        "hung": _elastic(tmp, "hung", _HUNG_WORKER, interval=0.2,
                         heartbeat_timeout=1.5, max_restarts=1),
        "exit0": _elastic(tmp, "exit0", _EXIT0_WORKER, interval=0.2,
                          heartbeat_timeout=10.0, max_restarts=2),
    }
    out = dict(one=_one_process(dict(TRAINER, params=tpath), ids,
                                dict(mp=2)),
               one_sharding=_one_process(dict(TRAINER, params=tpath,
                                              remat=True), ids,
                                         dict(sharding=2)),
               dp_ref=jax_dp)
    with no_fleet():
        saved = jmesh._global_mesh
        try:
            jmesh.build_mesh(mp=2, devices=jax.devices()[:2])
            out["jax_losses"] = jax_steps(ids)
        finally:
            jmesh._global_mesh = saved
    out["rc"], out["res"], out["log"] = cs.mp_finish(handle)
    out["elastic"] = {k: f() for k, f in elastic.items()}
    return out


def _res(world, rank, name):
    assert world["rc"] == 0, world["log"][-4000:]
    return world["res"][rank, name]


def test_launch_gives_each_rank_the_paddle_env(world):
    """The launch twin: two ranks with PADDLE_TRAINERS_NUM 2, ids 0 and 1
    and one master; a rendezvous at a taken port raised (naming the
    address and rank 0), and a world on distinct cards raised naming
    item 10b, before the real rendezvous."""
    envs = [_res(world, r, "env") for r in range(2)]
    assert [e["PADDLE_TRAINER_ID"] for e in envs] == ["0", "1"]
    assert {e["PADDLE_TRAINERS_NUM"] for e in envs} == {"2"}
    assert envs[0]["PADDLE_MASTER"] == envs[1]["PADDLE_MASTER"]
    for r in range(2):
        assert _res(world, r, "rendezvous_refused").startswith("127.0.0.1:")
        assert _res(world, r, "distinct_cards_refused") is True


def test_every_eager_collective_across_two_processes(world):
    """Each kind ran on float32 and int32 and was checked exactly in the
    ranks (all_reduce SUM / MAX / MIN / AVG keeping the dtype,
    all_gather, reduce_scatter, broadcast, reduce, scatter, alltoall,
    alltoall_single, send / recv, batch_isend_irecv, all_gather_object;
    PROD and an mp-axis group of a hybrid mesh raised); the counts equal
    on both ranks but for the point-to-point kinds."""
    c0, c1 = (_res(world, r, "collectives") for r in range(2))
    calls = {k: v["calls"] for k, v in c0.items()}
    assert calls["all_reduce"] == 8 and calls["all_to_all"] == 4
    for k in ("reduce_scatter", "all_gather", "broadcast", "reduce",
              "scatter"):
        assert calls[k] == 2, (k, calls)
    assert calls["all_gather_object"] == 1 and calls["barrier"] == 1
    assert (c0["send"]["calls"], c0["recv"]["calls"]) == (4, 2)
    assert (c1["send"]["calls"], c1["recv"]["calls"]) == (2, 4)
    assert {k: v for k, v in c0.items() if k not in ("send", "recv")} == \
        {k: v for k, v in c1.items() if k not in ("send", "recv")}
    assert "host_staged" not in c0           # CPU tensors: nothing staged


def test_two_process_allreduce_and_dp_step_match_jax(world):
    """The twin of test_two_process_allreduce_and_dp_step: both ranks
    land on the same parameters, within 1e-6 of the JAX package's
    step."""
    d0, d1 = (_res(world, r, "dp_step") for r in range(2))
    assert d0 == d1
    w, b = world["dp_ref"]
    np.testing.assert_allclose(np.asarray(d0["weight"], np.float32), w,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(d0["bias"], np.float32), b,
                               rtol=0, atol=1e-6)


def test_two_process_mp2_matches_single_process_and_jax(world):
    """The twin of test_two_process_mp2_matches_single_process: the ranks'
    losses bitwise equal, bitwise the one-process logical mp 2 run's
    (every shard and master too), with its collectives; within rtol 2e-4
    of the JAX mp 2 losses."""
    t0, t1 = (_res(world, r, "trainer") for r in range(2))
    one = world["one"]
    assert t0["losses"] == t1["losses"] == one["losses"]
    for t in (t0, t1):
        assert t["digests"] and all(one["digests"][k] == v
                                    for k, v in t["digests"].items())
        assert t["collectives"] == one["collectives"]
    assert set(t0["digests"]) | set(t1["digests"]) == set(one["digests"])
    assert not set(t0["digests"]) & set(t1["digests"])
    losses = [float.fromhex(x) for x in t0["losses"]]
    np.testing.assert_allclose(losses, world["jax_losses"], rtol=2e-4)


def test_sharding2_split_across_processes_is_the_one_process_run(world):
    """ZeRO over 'sharding' 2 split across the two processes (the
    gradients' reduce-scatter and the updated chunks' all-gather span
    them): losses, shards and masters bitwise the one-process logical
    run's, with its collectives."""
    t0, t1 = (_res(world, r, "trainer_sharding") for r in range(2))
    one = world["one_sharding"]
    assert t0["losses"] == t1["losses"] == one["losses"]
    for t in (t0, t1):
        assert all(one["digests"][k] == v for k, v in t["digests"].items())
        assert t["collectives"] == one["collectives"]
        assert t["collectives"]["reduce_scatter"]["calls"] > 0
    assert set(t0["digests"]) | set(t1["digests"]) == set(one["digests"])


def test_rpc_two_processes_cross_call(world):
    """The twin of test_rpc_two_processes_cross_call, between the two
    ranks."""
    r0, r1 = (_res(world, r, "rpc") for r in range(2))
    assert (r0["value"], r1["value"]) == (17, 4)
    assert r0["workers"] == r1["workers"] == 2


def test_elastic_supervisor_relaunches_killed_worker(world):
    box, sup, pids = world["elastic"]["killed"]
    assert box.get("started") and not box["alive"]
    assert box["rc"] == 0
    assert sup.restarts >= 1
    assert len(pids[1]) >= 2, pids


def test_elastic_supervisor_detects_hung_worker(world):
    box, sup, _ = world["elastic"]["hung"]
    assert sup.restarts == 1        # hang detected -> one relaunch
    assert box["rc"] == 1           # still hung -> gave up with code 1


def test_elastic_exited_worker_not_flagged_hung(world):
    box, sup, _ = world["elastic"]["exit0"]
    assert box["rc"] == 0
    assert sup.restarts == 0


def _free_port():
    return cs._free_port()


def _double(x):
    return x * 2


def _boom():
    return 1 / 0


def test_rpc_registry_survives_bad_authkey():
    from multiprocessing import AuthenticationError
    from multiprocessing.connection import Client
    from paddle_tpu_torch.distributed.rpc import rpc as R

    port = _free_port()
    reg = R._MasterRegistry(f"127.0.0.1:{port}", 1, b"A" * 32)
    reg.start()
    time.sleep(0.2)
    with pytest.raises((AuthenticationError, OSError, EOFError)):
        Client(("127.0.0.1", port), authkey=b"B" * 32)
    time.sleep(0.2)
    assert reg.is_alive()
    conn = Client(("127.0.0.1", port), authkey=b"A" * 32)
    conn.send(("register", ("w0", 0, "127.0.0.1", 12345)))
    assert len(conn.recv()) == 1
    conn.close()
    reg.stop()


def test_rpc_single_worker_roundtrip():
    from paddle_tpu_torch.distributed import rpc
    port = _free_port()
    rpc.init_rpc("worker0", rank=0, world_size=1,
                 master_endpoint=f"127.0.0.1:{port}")
    try:
        assert rpc.rpc_sync("worker0", _double, args=(21,)) == 42
        fut = rpc.rpc_async("worker0", _double, args=(5,))
        assert fut.wait() == 10
        info = rpc.get_worker_info("worker0")
        assert info.rank == 0 and info.name == "worker0"
        assert rpc.get_current_worker_info() == info
        assert len(rpc.get_all_worker_infos()) == 1
        with pytest.raises(ValueError, match="unknown rpc worker"):
            rpc.rpc_sync("nobody", _double, args=(1,))
        with pytest.raises(ZeroDivisionError):
            rpc.rpc_sync("worker0", _boom)
    finally:
        rpc.shutdown()


def test_rpc_cross_host_requires_secret(monkeypatch):
    from paddle_tpu_torch.distributed.rpc import rpc as rpc_mod
    monkeypatch.delenv("PADDLE_RPC_AUTHKEY", raising=False)
    with pytest.raises(RuntimeError, match="PADDLE_RPC_AUTHKEY"):
        rpc_mod._auth("10.0.0.5:8090")
    monkeypatch.setenv("PADDLE_RPC_AUTHKEY", "s3cret")
    assert rpc_mod._auth("10.0.0.5:8090") == b"s3cret"
    monkeypatch.delenv("PADDLE_RPC_AUTHKEY")
    assert rpc_mod._auth("127.0.0.1:8090")  # loopback: derived key ok


def test_collective_api_eager_global_view_matches_jax():
    """The twin of test_collective_api_eager in one process, under
    fleet.init(dp 8) in both packages: a replicated tensor's all_reduce
    is the identity; the port's per-rank list of 8 logical shards sums
    to what the JAX package's sharded array gives."""
    from jax.sharding import PartitionSpec
    import paddle_tpu_torch.distributed as pdist
    with no_fleet():
        for mod, kw in ((jfleet, {}), (pfleet, dict(device="cpu"))):
            s = mod.DistributedStrategy()
            s.hybrid_configs["dp_degree"] = 8
            mod.init(is_collective=True, strategy=s, **kw)
        jg = jfleet.get_hybrid_communicate_group().get_data_parallel_group()
        pg = pfleet.get_hybrid_communicate_group().get_data_parallel_group()
        assert pg.ranks == jg.ranks and pg.nranks == 8
        t = paddle.to_tensor([1.0, 2.0])
        jdist.all_reduce(t, group=jg)
        p = torch.tensor([1.0, 2.0])
        assert pdist.all_reduce(p, group=pg) is p
        np.testing.assert_array_equal(p.numpy(), t.numpy())
        t2 = paddle.to_tensor(np.arange(8, dtype=np.float32))
        t2._data = jmesh.shard_tensor_data(t2.data, PartitionSpec("dp"))
        jdist.all_reduce(t2, group=jg)
        shards = list(torch.arange(8, dtype=torch.float32).chunk(8))
        pdist.all_reduce(shards, group=pg)
        for sh in shards:
            np.testing.assert_array_equal(sh.numpy(), t2.numpy())
        # the rest of the global view: replicated values stay, gathers
        # give a copy per rank, a scatter takes this rank's entry
        got = pdist.all_gather([], p, group=pg)
        assert len(got) == 8 and all(torch.equal(g, p) for g in got)
        assert len(jdist.all_gather([], t, group=jg)) == 8
        assert pdist.broadcast(p, src=3, group=pg) is p
        objs = []
        pdist.all_gather_object(objs, {"a": 1}, group=pg)
        assert objs == [{"a": 1}] * 8
        assert pdist.get_backend() == "logical"
        assert pdist.get_world_size() == 8 and pdist.get_rank() == 0
        with pytest.raises(NotImplementedError):
            pdist.all_reduce([torch.ones(1)] * 2, op="prod")


def test_one_process_launch_and_spawn_run_in_place(tmp_path, monkeypatch):
    """One process per node runs the script in this process with the
    PADDLE env (the reference's launcher); spawn runs its function once
    (the reference's single-run semantic)."""
    import json
    import paddle_tpu_torch.distributed as pdist
    from paddle_tpu_torch.distributed.launch import launch
    script = tmp_path / "s.py"
    script.write_text(textwrap.dedent("""
        import json, os, sys
        with open(sys.argv[1], "w") as f:
            json.dump([os.environ["PADDLE_TRAINER_ID"],
                       os.environ["PADDLE_TRAINERS_NUM"], sys.argv[2:]], f)
    """))
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    out = tmp_path / "out.json"
    assert launch(argv=[str(script), str(out), "--x", "1"]) == 0
    assert json.loads(out.read_text()) == ["0", "1", ["--x", "1"]]
    calls = []
    assert pdist.spawn(calls.append, args=(7,), nprocs=2) is None
    assert calls == [7]


def test_mesh_owners_and_trainer_refusals():
    """A mesh without a process group is one process's (today's
    behaviour); the trainer refuses pp or sep spanning processes, and a
    group spread over processes needs init_parallel_env."""
    saved = pmesh._global_mesh
    try:
        m = pmesh.build_mesh(mp=2, devices=["cpu", "cpu"])
        assert not m.spans_processes and m.owners_of(m.coords()) is None
        assert m.local_coords() == m.coords()
        with pytest.raises(RuntimeError, match="init_parallel_env"):
            collective.psum([torch.ones(1)], owners=[0, 1])
        m.owners = np.arange(2).reshape(m.devices.shape)
        assert m.spans_processes and m.local_coords() == [(0, 0, 0, 0, 0)]
        m2 = pmesh.build_mesh(pp=2, devices=["cpu", "cpu"])
        m2.owners = np.arange(2).reshape(m2.devices.shape)
        from paddle_tpu_torch.models import LlamaConfig, LlamaSpmdTrainer
        with pytest.raises(NotImplementedError, match="pp axis"):
            LlamaSpmdTrainer(LlamaConfig.tiny(), compute_dtype=torch.float32)
    finally:
        pmesh._global_mesh = saved
