"""Shared pieces of the port's serving-stack twins (snapshots, resilience,
tenants, the ragged step): the reference tests' model sizes and greedy
readout, a (JAX core, port core) pair holding the same weights, one
serving driver that runs either package's PagedServingEngine, and a
comparison of two snapshots (control plane exact, payload within a
tolerance)."""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu_torch import weights

torch.set_num_threads(1)
# the reference tests' sizes (tests/test_resilience.py, test_tenants.py,
# test_paged_cache.py)
D, HEADS, FFN, LAYERS = 32, 4, 64, 2
VOCAB = 50
HID = dict(atol=1e-4, rtol=1e-4)

_RNG = np.random.RandomState(1234)
W_OUT = _RNG.randn(D, VOCAB).astype(np.float32)
EMBED = _RNG.randn(VOCAB, D).astype(np.float32)


def jax_model():
    paddle.seed(0)
    return JaxFMT(D, HEADS, FFN, num_layers=LAYERS)


@contextlib.contextmanager
def op_by_op():
    """The JAX package op by op inside the block (its per-op executable
    cache and layer captures off; tests/test_torch_serving.py's
    ``jax_op_by_op`` says why), its flags restored after."""
    names = ("FLAGS_eager_op_jit", "FLAGS_eager_layer_jit")
    before = {n: paddle.flags.get_flag(n) for n in names}
    paddle.set_flags({n: False for n in names})
    try:
        yield
    finally:
        paddle.set_flags(before)


def port_model(jcore=None):
    """The port's core with the weights of ``jax_model()``."""
    jcore = jcore or jax_model()
    state = {k: np.asarray(v.numpy()) for k, v in
             jcore.state_dict().items()}
    return weights.fused_multi_transformer(state, HEADS, device="cpu")


def tok_of(hidden_row) -> int:
    return int(np.argmax(np.asarray(hidden_row) @ W_OUT))


def to_jax(x):
    return paddle.to_tensor(np.asarray(x, np.float32))


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def wrap_of(eng):
    """The tensor constructor of ``eng``'s package."""
    return to_port if type(eng).__module__.startswith(
        "paddle_tpu_torch") else to_jax


def _drain(eng, active, pending, streams, outcomes, removed):
    """The engine's events into the driver's view; a re-admission's
    readout must equal the pending token (deterministic replay)."""
    for rid in eng.preempted:
        removed.add(rid)
        active.pop(rid, None)
    eng.preempted.clear()
    for oc in eng.outcomes:
        outcomes[oc.rid] = oc
        if oc.failed:
            removed.add(oc.rid)
            active.pop(oc.rid, None)
    eng.outcomes.clear()
    for rid, _slot, _n in eng.finished:
        removed.add(rid)
        active.pop(rid, None)
    eng.finished.clear()
    for rid, slot, h in eng.admitted:
        tok = tok_of(np.asarray(h.numpy())[0])
        if rid in streams:
            assert tok == pending[rid], \
                "re-prefill replay diverged from the recorded stream"
        else:
            streams[rid] = [tok]
            pending[rid] = tok
        active[rid] = slot
    eng.admitted.clear()


def drive(make_engine, work, targets, *, audit=False, max_steps=400):
    """Greedy token-serving loop over PagedServingEngine.step with the
    pending-token protocol (tests/test_tenants.py's driver, for either
    package). ``work`` is [(prompt, tenant_id)], ``targets`` {index:
    n_gen or None} (None: flood traffic, served until it fails or the
    steps run out). Stops when every targeted request finished or
    failed. Returns (streams, outcomes {rid: outcome}, rids, engine,
    outcome log [as_dict in emission order])."""
    eng = make_engine()
    wrap = wrap_of(eng)
    rids = [eng.submit(wrap(p), tenant_id=t) for p, t in work]
    log = [o.as_dict() for o in eng.outcomes]
    watched = {rids[i]: n for i, n in targets.items() if n is not None}
    streams, pending, outcomes = {}, {}, {}
    active, done = {}, set()
    B = eng.max_batch
    for _ in range(max_steps):
        removed = set()
        _drain(eng, active, pending, streams, outcomes, removed)
        live = [r for r in watched if r not in done
                and not (r in outcomes and outcomes[r].failed)]
        if not live:
            break
        x = np.zeros((B, 1, D), np.float32)
        for rid, slot in active.items():
            x[slot, 0] = EMBED[pending[rid]]
        prev = dict(active)
        removed = set()
        out = eng.step(wrap(x))
        if audit:
            eng.check_invariants()
        log += [o.as_dict() for o in eng.outcomes]
        _drain(eng, active, pending, streams, outcomes, removed)
        if out is None:
            continue
        o = np.asarray(out.numpy())
        for rid, slot in prev.items():
            if rid in removed or active.get(rid) != slot:
                continue
            tok = tok_of(o[slot, 0])
            streams[rid].append(tok)
            pending[rid] = tok
            if rid in watched and len(streams[rid]) >= watched[rid]:
                eng.release(slot)
                log += [o.as_dict() for o in eng.outcomes]
                active.pop(rid)
                done.add(rid)
    else:
        raise AssertionError("serving driver did not converge")
    log += [o.as_dict() for o in eng.outcomes]
    return streams, outcomes, rids, eng, log


# snapshot entries compared within HID rather than exactly: page
# payloads and event hiddens, which XLA and ATen compute in different
# orders
_NUMERIC = ("payload", "scale_payload", "admitted")


def assert_snapshots_match(a, b, path="", numeric=False):
    """Keys equal at every depth; control-plane values exactly equal;
    pool payloads and admitted hiddens within HID (int8 payloads within
    one quantization step)."""
    numeric = numeric or path.rsplit(".", 1)[-1] in _NUMERIC
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            (path, sorted(set(a) ^ set(b)) if isinstance(b, dict) else b)
        for k in a:
            assert_snapshots_match(a[k], b[k], f"{path}.{k}", numeric)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_snapshots_match(x, y, f"{path}[{i}]", numeric)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (path, a.shape, b.shape, a.dtype, b.dtype)
        if not numeric:
            np.testing.assert_array_equal(a, b, err_msg=path)
        elif a.dtype == np.int8:
            assert int(np.abs(a.astype(np.int32) - b).max(
                initial=0)) <= 1, path
        else:
            np.testing.assert_allclose(a, b, err_msg=path, **HID)
    elif numeric and isinstance(a, float):
        np.testing.assert_allclose(a, b, err_msg=path, **HID)
    else:
        assert type(a) is type(b) or {type(a), type(b)} <= {int, bool}, \
            (path, type(a), type(b))
        assert a == b, (path, a, b)


# -- both packages' topology, mesh and fleet state --------------------
_FLEET_STATE = {
    "jax": ("paddle_tpu.distributed.fleet.topology",
            "paddle_tpu.distributed.env", "paddle_tpu.parallel.mesh",
            "paddle_tpu.distributed.fleet.fleet"),
    "port": ("paddle_tpu_torch.distributed.fleet.topology",
             "paddle_tpu_torch.distributed.env",
             "paddle_tpu_torch.parallel.mesh",
             "paddle_tpu_torch.distributed.fleet.fleet"),
}


@contextlib.contextmanager
def no_fleet():
    """Both packages with no HybridCommunicateGroup and no installed mesh
    inside the block, their topology, env, mesh and fleet state as
    before it after (tests/test_torch_hybrid.py's ``_isolated``, which
    keeps whatever state it finds)."""
    import importlib
    saved = []
    for pkg, names in _FLEET_STATE.items():
        topo, env, mesh, fl = (importlib.import_module(m) for m in names)
        saved.append((topo, topo._HYBRID_PARALLEL_GROUP, env,
                      dict(env._state), mesh, mesh._global_mesh, fl,
                      dict(vars(fl._fleet))))
        topo._HYBRID_PARALLEL_GROUP = None
        if "hcg" in env._state:
            env._state["hcg"] = None
        mesh._global_mesh = None
    try:
        yield
    finally:
        for topo, hcg, env, env_state, mesh, m, fl, fleet_state in saved:
            topo._HYBRID_PARALLEL_GROUP = hcg
            env._state.clear()
            env._state.update(env_state)
            mesh._global_mesh = m
            vars(fl._fleet).clear()
            vars(fl._fleet).update(fleet_state)



@pytest.fixture(scope="module", autouse=True)
def shared_jax_cache(tmp_path_factory):
    """The JAX package's compiled executables kept on disk for the
    module (imported into a test module, this autouse fixture applies
    to it): the JAX references of these twins compile the same programs
    again and again (the package's layer captures compile per layer
    instance; op by op, every primitive per shape), and under xdist
    every worker compiles them anew. The directory is the test
    session's (the workers' common parent under xdist), so a program
    one module or worker compiled is read back by the next. The
    executables are the ones a compile gives; nothing else changes.
    The JAX settings are restored after the module."""
    import os
    from jax._src import compilation_cache as cc
    import jax
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "jax-compile-cache"
    root.mkdir(exist_ok=True)
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    before = {k: jax.config.values[k] for k in keys}
    jax.config.update("jax_compilation_cache_dir", str(root))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    cc.reset_cache()
    try:
        yield root
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
        cc.reset_cache()
