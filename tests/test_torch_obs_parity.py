"""The port's observability and billing held against the JAX package on
the CPU, exactly: the same traffic through both packages' engines with a
TraceCollector (on a counting clock), a HealthMonitor and a CostLedger
attached gives equal streams and outcomes, equal alert sequences, equal
ledger dumps (rows, FLOPs, waste by cause, tenant bills, the step log),
equal registry dumps and equal request records, timestamps included.
Hidden states are compared within ``torch_twins.HID``; everything here is
control plane. The copied host-only modules (these three and the fleet's
router.py, net.py, fleet.py and injectors) stay AST-equal to their
references, function by function
(``test_copied_modules_match_their_references``)."""
import ast
import inspect

import numpy as np
import pytest

import paddle_tpu.inference as J
import paddle_tpu_torch.inference as P
from paddle_tpu.inference import accounting as j_acc
from paddle_tpu.inference import fleet as j_fleet
from paddle_tpu.inference import monitor as j_mon
from paddle_tpu.inference import net as j_net
from paddle_tpu.inference import resilience as j_res
from paddle_tpu.inference import router as j_router
from paddle_tpu.inference import telemetry as j_tel
from paddle_tpu_torch.inference import accounting as p_acc
from paddle_tpu_torch.inference import fleet as p_fleet
from paddle_tpu_torch.inference import monitor as p_mon
from paddle_tpu_torch.inference import net as p_net
from paddle_tpu_torch.inference import resilience as p_res
from paddle_tpu_torch.inference import router as p_router
from paddle_tpu_torch.inference import telemetry as p_tel
from tests.torch_twins import (D, EMBED, VOCAB, jax_model, op_by_op,
                               port_model)
from tests.torch_twins import shared_jax_cache  # noqa: F401

N_GEN = 12


def _units(mod) -> dict:
    """{name: AST dump} of ``mod``'s source without imports and
    docstrings, one entry per function (``Class.method`` for methods),
    per class's other statements (``Class``) and for the module's other
    statements (``<module>``)."""
    tree = ast.parse(inspect.getsource(mod))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list):
            node.body = [
                s for s in body
                if not isinstance(s, (ast.Import, ast.ImportFrom))
                and not (isinstance(s, ast.Expr)
                         and isinstance(s.value, ast.Constant)
                         and isinstance(s.value.value, str))]
    out = {"<module>": []}
    for s in tree.body:
        if isinstance(s, ast.ClassDef):
            rest = []
            for m in s.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{s.name}.{m.name}"] = ast.dump(m)
                else:
                    rest.append(m)
            s.body = rest
            out[s.name] = ast.dump(s)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[s.name] = ast.dump(s)
        else:
            out["<module>"].append(s)
    out["<module>"] = ast.dump(ast.Module(out["<module>"], []))
    return out


# the host-only copies, each with the units allowed to differ from its
# reference and why
COPIES = {
    "telemetry": ((j_tel, p_tel), None, set()),
    "monitor": ((j_mon, p_mon), None, set()),
    "accounting": ((j_acc, p_acc), None, set()),
    # build_model_from_spec seeds the port's core with a CPU
    # torch.Generator on the spec's device (jax's PRNG is not
    # reproducible in torch)
    "router": ((j_router, p_router), None, {"build_model_from_spec"}),
    # the socket clients' large frames (ROADMAP Queue C item 11): they
    # buffer received bytes in a bytearray (linear in the frame size;
    # the reference's bytes concatenation is quadratic): the units that
    # set the buffer; a send gets the op's timeout, not the <= 50 ms the
    # last poll left on the socket (call, _send, SocketWorker.request);
    # the session client's reply budget is spent only by silent polls
    # (the reference's counts every poll, capping a reply at 157 MB at
    # the 120 s default): _await
    "net": ((j_net, p_net), None, {
        "ResilientTransport.__init__", "ResilientTransport._drop_conn",
        "ResilientTransport._decode", "ResilientTransport._hello_on",
        "ResilientTransport._await", "ResilientTransport.call",
        "ResilientTransport._send"}),
    "fleet": ((j_fleet, p_fleet), None, {"SocketWorker.__init__",
                                         "SocketWorker.request"}),
    # the port's resilience.py rewrites the engine-level injectors for
    # torch tensors; the fleet's two injectors are copies
    "resilience": ((j_res, p_res),
                   ("RouterFaultInjector", "NetworkFaultInjector"), set()),
}


@pytest.mark.parametrize("name", sorted(COPIES))
def test_copied_modules_match_their_references(name):
    """telemetry.py, monitor.py, accounting.py, router.py, net.py,
    fleet.py and resilience.py's fleet injectors are host-only copies:
    apart from imports and docstrings every function, class body and
    module statement equals the JAX package's, but for the listed
    boundary units, so a change to either side fails here, naming the
    units that differ, until the other follows."""
    (ref, port), only, allowed = COPIES[name]
    a, b = _units(ref), _units(port)
    if only is not None:
        keep = lambda u: u.split(".")[0] in only  # noqa: E731
        a = {u: v for u, v in a.items() if keep(u)}
        b = {u: v for u, v in b.items() if keep(u)}
        assert set(a) == set(b) and a, sorted(set(a) ^ set(b))
    differ = {u for u in set(a) | set(b) if a.get(u) != b.get(u)}
    assert differ == allowed, sorted(differ ^ allowed)


@pytest.fixture(scope="module")
def tsms():
    """{package: TokenServingModel} over the same weights; the JAX side
    runs op by op for the module."""
    with op_by_op():
        jcore = jax_model()
        yield {J: J.TokenServingModel(jcore, EMBED),
               P: P.TokenServingModel(port_model(jcore), EMBED)}


def _counter():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]
    return clock


def _observers(inf, slo=True):
    slo = {"*": inf.SloPolicy(ttft_s=3.0, tpot_s=2.0, queue_wait_s=4.0,
                              objective=0.9)} if slo else None
    return dict(collector=inf.TraceCollector(clock=_counter()),
                monitor=inf.HealthMonitor(slo=slo),
                ledger=inf.CostLedger())


def _prompts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, VOCAB, int(L)))
            for L in rng.integers(lo, hi, n)]


def _serve(eng, prompts, burst=(), burst_at=(), n_gen=N_GEN):
    """The monitor suite's overload loop (tests/test_monitor.py
    ``_overload_run``) for either package: serve until every request
    has ``n_gen`` tokens or failed, submitting ``burst`` two at a time
    at the rounds in ``burst_at``. Returns (streams, outcome log)."""
    burst = list(burst)
    rids = [eng.submit(p) for p in prompts]
    done, failed, log = {}, set(), []
    for it in range(300):
        if it in burst_at:
            rids += [eng.submit(burst.pop()) for _ in range(2)]
        live = [r for r in rids if r not in done and r not in failed]
        if not live and not burst:
            break
        eng.step()
        for oc in eng.outcomes:
            log.append((oc.rid, oc.status, oc.step, oc.tokens))
            if oc.failed:
                failed.add(oc.rid)
        eng.outcomes.clear()
        for r in live:
            if r not in failed and len(eng.generated(r)) >= n_gen:
                done[r] = eng.generated(r)[:n_gen]
                eng.release(r)
    else:
        raise AssertionError("serving loop did not converge")
    log += [(oc.rid, oc.status, oc.step, oc.tokens) for oc in eng.outcomes]
    return done, log


def _record(eng):
    """Everything the three observers and the registry export."""
    col, mon, led = eng.collector, eng.monitor, eng.ledger
    return {"alerts": [a.as_dict() for a in mon.alerts],
            "alert_counts": dict(mon.alert_counts),
            "monitor": mon.as_dict(),
            "ledger": led.as_dict(),
            "conservation": led.conservation(),
            "registry": eng.registry.as_dict(),
            "collector": col.as_dict(),
            "requests": {r.rid: r.as_dict()
                         for r in col.requests.values()},
            "timeline": [(e["name"], e["ph"], e["ts"], e.get("dur"),
                          e.get("args")) for e in col.events]}


# one pool geometry for every scenario: the JAX side compiles its ops
# once per shape, and that, not the serving, is most of this file's time
GEOMETRY = dict(k=0, max_batch=2, block_size=4, num_blocks=12,
                max_blocks_per_seq=8)
SCENARIOS = {
    # no retry budget and a submission burst into a tight pool: pool
    # pressure, queue growth and sheds (the monitor suite's overload run)
    "overload": dict(
        eng=dict(max_preemptions=0),
        traffic=lambda: dict(
            prompts=_prompts(7, 2, 10, 11), burst=_prompts(8, 4, 10, 11),
            burst_at=(3, 4), n_gen=10)),
    # preemption and warm re-prefill through the prefix cache
    "prefix_preempt": dict(
        eng=dict(prefix_cache=True),
        traffic=lambda: dict(prompts=_prompts(9, 4, 8, 14), n_gen=8)),
    # a fault storm: forced OOM sheds and a NaN-failed slot
    "faults": dict(
        eng=dict(),
        injector=dict(oom_at=[3, 4, 5, 6], nan_at={8: [1]}),
        traffic=lambda: dict(prompts=_prompts(84, 4, 8, 12), n_gen=8)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_observers_match_jax_exactly(tsms, name):
    """Streams, outcomes, alerts, ledger, registry and the collector's
    records (on a counting clock) are equal between the packages."""
    sc = SCENARIOS[name]
    recs, runs = {}, {}
    for inf in (J, P):
        inj = (inf.FaultInjector(**sc["injector"])
               if "injector" in sc else None)
        eng = inf.SpeculativeEngine(tsms[inf], None, injector=inj,
                                    **_observers(inf), **GEOMETRY,
                                    **sc["eng"])
        runs[inf] = _serve(eng, **sc["traffic"]())
        recs[inf] = _record(eng)
    assert runs[P] == runs[J]
    for key in recs[J]:
        assert recs[P][key] == recs[J][key], key
    rec = recs[P]
    assert rec["conservation"]["ok"]
    if name == "overload":
        kinds = {a["kind"] for a in rec["alerts"]}
        assert {"pool-pressure-high", "queue-growth"} <= kinds
    if name == "faults":
        assert rec["ledger"]["totals"]["waste_rows"]["shed"] > 0


def test_int8_core_needs_an_explicit_work_model():
    """``WorkModel.for_model`` reads a float ``ffn1.weight``: on an int8
    core (None in the JAX package, absent in the port) it fails in both
    packages alike, so a ledger on an int8 engine takes an explicit
    WorkModel; with ``weight_itemsize=1`` both packages price the w8a16
    weights at one byte and bind it unchanged."""
    from paddle_tpu.incubate.nn import FusedMultiTransformerInt8 as JInt8
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformerInt8
    jm = jax_model()
    cores = {J: JInt8.from_float(jm),
             P: FusedMultiTransformerInt8.from_float(port_model(jm))}
    dumps = {}
    for inf, core in cores.items():
        with pytest.raises(AttributeError):
            inf.WorkModel.for_model(core)
        wm = inf.WorkModel(core.num_layers, core.embed_dim, 64,
                           weight_itemsize=1)
        eng = inf.PagedServingEngine(core, 2, 4, 8, dtype="int8",
                                     ledger=inf.CostLedger(wm))
        assert eng.ledger.work is wm
        dumps[inf] = wm.as_dict()
    assert dumps[P] == dumps[J]
    f32 = P.WorkModel(2, D, 64).weight_bytes
    assert dumps[P]["weight_bytes"] * 4 == f32
