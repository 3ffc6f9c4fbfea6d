"""The port's ``ragged_step`` knob held against the JAX package on the
CPU: twins of tests/test_paged_cache.py::TestRaggedMixedStep at its
sizes. ``ragged_step=True`` (or "force") packs a token-budget step's
prefill chunks and decode rows into one model call, one ragged
paged-attention call per layer; ``False`` runs one model call per chunk
and one for the decode. The port packs on the CPU too (the JAX engine
only on its kernel path or with "force").

What is checked: the two modes schedule identically (chunks, mixed
steps, admissions) and give the same hidden rows within 1e-5 and the
same greedy tokens (ATen's packed and per-phase matmuls may differ in
the last bits, so bitwise equality is not asked); the packed step makes
one attention call per layer where the per-phase step makes one per
chunk plus one for the decode; and each mode's rows agree with the JAX
engine's in the same mode within 1e-4."""
import numpy as np
import pytest

from paddle_tpu.inference import PagedServingEngine as JaxPSE
from paddle_tpu_torch.inference import (PagedServingEngine,
                                        SpeculativeEngine,
                                        TokenServingModel)
from paddle_tpu_torch.inference import paged_cache as pc
from tests.torch_twins import (D, EMBED, HID, LAYERS, jax_model,
                               port_model, to_jax, to_port, tok_of)
from tests.torch_twins import shared_jax_cache  # noqa: F401

CAP_BS, CAP_MB = 16, 12
TIGHT = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def cores():
    jcore = jax_model()
    return jcore, port_model(jcore)


def _drive(core, cls, wrap, ragged, steps=7):
    """A short resident request decoding while a 70-token prompt streams
    in budgeted chunks. Returns (admitted hiddens by rid, per-step decode
    rows by slot, engine)."""
    rng = np.random.RandomState(77)
    pshort = rng.randn(6, D).astype(np.float32)
    plong = rng.randn(70, D).astype(np.float32)
    eng = cls(core, max_batch=2, block_size=CAP_BS, num_blocks=24,
              max_blocks_per_seq=CAP_MB, chunk_tokens=32,
              prefill_token_budget=32, ragged_step=ragged)
    rs = eng.submit(wrap(pshort))
    x = np.zeros((2, 1, D), np.float32)
    assert eng.step(wrap(x)) is None
    hiddens, rows = {}, []
    (rid, slot, h), = eng.admitted
    eng.admitted.clear()
    hiddens[rid] = np.asarray(h.numpy())
    x[slot, 0] = hiddens[rid][0]
    eng.submit(wrap(plong))
    for _ in range(steps):
        pre = eng.active.copy()
        out = eng.step(wrap(x))
        assert out is not None
        ov = np.asarray(out.numpy())
        rows.append({int(s): ov[s].copy()
                     for s in np.flatnonzero(pre & eng.active)})
        for s in np.flatnonzero(pre & eng.active):
            x[s, 0] = ov[s, 0]
        for (rr, ss, hh) in eng.admitted:
            hiddens[rr] = np.asarray(hh.numpy())
            x[ss, 0] = hiddens[rr][0]
        eng.admitted.clear()
    assert rs in hiddens and len(hiddens) == 2
    return hiddens, rows, eng


def _assert_runs_match(a, b, tol):
    (ha, ra, ea), (hb, rb, eb) = a, b
    assert set(ha) == set(hb)
    for rid in ha:
        np.testing.assert_allclose(ha[rid], hb[rid], **tol)
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert set(x) == set(y)
        for s in x:
            np.testing.assert_allclose(x[s], y[s], **tol)
            assert tok_of(x[s][0]) == tok_of(y[s][0])
    for f in ("chunks", "prefill_tokens", "mixed_steps", "prefill_steps",
              "decode_steps"):
        assert getattr(ea.prefill_stats, f) == getattr(eb.prefill_stats, f)


def test_streams_match_the_per_phase_path(cores):
    """Packed (True and "force") and per-phase (False) runs of the mixed
    workload: the same schedule and rows, and each agrees with the JAX
    engine's run in its mode ("force" and False)."""
    jcore, tcore = cores
    packed = _drive(tcore, PagedServingEngine, to_port, True)
    forced = _drive(tcore, PagedServingEngine, to_port, "force")
    legacy = _drive(tcore, PagedServingEngine, to_port, False)
    _assert_runs_match(packed, forced, dict(atol=0, rtol=0))
    _assert_runs_match(packed, legacy, TIGHT)
    assert packed[2].prefill_stats.mixed_steps >= 1
    _assert_runs_match(packed, _drive(jcore, JaxPSE, to_jax, "force"), HID)
    _assert_runs_match(legacy, _drive(jcore, JaxPSE, to_jax, False), HID)


def _count_attention(monkeypatch):
    calls = []
    real = pc.paged_attention_ragged

    def counting(*a, **kw):
        calls.append(len(a[3]))          # the call's sequence count
        return real(*a, **kw)
    monkeypatch.setattr(pc, "paged_attention_ragged", counting)
    return calls


@pytest.mark.parametrize("ragged", [True, False])
def test_mixed_step_attention_calls_per_layer(cores, monkeypatch, ragged):
    """A mixed step (a prefill chunk beside the decode rows): packed,
    ONE attention call per layer and one model call; per phase, one
    model call for the chunk and one for the decode, each with its
    attention call per layer — the count the plan predicts."""
    tcore = cores[1]
    rng = np.random.RandomState(78)
    eng = PagedServingEngine(tcore, max_batch=2, block_size=CAP_BS,
                             num_blocks=12, max_blocks_per_seq=4,
                             chunk_tokens=32, prefill_token_budget=32,
                             ragged_step=ragged)
    eng.submit(to_port(rng.randn(6, D).astype(np.float32)))
    x = np.zeros((2, 1, D), np.float32)
    assert eng.step(to_port(x)) is None
    (rid, slot, h), = eng.admitted
    eng.admitted.clear()
    x[slot, 0] = h.numpy()[0]
    eng.submit(to_port(rng.randn(40, D).astype(np.float32)))
    model_calls = []
    hook = tcore.register_forward_pre_hook(
        lambda m, a: model_calls.append(1))
    calls = _count_attention(monkeypatch)
    chunks = eng.prefill_stats.chunks
    try:
        assert eng.step(to_port(x)) is not None
    finally:
        hook.remove()
    chunks = eng.prefill_stats.chunks - chunks
    assert eng.prefill_stats.mixed_steps >= 1 and chunks == 1
    if ragged:
        assert len(model_calls) == 1
        assert calls == [3] * LAYERS        # chunk + 2 decode rows
    else:
        assert len(model_calls) == chunks + 1
        assert calls == [1] * LAYERS + [2] * LAYERS


def test_prefill_only_ragged_step_packs_multiple_slots(cores, monkeypatch):
    """Two prompts streaming together: their chunks pack into one
    prefill-only call per step (one attention call per layer over both
    sequences), and the admission hiddens match the per-phase path's
    and the JAX engine's."""
    jcore, tcore = cores

    def drive(core, cls, wrap, ragged):
        rng = np.random.RandomState(79)
        pa_, pb = (rng.randn(24, D).astype(np.float32) for _ in range(2))
        eng = cls(core, max_batch=2, block_size=CAP_BS, num_blocks=24,
                  max_blocks_per_seq=CAP_MB, chunk_tokens=16,
                  prefill_token_budget=64, ragged_step=ragged)
        ra, rb = eng.submit(wrap(pa_)), eng.submit(wrap(pb))
        x = wrap(np.zeros((2, 1, D), np.float32))
        got = {}
        for _ in range(6):
            eng.step(x)
            for (rr, ss, hh) in eng.admitted:
                got[rr] = np.asarray(hh.numpy())
            eng.admitted.clear()
            if len(got) == 2:
                break
        assert set(got) == {ra, rb}
        return got[ra], got[rb]

    calls = _count_attention(monkeypatch)
    ha, hb = drive(tcore, PagedServingEngine, to_port, True)
    assert calls[:LAYERS] == [2] * LAYERS   # both prompts, one call
    la, lb = drive(tcore, PagedServingEngine, to_port, False)
    np.testing.assert_allclose(ha, la, **TIGHT)
    np.testing.assert_allclose(hb, lb, **TIGHT)
    ja, jb = drive(jcore, JaxPSE, to_jax, "force")
    np.testing.assert_allclose(ha, ja, **HID)
    np.testing.assert_allclose(hb, jb, **HID)


def test_speculative_streams_equal_across_ragged_modes(cores):
    """Greedy k=2 self-drafted serving with a token budget: the streams
    with per-phase steps equal the packed ones."""
    tsm = TokenServingModel(cores[1], EMBED)
    prompts = [list(np.random.RandomState(s).randint(0, 50, n))
               for s, n in ((1, 11), (2, 23), (3, 7))]
    out = []
    for ragged in (True, False):
        e = SpeculativeEngine(tsm, None, k=2, max_batch=2, block_size=4,
                              num_blocks=40, max_blocks_per_seq=12,
                              chunk_tokens=8, prefill_token_budget=8)
        e.engine.ragged_step = ragged
        rids = [e.submit(p) for p in prompts]
        for _ in range(200):
            if all(len(e.generated(r)) >= 8 for r in rids):
                break
            e.step()
        e.check_invariants()
        out.append(({r: e.generated(r)[:8] for r in rids},
                    e.engine.prefill_stats.chunks))
    assert out[0] == out[1]
