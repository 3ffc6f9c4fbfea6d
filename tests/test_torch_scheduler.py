"""The PyTorch port's PagedServingEngine
(paddle_tpu_torch/inference/scheduler.py) held against the JAX package's
step by step on the CPU at tiny widths: admission, chunked prefill, the
token-budget ragged mixed step (``ragged_step = "force"`` on the JAX
side, the path the port always takes with a budget), synchronous
admission with fused decode steps (no budget), preemption with
re-prefill and slot refill. The control plane must be EXACTLY equal
after every step; hidden rows within 1e-4 (XLA and ATen reduce in
different orders). Weights come from a ``paddle.seed(0)`` JAX model
through ``paddle_tpu_torch.weights``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.inference import PagedServingEngine as JaxPSE
from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import PagedServingEngine

torch.set_num_threads(1)
D, HEADS, FFN, LAYERS = 64, 4, 128, 2
HID = dict(atol=1e-4, rtol=1e-4)
# 3 slots over 15 usable 4-token pages
POOL = dict(max_batch=3, block_size=4, num_blocks=16, chunk_tokens=8)


_JAX = {}


def _pair():
    """(JAX core, port core) holding the same weights. The JAX core is
    built once per module (its layer captures compile per layer
    instance; engines read it and never write it); each call gets a
    port core of its own."""
    if "core" not in _JAX:
        paddle.seed(0)
        jcore = JaxFMT(D, HEADS, FFN, num_layers=LAYERS)
        _JAX["core"] = jcore, {k: np.asarray(v.numpy()) for k, v in
                               jcore.state_dict().items()}
    jcore, state = _JAX["core"]
    return jcore, weights.fused_multi_transformer(state, HEADS,
                                                  device="cpu")


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _control_plane(eng):
    c = eng.cache
    return (list(c.allocator._free), c.allocator.refcount.tolist(),
            c.block_tables.tolist(), eng.lens.tolist(),
            eng.active.tolist(), eng.prefilling.tolist())


# (token budget, release length): both release points force preemptions
@pytest.mark.parametrize("budget,release_at", [(12, 24), (None, 28)])
def test_paged_engine_matches_jax_step_by_step(budget, release_at):
    """Mixed ragged steps (token budget) or synchronous admission plus
    fused decode steps (no budget), with preemption: after every step
    the allocator, tables, slot state, stats and event lists are equal,
    and every stepping row's hidden agrees within 1e-4."""
    jcore, tcore = _pair()
    kw = dict(POOL, prefill_token_budget=budget)
    je = JaxPSE(jcore, kw.pop("max_batch"), kw.pop("block_size"),
                kw.pop("num_blocks"), **kw)
    je.ragged_step = "force"
    te = PagedServingEngine(tcore, POOL["max_batch"], POOL["block_size"],
                            POOL["num_blocks"], **kw)
    rng = np.random.RandomState(2)
    prompts = [rng.randn(n, D).astype(np.float32) for n in (11, 26, 7, 19)]
    for p in prompts:
        assert je.submit(p) == te.submit(p)
    preempted = 0
    for _ in range(30):
        x = rng.randn(POOL["max_batch"], 1, D).astype(np.float32)
        active = je.active.copy()
        jo, to = je.step(paddle.to_tensor(x)), te.step(torch.from_numpy(x))
        assert (jo is None) == (to is None)
        if jo is not None:
            rows = active & te.active
            np.testing.assert_allclose(to.numpy()[rows], _np(jo)[rows],
                                       **HID)
        assert _control_plane(te) == _control_plane(je)
        assert [(r, s) for r, s, _ in te.admitted] == \
            [(r, s) for r, s, _ in je.admitted]
        for (_, _, th), (_, _, jh) in zip(te.admitted, je.admitted):
            np.testing.assert_allclose(th.numpy(), _np(jh), **HID)
        assert te.preempted == je.preempted
        assert te.prefill_stats.as_dict() == je.prefill_stats.as_dict()
        assert te.registry.as_dict()["pool.active"] == \
            je.registry.as_dict()["pool.active"]
        preempted += len(te.preempted)
        for eng in (je, te):
            eng.admitted.clear()
            eng.preempted.clear()
        te.check_invariants()
        for slot in np.flatnonzero(te.lens >= release_at):
            je.release(int(slot))
            te.release(int(slot))
        if not te.active.any() and not te.prefilling.any() \
                and not te.queue:
            break
    assert preempted >= 1
    assert [o.as_dict() for o in te.outcomes] == \
        [o.as_dict() for o in je.outcomes]
