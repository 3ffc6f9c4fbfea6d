"""The port's Mixture-of-Experts training layer (``incubate/moe.py``)
held against the JAX package (``paddle_tpu/incubate/moe.py``) on the
CPU at tiny widths (d 16, 4 experts, d_hidden 32, 24 tokens).

- The capacity utilities (``number_count``, ``limit_by_capacity``,
  ``prune_gate_by_capacity``, ``assign_pos``): exactly equal.
- ``_gshard_routing``: each slot's expert one-hot, capacity position and
  kept flag exactly equal, the kept weights within 1e-6, over seeded
  logits and over logits with many exact ties (``jax.lax.top_k`` breaks
  them toward the lower expert index; the port's stable sort does too).
- The gates' logits and aux losses, and ``MoELayer``'s output, aux loss
  and every gradient (stacked ``ExpertFFN`` experts through the dense
  dispatch; generic experts mixed by the combine weights; the switch
  and naive gates given as dicts): float32, within 1e-5 x max|ref| for
  values and 1e-4 x max|g| for gradients, floored at 1e-3 x the largest
  gradient of the layer (summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import moe as jmoe
from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate import moe
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
D, E, H, N = 16, 4, 32, 24


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close(got, want, rel=1e-5, floor=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), floor)
    assert float(np.abs(got - want).max()) <= rel * scale


def test_capacity_utilities_match_jax():
    rng = np.random.RandomState(0)
    gi = rng.randint(0, E, 40).astype(np.int64)
    jc = _np(jmoe.number_count(paddle.to_tensor(gi), E))
    tc = moe.number_count(torch.from_numpy(gi), E)
    np.testing.assert_array_equal(tc.numpy(), jc)
    cap = np.array([5, 20, 3, 9], np.int64)
    np.testing.assert_array_equal(
        moe.limit_by_capacity(tc, torch.from_numpy(cap), 1).numpy(),
        _np(jmoe.limit_by_capacity(paddle.to_tensor(jc),
                                   paddle.to_tensor(cap), 1)))
    np.testing.assert_array_equal(
        moe.prune_gate_by_capacity(torch.from_numpy(gi),
                                   torch.from_numpy(cap), E, 1).numpy(),
        _np(jmoe.prune_gate_by_capacity(paddle.to_tensor(gi),
                                        paddle.to_tensor(cap), E, 1)))
    np.testing.assert_array_equal(
        moe.assign_pos(torch.from_numpy(gi), None).numpy(),
        _np(jmoe.assign_pos(paddle.to_tensor(gi), paddle.to_tensor(jc))))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("ties", [False, True], ids=["seeded", "tied"])
def test_routing_matches_jax_exactly(ties, k):
    rng = np.random.RandomState(1)
    lg = rng.randn(64, E).astype(np.float32)
    if ties:
        # a few values per row: many exact ties among the top k
        lg = np.round(lg).clip(-1, 1)
    cap = 12
    want = list(jmoe.MoELayer._gshard_routing(jnp.asarray(lg), k, E, cap))
    got = list(moe.MoELayer._gshard_routing(torch.from_numpy(lg), k, E,
                                            cap))
    assert len(got) == len(want) == k
    for (to, tp, tk, tv), (jo, jp, jk, jv) in zip(got, want):
        np.testing.assert_array_equal(to.numpy(), _np(jo))
        np.testing.assert_array_equal(tp.numpy(), _np(jp))
        np.testing.assert_array_equal(tk.numpy(), _np(jk))
        np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=0, atol=1e-6)
    if ties:
        # ties did occur among the chosen experts
        probs = np.exp(lg) / np.exp(lg).sum(-1, keepdims=True)
        top = np.sort(probs, -1)[:, ::-1]
        assert (top[:, k - 1] == top[:, k]).any()


def _state(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


@pytest.mark.parametrize("kind", ["gshard", "switch", "naive"])
def test_gates_match_jax(kind):
    paddle.seed(0)
    jg = {"gshard": jmoe.GShardGate, "switch": jmoe.SwitchGate,
          "naive": jmoe.NaiveGate}[kind](D, E)
    tg = {"gshard": moe.GShardGate, "switch": moe.SwitchGate,
          "naive": moe.NaiveGate}[kind](D, E, device="cpu")
    weights.transformer(_state(jg), tg)
    x = np.random.RandomState(2).randn(N, D).astype(np.float32)
    jl, jloss = jg(paddle.to_tensor(x))
    tl, tloss = tg(torch.from_numpy(x))
    _close(tl.detach(), jl)
    if kind == "naive":
        assert jloss is None and tloss is None
    else:
        _close(tloss.detach(), jloss)
        assert tg.loss is tloss


def _generic_experts(paddle_side):
    """Experts of mixed activations: the generic path runs."""
    acts = ["relu", "gelu", "relu", "tanh"]
    if paddle_side:
        return [jmoe.ExpertFFN(D, H, a) for a in acts]
    return [moe.ExpertFFN(D, H, a, device="cpu") for a in acts]


@pytest.mark.parametrize("case", ["stacked", "generic", "switch",
                                  "naive"])
def test_moe_layer_matches_jax(case):
    paddle.seed(1)
    kw = {"stacked": {}, "generic": {},
          "switch": {"gate": {"type": "switch"}},
          "naive": {"gate": {"type": "naive"}}}[case]
    jexp = _generic_experts(True) if case == "generic" else None
    texp = _generic_experts(False) if case == "generic" else None
    jl = jmoe.MoELayer(D, experts=jexp, num_expert=E, d_hidden=H, **kw)
    tl = weights.moe_layer(_state(jl), moe.MoELayer(
        D, experts=texp, num_expert=E, d_hidden=H, device="cpu", **kw))
    assert tl.top_k == jl.top_k
    x = np.random.RandomState(3).randn(2, N // 2, D).astype(np.float32)
    proj = np.random.RandomState(4).randn(2, N // 2, D).astype(np.float32)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jl(jx)
    jloss = (jout * paddle.to_tensor(proj)).sum()
    if jl.l_aux is not None:
        jloss = jloss + jl.l_aux
    jloss.backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tl(tx)
    tloss = (tout * torch.from_numpy(proj)).sum()
    if tl.l_aux is not None:
        _close(tl.l_aux.detach(), jl.l_aux)
        tloss = tloss + tl.l_aux
    tloss.backward()
    _close(tout.detach(), jout)
    _close(tx.grad, jx.grad, 1e-4)
    jp = dict(jl.named_parameters())
    floor = 1e-3 * max(float(np.abs(_np(p.grad)).max())
                       for p in jp.values() if p.grad is not None)
    for name, p in tl.named_parameters():
        if jp[name].grad is None:
            assert p.grad is None or not p.grad.any(), name
            continue
        _close(p.grad, jp[name].grad, 1e-4, floor)


def test_moe_layer_refuses_mesh_options():
    # ep_axis is ported (tests/test_torch_hybrid.py): an axis the mesh
    # does not widen leaves the layer on one rank, as in the reference
    assert moe.MoELayer(D, num_expert=E, d_hidden=H, ep_axis="mp",
                        device="cpu").ep_axis is None
    with pytest.raises(NotImplementedError):
        moe.MoELayer(D, num_expert=E, d_hidden=H, moe_group=object(),
                     device="cpu")
