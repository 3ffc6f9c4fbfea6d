"""BERT pretraining under AMP: the port (``amp.decorate``, ``auto_cast``,
the op-boundary hook, multi-precision AdamW) held against the JAX
package on the CPU at tiny widths (2 layers, hidden 64, 4 heads, FFN
128, vocab 1000; batch 2 x 16; dropout 0: the two packages draw
different random bits). Weights come from a ``paddle.seed(0)`` JAX model
through ``weights.bert_for_pretraining``; O2 casts both copies to bf16
(round to nearest even on both sides, so the bf16 weights are equal).

- The dtype trace: the dtypes of every hooked op's inputs, in order, in
  one forward (the op names the port hooks, from the JAX package's
  ``maybe_cast_inputs``), the loss's and ``pred``'s dtypes and every
  gradient's dtype equal the JAX package's exactly, under O1 and O2,
  with and without ``FLAGS_tpu_fused_encoder``: a cast policy is
  control plane. Under O2 the loss is bf16, as in the reference (its
  ``loss + nsp_loss`` is an ``elementwise_add`` and casts).
- The loss within 2e-2 relative and ``pred`` within 5e-2 x max|pred|:
  both packages round every op's output to bf16 (2**-8 relative) along
  a chain of about 30 ops, in different summation orders.
- 3 ``multi_precision`` AdamW(1e-3) steps under O2: every loss within
  2e-2 relative of the JAX package's, the masters float32 and the
  parameters bf16 (each the master rounded). Adam's first step moves an
  entry by lr x sign(g) whatever |g| is, so after it the masters are
  held where the first gradient is large (above 1e-1 x the tensor's
  max|g|; the two packages' bf16 gradients differ there by up to ~10%,
  never in sign; the key projections' biases are left out: their exact
  gradient is 0, softmax being unchanged by a per-query shift of the
  scores, so both sides hold bf16 rounding noise there): within 1e-6 + 2 lr eps / |g| (float32 rounding, and
  Adam's eps in lr g / (|g| + eps)). Elsewhere a sign can flip: within
  2 lr + 1e-6.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPretraining as JaxBert
import paddle_tpu_torch
from paddle_tpu_torch import amp, weights
from paddle_tpu_torch.framework import op
from paddle_tpu_torch.models import BertConfig
from paddle_tpu_torch.optimizer import AdamW
from tests.torch_twins import op_by_op

torch.set_num_threads(1)
TINY = dict(vocab=1000, hidden=64, layers=2, heads=4, inter=128)
B, L, LR = 2, 16, 1e-3
HOOKED = {"embedding", "elementwise_add", "layer_norm", "linear",
          "flash_attention", "gelu", "tanh", "fused_ln_residual_dropout",
          "matmul", "cross_entropy", "dropout"}
jax_cast = importlib.import_module("paddle_tpu.amp.auto_cast")


def _config(cls):
    cfg = cls.tiny(**TINY)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab"], (B, L)).astype(np.int64)
    mlm = rng.randint(0, TINY["vocab"], (B, L)).astype(np.int64)
    mlm[rng.rand(B, L) > 0.15] = -100
    mlm[0, 0] = 7
    nsp = rng.randint(0, 2, (B,)).astype(np.int64)
    return ids, mlm, nsp


def _kind(t):
    s = str(t.dtype).replace("torch.", "")
    return "int" if "int" in s else s


def _entry(name, tensors):
    return (name, tuple(_kind(t) for t in tensors if t is not None))


def _set_fused(fused):
    paddle.set_flags({"FLAGS_tpu_fused_encoder": fused})
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": fused})


@pytest.fixture
def fused_flag():
    yield _set_fused
    _set_fused(False)


def _jax_model(level):
    paddle.seed(0)
    jm = JaxBert(_config(JaxBertConfig))
    for n, p in jm.named_parameters():
        p.name = n            # unique names: the JAX optimizer keys by name
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    if level == "O2":
        paddle.amp.decorate(models=jm, level="O2", dtype="bfloat16")
    return jm, state


def _port_model(state, level):
    tm = weights.bert_for_pretraining(state, _config(BertConfig),
                                      device="cpu")
    if level == "O2":
        amp.decorate(tm, level="O2", dtype="bfloat16")
    return tm


def _jax_forward(jm, level, batch, monkeypatch=None):
    ids, mlm, nsp = (paddle.to_tensor(a) for a in batch)
    trace = []
    if monkeypatch is not None:
        orig = jax_cast.maybe_cast_inputs

        def rec(op_name, args, symbolic=False):
            out = orig(op_name, args, symbolic)
            if op_name in HOOKED:
                trace.append(_entry(op_name, out))
            return out
        monkeypatch.setattr(jax_cast, "maybe_cast_inputs", rec)
    with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
        loss, pred = jm(ids, masked_lm_labels=mlm, next_sentence_label=nsp)
    if monkeypatch is not None:
        monkeypatch.setattr(jax_cast, "maybe_cast_inputs", orig)
    loss.backward()
    return loss, pred, trace


def _port_forward(tm, level, batch, record=False):
    ids, mlm, nsp = (torch.from_numpy(a) for a in batch)
    trace = []

    def obs(name, tensors):
        trace.append(_entry(name, tensors))
    if record:
        op.watch(obs)
    try:
        with amp.auto_cast(level=level, dtype="bfloat16"):
            loss, pred = tm(ids, masked_lm_labels=mlm,
                            next_sentence_label=nsp)
    finally:
        if record:
            op.unwatch(obs)
    loss.backward()
    return loss, pred, trace


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("level", ["O2", "O1"])
def test_dtype_trace_and_outputs_match_jax(level, fused, fused_flag,
                                           monkeypatch):
    fused_flag(fused)
    batch = _batch()
    jm, state = _jax_model(level)
    with op_by_op():
        jl, jp, jtrace = _jax_forward(jm, level, batch, monkeypatch)
    tm = _port_model(state, level)
    tl, tp, ttrace = _port_forward(tm, level, batch, record=True)
    assert ttrace == jtrace
    assert len(ttrace) > 30
    if fused:
        assert ("fused_ln_residual_dropout",
                ("bfloat16",) * 4 if level == "O2"
                else ("bfloat16", "float32", "float32", "float32")) \
            in ttrace
    assert _kind(tl) == _kind(jl) == ("bfloat16" if level == "O2"
                                      else "float32")
    assert _kind(tp) == _kind(jp)
    jg = {n: None if p.grad is None else _kind(p.grad)
          for n, p in jm.named_parameters()}
    tg = {n: None if p.grad is None else _kind(p.grad)
          for n, p in tm.named_parameters()}
    assert tg == jg
    jl, tl = float(jl.astype("float32").numpy()), tl.item()
    assert abs(tl - jl) <= 2e-2 * abs(jl)
    jp = np.asarray(jp.astype("float32").numpy())
    tp = tp.detach().float().numpy()
    assert np.abs(tp - jp).max() <= 5e-2 * np.abs(jp).max()


def test_o2_multi_precision_adamw_matches_jax(fused_flag):
    fused_flag(True)
    batch = _batch(1)
    jm, state = _jax_model("O2")
    tm = _port_model(state, "O2")
    jopt = paddle.optimizer.AdamW(LR, parameters=jm.parameters(),
                                  multi_precision=True)
    topt = AdamW(LR, parameters=tm.parameters(), multi_precision=True)
    moved, eps = 0, 1e-8
    for step in range(3):
        with op_by_op():
            jl, _, _ = _jax_forward(jm, "O2", batch)
        tl, _, _ = _port_forward(tm, "O2", batch)
        jl, tl = float(jl.astype("float32").numpy()), tl.item()
        assert abs(tl - jl) <= 2e-2 * abs(jl)
        first = {n: None if p.grad is None else
                 np.abs(np.asarray(p.grad.astype("float32").numpy()))
                 for n, p in jm.named_parameters()}
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
        if step:
            continue
        for n, p in tm.named_parameters():
            assert p.dtype == torch.bfloat16, n
            if first[n] is None:           # no gradient: never stepped
                assert p not in topt._master_weights, n
                continue
            tmaster = topt._master_weights[p]
            assert tmaster.dtype == torch.float32
            assert torch.equal(tmaster.to(torch.bfloat16), p.detach()), n
            jmaster = np.asarray(jopt._master_weights[n], np.float32)
            err = np.abs(tmaster.numpy() - jmaster)
            g = first[n]
            big = g > 1e-1 * g.max()
            if n.endswith("k_proj.bias"):
                big[:] = False
            assert (err <= 1e-6 + 2 * LR * eps / np.maximum(g, 1e-30))[
                big].all(), n
            assert err.max() <= 2 * LR + 1e-6, n
            moved += int(big.sum())
    assert moved > 1000
