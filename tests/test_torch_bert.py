"""The PyTorch port's BERT pretraining path (paddle_tpu_torch.models.bert,
nn, optimizer.AdamW, the fused LayerNorm and dropout kernels' plain
versions) held against the JAX package on the CPU at tiny widths (2
layers, hidden 64, 4 heads, FFN 128, vocab 1000; batch 2 x 16, 85% of
the MLM labels -100).

Weights come from a ``paddle.seed(0)`` JAX model through
``paddle_tpu_torch.weights.bert_for_pretraining``; inputs from seeded
numpy. Dropout is 0 in the parity tests (the two packages draw different
random bits); with ``FLAGS_tpu_fused_encoder`` on, both sides take their
fused LayerNorm (Pallas in interpret mode on the JAX side). Tolerances:

- loss within 1e-5 relative, ``pred`` within 1e-5 relative / 1e-4
  absolute (summation order only);
- each gradient within 1e-4 x its max|g|, floored at 1e-3 x the largest
  gradient of the model: the key projection's bias has an exact
  gradient of 0 (softmax is unchanged by a per-query shift of the
  scores), so both sides hold rounding noise there;
- 3 AdamW steps: losses within 1e-5 relative; parameters within 1e-6
  where the first step's |g| > 1e-3 x the tensor's max|g| (with the
  floor above, so no entry of the key bias counts). Elsewhere 2 lr
  + 1e-6: Adam moves every entry by about lr whatever the gradient's
  size, so where a gradient is at rounding-noise level its sign can
  differ between the packages and the entry lands 2 lr away.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPretraining as JaxBert
import paddle_tpu_torch
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import BertConfig, BertForPretraining
from paddle_tpu_torch.optimizer import AdamW
from tests.test_torch_serving import jax_op_by_op  # noqa: F401

torch.set_num_threads(1)
TINY = dict(vocab=1000, hidden=64, layers=2, heads=4, inter=128)
B, L, LR = 2, 16, 1e-4


def _config(cls, dropout=0.0):
    cfg = cls.tiny(**TINY)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    return cfg


def _jax_model():
    paddle.seed(0)
    return JaxBert(_config(JaxBertConfig))


@pytest.fixture(scope="module")
def jax_bert():
    jm = _jax_model()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, state


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab"], (B, L)).astype(np.int64)
    mlm = rng.randint(0, TINY["vocab"], (B, L)).astype(np.int64)
    mlm[rng.rand(B, L) > 0.15] = -100
    mlm[0, 0] = 7                       # at least one labelled position
    nsp = rng.randint(0, 2, (B,)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[1, 11:] = 0
    return ids, mlm, nsp, mask


@pytest.fixture
def flags(jax_op_by_op):
    """Runs the JAX package op by op (``jax_op_by_op``) and sets the
    fused-encoder flag on both sides; restores the defaults."""
    def set_(fused):
        paddle.set_flags({"FLAGS_tpu_fused_encoder": fused})
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": fused})
    yield set_
    paddle.set_flags({"FLAGS_tpu_fused_encoder": False})
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": False})


def _jax_step(jm, ids, mlm, nsp, mask=None):
    loss, pred = jm(paddle.to_tensor(ids),
                    attention_mask=None if mask is None
                    else paddle.to_tensor(mask),
                    masked_lm_labels=paddle.to_tensor(mlm),
                    next_sentence_label=paddle.to_tensor(nsp))
    loss.backward()
    grads = {n: None if p.grad is None else np.asarray(p.grad.numpy())
             for n, p in jm.named_parameters()}
    return float(loss.numpy()), np.asarray(pred.numpy()), grads


def _port_step(tm, ids, mlm, nsp, mask=None):
    loss, pred = tm(torch.from_numpy(ids),
                    attention_mask=None if mask is None
                    else torch.from_numpy(mask),
                    masked_lm_labels=torch.from_numpy(mlm),
                    next_sentence_label=torch.from_numpy(nsp))
    loss.backward()
    return loss.item(), pred.detach().numpy(), {
        n: None if p.grad is None else p.grad.numpy().copy()
        for n, p in tm.named_parameters()}


@pytest.mark.parametrize("case", ["fused", "unfused", "masked"])
def test_pretraining_matches_jax(jax_bert, flags, case):
    jm, state = jax_bert
    flags(case != "unfused")
    ids, mlm, nsp, mask = _batch()
    mask = mask if case == "masked" else None
    jl, jp, jg = _jax_step(jm, ids, mlm, nsp, mask)
    for p in jm.parameters():
        p.clear_grad()
    tm = weights.bert_for_pretraining(state, _config(BertConfig),
                                      device="cpu")
    tl, tp, tg = _port_step(tm, ids, mlm, nsp, mask)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-4)
    assert set(tg) == set(jg)
    # unused parameters get no gradient on either side: the tied
    # decoder's own weight and, without token_type_ids, the type
    # embeddings
    unused = {"cls.decoder.weight",
              "bert.embeddings.token_type_embeddings.weight"}
    assert {n for n, g in tg.items() if g is None} == unused
    assert {n for n, g in jg.items() if g is None} == unused
    floor = 1e-3 * max(np.abs(g).max() for g in jg.values()
                       if g is not None)
    for n, g in tg.items():
        if g is not None:
            scale = max(np.abs(jg[n]).max(), floor)
            assert np.abs(g - jg[n]).max() <= 1e-4 * scale, n


def test_adamw_steps_match_jax(flags):
    """3 AdamW(1e-4) steps of the JAX dygraph loop against the port's.
    The JAX side runs op by op (``jax_op_by_op``; a captured layer would
    hand zero gradients to the parameters the loss does not reach, which
    AdamW would then decay, where the op tape, like the port, gives them
    none and the optimizer skips them). Its parameters are renamed first:
    ``TransformerEncoder`` deep-copies its layer with the parameter names,
    and the JAX optimizer keys its moments by name, so without unique
    names every layer would read the moments of the last one."""
    flags(True)
    jm = _jax_model()
    for n, p in jm.named_parameters():
        p.name = n
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = weights.bert_for_pretraining(state, _config(BertConfig),
                                      device="cpu")
    jopt = paddle.optimizer.AdamW(LR, parameters=jm.parameters())
    topt = AdamW(LR, parameters=tm.parameters())
    ids, mlm, nsp, _ = _batch(1)
    first = None
    for _ in range(3):
        jl, _, jg = _jax_step(jm, ids, mlm, nsp)
        tl, _, _ = _port_step(tm, ids, mlm, nsp)
        assert abs(tl - jl) <= 1e-5 * abs(jl)
        first = first or jg
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
    jparams = dict(jm.named_parameters())
    floor = 1e-3 * max(np.abs(g).max() for g in first.values()
                       if g is not None)
    for n, p in tm.named_parameters():
        got, want = p.detach().numpy(), np.asarray(jparams[n].numpy())
        err = np.abs(got - want)
        g = first[n]
        if g is None:                    # skipped on both sides
            assert np.array_equal(got, state[n]) and np.array_equal(
                want, state[n]), n
            continue
        big = np.abs(g) > 1e-3 * max(np.abs(g).max(), floor)
        assert err[big].max(initial=0.0) <= 1e-6, n
        assert err.max() <= 2 * LR + 1e-6, n


def test_same_seed_runs_are_bit_identical():
    """Dropout 0.1 everywhere: two models with the same weights and
    generator seed give bitwise equal losses and gradients; another seed
    another loss."""
    ids, mlm, nsp, mask = _batch(2)
    cfg = _config(BertConfig, dropout=0.1)
    ref = BertForPretraining(cfg, device="cpu").state_dict()
    runs = []
    for seed in (5, 5, 6):
        # the generator draws the initial weights, then every dropout seed
        tm = BertForPretraining(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(seed))
        tm.load_state_dict(ref)
        runs.append(_port_step(tm, ids, mlm, nsp, mask))
    (l0, p0, g0), (l1, p1, g1), (l2, _, _) = runs
    assert l0 == l1 and np.array_equal(p0, p1)
    assert all(g0[n] is None and g1[n] is None
               or np.array_equal(g0[n], g1[n]) for n in g0)
    assert l2 != l0
