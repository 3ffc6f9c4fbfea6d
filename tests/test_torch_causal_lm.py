"""The port's causal LMs (``models.llama.LlamaForCausalLM``,
``models.gpt.GPTForCausalLM``) and recompute (``framework/recompute.py``)
held against the JAX package on the CPU at tiny widths: Llama with GQA
(2 layers, hidden 32, 4 heads, 2 KV heads, FFN 64, vocab 64), GPT (2
layers, hidden 32, 4 heads, FFN 64, vocab 128); batch 2 x 12.

Weights come from ``paddle.seed`` JAX models through
``weights.llama_for_causal_lm`` / ``gpt_for_causal_lm``; inputs from
seeded numpy; dropout 0 where the two packages are compared (they draw
different random bits). The JAX side runs op by op where it generates
(``tests/torch_twins.py`` ``op_by_op``). Tolerances, as
test_torch_bert.py's (float32, summation order only):

- loss within 1e-5 relative, logits within 1e-5 x max|logits|;
- each gradient within 1e-4 x its max|g|, floored at 1e-3 x the largest
  gradient of the model;
- 5 AdamW(1e-3) steps: every loss within 1e-4 relative (Adam moves an
  entry by about lr whatever its gradient, so where a gradient is at
  rounding-noise level the two packages may step it differently);
- greedy ``generate`` tokens equal (the logits' top two are far apart at
  these seeds: each step's margin is checked to exceed 1e-4 x max|logit|);
- recompute: in the port at dropout 0.1 from one generator seed, loss
  and every gradient bitwise equal to the run without it (the replay
  redraws the forward's dropout masks); at dropout 0, within the bounds
  above of the JAX package's recompute run.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.optimizer import AdamW
from tests.torch_twins import op_by_op
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
LLAMA = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
             seq=32)
GPT = dict(vocab=128, hidden=32, layers=2, heads=4, inter=64, seq=32)
B, T = 2, 12


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _llama_cfg(cls, **over):
    cfg = cls.tiny(**LLAMA)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _gpt_cfg(cls, dropout=0.0, **over):
    cfg = cls.tiny(**GPT)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _pair(kind, seed=0, **over):
    """(JAX model, port model) holding the same weights."""
    paddle.seed(seed)
    if kind == "llama":
        jm = JaxLlama(_llama_cfg(JaxLlamaConfig, **over))
        for n, p in jm.named_parameters():
            p.name = n
        state = {k: _np(v) for k, v in jm.state_dict().items()}
        return jm, weights.llama_for_causal_lm(
            state, _llama_cfg(LlamaConfig, **over), device="cpu")
    jm = JaxGPT(_gpt_cfg(JaxGPTConfig, **over))
    for n, p in jm.named_parameters():
        p.name = n
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    return jm, weights.gpt_for_causal_lm(
        state, _gpt_cfg(GPTConfig, **over), device="cpu")


def _ids(kind, seed=0):
    vocab = (LLAMA if kind == "llama" else GPT)["vocab"]
    return np.random.RandomState(seed).randint(0, vocab, (B, T))


def _jax_step(jm, ids):
    x = paddle.to_tensor(ids)
    loss, logits = jm(x, labels=x)
    loss.backward()
    return float(_np(loss)), _np(logits), {
        n: None if p.grad is None else _np(p.grad)
        for n, p in jm.named_parameters()}


def _port_step(tm, ids):
    x = torch.from_numpy(ids)
    loss, logits = tm(x, labels=x)
    loss.backward()
    return loss.item(), logits.detach().numpy(), {
        n: None if p.grad is None else p.grad.numpy().copy()
        for n, p in tm.named_parameters()}


def _assert_grads(tg, jg):
    assert set(tg) == set(jg)
    assert {n for n, g in tg.items() if g is None} == \
        {n for n, g in jg.items() if g is None}
    floor = 1e-3 * max(np.abs(g).max() for g in jg.values() if g is not None)
    for n, g in tg.items():
        if g is not None:
            scale = max(np.abs(jg[n]).max(), floor)
            assert np.abs(g - jg[n]).max() <= 1e-4 * scale, n


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_forward_backward_matches_jax(kind):
    jm, tm = _pair(kind)
    ids = _ids(kind)
    jl, jlog, jg = _jax_step(jm, ids)
    tl, tlog, tg = _port_step(tm, ids)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert np.abs(tlog - jlog).max() <= 1e-5 * np.abs(jlog).max()
    _assert_grads(tg, jg)
    if kind == "llama":
        # the rotary tables are buffers outside the state dict
        assert not any("cached" in k for k in tm.state_dict())
        assert tm.llama.layers[0].self_attn.rotary.cos_cached.shape == (
            LLAMA["seq"], LLAMA["hidden"] // LLAMA["heads"])


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_adamw_steps_match_jax(kind):
    jm, tm = _pair(kind, seed=1)
    ids = _ids(kind, 1)
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters())
    topt = AdamW(1e-3, parameters=tm.parameters())
    losses = []
    for _ in range(5):
        jl, _, _ = _jax_step(jm, ids)
        tl, _, _ = _port_step(tm, ids)
        assert abs(tl - jl) <= 1e-4 * abs(jl)
        losses.append(tl)
        for opt in (jopt, topt):
            opt.step()
            opt.clear_grad()
    assert losses[-1] < losses[0]


def _margin_ok(logits):
    top2 = np.sort(_np(logits), -1)[..., -2:]
    return bool(((top2[..., 1] - top2[..., 0])
                 > 1e-4 * np.abs(_np(logits)).max()).all())


def test_llama_greedy_generate_matches_jax():
    jm, tm = _pair("llama", seed=2)
    prompt = _ids("llama", 2)[:, :5]
    with op_by_op():
        jout = _np(jm.generate(paddle.to_tensor(prompt), max_new_tokens=4))
    tout = tm.generate(torch.from_numpy(prompt), max_new_tokens=4)
    assert tout.shape == (B, 9)
    np.testing.assert_array_equal(tout.numpy(), jout)
    # the cached decode equals re-forwards of the whole sequence
    with torch.no_grad():
        for t in range(5, 9):
            logits = tm(tout[:, :t])[:, -1]
            assert _margin_ok(logits)
            assert torch.equal(logits.argmax(-1), tout[:, t])


def _gpt_greedy(model, prompt, n, zeros, head, argmax, cat):
    """Greedy decode through GPTModel's caches (either package): the
    prompt in one call, then one token a call."""
    cfg = model.config
    z = zeros((B, 0, cfg.num_attention_heads,
               cfg.hidden_size // cfg.num_attention_heads))
    caches = [(z, z)] * cfg.num_hidden_layers
    out, step_in, offset = prompt, prompt, 0
    for _ in range(n):
        h, caches = model.gpt(step_in, caches, offset)
        offset += step_in.shape[1]
        step_in = argmax(head(h[:, -1], model.gpt.wte.weight))
        out = cat(out, step_in)
    return out


def test_gpt_greedy_decode_matches_jax():
    jm, tm = _pair("gpt", seed=3)
    jm.eval()
    tm.eval()
    prompt = _ids("gpt", 3)[:, :5]
    with op_by_op():
        jout = _np(_gpt_greedy(
            jm, paddle.to_tensor(prompt), 4,
            lambda s: paddle.zeros(list(s), "float32"),
            lambda h, w: paddle.matmul(h, w, transpose_y=True),
            lambda lg: paddle.argmax(lg, axis=-1, keepdim=True),
            lambda a, b: paddle.concat([a, b.astype(a.dtype)], axis=1)))
    with torch.no_grad():
        tout = _gpt_greedy(
            tm, torch.from_numpy(prompt), 4, torch.zeros,
            lambda h, w: h @ w.t(),
            lambda lg: lg.argmax(-1, keepdim=True),
            lambda a, b: torch.cat([a, b.to(a.dtype)], 1))
        for t in range(5, 9):
            logits = tm(tout[:, :t])[:, -1]
            assert _margin_ok(logits)
            assert torch.equal(logits.argmax(-1), tout[:, t])
    np.testing.assert_array_equal(tout.numpy(), jout)


def test_tied_word_embeddings():
    """The reference ties ``lm_head``'s [in, out] weight to the [vocab,
    hidden] table (so vocab == hidden here); the port keeps one
    Parameter for both names and computes the same logits."""
    jm, tm = _pair("llama", seed=4, tie_word_embeddings=True,
                   vocab_size=LLAMA["hidden"])
    assert tm.lm_head.weight is tm.llama.embed_tokens.weight
    assert sum(p is tm.lm_head.weight for p in tm.parameters()) == 1
    ids = _ids("llama", 4) % LLAMA["hidden"]
    jl, jlog, jg = _jax_step(jm, ids)
    tl, tlog, tg = _port_step(tm, ids)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert np.abs(tlog - jlog).max() <= 1e-5 * np.abs(jlog).max()
    np.testing.assert_allclose(
        tm.llama.embed_tokens.weight.grad.numpy(),
        jg["llama.embed_tokens.weight"], rtol=0,
        atol=1e-4 * np.abs(jg["llama.embed_tokens.weight"]).max())


def test_bf16_weights_carry_over_exactly():
    """The O2 case: a decorated (bf16) JAX model's arrays load into the
    port model and ``amp.decorate`` gives the same bf16 values."""
    from paddle_tpu_torch import amp
    paddle.seed(8)
    jm = JaxLlama(_llama_cfg(JaxLlamaConfig))
    paddle.amp.decorate(models=jm, level="O2", dtype="bfloat16")
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    tm = weights.llama_for_causal_lm(state, _llama_cfg(LlamaConfig),
                                     device="cpu")
    amp.decorate(tm, level="O2", dtype="bfloat16")
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, n
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(_np(jp[n]), np.float32))


def test_sampled_generate_draws_from_the_generator():
    _, tm = _pair("llama", seed=5)
    prompt = torch.from_numpy(_ids("llama", 5)[:, :4])
    outs = [tm.generate(prompt, 5, temperature=0.8,
                        generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert outs[0].shape == (B, 9) and int(outs[0].max()) < LLAMA["vocab"]
    assert torch.equal(outs[0][:, :4], prompt)


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_recompute_in_the_port_is_exact(kind):
    """Dropout 0.1 (GPT) from one generator seed: recompute on and off
    give bitwise equal losses and gradients."""
    ids = torch.from_numpy(_ids(kind, 6))
    runs = []
    for rc in (False, True):
        if kind == "gpt":
            cfg = _gpt_cfg(GPTConfig, dropout=0.1, recompute=rc)
            tm = GPTForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(3))
        else:
            cfg = _llama_cfg(LlamaConfig, recompute=rc)
            tm = LlamaForCausalLM(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
        loss, _ = tm(ids, labels=ids)
        loss.backward()
        runs.append((loss.item(), {n: p.grad.clone() for n, p in
                                   tm.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert l0 == l1
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_recompute_matches_jax(kind):
    """The twin of tests/test_models.py::test_gpt_recompute_matches:
    dropout 0, recompute on in both packages."""
    jm, tm = _pair(kind, seed=7, recompute=True)
    ids = _ids(kind, 7)
    jl, _, jg = _jax_step(jm, ids)
    tl, _, tg = _port_step(tm, ids)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _assert_grads(tg, jg)
