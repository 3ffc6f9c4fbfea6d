"""The PyTorch port's ``nn`` pieces of the encoder training path
(paddle_tpu_torch/nn, flags, framework/random) held against the JAX
package on the CPU, from the same seeded numpy inputs:

- ``scaled_dot_product_attention`` with JAX's signature, against
  ``paddle_tpu``'s ``sdpa_reference`` (masked, causal, dropout 0; float32
  within 1e-5), and its dense dropout's keep rate;
- ``dropout``'s routing (fused kernel's plain version, Bernoulli forms,
  inference modes) and its seeds from an explicit generator;
- ``cross_entropy`` with ``ignore_index`` against JAX's (1e-6);
- the fused post-norm encoder layer against the unfused one (dropout 0,
  the bound of the JAX package's own twin test) and the flags.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.functional import cross_entropy as jax_cross_entropy
from paddle_tpu.nn.functional import sdpa_reference
import paddle_tpu_torch
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.hopper import fused_norm as tfn
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)


def _qkv(seed, B=2, L=16, H=4, D=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, L, H, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("case", ["masked", "causal", "plain"])
def test_sdpa_matches_jax_reference(case):
    q, k, v = _qkv(3)
    mask = None
    if case == "masked":
        keep = np.random.RandomState(4).rand(2, 1, 1, 16) > 0.3
        mask = np.where(keep, 0.0, -1e4).astype(np.float32)
    causal = case == "causal"
    want = sdpa_reference(*(paddle.to_tensor(a) for a in (q, k, v)),
                          None if mask is None else paddle.to_tensor(mask),
                          0.0, causal)
    # positional arguments land where JAX's signature puts them
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), 0.0, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=1e-5, rtol=1e-5)
    # dropout is off outside training, whatever dropout_p says
    off = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), 0.5, causal,
        training=False)
    assert torch.equal(off, got)


def test_sdpa_dense_dropout_keep_rate():
    """q = k = 0 gives uniform probabilities, v the identity rows: the
    output is the dropped probability matrix, 1 / L / (1 - p) where kept."""
    B, L, H, p = 2, 64, 2, 0.25
    q = torch.zeros(B, L, H, L)
    v = torch.eye(L)[None, :, None, :].expand(B, L, H, L).contiguous()
    g = torch.Generator().manual_seed(5)
    out = F.scaled_dot_product_attention(q, q, v, dropout_p=p, generator=g)
    kept = (out != 0).float().mean().item()
    assert abs(kept - (1 - p)) < 0.02
    vals = out[out != 0]
    torch.testing.assert_close(vals, torch.full_like(vals, 1 / L / (1 - p)))
    # the same generator state draws the same mask
    again = F.scaled_dot_product_attention(
        q, q, v, dropout_p=p, generator=torch.Generator().manual_seed(5))
    assert torch.equal(out, again)


def test_dropout_routing_and_seeds():
    x = torch.from_numpy(np.random.RandomState(6).randn(8, 32)
                         .astype(np.float32))
    # upscale_in_train, axis None, 0 < p < 1, flag on: the fused kernel's
    # plain version with a seed drawn from the generator
    seed = int(torch.randint(0, 2 ** 31 - 1, (),
                             generator=torch.Generator().manual_seed(1)))
    got = F.dropout(x, 0.3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, tfn.dropout_reference(x, 0.3, seed))
    before = tfn.launch_count("dropout")
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_dropout": False})
    try:
        plain = F.dropout(x, 0.3, generator=torch.Generator().manual_seed(1))
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_dropout": True})
    assert tfn.launch_count("dropout") == before
    kept = plain != 0
    torch.testing.assert_close(plain[kept], x[kept] / 0.7)
    # axis: one mask entry per row, broadcast over the columns
    rows = F.dropout(x, 0.5, axis=0,
                     generator=torch.Generator().manual_seed(2))
    assert all(bool((r == 0).all()) or bool((r != 0).all()) for r in rows)
    # inference modes
    assert F.dropout(x, 0.3, training=False) is x
    torch.testing.assert_close(
        F.dropout(x, 0.3, training=False, mode="downscale_in_infer"),
        x * 0.7)
    down = F.dropout(x, 0.3, mode="downscale_in_infer",
                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(down[down != 0], x[down != 0])


def test_flags_are_set_atomically():
    with pytest.raises(ValueError):
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": True,
                                    "FLAGS_no_such_flag": 1})
    assert paddle_tpu_torch.get_flag("FLAGS_tpu_fused_encoder") is False
    assert paddle_tpu_torch.get_flag("FLAGS_tpu_fused_dropout") is True


def test_cross_entropy_matches_jax():
    rng = np.random.RandomState(8)
    logits = rng.randn(12, 10).astype(np.float32)
    labels = rng.randint(0, 10, 12).astype(np.int64)
    labels[[1, 4, 5]] = -100
    for red in ("mean", "sum", "none"):
        want = jax_cross_entropy(paddle.to_tensor(logits),
                                 paddle.to_tensor(labels),
                                 ignore_index=-100, reduction=red)
        got = F.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), reduction=red)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   atol=1e-6, rtol=1e-6)
    # every label ignored: 0, not a division by zero
    none = F.cross_entropy(torch.from_numpy(logits),
                           torch.full((12,), -100))
    assert float(none) == 0.0


def test_fused_encoder_layer_matches_unfused():
    """The port's twin of the JAX package's fused-encoder test: dropout
    0.1 in eval (no dropout), then gradients through the fused path in
    training."""
    layer = nn.TransformerEncoderLayer(
        64, 4, 128, dropout=0.1, device="cpu",
        generator=torch.Generator().manual_seed(0))
    layer.eval()
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 16, 64)
                         .astype(np.float32))
    ref = layer(x)
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": True})
    try:
        fused = layer(x)
        np.testing.assert_allclose(fused.detach().numpy(),
                                   ref.detach().numpy(), rtol=2e-5,
                                   atol=2e-6)
        layer.train()
        layer(x).sum().backward()
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": False})
    for name, p in layer.named_parameters():
        assert p.grad is not None, name
    # a bool mask (True keeps) is the additive mask 0 / -1e4
    keep = torch.ones(2, 1, 1, 16, dtype=torch.bool)
    keep[1, ..., 10:] = False
    layer.eval()
    torch.testing.assert_close(layer(x, keep),
                               layer(x, (keep.float() - 1.0) * 1e4))


def test_adamw_multi_precision_tracks_an_fp32_run():
    """bf16 parameters with ``multi_precision``: the fp32 masters follow
    the float32 run exactly (same grads), the parameters are the masters
    rounded to bf16; decay reads the master."""
    from paddle_tpu_torch.optimizer import AdamW
    rng = np.random.RandomState(10)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(2)]
    p32 = torch.nn.Parameter(torch.from_numpy(w0).bfloat16().float())
    p16 = torch.nn.Parameter(p32.detach().bfloat16())
    o32 = AdamW(1e-2, parameters=[p32])
    o16 = AdamW(1e-2, parameters=[p16], multi_precision=True)
    for g in grads:
        p32.grad = torch.from_numpy(g).bfloat16().float()
        p16.grad = torch.from_numpy(g).bfloat16()
        o32.step()
        o16.step()
    assert torch.equal(o16._master_weights[p16], p32.detach())
    assert torch.equal(p16.detach(), p32.detach().bfloat16())
