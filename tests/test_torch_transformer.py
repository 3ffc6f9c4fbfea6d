"""The port's ``nn`` transformer layers (pre- and post-norm encoder,
decoder, ``Transformer``, the ``Cache``/``StaticCache`` decode path),
``Embedding(padding_idx=)`` and the channel dropouts, on the CPU.

Weights come from ``paddle.seed(0)`` JAX layers through
``weights.transformer``; inputs from seeded numpy; dropout 0 in the
parity tests. The JAX side of the cached paths runs op by op
(``tests/torch_twins.py`` ``op_by_op``): with its layer captures and
per-op executables on, a
``TransformerEncoderLayer`` called with a cache returns only its output
and the decoder's incremental decode through ``gen_cache`` departs from
its full causal forward by O(1) (ROADMAP Queue C); op by op both agree
with the port. Tolerances:

- outputs within 1e-5 x max|ref| and every gradient within 1e-4 x its
  max|g|, floored at 1e-3 x the largest gradient of the model (float32;
  the two packages differ only in summation order; the key
  projections' biases have an exact gradient of 0, so both sides hold
  rounding noise there);
- the incremental decode (one target token a call through
  ``gen_cache``) equals the full causal forward's rows within 1e-5 x
  max|ref|, in the port and against the JAX package's own incremental
  decode;
- the channel dropouts: the two packages draw different random bits,
  so these hold the structure: whole channels dropped, kept entries
  scaled by exactly 1/(1 - p), and the kept share of 20000 channels
  within 4 standard deviations of 1 - p; alpha dropout's dropped
  entries all equal ``coef_a * alpha_p + coef_b``, kept ones
  ``coef_a * x + coef_b``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import nn, weights
from paddle_tpu_torch.nn import functional as F
from tests.torch_twins import op_by_op
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
D, HEADS, FFN, B, LS, LT = 32, 4, 64, 2, 7, 5


@pytest.fixture
def jax_op_by_op():
    with op_by_op():
        yield


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _state(jlayer):
    return {k: _np(v) for k, v in jlayer.state_dict().items()}


def _close(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{err:.3e} > {rel} x {scale:.3e}"


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, LS, D).astype(np.float32),
            rng.randn(B, LT, D).astype(np.float32))


def _jax_stack(nb):
    paddle.seed(0)
    return paddle.nn.Transformer(D, HEADS, 2, 2, FFN, 0.0,
                                 normalize_before=nb)


def _port_stack(nb):
    return nn.Transformer(D, HEADS, 2, 2, FFN, 0.0, normalize_before=nb,
                          device="cpu")


@pytest.mark.parametrize("nb", [False, True], ids=["post", "pre"])
def test_encoder_decoder_transformer_match_jax(nb):
    """``Transformer`` (2 + 2 layers, a causal target mask): the encoder
    stack's output (with its final LayerNorm when pre-norm), the decoder
    stack's, the input gradients and every parameter's gradient."""
    jm = _jax_stack(nb)
    tm = weights.transformer(_state(jm), _port_stack(nb))
    src, tgt = _inputs()
    mask = np.triu(np.full((LT, LT), -1e4, np.float32), 1)
    # a random projection of the output (LayerNorm makes sum(out^2) flat)
    proj = np.random.RandomState(9).randn(B, LT, D).astype(np.float32)
    jsrc, jtgt = paddle.to_tensor(src), paddle.to_tensor(tgt)
    jsrc.stop_gradient = jtgt.stop_gradient = False
    jmem = jm.encoder(jsrc)
    jout = jm.decoder(jtgt, jmem, paddle.to_tensor(mask))
    (jout * paddle.to_tensor(proj)).sum().backward()
    tsrc = torch.from_numpy(src).requires_grad_()
    ttgt = torch.from_numpy(tgt).requires_grad_()
    tmem = tm.encoder(tsrc)
    tout = tm(tsrc, ttgt, None, torch.from_numpy(mask))
    (tout * torch.from_numpy(proj)).sum().backward()
    _close(tmem.detach(), jmem)
    _close(tout.detach(), jout)
    _close(tsrc.grad, jsrc.grad, 1e-4)
    _close(ttgt.grad, jtgt.grad, 1e-4)
    jp = dict(jm.named_parameters())
    floor = 1e-3 * max(float(np.abs(_np(p.grad)).max())
                       for p in jp.values() if p.grad is not None)
    for name, p in tm.named_parameters():
        jg = jp[name].grad
        if jg is None:
            assert p.grad is None or not p.grad.any(), name
            continue
        err = float(np.abs(p.grad.numpy() - _np(jg)).max())
        assert err <= 1e-4 * max(float(np.abs(_np(jg)).max()), floor), name


def _decode_incrementally(model, src, tgt, gen):
    """The decoder fed one target position a call through ``gen_cache``;
    the rows stacked."""
    memory = model.encoder(src)
    cache = gen(model.decoder, memory)
    rows = []
    for t in range(tgt.shape[1]):
        out, cache = model.decoder(tgt[:, t:t + 1], memory, None, None,
                                   cache)
        rows.append(out)
    return rows


@pytest.mark.parametrize("nb", [False, True], ids=["post", "pre"])
def test_incremental_decode_matches_the_causal_forward(nb, jax_op_by_op):
    jm = _jax_stack(nb)
    tm = weights.transformer(_state(jm), _port_stack(nb))
    tm.eval()
    jm.eval()
    src, tgt = _inputs(1)
    tsrc, ttgt = torch.from_numpy(src), torch.from_numpy(tgt)
    with torch.no_grad():
        full = tm(tsrc, ttgt, None, tm.generate_square_subsequent_mask(LT))
        rows = _decode_incrementally(tm, tsrc, ttgt,
                                     lambda d, m: d.gen_cache(m))
    _close(torch.cat(rows, 1), full)
    cache = tm.decoder.gen_cache(tm.encoder(tsrc))
    assert isinstance(cache[0][0], nn.MultiHeadAttention.Cache)
    assert isinstance(cache[0][1], nn.MultiHeadAttention.StaticCache)
    assert tuple(cache[0][0].k.shape) == (B, 0, HEADS, D // HEADS)
    zipped = tm.decoder.gen_cache(tm.encoder(tsrc), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    jsrc, jtgt = paddle.to_tensor(src), paddle.to_tensor(tgt)
    jrows = _decode_incrementally(jm, jsrc, jtgt,
                                  lambda d, m: d.gen_cache(m))
    for got, want in zip(rows, jrows):
        _close(got, want)


def test_encoder_cache_and_attention_options(jax_op_by_op):
    """``TransformerEncoderLayer`` with an incremental cache, and
    ``MultiHeadAttention`` with ``kdim``/``vdim`` and ``need_weights``
    against the JAX package."""
    paddle.seed(0)
    jenc = paddle.nn.TransformerEncoderLayer(D, HEADS, FFN, 0.0,
                                             normalize_before=True)
    tenc = weights.transformer(_state(jenc), nn.TransformerEncoderLayer(
        D, HEADS, FFN, 0.0, normalize_before=True, device="cpu"))
    src, _ = _inputs(2)
    x = src[:, :3]
    jout, jcache = jenc(paddle.to_tensor(x), None,
                        jenc.gen_cache(paddle.to_tensor(x)))
    tout, tcache = tenc(torch.from_numpy(x), None,
                        tenc.gen_cache(torch.from_numpy(x)))
    _close(tout.detach(), jout)
    _close(tcache.k.detach(), jcache.k)
    paddle.seed(1)
    jattn = paddle.nn.MultiHeadAttention(D, HEADS, 0.0, kdim=16, vdim=24,
                                         need_weights=True)
    tattn = weights.transformer(_state(jattn), nn.MultiHeadAttention(
        D, HEADS, 0.0, 16, 24, True, device="cpu"))
    rng = np.random.RandomState(3)
    q = rng.randn(B, 4, D).astype(np.float32)
    k = rng.randn(B, 6, 16).astype(np.float32)
    v = rng.randn(B, 6, 24).astype(np.float32)
    jo, jw = jattn(*(paddle.to_tensor(a) for a in (q, k, v)))
    to, tw = tattn(*(torch.from_numpy(a) for a in (q, k, v)))
    assert jw is None and tw is None
    _close(to.detach(), jo)
    # bool masks become additive 0 / -1e4, as in the reference
    keep = np.ones((4, 6), bool)
    keep[:, 4:] = False
    jo = jattn(*(paddle.to_tensor(a) for a in (q, k, v)),
               attn_mask=paddle.to_tensor(keep))[0]
    to = tattn(*(torch.from_numpy(a) for a in (q, k, v)),
               attn_mask=torch.from_numpy(keep))[0]
    _close(to.detach(), jo)


def test_square_subsequent_mask():
    jm = _jax_stack(False)
    tm = _port_stack(False)
    np.testing.assert_array_equal(
        tm.generate_square_subsequent_mask(4).numpy(),
        _np(jm.generate_square_subsequent_mask(4)))


def test_layers_take_no_parameter_attrs():
    with pytest.raises(NotImplementedError):
        nn.TransformerDecoderLayer(D, HEADS, FFN, weight_attr=object(),
                                   device="cpu")
    with pytest.raises(NotImplementedError):
        nn.MultiHeadAttention(D, HEADS, bias_attr=object(), device="cpu")


@pytest.mark.parametrize("padding_idx", [2, -3])
def test_embedding_padding_idx(padding_idx):
    ids = np.array([[0, 2, 7, 2], [7, 1, 2, 9]])
    emb = nn.Embedding(10, 4, padding_idx, device="cpu")
    row = padding_idx % 10
    assert not emb.weight[row].any()        # the row starts at zero
    with torch.no_grad():
        emb.weight.normal_()                # and stays zero in the output
    out = emb(torch.from_numpy(ids))
    (out * torch.arange(1.0, 5.0)).sum().backward()
    hit = torch.from_numpy(ids == row)
    assert not out[hit].any() and out[~hit].abs().min() > 0
    assert not emb.weight.grad[row].any()
    assert emb.weight.grad.abs().sum() > 0
    jout = paddle.nn.functional.embedding(
        paddle.to_tensor(ids), paddle.to_tensor(emb.weight.detach().numpy()),
        padding_idx)
    np.testing.assert_array_equal(out.detach().numpy(), _np(jout))
    with pytest.raises(ValueError):
        F.embedding(torch.from_numpy(ids), emb.weight, 10)
    with pytest.raises(ValueError):
        nn.Embedding(10, 4, -11, device="cpu")


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_channel_dropout_drops_whole_channels(kind):
    p, n, c = 0.3, 1000, 20
    shape = (n, c, 3, 2) if kind == "2d" else (n, c, 2, 2, 2)
    x = torch.rand(shape) + 0.5
    g = torch.Generator().manual_seed(0)
    layer = (nn.Dropout2D(p, generator=g) if kind == "2d"
             else nn.Dropout3D(p, generator=g))
    y = layer(x)
    flat_x, flat_y = x.reshape(n, c, -1), y.reshape(n, c, -1)
    kept = (flat_y != 0).all(-1)
    dropped = (flat_y == 0).all(-1)
    assert bool((kept | dropped).all())          # whole channels
    torch.testing.assert_close(flat_y[kept], flat_x[kept] / (1 - p),
                               rtol=0, atol=0)
    share, sd = float(kept.float().mean()), np.sqrt(p * (1 - p) / (n * c))
    assert abs(share - (1 - p)) <= 4 * sd
    layer.eval()
    assert layer(x) is x
    last = F.dropout2d(x[..., 0] if kind == "3d" else x, p,
                       data_format="NHWC" if kind == "2d" else "NCHW",
                       generator=g)
    if kind == "2d":       # NHWC: the mask runs over the last axis
        m = (last != 0)
        assert bool((m == m[:, :1, :1, :]).all())
    # the same generator state draws the same mask
    y2 = (nn.Dropout2D(p, generator=torch.Generator().manual_seed(0))
          if kind == "2d" else
          nn.Dropout3D(p, generator=torch.Generator().manual_seed(0)))(x)
    assert torch.equal(y, y2)


def test_alpha_dropout():
    p = 0.2
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    alpha_p = -alpha * scale
    coef_a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    coef_b = -coef_a * p * alpha_p
    x = torch.randn(200, 500, generator=torch.Generator().manual_seed(1))
    y = nn.AlphaDropout(p, generator=torch.Generator().manual_seed(2))(x)
    dropped = torch.isclose(y, torch.tensor(coef_a * alpha_p + coef_b),
                            rtol=0, atol=1e-6)
    torch.testing.assert_close(y[~dropped], (coef_a * x + coef_b)[~dropped])
    n = x.numel()
    assert abs(float(dropped.float().mean()) - p) <= 4 * np.sqrt(
        p * (1 - p) / n)
    # SELU's fixed point: zero mean, unit variance stay so
    assert abs(float(y.mean())) < 0.02 and abs(float(y.std()) - 1) < 0.02
    assert F.alpha_dropout(x, p, training=False) is x
