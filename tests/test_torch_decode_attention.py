"""The PyTorch port's dense decode attention
(paddle_tpu_torch/ops/hopper/decode_attention.py) held against the JAX
package's Pallas kernel in interpret mode on the CPU, from the same
seeded numpy inputs; float32, atol = rtol = 1e-5. The port reads the
cache through strides, so the inputs are the [B, S, H, D] transposed
views of a [2, B, H, S, D] layer cache, as the serving model passes
them."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.hopper import decode_attention as tda

# the pallas package re-exports the function under the module's name
jda = importlib.import_module("paddle_tpu.ops.pallas.decode_attention")

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, B, nh, nkv, hd, S):
    rng = np.random.RandomState(seed)
    cache = rng.randn(2, B, nkv, S, hd).astype(np.float32)
    q = rng.randn(B, nh, hd).astype(np.float32)
    return q, cache


@pytest.mark.parametrize("nh,nkv,S,lens,hd,block_s", [
    (4, 4, 32, [0, 1, 17, 32], 16, 16),     # length 0 -> zeros, full row
    (8, 2, 48, [5, 48, 0], 16, 16),         # GQA, S not a block multiple
    (4, 4, 200, [199, 3], 16, 16),          # JAX pads the cache axis to 256
    # the serving model's widths: 16 heads of 64, spans of 128 positions
    (16, 16, 1000, [1000, 0, 129, 128, 1], 64, 128),
    (32, 8, 1000, [640, 1000], 128, 128),   # GQA 32/8 at head_dim 128
])
def test_plain_version_matches_pallas_kernel(nh, nkv, S, lens, hd,
                                             block_s):
    B = len(lens)
    q, cache = _case(len(lens) + S, B, nh, nkv, hd, S)
    lens = np.asarray(lens, np.int32)
    ref = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.swapaxes(jnp.asarray(cache[0]), 1, 2),
        jnp.swapaxes(jnp.asarray(cache[1]), 1, 2), jnp.asarray(lens),
        block_s=block_s))
    tc = torch.from_numpy(cache)
    got = tda.decode_attention(torch.from_numpy(q), tc[0].transpose(1, 2),
                               tc[1].transpose(1, 2), lens).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[lens == 0].any()


class _RecordingLib:
    """Stands in for the built library: records each entry-point call."""

    def __init__(self, max_rows):
        self.calls = []
        self.pt_decode_attention_max_rows = lambda hd: max_rows

    def pt_decode_attention(self, *args):
        self.calls.append(args)
        return 0


# float32 elements of the workspace at each shape (B, S, nh, nkv, hd)
_WORKSPACE_NUMEL = {
    # chip_smoke's oracle shape: 16 kv heads x 4 rows x 8 spans x 1 head
    # of the group x (64 + 2) floats, 135 KB
    (4, 1024, 16, 16, 64): 33792,
    (1, 8192, 16, 16, 64): 67584,    # one long row: 64 spans
    # S not a multiple of the span (3 spans), GQA 4: 8 x 3 x 3 x 4 x 130
    (3, 300, 32, 8, 128): 37440,
}


@pytest.mark.parametrize("B,S,nh,nkv,hd", list(_WORKSPACE_NUMEL))
def test_launch_sizes_the_workspace_from_the_cache_length(B, S, nh, nkv,
                                                          hd, monkeypatch):
    """The wrapper's host side of a launch: the workspace it hands the
    library is float32 of (acc, m, l) for every (kv head, row, span of
    the cache length, head of the group), sized from S alone (the lengths
    stay on the device), and the caches go in by their strides, K and V
    each their own."""
    q = torch.zeros((B, 3 * nh, hd))[:, :nh]        # row stride 3 nh hd
    k = torch.zeros((B, S, nkv, hd))
    v = torch.zeros((B, nkv, S, hd)).transpose(1, 2)
    lens = torch.zeros(B, dtype=torch.int32)
    made = []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    lib = _RecordingLib(max_rows=nh // nkv)
    out = tda._launch(lib, q, k, v, lens, 0.125, 0)
    monkeypatch.undo()
    assert out.shape == (B, nh, hd) and len(lib.calls) == 1
    c = lib.calls[0]
    ws = [t for t in made if t.data_ptr() == c[13]]
    assert len(ws) == 1 and ws[0].dtype == torch.float32
    numel = _WORKSPACE_NUMEL[B, S, nh, nkv, hd]
    assert ws[0].numel() == numel == tda.workspace_numel(B, S, nh, nkv, hd)
    assert c[2:4] == q.stride()[:2]
    assert c[4] == k.data_ptr() and c[5:8] == k.stride()[:3]
    assert c[8] == v.data_ptr() and c[9:12] == v.stride()[:3]
    assert c[12] == lens.data_ptr() and c[14] == out.data_ptr()
    assert c[15:20] == (B, nh, nkv, hd, S) and c[20] == 0.125
    # a GQA group wider than one block holds is refused before a launch
    with pytest.raises(ValueError):
        tda._launch(_RecordingLib(max_rows=nh // nkv - 1), q, k, v, lens,
                    0.125, 0)


def test_matches_jax_reference():
    q, cache = _case(0, 3, 4, 2, 16, 24)
    lens = np.asarray([24, 7, 1], np.int32)
    k, v = (np.swapaxes(c, 1, 2) for c in cache)
    ref = np.asarray(jda.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    got = tda.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lens).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
