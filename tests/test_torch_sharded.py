"""Head-sharded paged serving on the port: the reference suite
tests/test_sharded.py (its 17 tests, at its sizes and seeds) run on
``paddle_tpu_torch`` through ``tests/torch_ref_suite.py``, twins of the
in-process guards of tests/test_sharded_compiled.py (:353-386), and the
port's own checks of the pieces the reference suite does not reach: the
compiled step refused on distinct CUDA devices, the shard device list,
``rebind_shard_pools``, the registry, drafts and re-sharding,
bit-equal hidden states across widths on the CPU, and delta snapshots
restored at other widths."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn import FusedMultiTransformerInt8
from paddle_tpu_torch.inference import (MoeServingCore, PagedKVCache,
                                        ShardedServingCore,
                                        SpeculativeEngine)
from paddle_tpu_torch.parallel import serving_shard_devices
from tests.torch_ref_suite import load_on_port, suite

globals().update(suite("tests/test_sharded.py", __name__))
_REF = load_on_port("tests/test_sharded.py", __name__ + "._helpers")
_tsm, _run, PROMPTS = _REF["_tsm"], _REF["_run"], _REF["PROMPTS"]
D, H, LAYERS, BS = _REF["D"], _REF["H"], _REF["LAYERS"], _REF["BS"]


# -- twins of tests/test_sharded_compiled.py's in-process guards ---------

def test_single_device_auto_disables_compiled():
    """One device (the CPU): the shards are logical, ``auto`` keeps the
    host-staged path and the metrics say so."""
    t = _tsm().shard(2)
    assert t.core.shard_devices == [torch.device("cpu")] * 2
    assert not t.core.compiled_step
    m = t.core.sharded_metrics()
    assert not m["compiled"]
    assert m["allreduce_count"] == 0 and m["jit_calls"] == 0
    assert not t.core.prefers_packed_step


def test_forced_compiled_without_distinct_devices_raises():
    with pytest.raises(ValueError, match="distinct"):
        ShardedServingCore(_tsm().core, 2, compiled_step=True)


def test_bad_option_values_raise():
    with pytest.raises(ValueError, match="out_shard"):
        ShardedServingCore(_tsm().core, 2, out_shard="cols")
    with pytest.raises(ValueError, match="compiled_step"):
        ShardedServingCore(_tsm().core, 2, compiled_step="yes")
    with pytest.raises(ValueError, match="qkv_shard"):
        ShardedServingCore(_tsm().core, 2, qkv_shard="rows")


def test_nondivisible_heads_still_refused():
    with pytest.raises(ValueError, match="divide"):
        ShardedServingCore(_tsm().core, 3)


# -- the port's own ------------------------------------------------------

@pytest.mark.parametrize("compiled_step", [True, "auto"])
def test_compiled_step_on_distinct_cuda_devices_is_not_ported(
        compiled_step):
    """Two distinct CUDA devices: the compiled step the reference engages
    there is ROADMAP item 10b, so the constructor raises instead of
    changing path, before it places anything (this runs without a
    card)."""
    devs = [torch.device("cuda:0"), torch.device("cuda:1")]
    with pytest.raises(NotImplementedError, match="10b"):
        ShardedServingCore(_tsm().core, 2, devices=devs,
                           compiled_step=compiled_step)


def test_serving_shard_devices():
    cpu = torch.device("cpu")
    assert serving_shard_devices(1, "cpu") == [cpu]
    assert serving_shard_devices(4, cpu) == [cpu] * 4
    with pytest.raises(ValueError, match="mp"):
        serving_shard_devices(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            serving_shard_devices(2)


def test_int8_and_moe_cores_refused():
    q = FusedMultiTransformerInt8.from_float(_tsm().core)
    with pytest.raises(ValueError, match="int8 cores"):
        ShardedServingCore(q, 2)
    moe = MoeServingCore(D, H, 64, num_experts=2, top_k=1, num_layers=1,
                         device="cpu")
    with pytest.raises(ValueError, match="shard_experts"):
        ShardedServingCore(moe, 2)


def test_rebind_shard_pools_writes_in_place():
    """A full-head pool lands head-sliced in the shard entries, which
    keep their identity; the canonical snapshot gives it back."""
    for dtype in ("float32", "int8"):
        c = PagedKVCache(LAYERS, H, 8, BS, 6, 2, dtype=dtype, mp=2,
                         device="cpu")
        ids = [id(p) for p in c.pools]
        g = torch.randn(6, 2, H, BS, 8)
        gs = torch.rand(6, 2, H, BS) if c.quantized else None
        if c.quantized:
            g = g.mul(40).round().clamp(-127, 127).to(torch.int8)
        c.rebind_shard_pools(1, g, gs)
        assert [id(p) for p in c.pools] == ids
        assert torch.equal(c.pools[c.pool_index(1, 1)], g[:, :, 2:])
        assert torch.equal(c.pools[c.pool_index(1, 0)], g[:, :, :2])
        if c.quantized:
            assert torch.equal(c.scales[c.pool_index(1, 1)], gs[:, :, 2:])
        c.ensure(0, 5)
        blocks = c.seq_blocks[0]
        snap = c.snapshot()
        np.testing.assert_array_equal(snap["payload"][:, 1],
                                      g[blocks].numpy())
        with pytest.raises(ValueError, match="global pool"):
            c.rebind_shard_pools(0, g[:, :, :2])


def test_layout_bytes_and_views():
    c = PagedKVCache(LAYERS, H, 8, BS, 10, 2, mp=4, device="cpu")
    assert len(c.pools) == LAYERS * 4 and c.heads_per_shard == 1
    assert c.pool_index(1, 3) == 7
    assert tuple(c.pools[7].shape) == (10, 2, 1, BS, 8)
    assert c.pool_bytes() * 4 == c.pool_bytes_total()
    v = c.views[1].shard(3)
    assert v.pool is c.pools[7] and v.shape == c.pools[7].shape
    c.ensure(0, 3)
    p = c.prefill_views(0)[1].shard(2)
    assert p.pool is c.pools[6]
    r = c.ragged_views([("prefill", 0, 0, 3, 0)])[1]
    assert r.shard(1)._layout is r._layout
    with pytest.raises(ValueError, match="write_prefill_chunk"):
        c.write_prefill_chunk(0, 0, torch.zeros(1, 3, H, 8),
                              torch.zeros(1, 3, H, 8), 0)


def test_registry_drafts_and_resharding():
    """``sharded.*`` in the engine's registry holds the all-reduce
    count; a truncated draft of a sharded twin is unsharded; sharding a
    sharded twin re-wraps its base; embedding and readout are shared."""
    t = _tsm()
    t2 = t.shard(2)
    assert t2.lm_head is t.lm_head and t2._embed_np is t._embed_np
    t4 = t2.shard(4)
    assert t4.core.base is t.core and t4.core.mp == 4
    draft = t2.truncated_draft(1)
    assert not isinstance(draft.core, ShardedServingCore)
    assert draft.core.layers[0] is t.core.layers[0]
    eng, _ = _run(t2, steps=2)
    reg = eng.engine.registry.as_dict()
    assert reg["sharded.mp"] == 2 and reg["sharded.compiled"] == 0
    assert reg["sharded.allreduce_count"] == t2.core.allreduce_count > 0
    assert reg["pool.mp"] == 2
    # a separate draft: the draft pool stays unsharded beside the
    # target's sharded one
    e = SpeculativeEngine(t2, draft, k=2, max_batch=3, block_size=BS,
                          num_blocks=40)
    assert e.engine.cache.mp == 2 and e.draft_cache.mp == 1


@pytest.mark.parametrize("mp,mode", [(2, "activations"), (4, "activations"),
                                     (2, "weights")])
def test_hidden_states_equal_across_widths(mp, mode):
    """One chunked prefill and one decode call through the same pool
    state at mp 1 and mp: "activations" runs the single-card GEMMs and
    the padded sum is exact, so the hidden states are bitwise the
    unsharded core's; "weights" runs column-sliced GEMMs, held to 1e-6
    of max|h|."""
    t = _tsm()
    core = t.shard(mp, qkv_shard=mode).core
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 6, D).astype(np.float32))
    xd = torch.from_numpy(rng.randn(2, 1, D).astype(np.float32))
    outs = []
    for m in (t.core, core):
        c = PagedKVCache.for_model(m, BS, 12, 2)
        c.ensure(0, 6, write_from=0)
        c.ensure(1, 6, write_from=0)
        with torch.no_grad():
            h0, _ = m(x, caches=c.prefill_views(0), time_step=[0])
            m(x, caches=c.prefill_views(1), time_step=[0])
            c.ensure(0, 7)
            c.ensure(1, 7)
            h1, _ = m(xd, caches=c.views, time_step=np.array([6, 6]))
        outs.append((h0, h1))
    for a, b in zip(*outs):
        if mode == "activations":
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())
    assert core.allreduce_count == 3 * LAYERS


@pytest.mark.parametrize("dst_mp", [1, 2, 4])
def test_delta_snapshot_restores_at_any_width(dst_mp):
    """A delta snapshot of an mp=2 pool against an earlier one restores
    with its base at another width: every canonical page, the allocator
    and the index equal the full snapshot's."""
    eng, _ = _run(_tsm().shard(2), steps=3, prefix_cache=True)
    cache = eng.engine.cache
    base = cache.snapshot()
    for _ in range(3):
        eng.step()
    delta, full = cache.snapshot(base=base), cache.snapshot()
    assert delta["base_blocks"] and len(delta["blocks"]) < len(full["blocks"])
    got = PagedKVCache.restore(delta, base=base, mp=dst_mp,
                               device="cpu").snapshot()
    assert got["geometry"] == dict(full["geometry"], mp=dst_mp)
    for key in ("refcount", "free_order", "cached_order", "hash_index",
                "seq_blocks", "blocks"):
        assert got[key] == full[key], key
    np.testing.assert_array_equal(got["payload"], full["payload"])
