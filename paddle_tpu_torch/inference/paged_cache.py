"""Paged KV cache: block pool + free-list allocator + cache-protocol views
(counterpart of paddle_tpu/inference/paged_cache.py).

K/V live in a per-layer POOL of fixed-size blocks
``[num_blocks, 2, H, block_size, D]``; each sequence owns a block table
(an int32 row of pool indices) and grows allocate-on-write, one block at
a time. Blocks are refcounted, so a forked sequence shares its prefix
pages and splits them copy-on-write at its first divergent append.
Block 0 of every pool is the reserved TRASH block: inactive rows of a
fused step write there, and table entries past an allocation point at
it so every read lands on a valid pool row (masked by length).

The cache layout is a PROTOCOL, not a tensor shape:
``FusedMultiTransformer.forward(..., caches=..., time_step=...)``
accepts the views below (``is_paged``), whose ``decode`` appends the
step's K/V through the block table and returns the attention — the
ragged paged-attention kernel for CUDA pools, its plain version for CPU
pools (ops/hopper/paged_attention.py).

Cross-request PREFIX CACHING (``prefix_cache=True``) layers a content
index over the pool: every full prompt block gets a chained hash
``h_i = H(h_{i-1}, rows of block i)``, so a match on h_i proves the whole
prefix up to block i is identical. A new request's prompt is matched
block by block (``match_prefix``/``adopt_prefix``) and shares the hit
pages by refcount; copy-on-write handles later divergence. Freed blocks
whose hash is still indexed park in the allocator's CACHED-FREE tier,
resurrectable on a later hit and reclaimed least-recently-used only when
the free list runs dry: free -> active -> cached-free -> (resurrect ->
active | reclaim -> free).

QUANTIZED PAGES (``dtype="int8"``): pages hold int8 payload and every
page carries one float32 scale per (K|V, head, position) in ``scales``
``[num_blocks, 2, H, block_size]`` per layer. Rows are quantized when
they are written (``_quant_rows``, in every append) and dequantized on
every read (in registers by the int8 ragged kernel, in ``gather_pages``
by its plain version). A position's bytes depend only on that token's
K/V, so chunking cannot change them and prefix adoption of an int8 page
is exact; scales move with their page through COW copies, and the deep
audit fingerprints payload and scales.

TENANT CHARGES: every table reference a slot holds charges the slot's
tenant one block (``set_seq_tenant``, ``tenant_charge``), so a tenant's
bill is a function of its own tables only; the audit holds the
incremental charge to a walk of the tables.

SNAPSHOTS (``snapshot``/``restore``): a pool checkpoint is the allocator's
exact state (refcounts, free-list order, cached-free LRU order), the
tables, the chain-hash index and the content of every live or
cached-free block, as a plain picklable dict of numpy arrays, ints and
bytes with the JAX class's keys and layout, so a snapshot taken by
either package restores in the other. ``snapshot(base=)`` makes a
delta (hash-indexed blocks the base already carries ship as ids
only). A restore into another ``num_blocks`` rehomes the blocks under
fresh ids, dropping least-recently-used cached-free blocks first when
the target is smaller. ``export_slice``/``import_slice`` move one
slot's finished prefix pages between pools; ``quarantine_seq`` frees
suspect pages with no cached-free second chance.

Port notes. The control plane (allocator, tables, refcounts, COW, hash
index, tenant charges, audits) is host numpy and follows the JAX class
exactly. Pool writes are IN PLACE (``pool[blk, 0, :, off, :] = k``): the
JAX class rebinds a new pool array per append, here the one pool tensor
per layer is updated, which is what keeps peak KV memory equal to the
pool. A bfloat16 pool's snapshot payload is float32 (numpy has no
bfloat16; the upcast is exact and restore casts back). Tensor-parallel
pools are not ported.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..framework.unported import require_defaults
from ..ops.hopper.paged_attention import RaggedPlan, paged_attention_ragged

__all__ = ["BlockOOM", "BlockAllocator", "PagedKVCache",
           "PagedLayerCache", "PagedPrefillView", "PagedRaggedView",
           "chain_hash", "chain_block_hashes", "KV_QMAX"]


def _merge_delta_snapshot(snap: dict, base: dict,
                          referenced: List[int]) -> dict:
    """A FULL snapshot from a delta and the base it was taken against:
    the delta's own payload rows plus the base's rows for every
    ``base_blocks`` id. Refuses a base of another geometry or one
    missing a referenced block."""
    if base.get("geometry") != snap["geometry"]:
        raise ValueError("delta snapshot: base geometry mismatch")
    row_of = {int(b): i for i, b in enumerate(base["blocks"])}
    missing = [b for b in referenced if b not in row_of]
    if missing:
        raise ValueError(f"delta snapshot references block(s) "
                         f"{missing} the base does not carry — "
                         f"wrong base checkpoint")
    take = [row_of[b] for b in referenced]
    merged = dict(snap)
    merged["blocks"] = [int(b) for b in snap["blocks"]] + \
        [int(b) for b in referenced]
    merged["payload"] = np.concatenate(
        [np.asarray(snap["payload"]),
         np.asarray(base["payload"])[take]], axis=0)
    if "scale_payload" in snap:
        merged["scale_payload"] = np.concatenate(
            [np.asarray(snap["scale_payload"]),
             np.asarray(base["scale_payload"])[take]], axis=0)
    merged["base_blocks"] = []
    return merged


def chain_hash(parent: bytes, block_tokens) -> bytes:
    """One link of the block-identity chain: hash of the parent block's
    chained hash + this block's content (prompt rows are embeddings, so
    content identity is float32 byte identity)."""
    arr = np.ascontiguousarray(np.asarray(block_tokens, np.float32))
    return hashlib.blake2b(parent + arr.tobytes(),
                           digest_size=16).digest()


def chain_block_hashes(tokens, block_size: int,
                       parent: bytes = b"") -> List[bytes]:
    """Chained hashes for every FULL block of ``tokens`` ([T, ...]).
    Partial trailing blocks are never indexed: their owner keeps
    appending into them."""
    arr = np.asarray(tokens)
    out: List[bytes] = []
    h = parent
    for i in range(arr.shape[0] // block_size):
        h = chain_hash(h, arr[i * block_size:(i + 1) * block_size])
        out.append(h)
    return out


class BlockOOM(RuntimeError):
    """No free blocks in the pool (the scheduler preempts on this).
    ``details`` is the structured occupancy breakdown the message is
    composed from (``PagedKVCache.pool_occupancy()``)."""

    def __init__(self, *args, details: Optional[dict] = None):
        super().__init__(*args)
        self.details: dict = dict(details) if details else {}


class BlockAllocator:
    """Free-list allocator over pool rows 1..num_blocks-1 with
    refcounts (row 0 is the reserved trash block). Shared blocks hold
    refcount > 1 and are split copy-on-write by the cache.

    With prefix caching the allocator has a SECOND-CHANCE tier:
    refcount-0 blocks whose content is still hash-indexed park in
    ``_cached`` (cached-free) instead of the free list. They count as
    free: ``alloc`` drains the free list first, then reclaims cached-free
    blocks least-recently-released, announcing each through
    ``on_reclaim`` so the owner drops its index entry."""

    def __init__(self, num_blocks: int, on_reclaim=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = int(num_blocks)
        # pop() from the end -> lowest ids first (stable tests)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        # insertion order == release order: popitem(last=False) evicts
        # the least-recently-released block
        self._cached: "OrderedDict[int, bool]" = OrderedDict()
        self.on_reclaim = on_reclaim
        self.reclaimed = 0
        self.refcount = np.zeros(self.num_blocks, np.int32)
        self.refcount[0] = 1  # trash block: never allocated, never freed
        # diagnostics wired by the owning cache: context() -> str and
        # context_data() -> dict for BlockOOM, describe(block) -> str
        # for ref/free misuse errors; fault_hook(n) may raise BlockOOM
        # (FaultInjector) and is consulted first, so a forced OOM fires
        # with free blocks in the pool
        self.context = None
        self.context_data = None
        self.describe = None
        self.fault_hook = None

    def _blurb(self, block: int) -> str:
        if self.describe is None:
            return ""
        return f" ({self.describe(int(block))})"

    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._cached)

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    def alloc(self, n: int = 1) -> List[int]:
        if self.fault_hook is not None:
            self.fault_hook(n)
        if n > self.num_free:
            raise BlockOOM(
                f"need {n} block(s), {self.num_free} free "
                f"({len(self._free)} free-list + {len(self._cached)} "
                f"cached-free reclaimable)"
                + (self.context() if self.context is not None else ""),
                details=dict(
                    self.context_data()
                    if self.context_data is not None else {},
                    blocks_needed=int(n),
                    blocks_free=int(self.num_free)))
        blocks = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._cached.popitem(last=False)
                self.reclaimed += 1
                if self.on_reclaim is not None:
                    self.on_reclaim(b)
            self.refcount[b] = 1
            blocks.append(b)
        return blocks

    def ref(self, blocks) -> None:
        """Share blocks (forked prefix): one more owner each."""
        for b in blocks:
            if self.refcount[b] <= 0:
                raise ValueError(f"ref of unallocated block {b}"
                                 + self._blurb(b))
            self.refcount[b] += 1

    def free(self, blocks, to_cache: bool = False) -> None:
        """Drop one owner per block. A block reaching refcount 0 goes to
        the free list, or with ``to_cache`` to the cached-free tier."""
        for b in blocks:
            if b == 0:
                raise ValueError("block 0 is reserved")
            if self.refcount[b] <= 0:
                raise ValueError(f"double free of block {b}"
                                 + self._blurb(b))
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                if to_cache:
                    self._cached[int(b)] = True
                else:
                    self._free.append(int(b))

    def resurrect(self, block: int) -> None:
        """cached-free -> active again (a prefix hit adopted it)."""
        if block not in self._cached:
            raise ValueError(f"block {block} is not cached-free")
        del self._cached[block]
        self.refcount[block] = 1


# --- int8 KV pages --------------------------------------------------------
# Symmetric per-(position, head) scales: each written K/V row quantizes
# over its head_dim with its own scale amax / 127. Appends never
# re-quantize earlier positions, and a position's bytes depend only on
# that token's K/V, which is what keeps prefix adoption exact. All-zero
# rows quantize to zeros with scale 0, which dequantizes to exact zeros.
KV_QMAX = 127.0


def _quant_rows(x):
    """x [..., D] float -> (int8 payload [..., D], float32 scale [...])."""
    x = x.float()
    scale = x.abs().amax(dim=-1) / KV_QMAX
    q = torch.clamp(torch.round(x / torch.clamp_min(scale, 1e-30)[..., None]),
                    -KV_QMAX, KV_QMAX).to(torch.int8)
    return q, scale


class _Route:
    """Device copies of one append's routing (pool block and in-block
    offset per written row) and of the attention's per-sequence lengths
    and tables — built once per model call and shared by every layer."""

    __slots__ = ("blk", "off", "kv_lens", "bt", "plan", "tile_q",
                 "tile_kv")

    def __init__(self, blk, off, kv_lens, bt, q_lens, device,
                 tile_q=None, tile_kv=None):
        self.blk = torch.from_numpy(np.asarray(blk, np.int64)).to(device)
        self.off = torch.from_numpy(np.asarray(off, np.int64)).to(device)
        self.kv_lens = torch.from_numpy(
            np.asarray(kv_lens, np.int32)).to(device)
        self.bt = bt
        # the host lengths size the split-KV work items (no device read)
        self.plan = RaggedPlan(q_lens, kv_lens)
        # kernel tuning knobs of the engine's ragged step (None: the
        # kernel's defaults)
        self.tile_q = tile_q
        self.tile_kv = tile_kv


def _append(cache: "PagedKVCache", layer: int, route: _Route, k, v) -> None:
    """Packed in-place append: row r of k/v [N, H, D] lands at
    pool[blk[r], :, :, off[r], :] — quantized, with its scales, on an
    int8 pool. Rows routed to the trash block may collide there; nothing
    reads it unmasked."""
    pool = cache.pools[layer]
    if cache.quantized:
        kq, ks = _quant_rows(k)
        vq, vs = _quant_rows(v)
        sc = cache.scales[layer]
        pool[route.blk, 0, :, route.off, :] = kq
        pool[route.blk, 1, :, route.off, :] = vq
        sc[route.blk, 0, :, route.off] = ks
        sc[route.blk, 1, :, route.off] = vs
        return
    pool[route.blk, 0, :, route.off, :] = k.to(pool.dtype)
    pool[route.blk, 1, :, route.off, :] = v.to(pool.dtype)


class _View:
    """What every layer view shares: its pool, its scale pages (int8
    pools) and its shape."""

    is_paged = True

    @property
    def pool(self) -> torch.Tensor:
        return self._cache.pools[self._layer]

    @property
    def kv_scales(self) -> Optional[torch.Tensor]:
        """Per-page dequantization scales (int8 pools), else None."""
        c = self._cache
        return c.scales[self._layer] if c.quantized else None

    @property
    def shape(self):
        return self.pool.shape

    def _attend(self, q, route: _Route, q_lens):
        return paged_attention_ragged(q, self.pool, route.bt, q_lens,
                                      route.kv_lens, tile_q=route.tile_q,
                                      tile_kv=route.tile_kv,
                                      kv_scales=self.kv_scales,
                                      plan=route.plan)


class PagedLayerCache(_View):
    """One layer's view of the paged cache for the fused batch step —
    the object that rides in ``caches=``. ``decode(q, k, v, t)`` appends
    L tokens per row at positions t[b] .. t[b]+L-1 through the (decode-
    masked) batch table and returns the attention [B, L, nh, hd]."""

    def __init__(self, cache: "PagedKVCache", layer: int):
        self._cache = cache
        self._layer = layer

    def decode(self, q, k, v, t):
        """q/k/v: [B, L, H, D]; t: int [B] per-row START positions
        (host array or tensor). PRECONDITION: ``ensure(row, t[row]+L,
        write_from=t[row])`` for every active row."""
        c = self._cache
        B, L = q.shape[0], q.shape[1]
        if B != c.max_seqs:
            raise ValueError(f"batch {B} != cache max_seqs {c.max_seqs}")
        tv = _host_rows(t, B)
        route = c._decode_route(tv, L, check=self._layer == 0)
        H, D = q.shape[2], q.shape[3]
        _append(c, self._layer, route, k.reshape(B * L, H, D),
                v.reshape(B * L, H, D))
        out = self._attend(q.reshape(B * L, H, D), route, (L,) * B)
        return out.reshape(B, L, H, D)


class PagedPrefillView(_View):
    """One layer's CHUNKED-PREFILL view of a single slot (the ``caches=``
    list of a batch-1 chunk call, ``PagedKVCache.prefill_views``): the
    chunk's C rows append straight into the slot's pages and attend
    causally at absolute positions t[0] + i. Positions below
    ``write_start`` are an adopted (possibly shared) prefix whose pages
    already hold these exact K/V: their rows attend but route their
    writes to the trash block."""

    def __init__(self, cache: "PagedKVCache", layer: int, slot: int,
                 write_start: int = 0):
        self._cache = cache
        self._layer = layer
        self._slot = slot
        self._write_start = int(write_start)

    def decode(self, q, k, v, t):
        """q/k/v: [1, C, H, D], one chunk starting at position t[0].
        PRECONDITION: ``ensure(slot, t[0]+C, write_from=t[0])``."""
        c = self._cache
        B, C = q.shape[0], q.shape[1]
        if B != 1:
            raise ValueError(
                f"chunk prefill is a batch-1 call, got batch {B}")
        start = int(_host_rows(t, 1)[0])
        route = c._prefill_route(self._slot, start, C, self._write_start,
                                 check=self._layer == 0)
        _append(c, self._layer, route, k[0], v[0])
        return self._attend(q[0], route, (C,))[None]


class _RaggedLayout:
    """Host-side descriptors for ONE mixed ragged model call, shared by
    every layer's PagedRaggedView: the packed append routing (blk/off
    per row), the per-sequence (q_len, kv_len, block-table row)
    descriptors and the kernel's tile plan. Built once per launch from
    the cache's CURRENT tables — the caller must have ensure()d
    coverage and set the decode mask first."""

    def __init__(self, cache: "PagedKVCache", segments, tile_q=None,
                 tile_kv=None):
        bs = cache.block_size
        tbl = cache.block_tables
        masked_tbl = tbl
        if cache._decode_masked is not None and \
                cache._decode_masked.any():
            masked_tbl = tbl.copy()
            masked_tbl[cache._decode_masked] = 0
        q_lens: List[int] = []
        kv_lens: List[int] = []
        bt_rows: List[np.ndarray] = []
        blk: List[np.ndarray] = []
        off: List[np.ndarray] = []
        lo = 0
        for seg in segments:
            kind = seg[0]
            if kind == "prefill":
                _, slot, start, length, write_start = seg
                pos = np.arange(start, start + length)
                # adopted shared-prefix positions route to trash: their
                # pages already hold these exact values and may be shared
                blk.append(np.where(pos >= write_start,
                                    tbl[slot][pos // bs], 0))
                off.append(pos % bs)
                q_lens.append(int(length))
                kv_lens.append(int(start) + int(length))
                bt_rows.append(tbl[slot])
                lo += length
            elif kind == "decode":
                _, lens, L = seg
                if L < 1:
                    raise ValueError("decode segments carry >= 1 "
                                     "query row per slot")
                lens = np.asarray(lens, np.int64)
                B = lens.shape[0]
                # masked rows may sit at page capacity: clamp their
                # table column (they present all-trash rows, so any
                # in-range column writes block 0)
                cols = masked_tbl.shape[1]
                pos = lens[:, None] + np.arange(L)[None, :]
                b = masked_tbl[np.arange(B)[:, None],
                               np.minimum(pos // bs, cols - 1)]
                blk.append(b.reshape(-1))
                off.append((pos % bs).reshape(-1))
                q_lens.extend([L] * B)
                kv_lens.extend((lens + L).tolist())
                bt_rows.extend(masked_tbl)
                lo += B * L
            else:
                raise ValueError(f"unknown ragged segment kind {kind!r}")
        self.total_rows = lo
        self.q_lens = tuple(q_lens)
        bt = torch.from_numpy(np.stack(bt_rows).astype(np.int32)).to(
            cache.device)
        self.route = _Route(np.concatenate(blk), np.concatenate(off),
                            kv_lens, bt, self.q_lens, cache.device,
                            tile_q=tile_q, tile_kv=tile_kv)


class PagedRaggedView(_View):
    """One layer's MIXED-BATCH view — the ``caches=`` entry of the
    scheduler's ragged step: prefill chunks of several slots AND the
    fused decode rows packed into one [1, total_rows, d] model call.
    The packed K/V append is ONE scatter through the precomputed
    routing, and the attention is ONE ``paged_attention_ragged`` launch
    per layer (the kernel on CUDA, its plain version on the CPU)."""

    def __init__(self, cache: "PagedKVCache", layer: int,
                 layout: _RaggedLayout):
        self._cache = cache
        self._layer = layer
        self._layout = layout

    def decode(self, q, k, v, t=None):
        """q/k/v: [1, R, H, D] — the packed mixed batch. ``t`` is
        ignored: the layout carries every row's absolute position."""
        lay = self._layout
        if q.shape[0] != 1 or q.shape[1] != lay.total_rows:
            raise ValueError(
                f"ragged call expects [1, {lay.total_rows}, H, D], "
                f"got {tuple(q.shape)}")
        _append(self._cache, self._layer, lay.route, k[0], v[0])
        return self._attend(q[0], lay.route, lay.q_lens)[None]


def _host_rows(t, n: int) -> np.ndarray:
    """Per-row int positions on the host (a scalar broadcasts)."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.broadcast_to(np.asarray(t, np.int64).reshape(-1)
                           if np.ndim(t) else np.asarray(t, np.int64),
                           (n,))


class PagedKVCache:
    """Per-layer block pools + one block allocator + per-sequence block
    tables. ``views`` is the list consumed as ``caches=`` by the fused
    decoder; allocation/free/fork are host-side, the pool writes are
    in-place tensor scatters on ``device``. ``dtype`` is a torch dtype
    or its name ("float32", "bfloat16", "int8")."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 block_size: int, num_blocks: int, max_seqs: int,
                 max_blocks_per_seq: Optional[int] = None,
                 dtype="float32", prefix_cache: bool = False,
                 mp: int = 1, shard_devices=None, *, device=None):
        # tensor-parallel pools (mp > 1) are not ported
        require_defaults("PagedKVCache", mp=(mp, 1),
                         shard_devices=(shard_devices, None))
        # the dtype's name is what snapshots and slices record (the JAX
        # class's geometry key)
        self.dtype_name = dtype if isinstance(dtype, str) else \
            str(dtype).replace("torch.", "")
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_seqs = int(max_seqs)
        if max_blocks_per_seq is None:
            max_blocks_per_seq = self.num_blocks - 1
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.dtype = dtype
        self.quantized = dtype == torch.int8
        self.prefix_cache = bool(prefix_cache)
        # chained-hash block index: a block is indexed iff
        # _hash_to_block[h] == b and _block_hash[b] == h
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}
        self.allocator = BlockAllocator(self.num_blocks,
                                        on_reclaim=self._on_reclaim)
        self.allocator.context = self._pool_context
        self.allocator.context_data = self.pool_occupancy
        self.allocator.describe = self._describe_block
        # content fingerprints for the "never written in place" audit of
        # shared, hash-indexed and cached-free blocks; re-shares drop
        # the entry
        self._audit_fp: Dict[int, bytes] = {}
        self.pools: List[torch.Tensor] = [
            torch.zeros((self.num_blocks, 2, self.num_heads,
                         self.block_size, self.head_dim), dtype=dtype,
                        device=self.device)
            for _ in range(self.num_layers)]
        # int8 pools: [num_blocks, 2, H, block_size] float32 scales per
        # layer; zeros dequantize to exact zeros, like a zeroed pool
        self.scales: Optional[List[torch.Tensor]] = [
            torch.zeros((self.num_blocks, 2, self.num_heads,
                         self.block_size), dtype=torch.float32,
                        device=self.device)
            for _ in range(self.num_layers)] if self.quantized else None
        # all entries at the trash block until allocated
        self.block_tables = np.zeros(
            (self.max_seqs, self.max_blocks_per_seq), np.int32)
        self.seq_blocks: List[List[int]] = [[] for _ in
                                            range(self.max_seqs)]
        self.views = [PagedLayerCache(self, i)
                      for i in range(self.num_layers)]
        self._bt_cached: Optional[torch.Tensor] = None
        self._bt_rows_cached: Dict[int, torch.Tensor] = {}
        # last model call's routing, reused by every layer of the call
        self._route_memo: Optional[tuple] = None
        # rows whose table presents as ALL-TRASH to the fused decode
        # step (mid-prefill slots, slots admitted this very step)
        self._decode_masked: Optional[np.ndarray] = None
        self.peak_blocks_used = 0
        # tenant attribution: which tenant each slot serves, and the
        # per-tenant charge, ONE PER TABLE REFERENCE (a block shared by
        # k slots charges each sharer's tenant 1), so a tenant's charge
        # depends on its own slots' tables only; every table mutation
        # moves it (``_charge``), a COW swap is neutral
        self.seq_tenant: List[Optional[str]] = [None] * self.max_seqs
        self._tenant_charge: Dict[Optional[str], int] = {}

    # -- construction -------------------------------------------------
    @classmethod
    def for_model(cls, model, block_size, num_blocks, max_seqs,
                  max_blocks_per_seq=None, dtype="float32",
                  prefix_cache=False):
        """A pool matching ``model``'s geometry and device."""
        return cls(model.num_layers, model.num_heads, model.head_dim,
                   block_size, num_blocks, max_seqs,
                   max_blocks_per_seq=max_blocks_per_seq, dtype=dtype,
                   prefix_cache=prefix_cache, device=model.device)

    # -- geometry -----------------------------------------------------
    @property
    def capacity_per_seq(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    def blocks_needed(self, length: int) -> int:
        return -(-int(length) // self.block_size)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - 1 - self.allocator.num_free

    def pool_bytes(self) -> int:
        """Device bytes of the pool: payload, plus the scale pages of an
        int8 pool."""
        n = sum(p.numel() * p.element_size() for p in self.pools)
        if self.quantized:
            n += sum(s.numel() * s.element_size() for s in self.scales)
        return n

    def kv_bytes_per_token(self) -> int:
        """Device bytes one token's K/V occupies across every layer:
        2 x heads x (head_dim x payload itemsize + scale bytes) x
        layers."""
        per_head = self.head_dim * self.pools[0].element_size()
        if self.quantized:
            per_head += self.scales[0].element_size()
        return int(2 * self.num_heads * per_head * self.num_layers)

    # -- tenant accounting --------------------------------------------
    def _charge(self, slot: int, delta: int) -> None:
        """Move ``slot``'s tenant's block charge by ``delta`` table
        references."""
        if delta == 0:
            return
        t = self.seq_tenant[slot]
        self._tenant_charge[t] = self._tenant_charge.get(t, 0) + delta

    def set_seq_tenant(self, slot: int, tenant: Optional[str]) -> None:
        """Attribute ``slot`` to ``tenant`` (None = unattributed); the
        blocks the slot already holds move their charge with it."""
        old = self.seq_tenant[slot]
        if old == tenant:
            return
        held = len(self.seq_blocks[slot])
        if held:
            self._tenant_charge[old] = \
                self._tenant_charge.get(old, 0) - held
        self.seq_tenant[slot] = tenant
        if held:
            self._tenant_charge[tenant] = \
                self._tenant_charge.get(tenant, 0) + held

    def tenant_charge(self, tenant: Optional[str]) -> int:
        """Blocks charged to ``tenant`` (one per table reference its
        slots hold)."""
        return self._tenant_charge.get(tenant, 0)

    def tenant_blocks_held(self) -> Dict[Optional[str], int]:
        """{tenant: charged blocks}, nonzero entries only."""
        return {t: n for t, n in self._tenant_charge.items() if n}

    # -- diagnostics ---------------------------------------------------
    def owners_of(self, block: int) -> List[int]:
        return [s for s in range(self.max_seqs)
                if block in self.seq_blocks[s]]

    def pool_occupancy(self, tiers_only: bool = False) -> dict:
        """Structured occupancy breakdown: tier counts and (unless
        ``tiers_only``) the owning-slot histogram."""
        a = self.allocator
        out = {
            "active": self.num_blocks - 1 - a.num_free,
            "cached_free": a.num_cached,
            "free": len(a._free),
            "usable": self.num_blocks - 1,
        }
        if not tiers_only:
            out["blocks_per_slot"] = {
                s: len(bl) for s, bl in enumerate(self.seq_blocks) if bl}
            out["blocks_per_tenant"] = {
                t: n for t, n in self._tenant_charge.items()
                if n and t is not None}
        return out

    def _pool_context(self) -> str:
        occ = self.pool_occupancy()
        out = (f"; pool: {occ['active']} active / {occ['cached_free']} "
               f"cached-free / {occ['free']} free of {occ['usable']} "
               f"usable; blocks per slot: "
               f"{occ['blocks_per_slot'] or '{}'}")
        if occ["blocks_per_tenant"]:
            out += f"; blocks per tenant: {occ['blocks_per_tenant']}"
        return out

    def _describe_block(self, block: int) -> str:
        owners = self.owners_of(block)
        state = ("cached-free" if block in self.allocator._cached
                 else f"refcount {int(self.allocator.refcount[block])}")
        tail = ", hash-indexed" if block in self._block_hash else ""
        own = f"owned by slot(s) {owners}" if owners else "no owner"
        tnts = sorted({self.seq_tenant[s] for s in owners
                       if self.seq_tenant[s] is not None})
        if tnts:
            own += f" of tenant(s) {tnts}"
        return f"{state}, {own}{tail}"

    def _fingerprint(self, block: int, pool_arrs) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        for arr in pool_arrs:
            h.update(np.ascontiguousarray(arr[block]).tobytes())
        return h.digest()

    def check_invariants(self, lens=None, active=None,
                         deep: bool = True) -> bool:
        """Audit the pool's bookkeeping; raises AssertionError naming
        the violated invariant, returns True when clean:

          1. every usable block's refcount equals the number of slot
             tables holding it (at most once per table);
          2. the free list, the cached-free tier and the active set
             partition the usable blocks;
          3. trash block 0 keeps refcount 1 and is in no table, free
             tier or hash index;
          4. block_tables[slot] is seq_blocks[slot] then trash;
          5. the hash index maps are inverse, and every indexed block is
             live or cached-free; cached-free blocks are refcount 0 and
             indexed;
          6. with ``lens``/``active``: every active slot's table covers
             blocks_needed(lens[slot]);
          7. ``deep``: shared (refcount >= 2), hash-indexed and
             cached-free blocks are fingerprinted (payload and, on int8
             pools, scales) and re-verified while they stay so — an
             in-place write to such a page trips it;
          8. the per-tenant charges equal a walk of the tables (one
             charge per reference held by each tenant's slots) and their
             total equals the allocator's refcounts over usable blocks.
        """
        a = self.allocator
        counts: Dict[int, int] = {}
        for slot in range(self.max_seqs):
            blocks = self.seq_blocks[slot]
            assert len(blocks) == len(set(blocks)), \
                f"slot {slot} table holds duplicate blocks: {blocks}"
            assert len(blocks) <= self.max_blocks_per_seq, \
                f"slot {slot} table over capacity"
            assert 0 not in blocks, \
                f"slot {slot} table holds the trash block"
            for b in blocks:
                counts[int(b)] = counts.get(int(b), 0) + 1
            row = self.block_tables[slot]
            assert list(row[:len(blocks)]) == [int(b) for b in blocks] \
                and not row[len(blocks):].any(), \
                f"slot {slot} device table diverges from seq_blocks"
        free_set, cached_set = set(a._free), set(a._cached)
        active_set = {b for b in range(1, self.num_blocks)
                      if a.refcount[b] > 0}
        assert len(free_set) == len(a._free), "free list holds duplicates"
        assert a.refcount[0] == 1 and 0 not in free_set \
            and 0 not in cached_set and 0 not in self._block_hash, \
            "trash block 0 left its reserved state"
        for b in range(1, self.num_blocks):
            assert int(a.refcount[b]) == counts.get(b, 0), \
                (f"block {b} refcount {int(a.refcount[b])} != "
                 f"{counts.get(b, 0)} table reference(s) "
                 f"(slots {self.owners_of(b)})")
        assert not (free_set & cached_set) \
            and not (free_set & active_set) \
            and not (cached_set & active_set), \
            "free / cached-free / active sets overlap"
        assert free_set | cached_set | active_set \
            == set(range(1, self.num_blocks)), \
            "free / cached-free / active sets do not cover the pool"
        for h, b in self._hash_to_block.items():
            assert self._block_hash.get(b) == h, \
                f"hash index asymmetry at block {b}"
            assert b in active_set or b in cached_set, \
                f"hash index points at free-list block {b}"
        for b, h in self._block_hash.items():
            assert self._hash_to_block.get(h) == b, \
                f"block-hash asymmetry at block {b}"
        for b in cached_set:
            assert a.refcount[b] == 0, f"cached-free block {b} has owners"
            assert b in self._block_hash, \
                f"cached-free block {b} is not hash-indexed"
        truth: Dict[Optional[str], int] = {}
        for slot in range(self.max_seqs):
            n = len(self.seq_blocks[slot])
            if n:
                t = self.seq_tenant[slot]
                truth[t] = truth.get(t, 0) + n
        charged = {t: n for t, n in self._tenant_charge.items() if n}
        assert charged == truth, \
            (f"tenant block charges {charged} diverge from the "
             f"tables' ground truth {truth}")
        assert all(n >= 0 for n in self._tenant_charge.values()), \
            f"negative tenant charge: {self._tenant_charge}"
        total_refs = int(a.refcount[1:].sum())
        assert sum(truth.values()) == total_refs, \
            (f"tenant charges cover {sum(truth.values())} references "
             f"but the allocator counts {total_refs}")
        if lens is not None and active is not None:
            lens = np.asarray(lens)
            for slot in np.flatnonzero(np.asarray(active)):
                need = self.blocks_needed(int(lens[slot]))
                assert need <= len(self.seq_blocks[int(slot)]), \
                    (f"active slot {int(slot)} length "
                     f"{int(lens[slot])} not covered by its "
                     f"{len(self.seq_blocks[int(slot)])} block(s)")
        if deep:
            frozen = {b for b in range(1, self.num_blocks)
                      if a.refcount[b] >= 2 or b in self._block_hash
                      or b in cached_set}
            for b in list(self._audit_fp):
                if b not in frozen:
                    del self._audit_fp[b]
            if frozen:
                ids = torch.tensor(sorted(frozen), device=self.device)
                arrs = [p[ids].cpu().numpy() for p in self.pools]
                if self.quantized:
                    arrs += [s[ids].cpu().numpy() for s in self.scales]
                for i, b in enumerate(sorted(frozen)):
                    fp = self._fingerprint(i, arrs)
                    old = self._audit_fp.get(b)
                    assert old is None or old == fp, \
                        (f"immutable block {b} was written in place "
                         f"({self._describe_block(b)})")
                    self._audit_fp[b] = fp
        return True

    # -- checkpoint / restore -----------------------------------------
    def _np_dtype(self, scales: bool = False):
        """numpy dtype of a snapshot or slice payload (bfloat16 pages
        travel as float32: an exact upcast)."""
        if scales or self.dtype == torch.bfloat16:
            return np.float32
        return torch.empty((), dtype=self.dtype).numpy().dtype

    def _pull(self, arrs, blocks, scales: bool = False) -> np.ndarray:
        """[n, L, ...] host copy of ``blocks``' rows of every layer's
        pool (or scale pages): one gather on the device per layer, one
        transfer."""
        if not blocks:
            shape = arrs[0].shape[1:]
            return np.zeros((0, len(arrs)) + tuple(shape),
                            self._np_dtype(scales))
        ids = torch.tensor(blocks, dtype=torch.long, device=self.device)
        out = torch.stack([a[ids] for a in arrs], dim=1)
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()

    def _land(self, ids: List[int], payload: np.ndarray,
              spay: Optional[np.ndarray]) -> None:
        """Write payload rows [n, L, 2, H, bs, D] (and scale rows
        [n, L, 2, H, bs] on an int8 pool) into pool blocks ``ids``."""
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        for i, pool in enumerate(self.pools):
            pool[idx] = torch.from_numpy(np.ascontiguousarray(
                payload[:, i])).to(device=self.device, dtype=pool.dtype)
        if self.quantized:
            for i, sc in enumerate(self.scales):
                sc[idx] = torch.from_numpy(np.ascontiguousarray(
                    spay[:, i], np.float32)).to(self.device)

    def snapshot(self, base: Optional[dict] = None) -> dict:
        """Host-side checkpoint of the whole pool: geometry, the
        allocator's exact state (refcounts, free-list order, cached-free
        LRU order), block tables, tenant attribution, the chain-hash
        index and the content of every live or cached-free block (int8
        pools: payload and scales). Free-list blocks carry no content
        (a quarantined page is already free). One transfer to the host
        per call. A plain picklable dict (numpy, ints, bytes) with the
        JAX class's keys and payload layout.

        ``base`` (an earlier snapshot of the same geometry) makes this a
        DELTA: a block whose chain hash the base binds to the same id,
        and whose row the base carries, rides as an id in
        ``base_blocks`` (indexed blocks are never written in place, so
        same id and hash means same bytes). Allocator metadata stays
        complete; ``restore(..., base=)`` reconstitutes the pool."""
        a = self.allocator
        cached_order = [int(b) for b in a._cached]
        keep = sorted({b for b in range(1, self.num_blocks)
                       if a.refcount[b] > 0} | set(cached_order))
        geometry = {
            "num_layers": self.num_layers,
            "num_heads": self.num_heads,
            "head_dim": self.head_dim,
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "max_seqs": self.max_seqs,
            "max_blocks_per_seq": self.max_blocks_per_seq,
            "dtype": self.dtype_name,
            "prefix_cache": self.prefix_cache,
            "mp": 1,
        }
        clean = set()
        if base is not None:
            if base.get("geometry") != geometry:
                raise ValueError(
                    "delta snapshot: base comes from a different "
                    "pool geometry — content addresses do not "
                    "transfer across geometries")
            base_rows = {int(b) for b in base["blocks"]}
            base_index = base.get("hash_index", {})
            for b in keep:
                h = self._block_hash.get(b)
                if h is not None and base_index.get(h) == b \
                        and b in base_rows:
                    clean.add(b)
        dirty = [b for b in keep if b not in clean]
        out = {
            "kind": "paged_kv_cache",
            "geometry": geometry,
            "refcount": {int(b): int(a.refcount[b]) for b in keep},
            "free_order": [int(b) for b in a._free],
            "cached_order": cached_order,       # oldest (LRU) first
            "reclaimed": int(a.reclaimed),
            "hash_index": dict(self._hash_to_block),
            "seq_blocks": [[int(b) for b in bl]
                           for bl in self.seq_blocks],
            "seq_tenant": list(self.seq_tenant),
            "peak_blocks_used": int(self.peak_blocks_used),
            "blocks": [int(b) for b in dirty],
            "payload": self._pull(self.pools, dirty),
            "base_blocks": sorted(int(b) for b in clean),
        }
        if self.quantized:
            out["scale_payload"] = self._pull(self.scales, dirty,
                                              scales=True)
        return out

    @classmethod
    def restore(cls, snap: dict, *, num_blocks: Optional[int] = None,
                mp: Optional[int] = None, shard_devices=None,
                base: Optional[dict] = None,
                device=None) -> "PagedKVCache":
        """Rebuild a pool from a ``snapshot`` on ``device``. With the
        snapshot's ``num_blocks`` every block keeps its id and the
        free-list and LRU orders round-trip exactly, so the restored
        pool allocates as the uninterrupted one would. Another
        ``num_blocks`` rehomes the blocks under fresh ids (live blocks
        first, oldest ids first, then cached-free newest first): the
        least-recently-used cached-free blocks are dropped, with their
        index entries, when the target is smaller, and a live set that
        cannot fit raises ``BlockOOM`` with the occupancy breakdown. A
        delta snapshot needs its ``base``. Ends with the deep audit."""
        if mp not in (None, 1) or int(snap["geometry"].get("mp", 1)) != 1:
            raise NotImplementedError(
                "PagedKVCache.restore: tensor-parallel pools (mp > 1) "
                "are not ported")
        require_defaults("PagedKVCache.restore",
                         shard_devices=(shard_devices, None))
        referenced = [int(b) for b in snap.get("base_blocks", ())]
        if referenced:
            if base is None:
                raise ValueError(
                    f"delta snapshot references {len(referenced)} "
                    f"block(s) from its base checkpoint — restore "
                    f"needs base=...")
            snap = _merge_delta_snapshot(snap, base, referenced)
        g = snap["geometry"]
        nb = g["num_blocks"] if num_blocks is None else int(num_blocks)
        refcount = {int(b): int(n) for b, n in snap["refcount"].items()}
        cached = [int(b) for b in snap["cached_order"]]
        live = sorted(b for b, n in refcount.items() if n > 0)
        usable = nb - 1
        if len(live) > usable:
            hist = {s: len(bl) for s, bl in
                    enumerate(snap["seq_blocks"]) if bl}
            raise BlockOOM(
                f"restore needs {len(live)} live block(s) but the "
                f"target pool has only {usable} usable"
                f"; snapshot pool: {len(live)} active / {len(cached)} "
                f"cached-free of {g['num_blocks'] - 1} usable; "
                f"blocks per slot: {hist or '{}'}",
                details={"active": len(live),
                         "cached_free": len(cached),
                         "usable": g["num_blocks"] - 1,
                         "target_usable": usable,
                         "blocks_per_slot": hist})
        cache = cls(g["num_layers"], g["num_heads"], g["head_dim"],
                    g["block_size"], nb, g["max_seqs"],
                    max_blocks_per_seq=g["max_blocks_per_seq"],
                    dtype=g["dtype"], prefix_cache=g["prefix_cache"],
                    device=device)
        # cached-free blocks that fit, the most recently released kept
        # (dropping the LRU end is the live allocator's reclaim order)
        n_cached = min(len(cached), usable - len(live))
        dropped, kept_cached = (cached[:len(cached) - n_cached],
                                cached[len(cached) - n_cached:])
        a = cache.allocator
        if nb == g["num_blocks"] and not dropped:
            remap = {b: b for b in live + kept_cached}
            a._free = [int(b) for b in snap["free_order"]]
        else:
            order = live + kept_cached   # canonical rehoming order
            remap = {old: new for new, old in enumerate(order, start=1)}
            a._free = list(range(nb - 1, len(order), -1))
        for old, n in refcount.items():
            if old in remap:
                a.refcount[remap[old]] = n
        a._cached = OrderedDict((remap[b], True) for b in kept_cached)
        a.reclaimed = int(snap["reclaimed"]) + len(dropped)
        tenants = snap.get("seq_tenant", [None] * g["max_seqs"])
        for slot, blocks in enumerate(snap["seq_blocks"]):
            mapped = [remap[int(b)] for b in blocks]
            cache.seq_tenant[slot] = tenants[slot]
            cache.seq_blocks[slot] = mapped
            cache._charge(slot, len(mapped))
            cache.block_tables[slot, :len(mapped)] = mapped
        for h, b in snap["hash_index"].items():
            b = remap.get(int(b))
            if b is not None:     # a dropped cached-free block's entry
                cache._hash_to_block[h] = b
                cache._block_hash[b] = h
        rows = [i for i, b in enumerate(snap["blocks"])
                if int(b) in remap]
        if rows:
            spay = (np.asarray(snap["scale_payload"])[rows]
                    if cache.quantized else None)
            cache._land([remap[int(snap["blocks"][i])] for i in rows],
                        np.asarray(snap["payload"])[rows], spay)
        cache.peak_blocks_used = int(snap["peak_blocks_used"])
        cache._tables_dirty()
        cache.check_invariants(deep=True)
        return cache

    # -- page migration -------------------------------------------------
    def _slice_geometry(self) -> dict:
        return {"num_layers": self.num_layers,
                "num_heads": self.num_heads,
                "head_dim": self.head_dim,
                "block_size": self.block_size,
                "dtype": self.dtype_name}

    def export_slice(self, slot: int, hashes) -> Optional[dict]:
        """Wire-format slice of ONE slot's finished prefix pages: the
        first ``min(len(hashes), blocks held)`` blocks as (chain hash,
        payload) pairs plus the geometry the importer checks. Gathered
        on the device, one transfer; no allocator state moves. None
        when the slot holds no block to migrate."""
        blocks = [int(b) for b in self.seq_blocks[slot][:len(hashes)]]
        if not blocks:
            return None
        out = {
            "kind": "kv_slice",
            "geometry": self._slice_geometry(),
            "hashes": list(hashes[:len(blocks)]),
            "payload": self._pull(self.pools, blocks),
        }
        if self.quantized:
            out["scale_payload"] = self._pull(self.scales, blocks,
                                              scales=True)
        return out

    def import_slice(self, slc: dict) -> int:
        """Adopt an ``export_slice`` into this pool: each page lands
        CACHED-FREE and hash-indexed, so the migrated request's next
        ``adopt_prefix`` resurrects it. A hash already indexed here is
        skipped; blocks import in prefix order and stop at the first
        allocation failure; nothing is charged to any tenant. Returns
        the number of blocks written. ValueError on a geometry mismatch
        or a pool without a prefix index."""
        if slc.get("kind") != "kv_slice":
            raise ValueError(f"not a kv_slice: {slc.get('kind')!r}")
        if not self.prefix_cache:
            raise ValueError(
                "import_slice needs prefix_cache=True — migrated "
                "pages are adopted through the chain-hash index")
        g = slc["geometry"]
        mine = self._slice_geometry()
        if {k: g.get(k) for k in mine} != mine:
            raise ValueError(
                f"kv_slice geometry {g} does not match pool {mine}")
        if self.quantized and "scale_payload" not in slc:
            raise ValueError(
                "kv_slice carries no scales but this pool is int8 — "
                "corrupt or hand-built slice")
        landing: List[tuple] = []       # (pool block id, slice row)
        for i, h in enumerate(slc["hashes"]):
            if h in self._hash_to_block:
                continue            # this pool already holds the prefix
            try:
                b = self.allocator.alloc(1)[0]
            except BlockOOM:
                break               # pool full: keep the clean prefix
            landing.append((b, i))
        if not landing:
            return 0
        rows = [i for _, i in landing]
        self._land([b for b, _ in landing],
                   np.asarray(slc["payload"])[rows],
                   np.asarray(slc["scale_payload"])[rows]
                   if self.quantized else None)
        for b, i in landing:
            self._audit_fp.pop(b, None)
            self._hash_to_block[slc["hashes"][i]] = b
            self._block_hash[b] = slc["hashes"][i]
            self.allocator.free([b], to_cache=True)
        return len(landing)

    # -- direct page writes ---------------------------------------------
    def write_prefill_chunk(self, slot: int, layer: int, k, v,
                            start: int, write_start: int = 0) -> None:
        """Write k/v [1, C, H, D] into ``slot``'s pages at positions
        [start, start + C) of ``layer``, skipping positions below
        ``write_start`` (an adopted prefix). ``ensure(slot, start + C,
        write_from=start)`` must have run. The model path goes through
        ``prefill_views``; this serves callers holding projected K/V."""
        C = int(k.shape[1])
        pos = np.arange(start, start + C)
        blk = self.block_tables[slot][pos // self.block_size]
        route = _Route(np.where(pos >= write_start, blk, 0),
                       pos % self.block_size, [start + C], None, (C,),
                       self.device)
        _append(self, layer, route, torch.as_tensor(k)[0].to(self.device),
                torch.as_tensor(v)[0].to(self.device))

    # -- device tables --------------------------------------------------
    def bt_tensor(self) -> torch.Tensor:
        """Device copy of the block tables, rebuilt only after a table
        mutation; rows in the decode mask present as all-trash."""
        if self._bt_cached is None:
            tbl = self.block_tables
            if self._decode_masked is not None and \
                    self._decode_masked.any():
                tbl = tbl.copy()
                tbl[self._decode_masked] = 0
            self._bt_cached = torch.from_numpy(
                np.ascontiguousarray(tbl, np.int32)).to(self.device)
        return self._bt_cached

    def bt_row_tensor(self, slot: int) -> torch.Tensor:
        """Device copy of ONE slot's (unmasked) table row [1, MB]."""
        t = self._bt_rows_cached.get(slot)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(
                self.block_tables[slot:slot + 1], np.int32)).to(
                    self.device)
            self._bt_rows_cached[slot] = t
        return t

    def set_decode_mask(self, rows: Optional[np.ndarray]) -> None:
        """Mark rows whose pages a fused DECODE step must not touch.
        ``rows``: bool [max_seqs] or None to clear."""
        new = None if rows is None or not rows.any() else rows.copy()
        old = self._decode_masked
        if (old is None) != (new is None) or \
                (old is not None and not np.array_equal(old, new)):
            self._decode_masked = new
            self._bt_cached = None
            self._route_memo = None

    def _tables_dirty(self):
        self._bt_cached = None
        self._bt_rows_cached.clear()
        self._route_memo = None
        self.peak_blocks_used = max(self.peak_blocks_used,
                                    self.blocks_in_use)

    def _memo(self, key, build):
        if self._route_memo is None or self._route_memo[0] != key:
            self._route_memo = (key, build())
        return self._route_memo[1]

    def _decode_route(self, t: np.ndarray, L: int, check: bool) -> _Route:
        """Routing of a fused L-token step at start positions t [B]."""
        if check:
            for row in range(self.max_seqs):
                if self._decode_masked is not None and \
                        self._decode_masked[row]:
                    continue   # row presents a trash table this step
                have = len(self.seq_blocks[row])
                pos = int(t[row])
                if (have and self.blocks_needed(pos + L) > have) or \
                        (not have and pos > 0):
                    raise ValueError(
                        f"decode of {L} token(s) at position {pos} of "
                        f"row {row} is not covered by its {have} "
                        f"allocated block(s); call "
                        f"ensure(row, position+{L}) first")

        def build():
            bt = self.bt_tensor()
            tbl = self.block_tables if self._decode_masked is None else \
                np.where(self._decode_masked[:, None], 0,
                         self.block_tables)
            pos = t[:, None] + np.arange(L)[None, :]
            cols = np.minimum(pos // self.block_size, tbl.shape[1] - 1)
            blk = tbl[np.arange(self.max_seqs)[:, None], cols]
            return _Route(blk.reshape(-1), (pos % self.block_size)
                          .reshape(-1), t + L, bt, (L,) * self.max_seqs,
                          self.device)
        return self._memo(("decode", t.tobytes(), L), build)

    def _prefill_route(self, slot: int, start: int, C: int,
                       write_start: int, check: bool) -> _Route:
        have = len(self.seq_blocks[slot])
        if check and self.blocks_needed(start + C) > have:
            raise ValueError(
                f"prefill chunk [{start}, {start + C}) of slot {slot} is "
                f"not covered by its {have} allocated block(s); call "
                f"ensure() first")

        def build():
            pos = np.arange(start, start + C)
            blk = self.block_tables[slot][pos // self.block_size]
            # adopted-prefix positions write the trash block
            return _Route(np.where(pos >= write_start, blk, 0),
                          pos % self.block_size, [start + C],
                          self.bt_row_tensor(slot), (C,), self.device)
        return self._memo(("prefill", slot, start, C, write_start), build)

    # -- allocation ---------------------------------------------------
    def ensure(self, slot: int, length: int, start_block: int = 0,
               write_from: Optional[int] = None) -> None:
        """Grow slot's table to cover ``length`` tokens (allocate-on-
        write) and copy-on-write split every shared block the coming
        write range [write_from, length) touches (``write_from``
        defaults to length - 1). Table positions below ``start_block``
        are adopted prefix pages the caller never writes: no split
        there. Raises BlockOOM when the pool is exhausted (callers
        preempt) and ValueError past the per-seq table capacity."""
        if length <= 0:
            return
        need = self.blocks_needed(length)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence length {length} exceeds per-seq capacity "
                f"{self.capacity_per_seq} (max_blocks_per_seq="
                f"{self.max_blocks_per_seq})")
        have = self.seq_blocks[slot]
        if need > len(have):
            new = self.allocator.alloc(need - len(have))
            self.block_tables[slot, len(have):need] = new
            have.extend(new)
            self._charge(slot, len(new))
            self._tables_dirty()
        if write_from is None:
            write_from = int(length) - 1
        lo = max(int(write_from), 0) // self.block_size
        hi = (int(length) - 1) // self.block_size
        for bpos in range(max(lo, start_block), hi + 1):
            if self.allocator.refcount[have[bpos]] > 1:
                self._copy_block(slot, bpos)

    def truncate(self, slot: int, length: int) -> None:
        """Roll the slot back to ``length`` tokens: every block past
        blocks_needed(length) leaves the table, tail first (a shared
        page just drops one owner; a hash-indexed page reaching
        refcount 0 parks cached-free)."""
        if length < 0:
            raise ValueError(f"negative truncate length {length}")
        have = self.seq_blocks[slot]
        keep = self.blocks_needed(length)
        if keep >= len(have):
            return
        self.release_to_cache(have[keep:])
        self._charge(slot, -(len(have) - keep))
        del have[keep:]
        self.block_tables[slot, keep:] = 0
        self._tables_dirty()

    def free_seq(self, slot: int) -> None:
        if self.seq_blocks[slot]:
            self.release_to_cache(self.seq_blocks[slot])
            self._charge(slot, -len(self.seq_blocks[slot]))
            self.seq_blocks[slot] = []
            self.block_tables[slot, :] = 0
            self._tables_dirty()
        self.seq_tenant[slot] = None

    def quarantine_seq(self, slot: int) -> None:
        """Free a slot's pages with NO cached-free second chance (its
        content is suspect: a non-finite value reached its hidden).
        Solely owned blocks lose their index entry and go to the free
        list; blocks shared with other slots only drop this owner (a
        sharer's copy predates the fault: shared pages are never
        written in place)."""
        for b in self.seq_blocks[slot]:
            b = int(b)
            if self.allocator.refcount[b] == 1:
                self._on_reclaim(b)
            self.allocator.free([b], to_cache=b in self._block_hash)
        self._charge(slot, -len(self.seq_blocks[slot]))
        self.seq_blocks[slot] = []
        self.block_tables[slot, :] = 0
        self._tables_dirty()
        self.seq_tenant[slot] = None

    def fork(self, src: int, dst: int, length: int) -> None:
        """Share src's first blocks_needed(length) blocks with dst
        (refcounted, including a partial last block — the first
        divergent append splits it copy-on-write)."""
        if self.seq_blocks[dst]:
            raise ValueError(f"dst slot {dst} already allocated")
        shared = self.seq_blocks[src][:self.blocks_needed(length)]
        self.allocator.ref(shared)
        for b in shared:   # fresh share epoch for the content audit
            self._audit_fp.pop(int(b), None)
        self.seq_blocks[dst] = list(shared)
        self._charge(dst, len(shared))
        self.block_tables[dst, :len(shared)] = shared
        self._tables_dirty()

    def share_report(self, slots) -> dict:
        """Fork sharing across ``slots`` (a branch group, or any slot
        set), a pure read:

          shared_blocks   blocks referenced by >= 2 of the slots
          private_blocks  blocks referenced by exactly one
          multiplicity    {block: how many of the slots reference it}
          refcount        {block: allocator refcount} (>= multiplicity;
                          the prefix cache may hold more references)
          bytes_saved     pool bytes the sharing avoided: (multiplicity
                          - 1) block copies over the shared blocks, at
                          kv_bytes_per_token() x block_size
        """
        mult: Dict[int, int] = {}
        for slot in slots:
            for b in self.seq_blocks[int(slot)]:
                mult[int(b)] = mult.get(int(b), 0) + 1
        shared = sorted(b for b, m in mult.items() if m >= 2)
        bpb = self.kv_bytes_per_token() * self.block_size
        return {
            "shared_blocks": shared,
            "private_blocks": sorted(b for b, m in mult.items()
                                     if m == 1),
            "multiplicity": mult,
            "refcount": {b: int(self.allocator.refcount[b])
                         for b in mult},
            "bytes_saved": sum(mult[b] - 1 for b in shared) * bpb,
        }

    def _copy_block(self, slot: int, bpos: int) -> None:
        """Copy-on-write: give slot a private copy of the block at table
        position bpos (in place in every layer's pool)."""
        old = self.seq_blocks[slot][bpos]
        new = self.allocator.alloc(1)[0]
        for pool in self.pools:
            pool[new] = pool[old]
        if self.quantized:
            # the scales are part of the page's content
            for sc in self.scales:
                sc[new] = sc[old]
        self.release_to_cache([old])
        self.seq_blocks[slot][bpos] = new
        self.block_tables[slot, bpos] = new
        self._tables_dirty()

    # -- prefix caching -----------------------------------------------
    def _on_reclaim(self, block: int) -> None:
        """The allocator reclaimed a cached-free block: its content is
        about to be overwritten, so its index entry goes."""
        h = self._block_hash.pop(block, None)
        if h is not None and self._hash_to_block.get(h) == block:
            del self._hash_to_block[h]
        self._audit_fp.pop(block, None)

    def release_to_cache(self, blocks) -> None:
        """Drop ownership of ``blocks``; indexed blocks reaching
        refcount 0 park in the cached-free tier, others free normally."""
        for b in blocks:
            self.allocator.free([b], to_cache=b in self._block_hash)

    def match_prefix(self, hashes) -> List[int]:
        """Longest indexed prefix of the hash chain -> pool block ids (a
        pure lookup; ``adopt_prefix`` takes ownership)."""
        out: List[int] = []
        for h in hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def adopt_prefix(self, slot, hashes) -> int:
        """Take shared ownership of the longest indexed prefix for an
        empty slot: active blocks gain an owner, cached-free blocks are
        resurrected. Returns the number of blocks adopted."""
        if not self.prefix_cache:
            return 0
        if self.seq_blocks[slot]:
            raise ValueError(f"slot {slot} already allocated")
        matched = self.match_prefix(hashes)
        for b in matched:
            if self.allocator.refcount[b] > 0:
                self.allocator.ref([b])
                # new sharer: fresh epoch for the content audit
                self._audit_fp.pop(int(b), None)
            else:
                self.allocator.resurrect(b)
        if matched:
            self.seq_blocks[slot] = list(matched)
            self._charge(slot, len(matched))
            self.block_tables[slot, :len(matched)] = matched
            self._tables_dirty()
        return len(matched)

    def register_prefix(self, slot, hashes, start: int = 0) -> None:
        """Index the slot's blocks ``[start, len(hashes))`` under their
        chain hashes (first writer wins: a hash already indexed keeps its
        block)."""
        if not self.prefix_cache:
            return
        blocks = self.seq_blocks[slot]
        for i in range(start, min(len(hashes), len(blocks))):
            h, b = hashes[i], int(blocks[i])
            if h in self._hash_to_block or b in self._block_hash:
                continue
            self._hash_to_block[h] = b
            self._block_hash[b] = h

    # -- views ----------------------------------------------------------
    def ragged_views(self, segments, tile_q=None,
                     tile_kv=None) -> List[PagedRaggedView]:
        """Per-layer views for ONE mixed ragged model call. ``segments``
        is an ordered list of ("prefill", slot, start, length,
        write_start) chunks (positions below write_start, an adopted
        prefix, write the trash block) and at most one ("decode", lens,
        L) segment
        (L query rows per batch slot at lens[b] .. lens[b]+L-1 through
        the DECODE-MASKED batch table). The packed input is
        [1, sum(rows), d] in segment order. ``tile_q``/``tile_kv`` pass
        through to ``paged_attention_ragged``. Build AFTER ensure()ing
        coverage and setting the decode mask."""
        layout = _RaggedLayout(self, segments, tile_q=tile_q,
                               tile_kv=tile_kv)
        return [PagedRaggedView(self, i, layout)
                for i in range(self.num_layers)]

    def prefill_views(self, slot: int,
                      write_start: int = 0) -> List[PagedPrefillView]:
        """Per-layer chunked-prefill views of one slot (the ``caches=``
        list of a batch-1 chunk call); rows below ``write_start`` (an
        adopted prefix) attend but do not rewrite their pages."""
        return [PagedPrefillView(self, i, slot, write_start=write_start)
                for i in range(self.num_layers)]
