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

Port notes. The control plane (allocator, tables, refcounts, COW,
audits) is host numpy and follows the JAX class exactly. Pool writes are
IN PLACE (``pool[blk, 0, :, off, :] = k``): the JAX class rebinds a new
pool array per append, here the one pool tensor per layer is updated,
which is what keeps peak KV memory equal to the pool. The prefix-cache
index, snapshot/restore, export/import of slices, tenants' charges,
quarantine and int8 pages come in later slices; their arguments raise
NotImplementedError.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.hopper.paged_attention import RaggedPlan, paged_attention_ragged

__all__ = ["BlockOOM", "BlockAllocator", "PagedKVCache",
           "PagedLayerCache", "PagedPrefillView", "PagedRaggedView"]

_LATER = "comes in a later slice of the PyTorch port"


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
    refcount > 1 and are split copy-on-write by the cache. (The JAX
    allocator's cached-free tier belongs to the prefix cache, a later
    slice.)"""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = int(num_blocks)
        # pop() from the end -> lowest ids first (stable tests)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self.refcount = np.zeros(self.num_blocks, np.int32)
        self.refcount[0] = 1  # trash block: never allocated, never freed
        # diagnostics wired by the owning cache: context() -> str and
        # context_data() -> dict for BlockOOM, describe(block) -> str
        # for ref/free misuse errors
        self.context = None
        self.context_data = None
        self.describe = None

    def _blurb(self, block: int) -> str:
        if self.describe is None:
            return ""
        return f" ({self.describe(int(block))})"

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if n > self.num_free:
            raise BlockOOM(
                f"need {n} block(s), {self.num_free} free"
                + (self.context() if self.context is not None else ""),
                details=dict(
                    self.context_data()
                    if self.context_data is not None else {},
                    blocks_needed=int(n),
                    blocks_free=int(self.num_free)))
        blocks = []
        for _ in range(n):
            b = self._free.pop()
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

    def free(self, blocks) -> None:
        """Drop one owner per block; a block reaching refcount 0 returns
        to the free list."""
        for b in blocks:
            if b == 0:
                raise ValueError("block 0 is reserved")
            if self.refcount[b] <= 0:
                raise ValueError(f"double free of block {b}"
                                 + self._blurb(b))
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                self._free.append(int(b))


class _Route:
    """Device copies of one append's routing (pool block and in-block
    offset per written row) and of the attention's per-sequence lengths
    and tables — built once per model call and shared by every layer."""

    __slots__ = ("blk", "off", "kv_lens", "bt", "plan")

    def __init__(self, blk, off, kv_lens, bt, q_lens, device):
        self.blk = torch.from_numpy(np.asarray(blk, np.int64)).to(device)
        self.off = torch.from_numpy(np.asarray(off, np.int64)).to(device)
        self.kv_lens = torch.from_numpy(
            np.asarray(kv_lens, np.int32)).to(device)
        self.bt = bt
        self.plan = RaggedPlan(q_lens)


def _append(pool, route: _Route, k, v) -> None:
    """Packed in-place append: row r of k/v [N, H, D] lands at
    pool[blk[r], :, :, off[r], :]. Rows routed to the trash block may
    collide there; nothing reads it unmasked."""
    pool[route.blk, 0, :, route.off, :] = k.to(pool.dtype)
    pool[route.blk, 1, :, route.off, :] = v.to(pool.dtype)


class PagedLayerCache:
    """One layer's view of the paged cache for the fused batch step —
    the object that rides in ``caches=``. ``decode(q, k, v, t)`` appends
    L tokens per row at positions t[b] .. t[b]+L-1 through the (decode-
    masked) batch table and returns the attention [B, L, nh, hd]."""

    is_paged = True

    def __init__(self, cache: "PagedKVCache", layer: int):
        self._cache = cache
        self._layer = layer

    @property
    def pool(self) -> torch.Tensor:
        return self._cache.pools[self._layer]

    @property
    def shape(self):
        return self.pool.shape

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
        _append(self.pool, route, k.reshape(B * L, H, D),
                v.reshape(B * L, H, D))
        out = paged_attention_ragged(
            q.reshape(B * L, H, D), self.pool, route.bt, (L,) * B,
            route.kv_lens, plan=route.plan)
        return out.reshape(B, L, H, D)


class PagedPrefillView:
    """One layer's CHUNKED-PREFILL view of a single slot (the ``caches=``
    list of a batch-1 chunk call, ``PagedKVCache.prefill_views``): the
    chunk's C rows append straight into the slot's pages and attend
    causally at absolute positions t[0] + i."""

    is_paged = True

    def __init__(self, cache: "PagedKVCache", layer: int, slot: int):
        self._cache = cache
        self._layer = layer
        self._slot = slot

    @property
    def pool(self) -> torch.Tensor:
        return self._cache.pools[self._layer]

    @property
    def shape(self):
        return self.pool.shape

    def decode(self, q, k, v, t):
        """q/k/v: [1, C, H, D], one chunk starting at position t[0].
        PRECONDITION: ``ensure(slot, t[0]+C, write_from=t[0])``."""
        c = self._cache
        B, C = q.shape[0], q.shape[1]
        if B != 1:
            raise ValueError(
                f"chunk prefill is a batch-1 call, got batch {B}")
        start = int(_host_rows(t, 1)[0])
        route = c._prefill_route(self._slot, start, C,
                                 check=self._layer == 0)
        _append(self.pool, route, k[0], v[0])
        return paged_attention_ragged(q[0], self.pool, route.bt, (C,),
                                      route.kv_lens, plan=route.plan)[None]


class _RaggedLayout:
    """Host-side descriptors for ONE mixed ragged model call, shared by
    every layer's PagedRaggedView: the packed append routing (blk/off
    per row), the per-sequence (q_len, kv_len, block-table row)
    descriptors and the kernel's tile plan. Built once per launch from
    the cache's CURRENT tables — the caller must have ensure()d
    coverage and set the decode mask first."""

    def __init__(self, cache: "PagedKVCache", segments):
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
                _, slot, start, length = seg
                pos = np.arange(start, start + length)
                blk.append(tbl[slot][pos // bs])
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
                            kv_lens, bt, self.q_lens, cache.device)


class PagedRaggedView:
    """One layer's MIXED-BATCH view — the ``caches=`` entry of the
    scheduler's ragged step: prefill chunks of several slots AND the
    fused decode rows packed into one [1, total_rows, d] model call.
    The packed K/V append is ONE scatter through the precomputed
    routing, and the attention is ONE ``paged_attention_ragged`` launch
    per layer (the kernel on CUDA, its plain version on the CPU)."""

    is_paged = True

    def __init__(self, cache: "PagedKVCache", layer: int,
                 layout: _RaggedLayout):
        self._cache = cache
        self._layer = layer
        self._layout = layout

    @property
    def pool(self) -> torch.Tensor:
        return self._cache.pools[self._layer]

    @property
    def shape(self):
        return self.pool.shape

    def decode(self, q, k, v, t=None):
        """q/k/v: [1, R, H, D] — the packed mixed batch. ``t`` is
        ignored: the layout carries every row's absolute position."""
        lay = self._layout
        if q.shape[0] != 1 or q.shape[1] != lay.total_rows:
            raise ValueError(
                f"ragged call expects [1, {lay.total_rows}, H, D], "
                f"got {tuple(q.shape)}")
        r = lay.route
        _append(self.pool, r, k[0], v[0])
        return paged_attention_ragged(q[0], self.pool, r.bt, lay.q_lens,
                                      r.kv_lens, plan=r.plan)[None]


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
    in-place tensor scatters on ``device``."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 block_size: int, num_blocks: int, max_seqs: int,
                 max_blocks_per_seq: Optional[int] = None,
                 dtype=torch.float32, prefix_cache: bool = False,
                 device=None):
        if prefix_cache:
            raise NotImplementedError(f"prefix_cache {_LATER}")
        if str(dtype) in ("int8", "torch.int8"):
            raise NotImplementedError(f"int8 KV pages {_LATER}")
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
        self.prefix_cache = False
        self.allocator = BlockAllocator(self.num_blocks)
        self.allocator.context = self._pool_context
        self.allocator.context_data = self.pool_occupancy
        self.allocator.describe = self._describe_block
        # content fingerprints for the "never written in place" audit of
        # shared (refcount >= 2) blocks; fork re-shares drop the entry
        self._audit_fp: Dict[int, bytes] = {}
        self.pools: List[torch.Tensor] = [
            torch.zeros((self.num_blocks, 2, self.num_heads,
                         self.block_size, self.head_dim), dtype=dtype,
                        device=self.device)
            for _ in range(self.num_layers)]
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

    # -- construction -------------------------------------------------
    @classmethod
    def for_model(cls, model, block_size, num_blocks, max_seqs,
                  max_blocks_per_seq=None, dtype=torch.float32,
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
            "free": a.num_free,
            "usable": self.num_blocks - 1,
        }
        if not tiers_only:
            out["blocks_per_slot"] = {
                s: len(bl) for s, bl in enumerate(self.seq_blocks) if bl}
        return out

    def _pool_context(self) -> str:
        occ = self.pool_occupancy()
        return (f"; pool: {occ['active']} active / {occ['free']} free "
                f"of {occ['usable']} usable; blocks per slot: "
                f"{occ['blocks_per_slot'] or '{}'}")

    def _describe_block(self, block: int) -> str:
        owners = self.owners_of(block)
        own = f"owned by slot(s) {owners}" if owners else "no owner"
        return f"refcount {int(self.allocator.refcount[block])}, {own}"

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
          2. the free list and the active set partition the usable
             blocks;
          3. trash block 0 keeps refcount 1 and is in no table or the
             free list;
          4. block_tables[slot] is seq_blocks[slot] then trash;
          5. with ``lens``/``active``: every active slot's table covers
             blocks_needed(lens[slot]);
          6. ``deep``: shared (refcount >= 2) blocks are fingerprinted
             and re-verified while they stay shared — an in-place write
             to a shared page trips it.
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
        free_set = set(a._free)
        active_set = {b for b in range(1, self.num_blocks)
                      if a.refcount[b] > 0}
        assert len(free_set) == len(a._free), "free list holds duplicates"
        assert a.refcount[0] == 1 and 0 not in free_set, \
            "trash block 0 left its reserved state"
        for b in range(1, self.num_blocks):
            assert int(a.refcount[b]) == counts.get(b, 0), \
                (f"block {b} refcount {int(a.refcount[b])} != "
                 f"{counts.get(b, 0)} table reference(s) "
                 f"(slots {self.owners_of(b)})")
        assert not (free_set & active_set), "free / active sets overlap"
        assert free_set | active_set == set(range(1, self.num_blocks)), \
            "free / active sets do not cover the pool"
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
                      if a.refcount[b] >= 2}
            for b in list(self._audit_fp):
                if b not in frozen:
                    del self._audit_fp[b]
            if frozen:
                ids = torch.tensor(sorted(frozen), device=self.device)
                arrs = [p[ids].cpu().numpy() for p in self.pools]
                for i, b in enumerate(sorted(frozen)):
                    fp = self._fingerprint(i, arrs)
                    old = self._audit_fp.get(b)
                    assert old is None or old == fp, \
                        (f"shared block {b} was written in place "
                         f"({self._describe_block(b)})")
                    self._audit_fp[b] = fp
        return True

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
                       check: bool) -> _Route:
        have = len(self.seq_blocks[slot])
        if check and self.blocks_needed(start + C) > have:
            raise ValueError(
                f"prefill chunk [{start}, {start + C}) of slot {slot} is "
                f"not covered by its {have} allocated block(s); call "
                f"ensure() first")

        def build():
            pos = np.arange(start, start + C)
            return _Route(self.block_tables[slot][pos // self.block_size],
                          pos % self.block_size, [start + C],
                          self.bt_row_tensor(slot), (C,), self.device)
        return self._memo(("prefill", slot, start, C), build)

    # -- allocation ---------------------------------------------------
    def ensure(self, slot: int, length: int,
               write_from: Optional[int] = None) -> None:
        """Grow slot's table to cover ``length`` tokens (allocate-on-
        write) and copy-on-write split every shared block the coming
        write range [write_from, length) touches (``write_from``
        defaults to length - 1). Raises BlockOOM when the pool is
        exhausted (callers preempt) and ValueError past the per-seq
        table capacity."""
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
            self._tables_dirty()
        if write_from is None:
            write_from = int(length) - 1
        lo = max(int(write_from), 0) // self.block_size
        hi = (int(length) - 1) // self.block_size
        for bpos in range(lo, hi + 1):
            if self.allocator.refcount[have[bpos]] > 1:
                self._copy_block(slot, bpos)

    def truncate(self, slot: int, length: int) -> None:
        """Roll the slot back to ``length`` tokens: every block past
        blocks_needed(length) leaves the table, tail first (a shared
        page just drops one owner)."""
        if length < 0:
            raise ValueError(f"negative truncate length {length}")
        have = self.seq_blocks[slot]
        keep = self.blocks_needed(length)
        if keep >= len(have):
            return
        self.allocator.free(have[keep:])
        del have[keep:]
        self.block_tables[slot, keep:] = 0
        self._tables_dirty()

    def free_seq(self, slot: int) -> None:
        if self.seq_blocks[slot]:
            self.allocator.free(self.seq_blocks[slot])
            self.seq_blocks[slot] = []
            self.block_tables[slot, :] = 0
            self._tables_dirty()

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
        self.block_tables[dst, :len(shared)] = shared
        self._tables_dirty()

    def _copy_block(self, slot: int, bpos: int) -> None:
        """Copy-on-write: give slot a private copy of the block at table
        position bpos (in place in every layer's pool)."""
        old = self.seq_blocks[slot][bpos]
        new = self.allocator.alloc(1)[0]
        for pool in self.pools:
            pool[new] = pool[old]
        self.allocator.free([old])
        self.seq_blocks[slot][bpos] = new
        self.block_tables[slot, bpos] = new
        self._tables_dirty()

    # -- views ----------------------------------------------------------
    def ragged_views(self, segments) -> List[PagedRaggedView]:
        """Per-layer views for ONE mixed ragged model call. ``segments``
        is an ordered list of ("prefill", slot, start, length) chunks
        and at most one ("decode", lens, L) segment
        (L query rows per batch slot at lens[b] .. lens[b]+L-1 through
        the DECODE-MASKED batch table). The packed input is
        [1, sum(rows), d] in segment order. Build AFTER ensure()ing
        coverage and setting the decode mask."""
        layout = _RaggedLayout(self, segments)
        return [PagedRaggedView(self, i, layout)
                for i in range(self.num_layers)]

    def prefill_views(self, slot: int) -> List[PagedPrefillView]:
        """Per-layer chunked-prefill views of one slot (the ``caches=``
        list of a batch-1 chunk call)."""
        return [PagedPrefillView(self, i, slot)
                for i in range(self.num_layers)]
