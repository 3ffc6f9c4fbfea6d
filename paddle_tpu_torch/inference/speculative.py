"""Speculative decoding over the paged serving engine, behind a
token-ID serving surface (counterpart of
paddle_tpu/inference/speculative.py).

* ``TokenServingModel`` owns the embedding table and the readout head,
  so callers speak token ids while the engines speak embeddings;
  ``logits``/``probs`` run on the model's device, greedy sampling is an
  on-device argmax, and stochastic sampling draws on the host from an
  explicit ``np.random.RandomState``. ``truncated_draft(n)`` is a draft
  sharing the target's first n layers.
* ``SpeculativeEngine`` — draft / verify / rollback: per round the draft
  rolls k tokens ahead through its own paged pool, ONE target call
  (``PagedServingEngine.step_multi``) verifies all k+1 positions, the
  longest agreeing prefix is accepted (rejection sampling in the sampled
  modes) and the rejected tail is rolled back page-wise
  (``PagedServingEngine.rollback``). ``k=0`` serves plain token-ID paged
  decode. ``submit(token_ids)``, ``step() -> {rid: [tokens]}``,
  ``tokens(rid)``, ``release(rid)``.
* Parallel decoding: ``submit(..., n=4)`` serves a branch group over
  shared prompt pages; ``seed`` gives branch i the RNG lane
  ``branch_lane_seed(seed, i)`` (the group's streams are those of n
  lone submits with those seeds), ``best_of`` races the branches (the
  first to finish wins, the others are cancelled), ``logit_mask`` names
  a ``register_logit_mask`` grammar applied at every sampling site.
  ``fork_stream(rid)`` clones a running stream, ``cancel(rid)`` stops
  one, ``group(gid)`` reads a group's record.

* Resilience and tenants ride the wrapped engine: ``injector`` (the
  draft pool's allocator gets the injector's draft schedule, and draft
  logits its NaN schedule), ``numeric_guard``, ``tenants`` and
  ``set_tenant``, ``submit``'s deadlines and ``tenant_id``. A draft-pool
  OOM mid-roll rolls the partial roll back page-wise and the round
  verifies the pending token only (``stats.draft_oom_rolls``).
* ``snapshot``/``restore``: the wrapped engine's snapshot (the target
  pool included), the token streams, the RNG states and the groups, with
  the JAX engine's keys; the draft pool is rebuilt from the streams, not
  serialized. ``submit(resume=True)`` hands over a running stream whose
  last token is pending; ``export_slice``/``import_slice`` move its
  finished prefix pages.

Not ported yet: telemetry spans, the health monitor and the cost ledger
(their parameters raise for any value but None).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework.unported import require_defaults
from .paged_cache import BlockOOM, PagedKVCache
from .resilience import RequestOutcome
from .scheduler import PagedServingEngine, chunked_prefill
from .serving import SpecDecodeStats
from .telemetry import MetricsRegistry

__all__ = ["TokenServingModel", "SpeculativeEngine", "SpecDecodeStats",
           "branch_lane_seed", "register_logit_mask", "logit_mask_fn"]


def branch_lane_seed(seed: int, branch: int) -> int:
    """RNG-lane seed of branch ``branch`` of a group submitted with
    ``seed``: branch 0 is the seed itself (a lone seeded request is lane
    0 of a group of one), later branches step by the golden-ratio
    increment. An n-branch group's streams are those of n lone submits
    seeded ``branch_lane_seed(seed, i)``."""
    return (int(seed) + 0x9E3779B9 * int(branch)) % (2 ** 32)


# Grammar masks register by name: ``fn(tokens_so_far, vocab_size) ->
# bool[vocab_size]``, True where the next token is allowed (at least
# one must be).
_LOGIT_MASKS: Dict[str, object] = {}


def register_logit_mask(name: str, fn) -> None:
    """Register ``fn(tokens_so_far: List[int], vocab_size: int) ->
    bool[vocab_size]`` under ``name``. Sampling adds it to the logits on
    the device (0 allowed, -1e30 banned) before argmax or softmax, on
    every stream that names it: the first token, draft proposals, the
    verify sample and the rejection residual."""
    if not callable(fn):
        raise ValueError("logit mask must be callable")
    _LOGIT_MASKS[str(name)] = fn


def logit_mask_fn(name: str):
    """The mask registered under ``name`` (KeyError names a miss)."""
    try:
        return _LOGIT_MASKS[name]
    except KeyError:
        raise KeyError(
            f"unknown logit mask {name!r} — register_logit_mask() it "
            f"before submit") from None


class TokenServingModel:
    """Token-ID serving surface over a FusedMultiTransformer-protocol
    core: the embedding table [vocab, d_model] stays a host array (the
    engines take host prompt rows), the readout head [d_model, vocab]
    lives on the core's device — tied to the embedding transpose when
    not given, int8 with ``weight_dtype="int8"``."""

    def __init__(self, model, embedding, lm_head=None,
                 weight_dtype: str = "float32"):
        self.core = model
        emb = np.asarray(embedding.cpu().numpy() if isinstance(
            embedding, torch.Tensor) else embedding, np.float32)
        if emb.ndim != 2:
            raise ValueError("embedding must be [vocab, d_model]")
        self._embed_np = emb
        head_shape = (emb.shape[1], emb.shape[0])
        head = emb.T if lm_head is None else lm_head
        head = torch.as_tensor(np.ascontiguousarray(head, np.float32)
                               if not isinstance(head, torch.Tensor)
                               else head)
        if tuple(head.shape) != head_shape:
            raise ValueError(f"lm_head must be [d_model, vocab] = "
                             f"{head_shape}, got {tuple(head.shape)}")
        self.lm_head = head.to(device=model.device,
                               dtype=torch.float32).contiguous()
        # weight_dtype="int8": the head is stored int8 with per-output-
        # channel (per-vocab-column) symmetric scales, quantized exactly
        # as the JAX class does (numpy float32, round(w * 127 / amax),
        # clipped to +-127; the scale is the channel's amax, qmax folds
        # in inside quantized_matmul), and logits run through the w8a16
        # kernel
        if weight_dtype not in ("float32", "int8"):
            raise ValueError(f"unsupported weight_dtype "
                             f"{weight_dtype!r} (float32 | int8)")
        self.weight_dtype = weight_dtype
        self._head_int8: Optional[torch.Tensor] = None
        self._head_scale: Optional[torch.Tensor] = None
        if weight_dtype == "int8":
            w = self.lm_head.cpu().numpy().astype(np.float32)
            amax = np.abs(w).max(axis=0)             # per out-channel
            q = np.clip(np.round(w * (127.0 / np.maximum(amax, 1e-30))
                                 [None]), -127, 127).astype(np.int8)
            self._head_int8 = torch.from_numpy(q).to(model.device)
            self._head_scale = torch.from_numpy(
                amax.astype(np.float32)).to(model.device)

    def weight_bytes(self) -> int:
        """Device bytes of the readout head as served: int8 payload plus
        per-channel scales when quantized, else the float32 head."""
        if self._head_int8 is not None:
            return self._head_int8.numel() + 4 * self._head_scale.numel()
        return self.lm_head.numel() * 4

    @property
    def vocab_size(self) -> int:
        return self._embed_np.shape[0]

    @property
    def d_model(self) -> int:
        return self._embed_np.shape[1]

    def embed(self, token_ids) -> np.ndarray:
        """Token ids -> float32 embedding rows [..., d_model] (host)."""
        ids = np.asarray(token_ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.vocab_size):
            raise ValueError("token id out of range")
        return self._embed_np[ids]

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden [..., d_model] -> logits [..., vocab] on the device
        (the int8 head through ``quantized_matmul``)."""
        if self._head_int8 is None:
            return torch.matmul(hidden, self.lm_head)
        from ..quantization.functional import quantized_matmul
        return quantized_matmul(hidden, self._head_int8, self._head_scale)

    def probs(self, logits: torch.Tensor, temperature: float = 1.0,
              top_k: Optional[int] = None) -> torch.Tensor:
        """Temperature-scaled, top-k-masked softmax over the last axis."""
        z = logits
        if temperature != 1.0:
            if temperature <= 0:
                raise ValueError("temperature must be > 0 (use "
                                 "mode='greedy' for argmax decoding)")
            z = z / temperature
        if top_k is not None and top_k < self.vocab_size:
            kth = torch.topk(z, top_k, dim=-1).values.min(
                dim=-1, keepdim=True).values
            z = torch.where(z < kth, torch.full_like(z, -1e30), z)
        return torch.softmax(z, dim=-1)

    def sample(self, logits: torch.Tensor, mode: str = "greedy",
               temperature: float = 1.0, top_k: Optional[int] = None,
               rng: Optional[np.random.RandomState] = None,
               rng_rows: Optional[list] = None, logit_mask=None
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """logits [..., vocab] -> (token ids int64 [...], probs float32
        [..., vocab] or None). Greedy is an on-device argmax; the
        stochastic modes build the distribution on the device and draw
        per row on the host with ``rng`` (inverse CDF).

        ``rng_rows``: one RandomState or None per flat row; a row with a
        lane draws its uniform from it, the others from ``rng`` in row
        order (so all-None rows draw as the batched path does).
        ``logit_mask``: bool array of the logits' shape, True where a
        token is allowed, added on the device as 0 / -1e30 before argmax
        or softmax."""
        if logit_mask is not None:
            neg = np.where(np.asarray(logit_mask, bool), 0.0,
                           -1e30).astype(np.float32)
            logits = logits + torch.from_numpy(neg).to(logits.device)
        if mode == "greedy":
            return logits.argmax(dim=-1).cpu().numpy().astype(np.int64), \
                None
        if mode not in ("sample", "top_k", "temperature"):
            raise ValueError(f"unknown sampling mode {mode!r}")
        p = self.probs(logits, temperature, top_k).cpu().numpy().astype(
            np.float32)
        if rng is None:
            rng = np.random
        flat = p.reshape(-1, p.shape[-1]).astype(np.float64)
        flat = flat / flat.sum(axis=-1, keepdims=True)
        if rng_rows is None:
            u = rng.random_sample(flat.shape[0])
        else:
            if len(rng_rows) != flat.shape[0]:
                raise ValueError(
                    f"rng_rows needs one entry per flat row "
                    f"({flat.shape[0]}), got {len(rng_rows)}")
            u = np.array([(rng if r is None else r).random_sample()
                          for r in rng_rows], np.float64)
        cdf = np.cumsum(flat, axis=-1)
        toks = np.array([np.searchsorted(cdf[i], u[i], side="right")
                         for i in range(flat.shape[0])], np.int64)
        toks = np.minimum(toks, p.shape[-1] - 1)
        return toks.reshape(p.shape[:-1]), p

    def truncated_draft(self, num_layers: int) -> "TokenServingModel":
        """A draft that runs only the first ``num_layers`` of the core
        behind the same embedding and readout, sharing every weight with
        the target (``core.truncated``: the same block modules; an MoE
        core hands back its own routed twin). The cheapest draft: useful
        when the deep layers refine rather than redirect the argmax."""
        if num_layers >= self.core.num_layers:
            raise ValueError("draft must be shallower than the target")
        draft = TokenServingModel(self.core.truncated(num_layers),
                                  self._embed_np, self.lm_head)
        if self._head_int8 is not None:
            draft.weight_dtype = self.weight_dtype
            draft._head_int8, draft._head_scale = (self._head_int8,
                                                   self._head_scale)
        return draft


class _SpecSeq:
    """Host-side token state of one request: the full stream (prompt +
    every emitted token; the LAST entry is the pending token — emitted
    to the caller but not yet consumed by the models). Branch-group
    members also carry their group id, branch index, RNG lane and the
    name of their grammar mask."""

    __slots__ = ("rid", "toks", "prompt_len", "slot", "started",
                 "lane", "gid", "branch", "mask")

    def __init__(self, rid: int, prompt: List[int]):
        self.rid = rid
        self.toks: List[int] = list(prompt)
        self.prompt_len = len(prompt)
        self.slot: Optional[int] = None
        self.started = False    # first token sampled at admission?
        self.lane: Optional[np.random.RandomState] = None
        self.gid: Optional[int] = None
        self.branch = 0
        self.mask: Optional[str] = None


class SpeculativeEngine:
    """Draft/verify/rollback speculative decoding behind a token-ID API.
    ``target``/``draft`` are TokenServingModels; ``draft=None`` with
    ``k > 0`` self-drafts with the target (a correctness harness:
    acceptance ~100% in greedy mode, no speedup); ``k=0`` serves plain
    token-ID paged decode.

    A round (``step``) rolls the draft k tokens ahead through its own
    float paged pool (the target's may be int8), verifies the pending
    token plus all k proposals in ONE target call
    (``PagedServingEngine.step_multi``: k+1 query rows per slot, packed
    beside prefill chunks in token-budget mode), accepts the longest
    agreeing prefix (greedy) or by rejection sampling (sampled modes),
    and rolls the rejected tail back page-wise in both pools. With
    greedy sampling the emitted stream is the plain (k=0) stream
    whatever the draft proposes: every emitted token is an argmax of
    TARGET logits.

    Admission, chunked prefill, the token-budget mixed step, preemption
    with re-prefill, int8 KV pages (``kv_dtype="int8"``) and the prefix
    cache (``prefix_cache=True``) come from the wrapped
    ``PagedServingEngine``; on a preemption the draft slot is dropped
    and rebuilt from the token stream at re-admission. Capacity-finished
    requests land in ``finished`` as (rid, total_tokens); terminal
    outcomes in ``outcomes``; accounting in ``stats``."""

    def __init__(self, target: TokenServingModel,
                 draft: Optional[TokenServingModel] = None, *,
                 k: int = 4, max_batch: int, block_size: int,
                 num_blocks: int,
                 max_blocks_per_seq: Optional[int] = None,
                 draft_num_blocks: Optional[int] = None,
                 prefix_cache: bool = False, sampling: str = "greedy",
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 watermark_blocks: int = 0,
                 chunk_tokens: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 kv_dtype="float32", seed: int = 0,
                 injector=None,
                 max_preemptions: Optional[int] = None,
                 numeric_guard: Optional[bool] = None,
                 tenants: Optional[dict] = None,
                 collector=None, monitor=None, ledger=None):
        # the trace collector, health monitor and cost ledger are not
        # ported
        require_defaults("SpeculativeEngine",
                         collector=(collector, None),
                         monitor=(monitor, None), ledger=(ledger, None))
        if k < 0:
            raise ValueError("k must be >= 0")
        self.target = target
        self.k = int(k)
        self.draft = (draft if draft is not None else target) \
            if self.k > 0 else None
        self.sampling = sampling
        self.temperature = float(temperature)
        self.top_k = top_k
        self._rng = np.random.RandomState(seed)
        self.injector = injector
        self.engine = PagedServingEngine(
            target.core, max_batch, block_size, num_blocks,
            max_blocks_per_seq=max_blocks_per_seq, dtype=kv_dtype,
            watermark_blocks=watermark_blocks, prefix_cache=prefix_cache,
            chunk_tokens=chunk_tokens,
            prefill_token_budget=prefill_token_budget,
            injector=injector, max_preemptions=max_preemptions,
            numeric_guard=numeric_guard, tenants=tenants)
        self.max_batch = self.engine.max_batch
        self.stats = SpecDecodeStats()
        self.engine.registry.attach("spec", self.stats)
        self.finished: List[Tuple[int, int]] = []
        self.outcomes: List[RequestOutcome] = []
        self._seqs: Dict[int, _SpecSeq] = {}     # by target slot
        self._by_rid: Dict[int, _SpecSeq] = {}
        # draft slots whose cache could not be (re)built after a
        # draft-pool OOM: they serve unspeculated until a rebuild lands
        self._draft_dirty: set = set()
        # branch groups by gid: seed, mask, best-of policy and member
        # rids (the slot-level records live in the engine's _GroupTable)
        self._groups: Dict[int, dict] = {}
        self.draft_cache: Optional[PagedKVCache] = None
        if self.k > 0:
            # the draft's own float pool: the target's per-sequence page
            # capacity, fully reservable for every slot by default, so
            # the TARGET pool stays the only preemption authority
            mbps = self.engine.cache.max_blocks_per_seq
            if draft_num_blocks is None:
                draft_num_blocks = self.max_batch * mbps + 1
            self.draft_cache = PagedKVCache.for_model(
                self.draft.core, block_size, draft_num_blocks,
                max_seqs=self.max_batch, max_blocks_per_seq=mbps)
            self._draft_lens = np.zeros(self.max_batch, np.int32)
            if injector is not None:
                self.draft_cache.allocator.fault_hook = \
                    lambda n: injector.on_alloc("draft", n)

    # -- submission / events ------------------------------------------
    def submit(self, token_ids, *,
               max_preemptions: Optional[int] = None,
               deadline_steps: Optional[int] = None,
               deadline_s: Optional[float] = None,
               tenant_id: Optional[str] = None,
               resume: bool = False, n: int = 1,
               seed: Optional[int] = None, best_of: bool = False,
               logit_mask: Optional[str] = None) -> int:
        """Queue a token-ID prompt; admission (now or later) samples the
        first token from the prefill's last hidden and prefills the
        draft cache.

        ``n`` > 1 submits a branch group (the engine's ``submit(n=)``):
        each branch samples its first token from the shared prefill
        hidden; the returned rid is the lead's, the group id, and the
        branch rids appear in ``group(gid)["rids"]`` as they fork.
        ``seed`` gives branch i the lane ``branch_lane_seed(seed, i)``
        (a lone request: lane 0); unseeded streams draw from the
        engine's RandomState. ``best_of``: the first member to finish
        wins, the others are cancelled. ``logit_mask`` names a
        registered mask applied to every branch. ``max_preemptions``,
        the deadlines and ``tenant_id`` pass to the wrapped engine's
        ``submit``; terminal outcomes land in ``outcomes``.

        ``resume=True`` hands over a stream that ran on another engine:
        the LAST token of ``token_ids`` is sampled but not yet consumed
        (the pending token), so admission prefills ``token_ids[:-1]``
        and samples nothing; the first round consumes the pending token
        through the decode path, as the donor engine would have (a
        fresh submit would sample it from a prefill hidden instead).
        Needs >= 2 tokens."""
        toks = [int(t) for t in np.asarray(token_ids).reshape(-1)]
        if not toks:
            raise ValueError("empty prompt")
        if resume and len(toks) < 2:
            raise ValueError(
                "resume=True needs >= 2 tokens: a nonempty consumed "
                "prefix plus the pending (sampled, unconsumed) token")
        if resume and n > 1:
            raise ValueError("a resumed (handed-off) stream is one "
                             "branch — submit it with n=1")
        if best_of and n <= 1:
            raise ValueError("best_of needs n > 1 branches to race")
        if logit_mask is not None:
            logit_mask_fn(logit_mask)   # an unknown name fails now
        prefix = toks[:-1] if resume else toks
        rid = self.engine.submit(self.target.embed(prefix),
                                 max_preemptions=max_preemptions,
                                 deadline_steps=deadline_steps,
                                 deadline_s=deadline_s,
                                 tenant_id=tenant_id, n=n)
        seq = _SpecSeq(rid, toks)
        seq.mask = logit_mask
        if seed is not None:
            seq.lane = np.random.RandomState(branch_lane_seed(seed, 0))
        if n > 1:
            seq.gid = rid
            self._groups[rid] = {
                "gid": rid, "n": int(n), "seed": seed,
                "best_of": bool(best_of), "mask": logit_mask,
                "prompt": list(toks), "rids": [rid],
                "next_branch": 1, "done": False, "winner": None,
                "released": []}
        if resume:
            # this engine generated none of the handed-off stream, and
            # the pending token is toks[-1]: no admission sample
            seq.prompt_len = len(toks)
            seq.started = True
        self._by_rid[rid] = seq
        self._handle_events()
        return rid

    def set_tenant(self, tenant_id: str, **cfg):
        """Register or reconfigure a tenant on the wrapped engine (the
        target pool is the quota domain; the draft pool carries
        attribution only)."""
        return self.engine.set_tenant(tenant_id, **cfg)

    @property
    def tenant_stats(self):
        return self.engine.tenant_stats

    def tenant_report(self):
        return self.engine.tenant_report()

    def export_slice(self, rid: int) -> Optional[dict]:
        """Migration export of ``rid``'s finished prefix pages from the
        target pool (the draft pool is rebuilt from the token stream
        wherever the request lands)."""
        return self.engine.export_request_slice(rid)

    def import_slice(self, slc: dict) -> int:
        """Adopt a migrated slice into the target pool."""
        return self.engine.import_slice(slc)

    def tokens(self, rid: int) -> List[int]:
        """Full stream (prompt + generated) of a request."""
        return list(self._by_rid[rid].toks)

    def generated(self, rid: int) -> List[int]:
        seq = self._by_rid[rid]
        return list(seq.toks[seq.prompt_len:])

    def release(self, rid: int) -> None:
        """Caller-side finish: free the request's pages (both pools) and
        refill. A request released while still queued leaves the queue
        too. A group's record drains when its last member is released."""
        seq = self._by_rid.pop(rid)
        g = self._groups.get(seq.gid) if seq.gid is not None else None
        if g is not None:
            g["released"].append(rid)
            if set(g["rids"]) <= set(g["released"]):
                del self._groups[seq.gid]
        if seq.slot is not None:
            slot = seq.slot
            self._seqs.pop(slot, None)
            seq.slot = None
            self._clear_draft_slot(slot)
            self.engine.release(slot)
        else:
            for req in self.engine.queue:
                if req.rid == rid:
                    self.engine._dequeue(req)
        self._handle_events()

    def group(self, gid: int) -> Optional[dict]:
        """A copy of the live branch group's record (None once every
        member is released): member ``rids`` in branch order, the
        best-of ``winner``, ``done``, the seed and the mask."""
        g = self._groups.get(gid)
        return None if g is None else dict(g)

    def cancel(self, rid: int) -> bool:
        """Stop one stream early (the engine's ``cancel``: pages freed,
        CANCELLED outcome); its tokens stay readable until
        ``release(rid)``. False for an unknown or terminal rid."""
        ok = self.engine.cancel(rid)
        self._handle_events()
        return ok

    def fork_stream(self, rid: int) -> int:
        """Clone the running stream ``rid`` (the engine's
        ``fork_stream``: pages shared at the current length, fresh rid,
        the source's group grows by the clone). The clone copies the
        token stream with its pending token and the grammar mask; its
        lane is ``branch_lane_seed(seed, branch)`` in a seeded group, a
        copy of the source's lane state in an unseeded one, none for a
        laneless source; its draft cache is rebuilt from the stream.
        Returns the clone's rid."""
        seq = self._by_rid[rid]
        if seq.slot is None:
            raise ValueError(f"rid {rid} is not an active stream")
        brid = self.engine.fork_stream(rid)
        bslot = next(s for s, r in enumerate(self.engine._requests)
                     if r is not None and r.rid == brid)
        breq = self.engine._requests[bslot]
        gid = breq.gid
        seq.gid = gid
        g = self._groups.get(gid)
        if g is None:
            # a group on demand for a lone stream: seedless (a lone
            # seeded stream's clones copy its lane state instead)
            g = {"gid": gid, "n": 1, "seed": None, "best_of": False,
                 "mask": seq.mask,
                 "prompt": list(seq.toks[:seq.prompt_len]),
                 "rids": [rid], "next_branch": 1, "done": False,
                 "winner": None, "released": []}
            self._groups[gid] = g
        g["n"] += 1
        g["next_branch"] = max(g["next_branch"], breq.branch + 1)
        g["rids"].append(brid)
        clone = _SpecSeq(brid, [])
        clone.toks = list(seq.toks)
        clone.prompt_len = seq.prompt_len
        clone.started = True
        clone.slot = bslot
        clone.gid = gid
        clone.branch = breq.branch
        clone.mask = seq.mask
        if g["seed"] is not None:
            clone.lane = np.random.RandomState(
                branch_lane_seed(g["seed"], breq.branch))
        elif seq.lane is not None:
            clone.lane = np.random.RandomState(0)
            clone.lane.set_state(seq.lane.get_state())
        self._by_rid[brid] = clone
        self._seqs[bslot] = clone
        self._rebuild_draft(bslot)
        return brid

    def _clear_draft_slot(self, slot: int) -> None:
        if self.draft_cache is not None:
            self.draft_cache.free_seq(slot)
            self._draft_lens[slot] = 0
        self._draft_dirty.discard(slot)

    def _detach(self, seq: _SpecSeq) -> None:
        """Drop a stream's slot (both pools' view of it); its host-side
        tokens stay readable."""
        if seq.slot is not None:
            self._seqs.pop(seq.slot, None)
            self._clear_draft_slot(seq.slot)
            seq.slot = None

    def _sample(self, model: TokenServingModel, logits,
                rng_rows: Optional[list] = None, logit_mask=None):
        return model.sample(logits, mode=self.sampling,
                            temperature=self.temperature,
                            top_k=self.top_k, rng=self._rng,
                            rng_rows=rng_rows, logit_mask=logit_mask)

    def _lane_rows(self, slots, L: int) -> Optional[list]:
        """Per-flat-row lanes of a [max_batch, L]-row sample: row
        s*L + l draws from slot s's lane, laneless and inactive rows from
        the engine's RandomState. None when no active stream has a lane
        (the batched draw)."""
        if not any(self._seqs[s].lane is not None for s in slots):
            return None
        rows: List[Optional[np.random.RandomState]] = \
            [None] * (self.max_batch * L)
        for s in slots:
            lane = self._seqs[s].lane
            if lane is not None:
                for pos in range(L):
                    rows[s * L + pos] = lane
        return rows

    def _mask_next(self, model: TokenServingModel, slots,
                   extra: Dict[int, List[int]]):
        """bool [max_batch, vocab] mask for one next token per slot
        (the draft roll): row s masks the token after stream(s) +
        extra[s]. None when no active stream has a mask."""
        masked = [s for s in slots if self._seqs[s].mask is not None]
        if not masked:
            return None
        V = model.vocab_size
        m = np.ones((self.max_batch, V), bool)
        for s in masked:
            seq = self._seqs[s]
            m[s] = np.asarray(logit_mask_fn(seq.mask)(
                list(seq.toks) + list(extra.get(s, [])), V), bool)
        return m

    def _mask_rows(self, model: TokenServingModel, slots,
                   drafts: Dict[int, List[int]], L: int):
        """bool [max_batch, L, vocab] mask for the verify sample: row
        (s, l) masks the token after stream(s) + drafts[s][:l]. None
        when no active stream has a mask."""
        masked = [s for s in slots if self._seqs[s].mask is not None]
        if not masked:
            return None
        V = model.vocab_size
        m = np.ones((self.max_batch, L, V), bool)
        for s in masked:
            seq = self._seqs[s]
            fn = logit_mask_fn(seq.mask)
            for pos in range(L):
                m[s, pos] = np.asarray(
                    fn(list(seq.toks) + drafts[s][:pos], V), bool)
        return m

    def _handle_events(self) -> None:
        """Reconcile wrapped-engine events: preemptions and failures
        detach the stream from its slot (its tokens and pending token
        survive host-side); admissions of fresh requests sample the first
        token (a re-admitted request keeps its pending token) and build
        the draft cache from the stream."""
        eng = self.engine
        for rid in eng.preempted:
            seq = self._by_rid.get(rid)
            if seq is not None:
                self._detach(seq)
        eng.preempted.clear()
        for oc in eng.outcomes:
            if oc.failed:
                seq = self._by_rid.get(oc.rid)
                if seq is not None:
                    self._detach(seq)
            self.outcomes.append(oc)
        eng.outcomes.clear()
        for rid, slot, length in eng.finished:
            seq = self._by_rid.get(rid)
            if seq is not None:
                self._detach(seq)
                self.finished.append((rid, len(seq.toks)))
                self._member_done(seq)
        eng.finished.clear()
        for rid, slot, h in eng.admitted:
            seq = self._by_rid.get(rid)
            if seq is None:
                seq = self._adopt_branch(rid)
            # an event is stale when its request was preempted in the
            # same engine step after its prefill landed: the slot is
            # then empty, another request's, or this request's again but
            # still re-prefilling (its own admitted event comes later)
            req = eng._requests[slot]
            live = eng.active[slot] and req is not None and req.rid == rid
            if seq is None:
                if live:
                    eng.release(slot)      # released while queued
                continue
            if not seq.started:
                # the prefill did land: its last hidden gives the first
                # token even when the event is stale
                m = None
                if seq.mask is not None:
                    m = np.asarray(logit_mask_fn(seq.mask)(
                        list(seq.toks), self.target.vocab_size),
                        bool)[None]
                rows = None if seq.lane is None else [seq.lane]
                tok, _ = self._sample(self.target, self.logits_of(h),
                                      rng_rows=rows, logit_mask=m)
                seq.toks.append(int(tok.reshape(-1)[0]))
                seq.started = True
            if live:
                seq.slot = slot
                self._seqs[slot] = seq
                self._rebuild_draft(slot)
        eng.admitted.clear()

    def _adopt_branch(self, rid: int) -> Optional[_SpecSeq]:
        """First sight of a branch rid the engine's fork minted: its
        stream state (the prompt, the next branch index, the lane
        ``branch_lane_seed(seed, branch)``, the group's mask). None for
        a rid of no live group."""
        gid = self.engine.groups.gid_of(rid)
        g = self._groups.get(gid) if gid is not None else None
        if g is None:
            return None
        branch = g["next_branch"]
        g["next_branch"] = branch + 1
        g["rids"].append(rid)
        seq = _SpecSeq(rid, g["prompt"])
        seq.gid = g["gid"]
        seq.branch = branch
        seq.mask = g["mask"]
        if g["seed"] is not None:
            seq.lane = np.random.RandomState(
                branch_lane_seed(g["seed"], branch))
        self._by_rid[rid] = seq
        return seq

    def _member_done(self, seq: _SpecSeq) -> None:
        """A member finished: under ``best_of`` the first to finish
        wins and every other member still held is cancelled (their
        outcomes drain on the next ``_handle_events``)."""
        g = self._groups.get(seq.gid) if seq.gid is not None else None
        if g is None or not g["best_of"] or g["done"]:
            return
        g["done"] = True
        g["winner"] = seq.rid
        for rid in list(g["rids"]):
            if rid != seq.rid and rid in self._by_rid:
                self.engine.cancel(rid)

    def logits_of(self, hidden) -> torch.Tensor:
        return self.target.logits(hidden)

    @property
    def resilience_stats(self):
        return self.engine.resilience_stats

    @property
    def registry(self) -> MetricsRegistry:
        """The wrapped engine's MetricsRegistry, with this layer's
        SpecDecodeStats attached under ``spec``."""
        return self.engine.registry

    def check_invariants(self) -> bool:
        """Audit the wrapped engine and BOTH pools; the draft pool also
        keeps slot alignment (a tracked stream's draft table covers its
        draft length; untracked slots hold no draft pages)."""
        self.engine.check_invariants()
        if self.draft_cache is not None:
            tracked = np.zeros(self.max_batch, bool)
            for s in self._seqs:
                tracked[s] = True
            self.draft_cache.check_invariants(lens=self._draft_lens,
                                              active=tracked)
            for s in range(self.max_batch):
                if not tracked[s]:
                    assert not self.draft_cache.seq_blocks[s], \
                        (f"draft slot {s} holds pages with no tracked "
                         f"stream")
        return True

    def _draft_prefill(self, slot: int, seq: _SpecSeq) -> None:
        """(Re)build the draft cache of a slot from the token stream
        (everything but the pending token: what the target consumed),
        through the same chunked prefill the target engine uses."""
        consumed = seq.toks[:-1]
        if len(consumed) > self.draft_cache.capacity_per_seq:
            raise ValueError("draft capacity exceeded")   # unreachable
        self._clear_draft_slot(slot)
        # the draft slot carries its target slot's tenant (attribution
        # for OOM messages and the charge audit; the draft pool is no
        # quota domain)
        req = self.engine._requests[slot]
        if req is not None:
            self.draft_cache.set_seq_tenant(slot, req.tenant)
        chunked_prefill(self.draft.core, self.draft_cache, slot,
                        self.draft.embed(consumed),
                        chunk_tokens=self.engine.chunk_tokens)
        self._draft_lens[slot] = len(consumed)

    def _rebuild_draft(self, slot: int) -> None:
        """``_draft_prefill``, or mark the slot dirty (served without a
        draft until a rebuild lands) when the draft pool is out of
        pages: a request never fails over its DRAFT state."""
        if self.draft_cache is None:
            return
        try:
            self._draft_prefill(slot, self._seqs[slot])
            self._draft_dirty.discard(slot)
        except BlockOOM:
            self._clear_draft_slot(slot)
            self._draft_dirty.add(slot)

    def _draft_forward(self, slots, toks: Dict[int, int]):
        """One draft step: slot s consumes ``toks[s]`` at its draft
        length (untracked rows write the trash block). Returns the draft
        hidden [max_batch, 1, d]. BlockOOM propagates."""
        x = np.zeros((self.max_batch, 1, self.draft.d_model), np.float32)
        for s in slots:
            x[s, 0] = self.draft.embed(toks[s])
            self.draft_cache.ensure(s, int(self._draft_lens[s]) + 1)
        with torch.no_grad():
            out, _ = self.draft.core(
                torch.from_numpy(x).to(self.draft_cache.device),
                caches=self.draft_cache.views,
                time_step=self._draft_lens.copy())
        for s in slots:
            self._draft_lens[s] += 1
        self.stats.draft_steps += len(slots)
        return out

    def _unroll_draft(self, slots, pre_draft: Dict[int, int]) -> None:
        """Page-level rollback of a partial draft roll after a draft-pool
        OOM; the target state is untouched."""
        for s in slots:
            self.draft_cache.truncate(s, pre_draft[s])
            self._draft_lens[s] = pre_draft[s]
        self.stats.draft_oom_rolls += 1

    # -- the round ----------------------------------------------------
    def step(self) -> Dict[int, List[int]]:
        """One draft/verify/rollback round over every active slot.
        Returns {rid: tokens emitted this round} (>= 1 token per active
        request). Capacity-finished requests are released and reported
        in ``finished`` instead. No BlockOOM of either pool leaves the
        round: a request the target pool cannot serve fails alone, a
        draft-pool OOM costs the round its proposals."""
        eng = self.engine
        if self.injector is not None:
            # draft-phase faults share the verify step's clock
            self.injector.begin_step(eng._step_count + 1)
        # retire requests at page capacity; loop to a fixed point — a
        # release can refill the slot with a prompt itself at capacity
        while True:
            self._handle_events()
            full = [s for s in sorted(self._seqs)
                    if int(eng.lens[s]) >= eng.max_len]
            if not full:
                break
            for slot in full:
                seq = self._seqs[slot]
                req = eng._requests[slot]
                if req is None or req.rid != seq.rid:
                    # cancelled by a best-of win in this loop (its slot
                    # may already hold a refill): its outcome drains at
                    # the loop top
                    continue
                self._detach(seq)
                self.finished.append((seq.rid, len(seq.toks)))
                eng.release(slot)
                # best-of: the losers' outcomes drain at the loop top
                self._member_done(seq)
        slots = sorted(self._seqs)
        if not slots:
            if eng.prefill_token_budget is not None and \
                    (eng.num_prefilling > 0 or eng._queue_len):
                # every tracked stream is still mid-prefill: run an
                # empty-verify engine step so the prompts keep streaming
                eng.step_multi(torch.zeros(
                    (self.max_batch, 1, self.target.d_model)))
            elif eng._queue_len:
                # the admission kick consumes an engine step of its own,
                # so step-keyed fault schedules expire even when
                # admission is the faulted path
                eng._begin_step()
                eng._try_admit()
            self._handle_events()
            return {}
        B = self.max_batch
        # every active slot rides every call, so the depth clamps to the
        # tightest remaining capacity
        remaining = min(eng.max_len - int(eng.lens[s]) for s in slots)
        L = max(1, min(self.k + 1, remaining))
        k_eff = L - 1
        if self._draft_dirty:
            # a slot lacks its draft cache: no proposals this round; the
            # clean slots keep lockstep below, the dirty ones rebuild
            k_eff, L = 0, 1

        # 1. draft roll: k_eff proposals, then one append-only step so
        #    the draft cache ends at the target's verified length. A
        #    draft-pool BlockOOM rolls the partial roll back and the
        #    round verifies the pending token only.
        pre_draft = {s: int(self._draft_lens[s]) for s in slots} \
            if self.draft_cache is not None else {}
        roll_oom = False
        drafts: Dict[int, List[int]] = {s: [] for s in slots}
        dprobs: Dict[int, List[np.ndarray]] = {s: [] for s in slots}
        if self.draft_cache is not None and k_eff > 0:
            cur = {s: self._seqs[s].toks[-1] for s in slots}
            try:
                for j in range(k_eff + 1):
                    out = self._draft_forward(slots, cur)
                    if j < k_eff:
                        lg = self.draft.logits(out[:, -1])
                        if self.injector is not None:
                            lg = self.injector.corrupt_draft_logits(lg)
                        toks, probs = self._sample(
                            self.draft, lg,
                            rng_rows=self._lane_rows(slots, 1),
                            logit_mask=self._mask_next(self.draft, slots,
                                                       drafts))
                        for s in slots:
                            drafts[s].append(int(toks[s]))
                            if probs is not None:
                                dprobs[s].append(probs[s])
                            cur[s] = int(toks[s])
            except BlockOOM:
                self._unroll_draft(slots, pre_draft)
                drafts = {s: [] for s in slots}
                dprobs = {s: [] for s in slots}
                k_eff, L = 0, 1
                roll_oom = True
        elif self.draft_cache is not None:
            # depth 0 (capacity, or a dirty slot): the CLEAN slots'
            # draft caches consume the pending token beside the target
            live = [s for s in slots if s not in self._draft_dirty]
            if live:
                try:
                    self._draft_forward(
                        live, {s: self._seqs[s].toks[-1] for s in live})
                except BlockOOM:
                    self._unroll_draft(live, pre_draft)
                    roll_oom = True

        # 2. verify: ONE target call scores the pending token plus the
        #    k_eff proposals of every slot. The mid_spec_round crash
        #    point sits between the roll and the verify (the draft has
        #    advanced, the target has verified nothing)
        if self.injector is not None:
            self.injector.crash_point("mid_spec_round")
        x = np.zeros((B, L, self.target.d_model), np.float32)
        pre_lens = {s: int(eng.lens[s]) for s in slots}
        for s in slots:
            x[s] = self.target.embed([self._seqs[s].toks[-1]] + drafts[s])
        out = eng.step_multi(torch.from_numpy(x))
        if out is None:
            self._handle_events()
            return {}
        g_toks, g_probs = self._sample(
            self.target, self.target.logits(out),
            rng_rows=self._lane_rows(slots, L),
            logit_mask=self._mask_rows(self.target, slots, drafts, L))
        preempted = set(eng.preempted)
        failed = {oc.rid for oc in eng.outcomes if oc.failed}

        # 3. accept + rollback per slot
        emitted_by_rid: Dict[int, List[int]] = {}
        for s in slots:
            seq = self._seqs.get(s)
            if seq is None or seq.rid in preempted or \
                    seq.rid in failed or not eng.active[s]:
                continue        # evicted / failed during the step
            d = drafts[s]
            if self.sampling == "greedy":
                n = 0
                while n < k_eff and d[n] == int(g_toks[s, n]):
                    n += 1
                emitted = d[:n] + [int(g_toks[s, n])]
            else:
                n, correction = self._reject_sample(d, dprobs[s],
                                                    g_probs[s],
                                                    rng=seq.lane)
                bonus = int(g_toks[s, k_eff]) if n == k_eff \
                    else correction
                emitted = d[:n] + [bonus]
            new_len = pre_lens[s] + 1 + n
            if new_len < int(eng.lens[s]):
                eng.rollback(s, new_len)
            if self.draft_cache is not None and not roll_oom \
                    and s not in self._draft_dirty:
                # the draft advanced in lockstep: align it to the
                # accepted length
                self.draft_cache.truncate(s, new_len)
                self._draft_lens[s] = new_len
            seq.toks.extend(emitted)
            self.stats.proposed += k_eff
            self.stats.accepted += n
            self.stats.rolled_back += k_eff - n
            self.stats.emitted += len(emitted)
            self.stats.target_steps += 1
            emitted_by_rid[seq.rid] = emitted
        if self.draft_cache is not None and \
                (roll_oom or self._draft_dirty):
            # rebuild draft caches from the token streams: every slot
            # after a fresh roll OOM, else only the dirty ones
            for s in (list(self._seqs) if roll_oom
                      else list(self._draft_dirty)):
                if s in self._seqs and eng.active[s]:
                    self._rebuild_draft(s)
        self._handle_events()
        return emitted_by_rid

    def _reject_sample(self, d: List[int], q_rows: List[np.ndarray],
                       p_rows: np.ndarray,
                       rng: Optional[np.random.RandomState] = None
                       ) -> Tuple[int, int]:
        """Standard speculative rejection sampling: accept proposal d[i]
        with probability min(1, p_i[d_i] / q_i[d_i]); at the first
        rejection draw the correction from normalize(max(p_i - q_i, 0)).
        Returns (n_accepted, correction_token); the correction means
        something only when n_accepted < len(d). Draws from ``rng`` (the
        stream's lane) or else the engine's RandomState, in the JAX
        package's order."""
        r = self._rng if rng is None else rng
        for i, tok in enumerate(d):
            p_i = p_rows[i].astype(np.float64)
            q_i = q_rows[i].astype(np.float64)
            ratio = p_i[tok] / max(q_i[tok], 1e-30)
            if r.random_sample() < min(1.0, ratio):
                continue
            resid = np.maximum(p_i - q_i, 0.0)
            tot = resid.sum()
            if tot <= 0.0:      # p == q: accept-equivalent, take p draw
                resid, tot = p_i, p_i.sum()
            cdf = np.cumsum(resid / tot)
            c = int(np.searchsorted(cdf, r.random_sample(),
                                    side="right"))
            return i, min(c, len(p_i) - 1)
        return len(d), -1

    # -- checkpoint / restore -----------------------------------------
    def snapshot(self) -> dict:
        """Checkpoint of the speculative layer: the wrapped engine's
        snapshot (target pool included), every token stream (prompt,
        emitted tokens, pending token) with its lane state, the sampler
        RNG state, stats, undrained events, the dirty draft slots and the
        group records. The draft pool is not serialized: restore rebuilds
        it from the streams, as a preemption does. The JAX engine's
        keys."""
        return {
            "kind": "speculative_engine",
            "config": {"k": self.k, "sampling": self.sampling,
                       "temperature": self.temperature,
                       "top_k": self.top_k,
                       "draft_num_blocks":
                           (None if self.draft_cache is None
                            else self.draft_cache.num_blocks),
                       "self_draft": self.draft is self.target},
            "engine": self.engine.snapshot(),
            "seqs": [{"rid": s.rid, "toks": list(s.toks),
                      "prompt_len": s.prompt_len, "slot": s.slot,
                      "started": s.started, "gid": s.gid,
                      "branch": s.branch, "mask": s.mask,
                      "lane": (None if s.lane is None
                               else s.lane.get_state())}
                     for s in self._by_rid.values()],
            "rng": self._rng.get_state(),
            "stats": PagedServingEngine._stats_rec(self.stats),
            "finished": list(self.finished),
            "outcomes": [oc.as_dict() for oc in self.outcomes],
            "draft_dirty": sorted(self._draft_dirty),
            "groups": [dict(g) for g in self._groups.values()],
        }

    @classmethod
    def restore(cls, target: TokenServingModel,
                draft: Optional[TokenServingModel], snap: dict, *,
                injector=None, collector=None, monitor=None,
                ledger=None) -> "SpeculativeEngine":
        """Rebuild a speculative engine from a ``snapshot`` (either
        package's) around the caller's models. The target engine
        restores exactly (``PagedServingEngine.restore``); the draft
        pool is rebuilt from the token streams slot by slot with the
        fault hook off. Slots dirty at snapshot time stay dirty, so the
        restored run schedules as the uninterrupted one."""
        cfg = snap["config"]
        ecfg = snap["engine"]["config"]
        if cfg["k"] > 0 and cfg.get("self_draft") is not None \
                and cfg["self_draft"] != (draft is None):
            raise ValueError(
                "draft-model mismatch: snapshot was taken with a "
                + ("self-drafted (draft=None)"
                   if cfg["self_draft"] else "separate draft")
                + " engine but restore() was given "
                + ("draft=None" if draft is None
                   else "a separate draft model"))
        # num_blocks=2: the constructor's target pool is a placeholder
        # the restored one replaces; the draft pool built here is kept
        spec = cls(target, draft, k=cfg["k"],
                   max_batch=ecfg["max_batch"],
                   block_size=ecfg["block_size"],
                   num_blocks=2,
                   max_blocks_per_seq=ecfg["max_blocks_per_seq"],
                   draft_num_blocks=cfg["draft_num_blocks"],
                   prefix_cache=ecfg["prefix_cache"],
                   sampling=cfg["sampling"],
                   temperature=cfg["temperature"], top_k=cfg["top_k"],
                   watermark_blocks=ecfg["watermark_blocks"],
                   chunk_tokens=ecfg["chunk_tokens"],
                   injector=injector, collector=collector,
                   max_preemptions=ecfg["max_preemptions"],
                   numeric_guard=ecfg["numeric_guard"],
                   ledger=ledger)
        spec.engine = PagedServingEngine.restore(
            target.core, snap["engine"], injector=injector,
            collector=collector, monitor=monitor, ledger=ledger)
        spec.engine.registry.attach("spec", spec.stats)
        for rec in snap["seqs"]:
            seq = _SpecSeq(rec["rid"], rec["toks"])
            seq.prompt_len = rec["prompt_len"]
            seq.slot = rec["slot"]
            seq.started = rec["started"]
            seq.gid = rec.get("gid")
            seq.branch = rec.get("branch", 0)
            seq.mask = rec.get("mask")
            lane = rec.get("lane")
            if lane is not None:
                seq.lane = np.random.RandomState(0)
                seq.lane.set_state(lane)
            spec._by_rid[seq.rid] = seq
            if seq.slot is not None:
                spec._seqs[seq.slot] = seq
        spec._rng.set_state(snap["rng"])
        spec._groups = {int(g["gid"]): dict(g)
                        for g in snap.get("groups", [])}
        PagedServingEngine._stats_set(spec.stats, snap["stats"])
        spec.finished = list(snap["finished"])
        spec.outcomes = [RequestOutcome(**oc)
                         for oc in snap["outcomes"]]
        dirty = {int(s) for s in snap["draft_dirty"]}
        if spec.draft_cache is not None:
            hook = spec.draft_cache.allocator.fault_hook
            spec.draft_cache.allocator.fault_hook = None
            try:
                for slot, seq in spec._seqs.items():
                    if slot in dirty:
                        continue
                    try:
                        spec._draft_prefill(slot, seq)
                    except BlockOOM:
                        spec._clear_draft_slot(slot)
                        spec._draft_dirty.add(slot)
            finally:
                spec.draft_cache.allocator.fault_hook = hook
        spec._draft_dirty.update(s for s in dirty if s in spec._seqs)
        spec.check_invariants()
        return spec
