"""Token-ID serving surface over the paged serving engine (counterpart
of paddle_tpu/inference/speculative.py).

* ``TokenServingModel`` owns the embedding table and the readout head,
  so callers speak token ids while the engines speak embeddings;
  ``logits``/``probs`` run on the model's device, greedy sampling is an
  on-device argmax, and stochastic sampling draws on the host from an
  explicit ``np.random.RandomState``.
* ``SpeculativeEngine`` with ``k=0`` serves plain token-ID paged decode
  through a wrapped ``PagedServingEngine``: ``submit(token_ids)``,
  ``step() -> {rid: [tokens]}``, ``tokens(rid)``, ``release(rid)``.
  Draft / verify / rollback speculation (``k > 0``) comes in a later
  slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .resilience import RequestOutcome
from .scheduler import PagedServingEngine
from .serving import SpecDecodeStats

__all__ = ["TokenServingModel", "SpeculativeEngine", "SpecDecodeStats"]


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
               rng: Optional[np.random.RandomState] = None
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """logits [..., vocab] -> (token ids int64 [...], probs float32
        [..., vocab] or None). Greedy is an on-device argmax; the
        stochastic modes build the distribution on the device and draw
        per row on the host with ``rng`` (inverse CDF)."""
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
        u = rng.random_sample(flat.shape[0])
        cdf = np.cumsum(flat, axis=-1)
        toks = np.array([np.searchsorted(cdf[i], u[i], side="right")
                         for i in range(flat.shape[0])], np.int64)
        toks = np.minimum(toks, p.shape[-1] - 1)
        return toks.reshape(p.shape[:-1]), p


class _SpecSeq:
    """Host-side token state of one request: the full stream (prompt +
    every emitted token; the LAST entry is the pending token — emitted
    to the caller but not yet consumed by the model)."""

    __slots__ = ("rid", "toks", "prompt_len", "slot", "started")

    def __init__(self, rid: int, prompt: List[int]):
        self.rid = rid
        self.toks: List[int] = list(prompt)
        self.prompt_len = len(prompt)
        self.slot: Optional[int] = None
        self.started = False    # first token sampled at admission?


class SpeculativeEngine:
    """Token-ID serving behind the speculative engine's API. With
    ``k=0`` (the only depth this slice serves) every round consumes
    each active stream's pending token and emits one greedy or sampled
    token per stream; admission, chunked prefill, the token-budget mixed
    step, preemption with re-prefill, int8 KV pages (``kv_dtype="int8"``)
    and the prefix cache (``prefix_cache=True``) come from the wrapped
    ``PagedServingEngine``. Capacity-finished requests land in
    ``finished`` as (rid, total_tokens); terminal outcomes in
    ``outcomes``."""

    def __init__(self, target: TokenServingModel,
                 draft: Optional[TokenServingModel] = None, *,
                 k: int = 0, max_batch: int, block_size: int,
                 num_blocks: int,
                 max_blocks_per_seq: Optional[int] = None,
                 prefix_cache: bool = False, sampling: str = "greedy",
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 watermark_blocks: int = 0,
                 chunk_tokens: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 kv_dtype="float32", seed: int = 0,
                 max_preemptions: Optional[int] = None):
        if k != 0 or draft is not None:
            raise NotImplementedError(
                "draft/verify speculation (k > 0) comes in a later slice "
                "of the PyTorch port; k=0 serves plain token-ID decode")
        self.target = target
        self.k = 0
        self.sampling = sampling
        self.temperature = float(temperature)
        self.top_k = top_k
        self._rng = np.random.RandomState(seed)
        self.engine = PagedServingEngine(
            target.core, max_batch, block_size, num_blocks,
            max_blocks_per_seq=max_blocks_per_seq, dtype=kv_dtype,
            watermark_blocks=watermark_blocks, prefix_cache=prefix_cache,
            chunk_tokens=chunk_tokens,
            prefill_token_budget=prefill_token_budget,
            max_preemptions=max_preemptions)
        self.max_batch = self.engine.max_batch
        self.stats = SpecDecodeStats()
        self.engine.registry.attach("spec", self.stats)
        self.finished: List[Tuple[int, int]] = []
        self.outcomes: List[RequestOutcome] = []
        self._seqs: Dict[int, _SpecSeq] = {}     # by target slot
        self._by_rid: Dict[int, _SpecSeq] = {}

    # -- submission / events ------------------------------------------
    def submit(self, token_ids, *,
               max_preemptions: Optional[int] = None) -> int:
        """Queue a token-ID prompt; admission (now or later) samples the
        first token from the prefill's last hidden."""
        toks = [int(t) for t in np.asarray(token_ids).reshape(-1)]
        if not toks:
            raise ValueError("empty prompt")
        rid = self.engine.submit(self.target.embed(toks),
                                 max_preemptions=max_preemptions)
        seq = _SpecSeq(rid, toks)
        self._by_rid[rid] = seq
        self._handle_events()
        return rid

    def tokens(self, rid: int) -> List[int]:
        """Full stream (prompt + generated) of a request."""
        return list(self._by_rid[rid].toks)

    def generated(self, rid: int) -> List[int]:
        seq = self._by_rid[rid]
        return list(seq.toks[seq.prompt_len:])

    def release(self, rid: int) -> None:
        """Caller-side finish: free the request's pages and refill. A
        request released while still queued leaves the queue too."""
        seq = self._by_rid.pop(rid)
        if seq.slot is not None:
            slot = seq.slot
            self._seqs.pop(slot, None)
            seq.slot = None
            self.engine.release(slot)
        else:
            for req in self.engine.queue:
                if req.rid == rid:
                    self.engine._queue.remove(req)
        self._handle_events()

    def _sample(self, logits):
        return self.target.sample(logits, mode=self.sampling,
                                  temperature=self.temperature,
                                  top_k=self.top_k, rng=self._rng)

    def _handle_events(self) -> None:
        """Reconcile wrapped-engine events: preemptions detach the stream
        from its slot (its tokens and pending token survive host-side);
        admissions of fresh requests sample the first token (a
        re-admitted request keeps its pending token)."""
        eng = self.engine
        for rid in eng.preempted:
            seq = self._by_rid.get(rid)
            if seq is not None and seq.slot is not None:
                self._seqs.pop(seq.slot, None)
                seq.slot = None
        eng.preempted.clear()
        for oc in eng.outcomes:
            if oc.failed:
                seq = self._by_rid.get(oc.rid)
                if seq is not None and seq.slot is not None:
                    self._seqs.pop(seq.slot, None)
                    seq.slot = None
            self.outcomes.append(oc)
        eng.outcomes.clear()
        for rid, slot, length in eng.finished:
            seq = self._by_rid.get(rid)
            if seq is not None:
                self._seqs.pop(slot, None)
                seq.slot = None
                self.finished.append((rid, len(seq.toks)))
        eng.finished.clear()
        for rid, slot, h in eng.admitted:
            seq = self._by_rid.get(rid)
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
                tok, _ = self._sample(self.target.logits(h))
                seq.toks.append(int(tok.reshape(-1)[0]))
                seq.started = True
            if live:
                seq.slot = slot
                self._seqs[slot] = seq
        eng.admitted.clear()

    # -- the round ----------------------------------------------------
    def step(self) -> Dict[int, List[int]]:
        """One round over every active slot: consume each stream's
        pending token and emit the next. Returns {rid: [token]}.
        Capacity-finished requests are released and reported in
        ``finished`` instead."""
        eng = self.engine
        while True:
            # retire requests at page capacity (a refill can land a
            # prompt that is itself at capacity, hence the loop)
            self._handle_events()
            full = [s for s in sorted(self._seqs)
                    if int(eng.lens[s]) >= eng.max_len]
            if not full:
                break
            for slot in full:
                seq = self._seqs.pop(slot)
                self.finished.append((seq.rid, len(seq.toks)))
                seq.slot = None
                eng.release(slot)
        slots = sorted(self._seqs)
        d = self.target.d_model
        if not slots:
            if eng.prefill_token_budget is not None and \
                    (eng.num_prefilling > 0 or eng._queue):
                # every tracked stream is still mid-prefill: run an
                # empty engine step so the prompts keep streaming
                eng.step_multi(torch.zeros((self.max_batch, 1, d)))
            elif eng._queue:
                # the admission kick consumes an engine step of its own
                eng._step_count += 1
                eng._try_admit()
            self._handle_events()
            return {}
        x = np.zeros((self.max_batch, 1, d), np.float32)
        for s in slots:
            x[s, 0] = self.target.embed(self._seqs[s].toks[-1])
        out = eng.step_multi(torch.from_numpy(x))
        if out is None:
            self._handle_events()
            return {}
        toks, _ = self._sample(self.target.logits(out))
        preempted = set(eng.preempted)
        failed = {oc.rid for oc in eng.outcomes if oc.failed}
        emitted: Dict[int, List[int]] = {}
        for s in slots:
            seq = self._seqs.get(s)
            if seq is None or seq.rid in preempted or \
                    seq.rid in failed or not eng.active[s]:
                continue        # evicted / failed during the step
            tok = int(toks[s, 0])
            seq.toks.append(tok)
            self.stats.emitted += 1
            self.stats.target_steps += 1
            emitted[seq.rid] = [tok]
        self._handle_events()
        return emitted
