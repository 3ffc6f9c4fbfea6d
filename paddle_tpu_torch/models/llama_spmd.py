"""The training flagship — the counterpart of
``paddle_tpu/models/llama_spmd.py``'s ``LlamaSpmdTrainer``.

The JAX trainer is one jitted program over a device mesh of five axes
(``parallel/mesh.py``'s AXIS_ORDER): dp splits the batch, pp runs the
decoder stack as pipeline stages (optionally interleaved), mp shards
heads, the FFN and the vocabulary (Megatron column / row weights), sep
splits the sequence (ring attention) and sharding partitions the AdamW
moments and fp32 masters (ZeRO, ``_zero_spec``). The port runs the same
step in eager PyTorch, one program per RANK of the mesh, the ranks
coupled only by ``parallel/collective.py``'s counted collectives. Ranks
are logical: on one H100 (or the CPU) several share a device, each with
its own tensors; where a machine has a card per rank they sit on
distinct cards (written, unverified on one card).

Per rank:
- parameters: the shard ``_param_specs`` gives it (block leaves
  ``[pp * v, lps, ...]`` split over pp on dim 0, rearranged once into
  ``[pp, v, lps, ...]`` when ``n_virtual > 1``; column / row splits over
  mp; embedding rows and head columns over mp). The embedding lives on
  the first stage's ranks, the final norm and the head on the last's:
  the reference replicates them over pp and runs them on every stage
  (only stage 0's embedding feeds the pipeline; every stage's head sees
  the same broadcast output), the port runs each once;
- forward: its batch rows (dp) and sequence chunk (sep, rope offset
  ``sep_rank * T_local``); the vocab-sharded embedding is a masked
  gather plus a psum over mp; each block psums over mp after ``wo`` and
  after ``wd``; attention is ring attention over sep (sep > 1), else the
  flash kernel or the dense branch; pp runs the blocks through
  ``parallel/pipeline.py``'s schedule; the vocab-sharded head feeds a
  cross entropy over vocab shards (a max and two psums). Sharding
  replicates the compute, as the reference's batch spec ``P("dp",
  None)`` does;
- gradients: the step's objective is the sum of the ranks' losses, each
  replica of a value (over sharding and mp) weighted 1 / its replica
  count, and every collective has its true adjoint. So the gradient of
  a parameter is the sum of its copies' gradients over the axes it is
  replicated on: an explicit, counted reduce-scatter to the owning ZeRO
  rank (the leaf has a 'sharding' dim) or all-reduce;
- update: the fused AdamW kernel on each owned chunk, then an
  all-gather of the updated chunks to every replica.

The same parameter tree as JAX (``embed``, ``norm``, ``head``,
``blocks`` with ``wq``..``ln2``); ``weights.llama_spmd_state_np`` gives
the global arrays. On a one-rank mesh a leaf of ``params`` /
``opt_state`` is a tensor; on a larger mesh it is a dict from rank
coordinate (a tuple in AXIS_ORDER) to that rank's tensor.

One attribute, ``_fused`` (JAX's ``_pallas_fused``), gates the four
hand-written kernels of the step on every rank: the fused RMSNorm (plain
and with the residual add), flash attention forward and backward (sep
1, ``hd % 64 == 0`` and local ``T % 128 == 0``) and the fused AdamW (fp32
moments). It is True exactly on CUDA: eager PyTorch fuses nothing, so on
the card the kernels are the port's path (the JAX trainer turns its
Pallas path off on any multi-device mesh, where ``pallas_call`` does not
partition under GSPMD; the port's per-rank programs have no such limit).

Remat: ``full`` checkpoints each block; ``save_dots`` and ``save_attn``
keep the reference's tags (``q``, ``k``, ``v``, ``attn_out``, and
``ffn_gate``, ``ffn_up`` for ``save_dots``) and recompute the rest, by an
explicit split of the block at the tags: a tagged matmul's input is
recomputed in the backward, its output is kept (``_TaggedMatmuls``), and
the untagged parts between tags are checkpoints.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.hopper.flash_attention import flash_attention_blhd
from ..ops.hopper.fused_adamw import adamw_scalars, fused_adamw_update
from ..ops.hopper.fused_norm import fused_rms_norm, fused_rms_norm_residual
from ..parallel import collective
from ..parallel import mesh as mesh_mod
from ..parallel.pipeline import interleave_stage_params, run_schedule
from ..parallel.ring_attention import _ring_local
from .llama import LlamaConfig

# block leaves in the JAX tree's order: (name, shape from (H, KV, F), the
# mp spec of the leaf's own dims)
_BLOCK_SHAPES = (
    ("wq", lambda H, KV, F_: (H, H), (None, "mp")),
    ("wk", lambda H, KV, F_: (H, KV), (None, "mp")),
    ("wv", lambda H, KV, F_: (H, KV), (None, "mp")),
    ("wo", lambda H, KV, F_: (H, H), ("mp", None)),
    ("wg", lambda H, KV, F_: (H, F_), (None, "mp")),
    ("wu", lambda H, KV, F_: (H, F_), (None, "mp")),
    ("wd", lambda H, KV, F_: (F_, H), ("mp", None)),
    ("ln1", lambda H, KV, F_: (H,), (None,)),
    ("ln2", lambda H, KV, F_: (H,), (None,)),
)
_AX = {a: i for i, a in enumerate(mesh_mod.AXIS_ORDER)}


def tree_paths(params) -> List[Tuple[str, ...]]:
    """Key paths of the parameter tree's leaves in jax.tree_util order
    (dict keys sorted)."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict) and not _is_sharded(v):
            out.extend((k,) + p for p in tree_paths(v))
        else:
            out.append((k,))
    return out


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _is_sharded(v) -> bool:
    """A per-rank leaf: {rank coordinate: tensor}."""
    return isinstance(v, dict) and bool(v) and isinstance(
        next(iter(v)), tuple)


def _zero_spec_n(shape, base_spec, axis, n):
    spec = list(base_spec) + [None] * (len(shape) - len(base_spec))
    if n <= 1:
        return tuple(spec)
    for i, (dim, s) in enumerate(zip(shape, spec)):
        if s is None and dim % n == 0 and dim >= n:
            spec[i] = axis
            break
    return tuple(spec)


def _zero_spec(shape, base_spec, axis="sharding"):
    """Add 'sharding' to the first free, divisible dim of base_spec (the
    installed mesh's axis size; a tuple where the reference returns a
    PartitionSpec)."""
    return _zero_spec_n(shape, base_spec, axis,
                        mesh_mod.mesh_axis_size(axis))


def _silu_mul(gate, up):
    # jax.nn.silu is x * sigmoid(x), rounded after each op in bf16
    return gate * torch.sigmoid(gate) * up


class _TaggedMatmuls(torch.autograd.Function):
    """ys[r][j] = hs[r] @ ws[r][j] with (extras, hs) = fn(inputs), over the
    ranks r of a group: the outputs (the reference's checkpoint_name
    tags) are kept for the backward, ``hs`` is not: the backward
    recomputes fn from the saved inputs (collectives in fn included) and
    takes the matmuls' gradients from the kept outputs' gradients.
    ``extras`` are further outputs of fn (not recomputed in the forward,
    not saved)."""

    @staticmethod
    def forward(ctx, fn, n_in, n_w, *args):
        inputs, ws = args[:n_in], args[n_in:]
        extras, hs = fn(list(inputs))
        ys = [hs[r] @ ws[r * n_w + j] for r in range(len(hs))
              for j in range(n_w)]
        ctx.fn, ctx.n_in, ctx.n_w, ctx.n_ex = fn, n_in, n_w, len(extras)
        ctx.save_for_backward(*args)
        return tuple(extras) + tuple(ys)

    @staticmethod
    def backward(ctx, *grads):
        args = ctx.saved_tensors
        n_in, n_w = ctx.n_in, ctx.n_w
        inputs = [a.detach().requires_grad_(ctx.needs_input_grad[3 + i])
                  for i, a in enumerate(args[:n_in])]
        ws = args[n_in:]
        with torch.enable_grad():
            extras, hs = ctx.fn(inputs)
        g_ex, g_ys = grads[:ctx.n_ex], grads[ctx.n_ex:]
        dhs, dws = [], []
        for r, h in enumerate(hs):
            dh, dw = None, {}
            # the matmuls' input gradients summed last use first, the
            # order in which autograd accumulates them
            for j in reversed(range(n_w)):
                gy, w = g_ys[r * n_w + j], ws[r * n_w + j]
                if gy is None:
                    gy = torch.zeros(h.shape[:-1] + (w.shape[-1],),
                                     dtype=h.dtype, device=h.device)
                d = gy @ w.t()
                dh = d if dh is None else dh + d
                dw[j] = (h.detach().reshape(-1, h.shape[-1]).t()
                         @ gy.reshape(-1, gy.shape[-1]))
            dhs.append(dh)
            dws.extend(dw[j] for j in range(n_w))
        outs, gouts = [], []
        for o, g in zip(list(extras) + list(hs), list(g_ex) + dhs):
            if g is not None and o.requires_grad:
                outs.append(o)
                gouts.append(g)
        need = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad(outs, need, gouts, allow_unused=True)
                   if need else ())
        d_in = [next(got) if x.requires_grad else None for x in inputs]
        return (None, None, None) + tuple(d_in) + tuple(dws)


def _tagged(fn, inputs, ws):
    """(extras, ys) of _TaggedMatmuls; ws[r] is rank r's weight list."""
    n_w = len(ws[0])
    out = _TaggedMatmuls.apply(fn, len(inputs), n_w, *inputs,
                               *[w for wr in ws for w in wr])
    n_ex = len(out) - n_w * len(ws)
    ys = out[n_ex:]
    return list(out[:n_ex]), [list(ys[r * n_w:(r + 1) * n_w])
                              for r in range(len(ws))]


def _untagged(fn, inputs, ws):
    extras, hs = fn(list(inputs))
    return extras, [[h @ w for w in wr] for h, wr in zip(hs, ws)]


class LlamaSpmdTrainer:
    def __init__(self, config: LlamaConfig, lr=3e-4, weight_decay=0.1,
                 beta1=0.9, beta2=0.95, eps=1e-8, remat=True,
                 n_micro=None, seed=0, compute_dtype=torch.bfloat16,
                 from_state_dict=None, remat_policy="full",
                 n_virtual=1, remat_stage=False,
                 moments_dtype=torch.float32, ce_remat=True,
                 scan_unroll=1, *, device=None):
        """The trainer runs on the installed mesh
        (``parallel.mesh.get_mesh()``, by default dp over every card);
        ``device`` places all of its ranks on that device instead (one
        rank when no mesh is installed). ``from_state_dict`` is accepted
        and not read, as in the reference."""
        self.config = config
        self.lr = lr
        self.wd = weight_decay
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.remat = remat
        if remat_policy not in ("full", "save_dots", "save_attn"):
            raise ValueError(f"remat_policy must be 'full', 'save_dots' "
                             f"or 'save_attn', got {remat_policy!r}")
        self.remat_policy = remat_policy
        self.compute_dtype = compute_dtype
        self.moments_dtype = moments_dtype
        self.ce_remat = ce_remat
        # kept for the JAX signature: PyTorch runs the layers as a loop
        self.scan_unroll = int(scan_unroll)
        self.mesh = (mesh_mod.get_mesh() if device is None
                     else mesh_mod.on_device(device))
        self.device = self.mesh.devices.flat[0]
        self.dp, self.pp, self.sharding, self.sep, self.mp = \
            self.mesh.devices.shape
        self.n_micro = n_micro or max(2 * self.pp, 1)
        # interleaved virtual stages: each stage owns n_virtual
        # non-adjacent chunks
        self.n_virtual = int(n_virtual)
        self.remat_stage = remat_stage
        L = config.num_hidden_layers
        n_chunks = self.pp * self.n_virtual
        assert L % n_chunks == 0, \
            "layers must divide pp_degree * n_virtual"
        self.layers_per_stage = L // n_chunks
        self.head_dim = config.hidden_size // config.num_attention_heads
        for name, n in (("heads", config.num_attention_heads),
                        ("kv heads", config.num_key_value_heads),
                        ("intermediate size", config.intermediate_size),
                        ("vocab", config.vocab_size)):
            if n % self.mp:
                raise ValueError(f"{name} {n} do not split over mp "
                                 f"{self.mp}")
        # the hand-written kernels are the CUDA path (see the module
        # docstring); tests set this by hand to run the kernels' plain
        # versions on the CPU, or the jnp branches on the card
        self._fused = self.device.type == "cuda"
        self._stepno = 0
        self._scal = {}
        self.pipeline_stats = None
        self._specs = self._global_specs()
        self.params = self._init_params(seed)
        self.opt_state = self._init_opt_state()

    # -- layout -------------------------------------------------------------
    def _staged(self):
        return self.n_virtual > 1 and self.pp > 1

    def _global_specs(self):
        """{path: (global shape, spec over AXIS_ORDER names, holder
        stage or None for every stage)}."""
        c = self.config
        H, V = c.hidden_size, c.vocab_size
        KV = c.num_key_value_heads * self.head_dim
        specs = {("embed",): ((V, H), ("mp", None), 0),
                 ("norm",): ((H,), (None,), self.pp - 1),
                 ("head",): ((H, V), (None, "mp"), self.pp - 1)}
        lead = ((self.pp, self.n_virtual, self.layers_per_stage)
                if self._staged() else
                (self.pp * self.n_virtual, self.layers_per_stage))
        lead_spec = ("pp",) + (None,) * (len(lead) - 1)
        for name, shape, spec in _BLOCK_SHAPES:
            specs[("blocks", name)] = (
                lead + shape(H, KV, c.intermediate_size), lead_spec + spec,
                None)
        return specs

    def _holders(self, path):
        stage = self._specs[path][2]
        return [c for c in self.mesh.coords()
                if stage is None or c[_AX["pp"]] == stage]

    def _local_slices(self, path, c):
        shape, spec, _ = self._specs[path]
        out = []
        for dim, ax in zip(shape, spec):
            if ax is None:
                out.append(slice(None))
            else:
                n = self.mesh.shape[ax]
                out.append(slice(c[_AX[ax]] * dim // n,
                                 (c[_AX[ax]] + 1) * dim // n))
        return tuple(out)

    def _zdim(self, path):
        """The dim of the leaf that 'sharding' partitions its optimizer
        state over (``_zero_spec``), or None (replicated state)."""
        shape, spec, _ = self._specs[path]
        z = _zero_spec_n(shape, spec, "sharding", self.sharding)
        return z.index("sharding") if "sharding" in z else None

    def _owned_slices(self, path, c):
        """The global slices of rank c's chunk of the optimizer state."""
        sl = list(self._local_slices(path, c))
        z = self._zdim(path)
        if z is not None:
            dim, n = self._specs[path][0][z], self.sharding
            k = c[_AX["sharding"]]
            sl[z] = slice(k * dim // n, (k + 1) * dim // n)
        return tuple(sl)

    def _replica_groups(self, path):
        """Holders grouped by their shard (the coordinates on the axes the
        leaf is split over): each group holds copies of one shard."""
        spec = self._specs[path][1]
        axes = [_AX[a] for a in spec if a is not None]
        groups: Dict[tuple, list] = {}
        for c in self._holders(path):
            groups.setdefault(tuple(c[i] for i in axes), []).append(c)
        return list(groups.values())

    def _wrap(self, shards):
        """A leaf as stored: the tensor on a one-rank mesh, else the dict."""
        return shards[(0,) * 5] if self.mesh.size == 1 else shards

    @staticmethod
    def _shards(leaf):
        return leaf if isinstance(leaf, dict) else {(0,) * 5: leaf}

    # -- parameters ---------------------------------------------------------
    def _init_params(self, seed):
        """Random weights from ``seed`` (std 0.02, norms ones), drawn as
        global arrays by a torch.Generator on the first rank's device, in
        the JAX tree's order, then split over the ranks."""
        dev, dt = self.device, self.compute_dtype
        gen = torch.Generator(device=dev).manual_seed(int(seed))

        def init(shape, ones=False):
            if ones:
                return torch.ones(shape, dtype=dt, device=dev)
            return (0.02 * torch.randn(shape, generator=gen,
                                       device=dev)).to(dt)

        full = {}
        for path in [("embed",), ("norm",), ("head",)] + [
                ("blocks", n) for n, _, _ in _BLOCK_SHAPES]:
            shape = self._specs[path][0]
            ones = path[-1] in ("norm", "ln1", "ln2")
            if self._staged() and path[0] == "blocks":
                # drawn in the logical [pp * v, lps, ...] layout and
                # rearranged ONCE into the staged one
                logical = (self.pp * self.n_virtual,) + shape[2:]
                full[path] = interleave_stage_params(
                    init(logical, ones), self.pp, self.n_virtual)
            else:
                full[path] = init(shape, ones)
        params: dict = {"blocks": {}}
        for path, a in full.items():
            # a copy per rank: replicas on one device keep their own
            shards = {c: a[self._local_slices(path, c)].to(
                self.mesh.device(c), copy=True).contiguous()
                .requires_grad_(True) for c in self._holders(path)}
            node = params if len(path) == 1 else params["blocks"]
            node[path[-1]] = self._wrap(shards)
        return params

    def _init_opt_state(self):
        st = {}
        for path in tree_paths(self.params):
            leaf = self._shards(tree_get(self.params, path))
            z = self._zdim(path)
            state = {"m": {}, "v": {}, "master": {}}
            for c, p in leaf.items():
                if z is not None:
                    p = p.chunk(self.sharding, z)[c[_AX["sharding"]]]
                for k in ("m", "v"):
                    state[k][c] = torch.zeros(p.shape,
                                              dtype=self.moments_dtype,
                                              device=p.device)
                state["master"][c] = p.detach().float().clone(
                    memory_format=torch.contiguous_format)
            node = st
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = {k: self._wrap(v) for k, v in state.items()}
        return st

    def assemble(self, path, shards, owned=False):
        """The global array of leaf ``path`` from per-rank pieces: the
        local shards, or (``owned``) the ZeRO-owned chunks."""
        shape = self._specs[path][0]
        pieces = self._shards(shards)
        first = next(iter(pieces.values()))
        out = torch.empty(shape, dtype=first.dtype, device=first.device)
        where = self._owned_slices if owned else self._local_slices
        for c, t in pieces.items():
            out[where(path, c)] = t.detach().to(first.device)
        return out

    # -- model math ---------------------------------------------------------
    def _rope(self, T, offset, device):
        d = self.head_dim
        inv = 1.0 / (self.config.rope_theta ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
        t = torch.arange(T, dtype=torch.float32, device=device) + offset
        freqs = torch.outer(t, inv)
        emb = torch.cat([freqs, freqs], dim=-1)
        return torch.cos(emb), torch.sin(emb)

    def _rms(self, h, w):
        h32 = h.float()
        out = h32 * torch.rsqrt((h32 * h32).mean(-1, keepdim=True)
                                + self.config.rms_norm_eps)
        return (out * w.float()).to(h.dtype)

    def _mp_psum(self, xs, keys):
        """psum over mp of {(q, m): tensor}, for each sep rank q."""
        out = {}
        for q in range(self.sep):
            ks = [k for k in keys if k[0] == q]
            for k, y in zip(ks, collective.psum([xs[k] for k in ks])):
                out[k] = y
        return out

    # The block, over a stage's sep x mp ranks: xs and bps map (q, m) to
    # rank tensors; segments split at the reference's tags.
    def _seg_qkv(self, bps, xs, tagged):
        keys = list(xs)
        eps = self.config.rms_norm_eps

        def fn(ins):
            n = len(keys)
            return [], [fused_rms_norm(x, w, eps) if self._fused
                        else self._rms(x, w)
                        for x, w in zip(ins[:n], ins[n:])]

        ins = [xs[k] for k in keys] + [bps[k]["ln1"] for k in keys]
        ws = [[bps[k]["wq"], bps[k]["wk"], bps[k]["wv"]] for k in keys]
        _, ys = (_tagged if tagged else _untagged)(fn, ins, ws)
        return {k: y for k, y in zip(keys, ys)}

    def _seg_attn(self, qkv):
        """rope + attention: {(q, m): [q, k, v]} -> {(q, m): attn_out}."""
        c = self.config
        nh, nkv = c.num_attention_heads // self.mp, \
            c.num_key_value_heads // self.mp
        hd = self.head_dim
        rot = {}
        for (qi, m), (q, k, v) in qkv.items():
            B, T, _ = q.shape
            dt = q.dtype
            cos, sin = self._rope(T, qi * T, q.device)
            cos = cos[None, :, None, :].to(dt)
            sin = sin[None, :, None, :].to(dt)

            def rope(u):
                u1, u2 = u.chunk(2, dim=-1)
                return u * cos + torch.cat([-u2, u1], dim=-1) * sin

            rot[qi, m] = (rope(q.reshape(B, T, nh, hd)),
                          rope(k.reshape(B, T, nkv, hd)),
                          v.reshape(B, T, nkv, hd))
        scale = 1.0 / math.sqrt(hd)
        out = {}
        if self.sep > 1:
            for m in range(self.mp):
                ks = [(qi, m) for qi in range(self.sep)]
                res = _ring_local(*[[rot[k][i] for k in ks]
                                    for i in range(3)],
                                  causal=True, sm_scale=scale)
                out.update(zip(ks, res))
        else:
            for k, (q, kk, v) in rot.items():
                out[k] = self._attention(q, kk, v, scale)
        return {k: o.reshape(o.shape[0], o.shape[1], nh * hd)
                for k, o in out.items()}

    def _attention(self, q, k, v, scale):
        B, T, nh, hd = q.shape
        nkv = k.shape[2]
        if self._fused and hd % 64 == 0 and T % 128 == 0:
            if nkv != nh:
                # the kernel takes equal head counts
                rep = nh // nkv
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            return flash_attention_blhd(q, k, v, causal=True, sm_scale=scale)
        # JAX's dense branches; its fp32 scores come from bf16 operands
        # (preferred_element_type=float32): the operands are upcast here,
        # a product of two bf16 values being exact in fp32
        dt = q.dtype
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        neg = torch.full((), -1e30, device=q.device)
        if nkv != nh:
            # grouped-query attention without repeating K/V
            g = nh // nkv
            qg = q.reshape(B, T, nkv, g, hd)
            scores = torch.einsum("bqngd,bknd->bngqk", qg.float(),
                                  k.float()) * scale
            probs = torch.softmax(torch.where(mask, scores, neg),
                                  dim=-1).to(dt)
            return torch.einsum("bngqk,bknd->bqngd", probs, v).reshape(
                B, T, nh, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * scale
        probs = torch.softmax(torch.where(mask, scores, neg), dim=-1).to(dt)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    def _seg_ffn_in(self, bps, xs, attn, tagged):
        """x1 = x + psum(attn @ wo), h = rms(x1); -> (x1, [gate, up])."""
        keys = list(xs)
        n = len(keys)
        eps = self.config.rms_norm_eps

        def fn(ins):
            x, a, wo, ln2 = (ins[i * n:(i + 1) * n] for i in range(4))
            o = self._mp_psum({k: a[i] @ wo[i] for i, k in enumerate(keys)},
                              keys)
            x1, hs = [], []
            for i, k in enumerate(keys):
                if self._fused:
                    # fused residual add + RMSNorm: one pass
                    h, z = fused_rms_norm_residual(o[k], x[i], ln2[i], eps)
                else:
                    z = x[i] + o[k]
                    h = self._rms(z, ln2[i])
                x1.append(z)
                hs.append(h)
            return x1, hs

        ins = ([xs[k] for k in keys] + [attn[k] for k in keys]
               + [bps[k]["wo"] for k in keys] + [bps[k]["ln2"] for k in keys])
        ws = [[bps[k]["wg"], bps[k]["wu"]] for k in keys]
        x1, ys = (_tagged if tagged else _untagged)(fn, ins, ws)
        return ({k: x for k, x in zip(keys, x1)},
                {k: y for k, y in zip(keys, ys)})

    def _seg_ffn_out(self, bps, x1, gu, tagged):
        """x2 = x1 + psum(silu(gate) * up @ wd)."""
        keys = list(x1)
        n = len(keys)

        def fn(ins):
            return [], [_silu_mul(g, u) for g, u in zip(ins[:n], ins[n:])]

        ins = [gu[k][0] for k in keys] + [gu[k][1] for k in keys]
        _, ys = (_tagged if tagged else _untagged)(
            fn, ins, [[bps[k]["wd"]] for k in keys])
        o = self._mp_psum({k: y[0] for k, y in zip(keys, ys)}, keys)
        return {k: x1[k] + o[k] for k in keys}

    def _block_plain(self, bps, xs):
        return self._block_attn_tail(
            bps, xs, self._seg_attn(self._seg_qkv(bps, xs, False)))

    def _block_attn_tail(self, bps, xs, attn):
        x1, gu = self._seg_ffn_in(bps, xs, attn, False)
        return self._seg_ffn_out(bps, x1, gu, False)

    def _block_remat(self, bps, xs):
        """One block under the remat policy."""
        if self.remat_policy == "full":
            return checkpoint(self._block_plain, bps, xs, use_reentrant=False)
        qkv = self._seg_qkv(bps, xs, True)
        attn = checkpoint(self._seg_attn, qkv, use_reentrant=False)
        if self.remat_policy == "save_attn":
            return checkpoint(self._block_attn_tail, bps, xs, attn,
                              use_reentrant=False)
        x1, gu = self._seg_ffn_in(bps, xs, attn, True)
        return self._seg_ffn_out(bps, x1, gu, True)

    def _stage_fn(self, stage_params, xs):
        """Run a stage's blocks in order over its ranks: stage_params
        {(q, m): {name: [layers, ...]}}, xs {(q, m): [b, T, H]}. With remat
        each block follows ``remat_policy`` (its forward, kernels and
        collectives included, runs again in the backward), unless the
        pipeline already checkpoints the whole stage (``remat_stage``)."""
        block = self._block_plain
        if self.remat and not (self.remat_stage and self.pp > 1):
            block = self._block_remat
        n = next(iter(next(iter(stage_params.values())).values())).shape[0]
        for i in range(n):
            xs = block({k: {nm: a[i] for nm, a in p.items()}
                        for k, p in stage_params.items()}, xs)
        return xs

    def _local(self, params, path, c):
        return self._shards(tree_get(params, path))[c]

    def _group_hidden(self, params, ids, d, s):
        """Final-norm hidden states {(q, m): [B/dp, T/sep, H]} of the
        (dp d, sharding s) replica, on the last stage's ranks."""
        D, P, Q, M = self.dp, self.pp, self.sep, self.mp
        B, T = ids.shape
        Bl, Tl = B // D, T // Q
        keys = [(q, m) for q in range(Q) for m in range(M)]

        def rank(p, k):
            return (d, p, s) + k

        xs = {}
        for q in range(Q):
            part = ids[d * Bl:(d + 1) * Bl, q * Tl:(q + 1) * Tl]
            rows = []
            for m in range(M):
                E = self._local(params, ("embed",), rank(0, (q, m)))
                i = part.to(E.device)
                if M > 1:
                    # vocab-sharded embedding: masked gather + psum
                    Vl = E.shape[0]
                    i = i - m * Vl
                    ok = (i >= 0) & (i < Vl)
                    e = E[i.clamp(0, Vl - 1)] * ok[..., None].to(E.dtype)
                else:
                    e = E[i]
                rows.append(e.to(self.compute_dtype))
            xs.update(zip([(q, m) for m in range(M)], collective.psum(rows)))
        blocks = [("blocks", n) for n, _, _ in _BLOCK_SHAPES]
        if P == 1:
            stage = {}
            for k in keys:
                leaves = {p[1]: self._local(params, p, rank(0, k))
                          for p in blocks}
                stage[k] = {nm: a.reshape((-1,) + tuple(a.shape[2:]))
                            for nm, a in leaves.items()}
            xs = self._stage_fn(stage, xs)
        else:
            if Bl % self.n_micro:
                raise ValueError(f"n_micro ({self.n_micro}) must divide the "
                                 f"batch per dp rank ({Bl})")
            mb = Bl // self.n_micro
            v = self.n_virtual
            local = [{k: {p[1]: self._local(params, p, rank(st, k))[0]
                          for p in blocks} for k in keys}
                     for st in range(P)]
            perm = [(i, (i + 1) % P) for i in range(P)]

            def stage_call(st, chunk, xg):
                sp = local[st]
                if v > 1:
                    sp = {k: {nm: a[chunk] for nm, a in p.items()}
                          for k, p in sp.items()}
                return self._stage_fn(sp, xg)

            def send(ys):
                got: List = [None] * P
                for k in keys:
                    devs = [self.mesh.device(rank(st, k)) for st in range(P)]
                    recv = collective.ppermute(
                        [None if y is None else y[k] for y in ys], perm,
                        devs)
                    for st, r in enumerate(recv):
                        if r is not None:
                            got[st] = got[st] or {}
                            got[st][k] = r
                return got

            inputs = [{k: x[i * mb:(i + 1) * mb] for k, x in xs.items()}
                      for i in range(self.n_micro)]
            outs, self.pipeline_stats = run_schedule(
                stage_call, inputs, P, v, send, self.remat_stage)
            xs = {k: torch.cat([o[k] for o in outs], 0) for k in keys}
        return {k: self._rms(x, self._local(params, ("norm",),
                                            rank(P - 1, k)))
                for k, x in xs.items()}

    def _check_batch(self, ids):
        B, T = ids.shape
        if B % self.dp or T % self.sep:
            raise ValueError(f"batch {B} x seq {T} does not split over dp "
                             f"{self.dp} x sep {self.sep}")

    def forward(self, params, ids):
        """ids: [B, T] -> logits [B, T, V] (assembled from the ranks)."""
        ids = self._ids(ids)
        self._check_batch(ids)
        return self._assemble_rows(lambda d, k, x: x @ self._local(
            params, ("head",), (d, self.pp - 1, 0) + k),
            params, ids, vocab=True)

    def forward_hidden(self, params, ids):
        """ids: [B, T] -> final-norm hidden states [B, T, H] (pre-head)."""
        ids = self._ids(ids)
        self._check_batch(ids)
        return self._assemble_rows(lambda d, k, x: x, params, ids)

    def _assemble_rows(self, fn, params, ids, vocab=False):
        rows = []
        for d in range(self.dp):
            xs = self._group_hidden(params, ids, d, 0)
            rows.append(torch.cat([
                torch.cat([fn(d, (q, m), xs[q, m]).to(self.device)
                           for m in range(self.mp if vocab else 1)], -1)
                for q in range(self.sep)], 1))
        return torch.cat(rows, 0)

    def _group_ce(self, params, xs, labels, d, s):
        """Per-token cross entropy summed over each rank's positions,
        {(q, m): [B/dp] float32}, chunked over the sequence as in JAX:
        each chunk of C positions goes through the vocab head and reduces
        to logsumexp - target logit in fp32 (over vocab shards: a max and
        two psums over mp); with ``ce_remat`` each chunk is a checkpoint,
        so the backward recomputes its logits. Position t predicts
        labels[t + 1] (a chunk's last target comes from the next sep
        chunk); the final position has none: a dummy target's CE is
        subtracted from the sum (JAX's chunked branch; its sep > 1
        log_softmax branch computes the same mean unchunked)."""
        Q, M, P = self.sep, self.mp, self.pp
        B, T = labels.shape
        Bl, Tl = B // self.dp, T // Q
        rows = labels[d * Bl:(d + 1) * Bl]
        tgt_all = torch.cat([rows[:, 1:], rows[:, :1]], dim=1)
        C = min(256, Tl)
        while Tl % C:
            C //= 2
        nC = Tl // C
        out = {}
        for q in range(Q):
            keys = [(q, m) for m in range(M)]
            heads = [self._local(params, ("head",), (d, P - 1, s) + k)
                     for k in keys]
            tgt = tgt_all[:, q * Tl:(q + 1) * Tl]
            tg = [tgt.to(h.device) for h in heads]

            def chunk_ce(xcs, tcs, heads):
                logits = [(xc @ h).float() for xc, h in zip(xcs, heads)]
                if M == 1:
                    lse = torch.logsumexp(logits[0], dim=-1)
                    return [lse - logits[0].gather(
                        -1, tcs[0][..., None])[..., 0]]
                Vl = logits[0].shape[-1]
                mx = collective.pmax([lg.amax(-1) for lg in logits])
                se = collective.psum([torch.exp(lg - x[..., None]).sum(-1)
                                      for lg, x in zip(logits, mx)])
                picked = []
                for m, (lg, tc) in enumerate(zip(logits, tcs)):
                    i = tc - m * Vl
                    ok = (i >= 0) & (i < Vl)
                    pk = lg.gather(-1, i.clamp(0, Vl - 1)[..., None])[..., 0]
                    picked.append(torch.where(ok, pk, torch.zeros_like(pk)))
                picked = collective.psum(picked)
                return [torch.log(e) + x - p
                        for e, x, p in zip(se, mx, picked)]

            def body(xcs, tcs, heads):
                return [ce.sum(dim=-1) for ce in chunk_ce(xcs, tcs, heads)]

            xq = [xs[k] for k in keys]
            last = q == Q - 1
            if nC > 1:
                ce_rows = None
                for i in range(nC):
                    sl = slice(i * C, (i + 1) * C)
                    args = ([x[:, sl] for x in xq], [t[:, sl] for t in tg],
                            heads)
                    part = (checkpoint(body, *args, use_reentrant=False)
                            if self.ce_remat else body(*args))
                    ce_rows = part if ce_rows is None else [
                        a + b for a, b in zip(ce_rows, part)]
                if last:
                    dummy = chunk_ce([x[:, -1:] for x in xq],
                                     [t[:, -1:] for t in tg], heads)
                    ce_rows = [a - b[:, 0] for a, b in zip(ce_rows, dummy)]
            else:
                ces = chunk_ce(xq, tg, heads)
                ce_rows = [ce[:, :-1].sum(-1) if last else ce.sum(-1)
                           for ce in ces]
            out.update(zip(keys, ce_rows))
        return out

    def loss_fn(self, params, ids, labels):
        """Next-token cross entropy, the mean over B x (T - 1) positions:
        the sum of the ranks' chunked CE sums (``_group_ce``), each replica
        weighted 1 / (sharding x mp), psummed over the mesh."""
        ids, labels = self._ids(ids), self._ids(labels)
        self._check_batch(ids)
        B, T = ids.shape
        w = 1.0 / (self.sharding * self.mp)
        parts = []
        for d in range(self.dp):
            for s in range(self.sharding):
                xs = self._group_hidden(params, ids, d, s)
                for ce in self._group_ce(params, xs, labels, d, s).values():
                    parts.append(ce.sum() if w == 1.0 else ce.sum() * w)
        return collective.psum(parts)[0] / (B * (T - 1))

    def _ids(self, ids):
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids))
        return ids.to(device=self.device, dtype=torch.long)

    # -- optimizer ----------------------------------------------------------
    def _adamw(self, p, g, st, lr, step):
        """Update one chunk in place (p, m, v, master)."""
        if self._fused and self.moments_dtype == torch.float32:
            # one fused pass over p/g/m/v/master; the step's chunks on a
            # device share one device tensor of scalars
            if self._scal.get("key") != (lr, step):
                self._scal = {"key": (lr, step)}
            if p.device not in self._scal:
                self._scal[p.device] = adamw_scalars(
                    lr, self.b1, self.b2, self.eps, self.wd, step, p.device)
            fused_adamw_update(p, g, st["m"], st["v"], st["master"], lr,
                               self.b1, self.b2, self.eps, self.wd, step,
                               scal=self._scal[p.device])
            return
        dev = p.device
        lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
        step_t = torch.tensor(step, dtype=torch.float32, device=dev)
        g32 = g.float()
        m = self.b1 * st["m"].float() + (1 - self.b1) * g32
        v = self.b2 * st["v"].float() + (1 - self.b2) * g32 * g32
        mh = m / (1 - self.b1 ** step_t)
        vh = v / (1 - self.b2 ** step_t)
        upd = mh / (torch.sqrt(vh) + self.eps) + self.wd * st["master"]
        master = st["master"] - lr_t * upd
        st["m"].copy_(m)
        st["v"].copy_(v)
        st["master"].copy_(master)
        p.copy_(master)

    def reduce_grads(self, grads):
        """{path: {rank: gradient of that rank's copy}} -> {path: {rank:
        the summed gradient of the rank's ZeRO chunk (or whole shard)}}:
        a reduce-scatter (or all-reduce) over each shard's replicas."""
        out = {}
        for path, per_rank in grads.items():
            z = self._zdim(path)
            got = {}
            for group in self._replica_groups(path):
                gs = [per_rank[c] for c in group]
                if z is not None:
                    red = collective.reduce_scatter(
                        gs, z, [c[_AX["sharding"]] for c in group],
                        self.sharding)
                else:
                    red = collective.all_reduce(gs)
                got.update(zip(group, red))
            out[path] = got
        return out

    def _apply(self, path, grads, lr, step):
        """AdamW on every holder's chunk, then the all-gather of the
        updated chunks over 'sharding'."""
        z = self._zdim(path)
        shards = self._shards(tree_get(self.params, path))
        st = {k: self._shards(v)
              for k, v in tree_get(self.opt_state, path).items()}
        new = {}
        for c, p in shards.items():
            target = p if z is None else torch.empty(
                st["master"][c].shape, dtype=p.dtype, device=p.device)
            self._adamw(target, grads[c], {k: st[k][c] for k in st}, lr,
                        step)
            new[c] = target
        if z is None:
            return
        lines: Dict[tuple, list] = {}
        for c in shards:
            key = c[:_AX["sharding"]] + c[_AX["sharding"] + 1:]
            lines.setdefault(key, []).append(c)
        for line in lines.values():
            line.sort(key=lambda c: c[_AX["sharding"]])
            for c, full in zip(line, collective.all_gather(
                    [new[c] for c in line], z)):
                shards[c].copy_(full)

    def _leaves(self, params) -> List[torch.Tensor]:
        """Every rank's tensor of every leaf, in tree order."""
        return [t for p in tree_paths(params)
                for t in self._shards(tree_get(params, p)).values()]

    def _loss_and_reduced(self, ids, labels):
        paths = tree_paths(self.params)
        loss = self.loss_fn(self.params, ids, labels)
        gs = iter(torch.autograd.grad(loss, self._leaves(self.params)))
        per = {p: {c: next(gs) for c in self._shards(
            tree_get(self.params, p))} for p in paths}
        with torch.no_grad():
            return loss, self.reduce_grads(per)

    def grads(self, ids, labels=None):
        """(loss, {path: the global gradient}) of one step, reduced as
        ``train_step`` reduces it and assembled from the owned chunks
        (for checks; the step itself assembles nothing)."""
        loss, red = self._loss_and_reduced(ids, ids if labels is None
                                           else labels)
        return loss.detach(), {p: self.assemble(p, g, owned=True)
                               for p, g in red.items()}

    def train_step(self, ids, labels=None):
        """One AdamW step on (ids, labels); returns the loss (a 0-dim
        float32 tensor on the first rank's device, like the JAX step's)."""
        if labels is None:
            labels = ids
        self._stepno += 1
        loss, red = self._loss_and_reduced(ids, labels)
        with torch.no_grad():
            for path, g in red.items():
                self._apply(path, g, self.lr, self._stepno)
        return loss.detach()

    # -- analytics ----------------------------------------------------------
    def flops_per_token(self, seq_len=None):
        """Training FLOPs/token, the JAX trainer's convention: 6 x the
        matmul parameters (the vocab head once, the embedding gather not
        at all) plus the causal attention term 6 * L * H * T; remat
        recompute is not counted."""
        c = self.config
        H, F_, V = c.hidden_size, c.intermediate_size, c.vocab_size
        T = seq_len or c.max_position_embeddings
        KV = c.num_key_value_heads * self.head_dim
        per_layer = 2 * H * H + 2 * H * KV + 3 * H * F_
        matmul_params = c.num_hidden_layers * per_layer + V * H
        attn = 6 * c.num_hidden_layers * H * T
        return 6 * matmul_params + attn

    def param_count(self):
        return sum(int(np.prod(s[0])) for s in self._specs.values())
