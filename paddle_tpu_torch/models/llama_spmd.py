"""The training flagship on one device — the counterpart of
``paddle_tpu/models/llama_spmd.py``'s ``LlamaSpmdTrainer``.

The JAX trainer is one jitted program over a device mesh (dp, mp, pp,
sep, ZeRO sharding). This port runs its single-device step in eager
PyTorch: the same parameter tree (``embed``, ``norm``, ``head`` and
``blocks`` with ``wq``..``ln2``, block leaves stacked ``[1, L, ...]`` as
the JAX tree's ``[pp, layers_per_stage, ...]``), the same block math
(RMSNorm, rotary embeddings, causal GQA attention, SwiGLU), the same
chunked cross entropy and the same AdamW with fp32 master weights.
Gradients come from ``torch.autograd.grad``; the update writes ``p``,
``m``, ``v`` and ``master`` in place (JAX returns new arrays; in place
keeps one copy of the optimizer state in memory).

One attribute, ``_fused`` (JAX's ``_pallas_fused``), gates the four
hand-written kernels of the step: the fused RMSNorm (plain and with the
residual add), flash attention forward and backward (when ``hd % 64 ==
0`` and ``T % 128 == 0``) and the fused AdamW (fp32 moments). It is True
exactly on CUDA. The JAX package leaves its fused path off by default on
the TPU because XLA fuses the jnp chain of the step there and a Pallas
call is a fusion barrier; eager PyTorch fuses nothing, so on the card the
kernels are the port's path. With ``_fused`` False the step runs JAX's
jnp branches written in PyTorch.

Meshes and pipelines are not ported (ROADMAP Queue A): ``n_virtual > 1``,
``remat_stage`` and the ``save_dots``/``save_attn`` remat policies raise
NotImplementedError.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.hopper.flash_attention import flash_attention_blhd
from ..ops.hopper.fused_adamw import adamw_scalars, fused_adamw_update
from ..ops.hopper.fused_norm import fused_rms_norm, fused_rms_norm_residual
from .llama import LlamaConfig

_NOT_PORTED = ("is not ported yet: the port trains on one device "
               "(ROADMAP Queue A, the dp/pp/mp/sharding/sep axes and the "
               "remat policies)")

# block leaves in the JAX tree's order: (name, shape from (H, KV, F))
_BLOCK_SHAPES = (
    ("wq", lambda H, KV, F_: (H, H)),
    ("wk", lambda H, KV, F_: (H, KV)),
    ("wv", lambda H, KV, F_: (H, KV)),
    ("wo", lambda H, KV, F_: (H, H)),
    ("wg", lambda H, KV, F_: (H, F_)),
    ("wu", lambda H, KV, F_: (H, F_)),
    ("wd", lambda H, KV, F_: (F_, H)),
    ("ln1", lambda H, KV, F_: (H,)),
    ("ln2", lambda H, KV, F_: (H,)),
)


def tree_paths(params) -> List[Tuple[str, ...]]:
    """Key paths of the parameter tree's leaves in jax.tree_util order
    (dict keys sorted)."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.extend((k,) + p for p in tree_paths(v))
        else:
            out.append((k,))
    return out


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class LlamaSpmdTrainer:
    def __init__(self, config: LlamaConfig, lr=3e-4, weight_decay=0.1,
                 beta1=0.9, beta2=0.95, eps=1e-8, remat=True,
                 n_micro=None, seed=0, compute_dtype=torch.bfloat16,
                 remat_policy="full", n_virtual=1, remat_stage=False,
                 moments_dtype=torch.float32, ce_remat=True,
                 scan_unroll=1, device=None):
        self.config = config
        self.lr = lr
        self.wd = weight_decay
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.remat = remat
        if remat_policy not in ("full", "save_dots", "save_attn"):
            raise ValueError(f"remat_policy must be 'full', 'save_dots' "
                             f"or 'save_attn', got {remat_policy!r}")
        if remat_policy != "full":
            raise NotImplementedError(f"remat_policy={remat_policy!r} "
                                      + _NOT_PORTED)
        if int(n_virtual) != 1:
            raise NotImplementedError(f"n_virtual={n_virtual} " + _NOT_PORTED)
        if remat_stage:
            raise NotImplementedError("remat_stage " + _NOT_PORTED)
        self.remat_policy = remat_policy
        self.compute_dtype = compute_dtype
        self.moments_dtype = moments_dtype
        self.ce_remat = ce_remat
        # kept for the JAX signature: PyTorch runs the layers as a loop
        self.scan_unroll = int(scan_unroll)
        self.device = resolve_device(device)
        self.pp = 1
        self.n_micro = n_micro or max(2 * self.pp, 1)
        self.n_virtual = 1
        self.remat_stage = False
        self.layers_per_stage = config.num_hidden_layers
        # the hand-written kernels are the CUDA path (see the module
        # docstring); tests set this by hand to run the kernels' plain
        # versions on the CPU, or the jnp branches on the card
        self._fused = self.device.type == "cuda"
        self.head_dim = config.hidden_size // config.num_attention_heads
        self._stepno = 0
        self._scal = None
        self.params = self._init_params(seed)
        self.opt_state = self._init_opt_state()

    # -- parameters ---------------------------------------------------------
    def _init_params(self, seed):
        """Random weights from ``seed`` (std 0.02, norms ones), drawn by a
        torch.Generator on the trainer's device."""
        c = self.config
        dev, dt = self.device, self.compute_dtype
        H, V = c.hidden_size, c.vocab_size
        KV = c.num_key_value_heads * self.head_dim
        gen = torch.Generator(device=dev).manual_seed(int(seed))

        def init(shape, ones=False):
            if ones:
                return torch.ones(shape, dtype=dt, device=dev)
            return (0.02 * torch.randn(shape, generator=gen,
                                       device=dev)).to(dt)

        params = {"embed": init((V, H)), "norm": init((H,), ones=True),
                  "head": init((H, V))}
        lead = (1, self.layers_per_stage)
        params["blocks"] = {
            name: init(lead + shape(H, KV, c.intermediate_size),
                       ones=name.startswith("ln"))
            for name, shape in _BLOCK_SHAPES}
        for p in self._leaves(params):
            p.requires_grad_(True)
        return params

    def _init_opt_state(self):
        def state(p):
            return {"m": torch.zeros(p.shape, dtype=self.moments_dtype,
                                     device=p.device),
                    "v": torch.zeros(p.shape, dtype=self.moments_dtype,
                                     device=p.device),
                    "master": p.detach().float().clone()}
        st = {}
        for path in tree_paths(self.params):
            node = st
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = state(tree_get(self.params, path))
        return st

    @staticmethod
    def _leaves(params) -> List[torch.Tensor]:
        return [tree_get(params, p) for p in tree_paths(params)]

    # -- model math ---------------------------------------------------------
    def _rope(self, T, offset=0):
        d = self.head_dim
        dev = self.device
        inv = 1.0 / (self.config.rope_theta ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=dev) / d))
        t = torch.arange(T, dtype=torch.float32, device=dev) + offset
        freqs = torch.outer(t, inv)
        emb = torch.cat([freqs, freqs], dim=-1)
        return torch.cos(emb), torch.sin(emb)

    def _block(self, bp, x):
        """One decoder block. x: [B, T, H]."""
        c = self.config
        nh = c.num_attention_heads
        nkv = c.num_key_value_heads
        hd = self.head_dim
        dt = x.dtype
        B, T, H = x.shape

        def rms(h, w):
            h32 = h.float()
            out = h32 * torch.rsqrt((h32 * h32).mean(-1, keepdim=True)
                                    + c.rms_norm_eps)
            return (out * w.float()).to(dt)

        if self._fused:
            h = fused_rms_norm(x, bp["ln1"], c.rms_norm_eps)
        else:
            h = rms(x, bp["ln1"])
        q = (h @ bp["wq"]).reshape(B, T, nh, hd)
        k = (h @ bp["wk"]).reshape(B, T, nkv, hd)
        v = (h @ bp["wv"]).reshape(B, T, nkv, hd)
        cos, sin = self._rope(T)
        cos = cos[None, :, None, :].to(dt)
        sin = sin[None, :, None, :].to(dt)

        def rot(u):
            u1, u2 = u.chunk(2, dim=-1)
            return torch.cat([-u2, u1], dim=-1)

        q = q * cos + rot(q) * sin
        k = k * cos + rot(k) * sin

        scale = 1.0 / math.sqrt(hd)
        use_flash = self._fused and hd % 64 == 0 and T % 128 == 0
        if use_flash:
            if nkv != nh:
                # the kernel takes equal head counts
                rep = nh // nkv
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            attn = flash_attention_blhd(q, k, v, causal=True,
                                        sm_scale=scale)
        else:
            # JAX's dense branches; its fp32 scores come from bf16
            # operands (preferred_element_type=float32): the operands are
            # upcast here, a product of two bf16 values being exact in fp32
            mask = torch.ones((T, T), dtype=torch.bool,
                              device=x.device).tril()
            neg = torch.full((), -1e30, device=x.device)
            if nkv != nh:
                # grouped-query attention without repeating K/V
                g = nh // nkv
                qg = q.reshape(B, T, nkv, g, hd)
                scores = torch.einsum("bqngd,bknd->bngqk", qg.float(),
                                      k.float()) * scale
                probs = torch.softmax(torch.where(mask, scores, neg),
                                      dim=-1).to(dt)
                attn = torch.einsum("bngqk,bknd->bqngd", probs, v)
                attn = attn.reshape(B, T, nh, hd)
            else:
                scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                      k.float()) * scale
                probs = torch.softmax(torch.where(mask, scores, neg),
                                      dim=-1).to(dt)
                attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        attn = attn.reshape(B, T, nh * hd)
        if self._fused:
            # fused residual add + RMSNorm: one pass over x and the branch
            h, x = fused_rms_norm_residual(attn @ bp["wo"], x, bp["ln2"],
                                           c.rms_norm_eps)
        else:
            x = x + attn @ bp["wo"]
            h = rms(x, bp["ln2"])
        # jax.nn.silu is x * sigmoid(x), rounded after each op in bf16
        gate = h @ bp["wg"]
        gate = gate * torch.sigmoid(gate)
        up = h @ bp["wu"]
        return x + (gate * up) @ bp["wd"]

    def _stage_fn(self, stage_params, x):
        """Run the stage's blocks in order; with remat each block is a
        non-reentrant checkpoint, so its forward (kernels included) runs
        again in the backward."""
        n = next(iter(stage_params.values())).shape[0]
        for i in range(n):
            bp = {k: v[i] for k, v in stage_params.items()}
            if self.remat:
                x = checkpoint(self._block, bp, x, use_reentrant=False)
            else:
                x = self._block(bp, x)
        return x

    def forward(self, params, ids):
        """ids: [B, T] -> logits [B, T, V]."""
        return self.forward_hidden(params, ids) @ params["head"]

    def forward_hidden(self, params, ids):
        """ids: [B, T] -> final-norm hidden states [B, T, H] (pre-head)."""
        ids = self._ids(ids)
        x = params["embed"][ids].to(self.compute_dtype)
        stage = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                 for k, v in params["blocks"].items()}
        x = self._stage_fn(stage, x)
        # the final norm stays plain, as in JAX
        x32 = x.float()
        x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                                + self.config.rms_norm_eps)
        return (x32 * params["norm"].float()).to(self.compute_dtype)

    def loss_fn(self, params, ids, labels):
        """Next-token cross entropy, chunked over the sequence as in JAX:
        each chunk of C positions goes through the vocab head and reduces
        to per-token CE (logsumexp - target logit) in fp32; with
        ``ce_remat`` each chunk is a checkpoint, so the backward
        recomputes its logits instead of keeping them."""
        x = self.forward_hidden(params, ids)          # [B, T, H]
        labels = self._ids(labels)
        B, T, H = x.shape
        head = params["head"]
        # position t predicts labels[t+1]; the final position has no
        # target — give it a dummy and subtract it from the sum
        tgt = torch.cat([labels[:, 1:], labels[:, :1]], dim=1)
        C = min(256, T)
        while T % C:
            C //= 2
        nC = T // C

        def chunk_ce(xc, tc):
            logits = (xc @ head).float()                 # [B, C, V]
            lse = torch.logsumexp(logits, dim=-1)        # [B, C]
            picked = logits.gather(-1, tc[..., None])[..., 0]
            return lse - picked                          # [B, C]

        def body(xc, tc):
            return chunk_ce(xc, tc).sum(dim=-1)

        if nC > 1:
            ce_rows = torch.zeros((B,), dtype=torch.float32, device=x.device)
            for i in range(nC):
                xc, tc = x[:, i * C:(i + 1) * C], tgt[:, i * C:(i + 1) * C]
                ce_rows = ce_rows + (checkpoint(body, xc, tc,
                                                use_reentrant=False)
                                     if self.ce_remat else body(xc, tc))
            ce_rows = ce_rows - chunk_ce(x[:, -1:], tgt[:, -1:])[:, 0]
        else:
            ce_rows = chunk_ce(x, tgt)[:, :-1].sum(dim=-1)
        return ce_rows.sum() / (B * (T - 1))

    def _ids(self, ids):
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids))
        return ids.to(device=self.device, dtype=torch.long)

    # -- optimizer ----------------------------------------------------------
    def _adamw(self, p, g, st, lr, step):
        """Update one leaf in place (p, m, v, master)."""
        if self._fused and self.moments_dtype == torch.float32:
            # one fused pass over p/g/m/v/master; the 12 leaves of a step
            # share one device tensor of scalars
            if self._scal is None or self._scal[0] != (lr, step):
                self._scal = ((lr, step), adamw_scalars(
                    lr, self.b1, self.b2, self.eps, self.wd, step,
                    p.device))
            fused_adamw_update(p, g, st["m"], st["v"], st["master"], lr,
                               self.b1, self.b2, self.eps, self.wd, step,
                               scal=self._scal[1])
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

    def train_step(self, ids, labels=None):
        """One AdamW step on (ids, labels); returns the loss (a 0-dim
        float32 tensor on the device, like the JAX step's)."""
        if labels is None:
            labels = ids
        self._stepno += 1
        paths = tree_paths(self.params)
        leaves = [tree_get(self.params, p) for p in paths]
        loss = self.loss_fn(self.params, ids, labels)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for path, p, g in zip(paths, leaves, grads):
                self._adamw(p, g, tree_get(self.opt_state, path), self.lr,
                            self._stepno)
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
        return sum(p.numel() for p in self._leaves(self.params))

