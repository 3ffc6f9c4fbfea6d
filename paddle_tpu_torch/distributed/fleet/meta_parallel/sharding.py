"""Sharded data parallel, ZeRO stages 1-3 (counterpart of paddle_tpu/
distributed/fleet/meta_parallel/sharding.py:1-251).

The reference places optimizer states (and, at stage 3, parameters)
sharded over the mesh's ``sharding`` axis by ``_shard_spec``: the first
dimension that divides by the axis size, else replicated. The port's
sharding ranks are LOGICAL ranks of the installed mesh
(``parallel/mesh.py``), each holding its own tensors:

* stage 1 (``DygraphShardingOptimizer``): rank r keeps chunk r of every
  moment and fp32 master along that dimension (a replicated leaf is one
  tensor every rank reads). A step hands rank r chunk r of the global
  gradient (the one value of the global batch: nothing to reduce),
  updates its chunks through the inner optimizer's own rule, and
  all-gathers the parameter's updated chunks (one counted ``all_gather``
  per sharded parameter, ``parallel/collective.py``);
* stage 2 (``GroupShardedOptimizerStage2``): the same; a rank reads only
  its chunk of the global gradient, so sharding the gradients moves no
  more bytes on the global view;
* stage 3 (``GroupShardedStage3``): rank r also keeps chunk r of each
  such parameter, and the full parameter exists only from the first
  forward after a step (one counted ``all_gather`` per sharded
  parameter) until the next step, which updates the chunks and frees it.

``offload=True`` keeps the moments and fp32 masters in host memory
(pinned when the parameters are on a card): a step streams one
parameter's states to the card, updates them there and streams them
back, as the reference's ``_offload_step`` does, so the card holds at
most one parameter's optimizer state at a time. Offload on a mesh of
more than one rank raises, as in the reference.

The wrapper takes over the inner optimizer's ``step``, ``state_dict``
and ``set_state_dict`` (as the reference reroutes the inner optimizer's
step under offload), so a caller holding the original optimizer steps
through the shards too; ``state_dict()`` gives the global view under
the reference's keys.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from ....framework.io import save, tensor_name
from ....nn.layer.layers import Layer
from ....optimizer.optimizer import Optimizer
from ....parallel import collective
from ....parallel import mesh as mesh_mod

__all__ = ["DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "save_group_sharded_model",
           "shard_accumulators"]


def _axis_size(axis):
    m = mesh_mod._global_mesh
    return m.shape.get(axis, 1) if m is not None else 1


def _axis_devices(axis):
    """The devices of the ranks along ``axis`` (the other coordinates
    0)."""
    m = mesh_mod._global_mesh
    if m is None or axis not in m.shape:
        return [None]
    idx = [0] * len(m.axis_names)
    out = []
    for r in range(m.shape[axis]):
        idx[m.axis_names.index(axis)] = r
        out.append(m.devices[tuple(idx)])
    return out


def _shardable_dim(shape, n):
    for dim, s in enumerate(shape):
        if s % n == 0 and s >= n:
            return dim
    return None


def _shard_spec(shape, axis="sharding"):
    """The reference's placement of a leaf of ``shape``: a tuple with
    ``axis`` at the first dimension that divides by the axis size, None
    elsewhere; None when the leaf stays replicated."""
    n = _axis_size(axis)
    if n <= 1:
        return None
    dim = _shardable_dim(tuple(shape), n)
    if dim is None:
        return None
    return tuple(axis if i == dim else None for i in range(len(shape)))


def _split(t, dim, n, devices):
    """Rank r's own contiguous copy of chunk r of ``t`` along ``dim``."""
    return [c.to(d if d is not None else t.device).contiguous().clone()
            for c, d in zip(t.chunk(n, dim), devices)]


class _Leaf:
    """One parameter's optimizer states and master, per rank: ``dim`` the
    sharded dimension (None: one tensor every rank reads)."""

    def __init__(self, dim, states, master):
        self.dim = dim
        self.states = states        # {name: [tensor per rank]}
        self.master = master        # [tensor per rank] or None


class DygraphShardingOptimizer:
    """Stage 1: the optimizer states and masters of ``optimizer`` split
    over the logical ``sharding`` ranks; ``offload=True`` keeps them in
    host memory instead (one rank only)."""

    def __init__(self, optimizer, hcg=None, offload=False, **kwargs):
        # a schedule wrapper (gradient merge, local SGD) keeps its step;
        # the states are its inner optimizer's
        while not isinstance(optimizer, Optimizer) and \
                hasattr(optimizer, "_inner_opt"):
            optimizer = optimizer._inner_opt
        self._inner_opt = optimizer
        self._hcg = hcg
        self._offload = bool(offload)
        mesh = mesh_mod._global_mesh
        if self._offload and mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                "offload=True with a mesh of more than one rank is not "
                "supported (as in the reference): use offload on one "
                "rank, or sharding without offload")
        self._n = 1 if self._offload else _axis_size("sharding")
        self._devices = ([None] if self._offload
                         else _axis_devices("sharding"))
        if self._n > 1 and not getattr(optimizer, "_elementwise", True):
            raise NotImplementedError(
                f"{type(optimizer).__name__} under sharding: its update "
                f"reads whole parameters (norms, top-k), not chunks")
        self._leaves: Dict[torch.Tensor, _Leaf] = {}
        self._stage3: Optional["GroupShardedStage3"] = None
        # states the inner optimizer made before wrapping move to shards
        for p in list(optimizer._accumulators):
            self._adopt(p, optimizer._accumulators.pop(p),
                        optimizer._master_weights.pop(p, None))
        optimizer.step = self.step
        optimizer.state_dict = self.state_dict
        optimizer.set_state_dict = optimizer.set_dict = self.set_state_dict

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)

    # -- placement ---------------------------------------------------------
    def _dim(self, p):
        if self._n <= 1:
            return None
        return _shardable_dim(tuple(p.shape), self._n)

    def _host(self, t):
        """A host copy of ``t`` (pinned when it is on a card)."""
        if t.device.type != "cuda":
            return t.detach().clone()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def _adopt(self, p, states, master):
        """Place ``p``'s full states and master as this wrapper keeps
        them."""
        dim = self._dim(p)
        if self._offload:
            self._leaves[p] = _Leaf(None, {k: [self._host(v)] for k, v in
                                           states.items()},
                                    None if master is None
                                    else [self._host(master)])
            return
        if dim is None:
            self._leaves[p] = _Leaf(None, {k: [v] * self._n for k, v in
                                           states.items()},
                                    None if master is None
                                    else [master] * self._n)
            return
        split = lambda t: _split(t, dim, self._n, self._devices)  # noqa: E731
        self._leaves[p] = _Leaf(dim, {k: split(v) for k, v in
                                      states.items()},
                                None if master is None else split(master))

    def _leaf(self, p):
        leaf = self._leaves.get(p)
        if leaf is None:
            opt = self._inner_opt
            master = p.detach().float() if opt._needs_master(p) else None
            if self._offload:
                # zeros made in host memory, not on the card
                pin = p.device.type == "cuda"
                self._leaves[p] = _Leaf(None, {
                    k: [torch.zeros(p.shape, dtype=torch.float32,
                                    pin_memory=pin)]
                    for k in opt._accum_names},
                    None if master is None else [self._host(master)])
            else:
                self._adopt(p, opt._init_state(p), master)
            leaf = self._leaves[p]
        return leaf

    def bytes_per_rank(self) -> List[int]:
        """The bytes of moments and masters each sharding rank holds (a
        replicated leaf counts whole on every rank)."""
        out = [0] * self._n
        for leaf in self._leaves.values():
            tensors = list(leaf.states.values()) + (
                [leaf.master] if leaf.master is not None else [])
            for per_rank in tensors:
                for r, t in enumerate(per_rank):
                    out[r] += t.numel() * t.element_size()
        return out

    # -- the step ------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        opt = self._inner_opt
        params = opt._prepare_step()
        if params is None:
            return
        if self._offload:
            return self._offload_step(params)
        n = self._n
        # one foreach update per rank over its chunks; replicated leaves
        # once, on rank 0's list
        lists = [([], [], [], []) for _ in range(n)]
        finish = []
        for p in params:
            leaf = self._leaf(p)
            g = opt._grad(p)
            if leaf.dim is None:
                q = leaf.master[0] if leaf.master is not None else p
                lists[0][0].append(p)
                lists[0][1].append(q)
                lists[0][2].append(g)
                lists[0][3].append({k: v[0] for k, v in
                                    leaf.states.items()})
                if q is not p:
                    finish.append((p, None, q))
                continue
            gs = g.chunk(n, leaf.dim)
            chunks = self._stage3._pchunks[p] if (
                self._stage3 is not None and p in self._stage3._pchunks) \
                else None
            if leaf.master is not None:
                vals = leaf.master
            elif chunks is not None:
                vals = chunks
            else:
                vals = [c.clone() for c in p.detach().chunk(n, leaf.dim)]
            for r in range(n):
                lists[r][0].append(p)
                lists[r][1].append(vals[r])
                lists[r][2].append(gs[r].to(vals[r].device))
                lists[r][3].append({k: v[r] for k, v in
                                    leaf.states.items()})
            finish.append((p, leaf, vals))
        for ps_, qs, gs_, sts in lists:
            if ps_:
                opt._update_lists(ps_, qs, gs_, sts)
        for p, leaf, vals in finish:
            if leaf is None:            # a replicated master
                p.copy_(vals)
                continue
            if self._stage3 is not None and p in self._stage3._pchunks:
                chunks = self._stage3._pchunks[p]
                if vals is not chunks:
                    for c, v in zip(chunks, vals):
                        c.copy_(v)
                self._stage3._release(p)
                continue
            full = collective.all_gather(
                [v.to(p.dtype) for v in vals], leaf.dim)
            p.copy_(full[0])

    def _offload_step(self, params):
        """Per parameter: its states and master to the card, the update
        there, and back to host memory."""
        opt = self._inner_opt
        for p in params:
            leaf = self._leaf(p)
            dev = p.device
            st = {k: v[0].to(dev, non_blocking=True)
                  for k, v in leaf.states.items()}
            q = (leaf.master[0].to(dev, non_blocking=True)
                 if leaf.master is not None else p)
            opt._update_lists([p], [q], [opt._grad(p)], [st])
            for k, v in leaf.states.items():
                if v[0] is not st[k]:
                    v[0].copy_(st[k], non_blocking=True)
            if q is not p:
                if leaf.master[0] is not q:
                    leaf.master[0].copy_(q, non_blocking=True)
                p.copy_(q)
        if params and params[0].device.type == "cuda":
            torch.cuda.current_stream(params[0].device).synchronize()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return [], []

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    # -- checkpoint ----------------------------------------------------------
    def _full(self, leaf, per_rank):
        if leaf.dim is None:
            return per_rank[0].detach().clone()
        return collective.all_gather(per_rank, leaf.dim)[0].clone()

    def state_dict(self):
        """The global view, under the reference's keys (a sharded leaf
        gathered: one counted ``all_gather``)."""
        out, masters = {}, {}
        for p, leaf in self._leaves.items():
            name = tensor_name(p)
            for k, v in leaf.states.items():
                out[f"{name}_{k}"] = self._full(leaf, v)
            if leaf.master is not None:
                masters[name] = self._full(leaf, leaf.master)
        out["global_step"] = self._inner_opt._step_count
        if masters:
            out["master_weights"] = masters
        return out

    def set_state_dict(self, state):
        """Load a global-view ``state`` (either package's) and place it."""
        opt = self._inner_opt
        opt._accumulators.clear()
        opt._master_weights.clear()
        type(opt).set_state_dict(opt, state)
        self._leaves.clear()
        for p in list(opt._accumulators):
            self._adopt(p, opt._accumulators.pop(p),
                        opt._master_weights.pop(p, None))

    set_dict = set_state_dict


def shard_accumulators(optimizer, axis="sharding"):
    """Split ``optimizer``'s states (those it has made and those it
    makes later) over the ``sharding`` ranks; returns ``optimizer``,
    whose step now runs on the shards."""
    if axis != "sharding":
        raise NotImplementedError("states shard over the 'sharding' axis")
    DygraphShardingOptimizer(optimizer)
    return optimizer


class GroupShardedOptimizerStage2(DygraphShardingOptimizer):
    """Stage 2: stage 1's placement (each rank reads only its chunk of
    the global gradient)."""

    def __init__(self, params, optim, group=None, offload=False, **kw):
        super().__init__(optim, offload=offload)
        self._params = list(params)


class GroupShardedStage2(Layer):
    """The model of stage 2: calls pass through."""

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23, **kw):
        super().__init__()
        self._layer = layer
        self._opt = sharding_optimizer

    def forward(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layer.state_dict(*args, **kwargs)


class GroupShardedStage3(Layer):
    """Stage 3: each parameter with a dividing dimension is kept as one
    chunk per ``sharding`` rank; the layer's first forward after a step
    gathers the full parameters (one counted ``all_gather`` each), and
    the step updates the chunks and frees them. The optimizer's states
    shard as at stage 1 (``offload=True``: in host memory, one rank)."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 *, device=None, segment_size=2 ** 20,
                 pertrain_sync_models=True, offload=False, **kw):
        # the reference's ``device`` and what follows it are keyword-only
        # here (``device`` is the port's placement keyword)
        super().__init__()
        self._layer = layer
        self._pchunks: Dict[torch.Tensor, List[torch.Tensor]] = {}
        self._dims: Dict[torch.Tensor, int] = {}
        n = 1 if offload else _axis_size("sharding")
        devices = _axis_devices("sharding")
        with torch.no_grad():
            for p in layer.parameters():
                dim = _shardable_dim(tuple(p.shape), n) if n > 1 else None
                if dim is None:
                    continue
                self._dims[p] = dim
                self._pchunks[p] = _split(p.detach(), dim, n, devices)
                self._release(p)
        layer.register_forward_pre_hook(lambda m, args: self._gather())
        self._opt = None
        if optimizer is not None:
            self._opt = DygraphShardingOptimizer(optimizer, offload=offload)
            self._opt._stage3 = self

    def _release(self, p):
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    @torch.no_grad()
    def _gather(self):
        """Every freed sharded parameter made whole again."""
        for p, chunks in self._pchunks.items():
            if p.numel() == 0:
                p.data = collective.all_gather(chunks, self._dims[p])[0]

    def forward(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def param_bytes_per_rank(self) -> List[int]:
        """The parameter bytes each sharding rank keeps between steps (a
        parameter that does not divide counts whole on every rank)."""
        n = max((len(c) for c in self._pchunks.values()), default=1)
        out = [0] * n
        for p in self._layer.parameters():
            if p in self._pchunks:
                for r, c in enumerate(self._pchunks[p]):
                    out[r] += c.numel() * c.element_size()
            else:
                for r in range(n):
                    out[r] += p.numel() * p.element_size()
        return out

    def get_all_parameters(self):
        """The full parameters (gathered where freed)."""
        self._gather()
        return list(self._layer.parameters())

    def state_dict(self, *args, **kwargs):
        self._gather()
        return self._layer.state_dict(*args, **kwargs)


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``level`` "os" (stage 1), "os_g" (stage 2) or "p_g_os" (stage 3):
    (model, optimizer, scaler) wrapped for it."""
    if level == "os":
        return model, DygraphShardingOptimizer(optimizer,
                                               offload=offload), scaler
    if level == "os_g":
        opt = GroupShardedOptimizerStage2(model.parameters(), optimizer,
                                          offload=offload)
        return GroupShardedStage2(model, opt), opt, scaler
    if level == "p_g_os":
        wrapped = GroupShardedStage3(model, optimizer, offload=offload)
        return wrapped, wrapped._opt, scaler
    raise ValueError(f"unknown group_sharded level {level}")


def save_group_sharded_model(model, output, optimizer=None):
    """``model.pdmodel`` (and ``model.pdopt``) under ``output``, in the
    ``paddle.save`` layout."""
    layer = model._layer if isinstance(
        model, (GroupShardedStage2, GroupShardedStage3)) else model
    if isinstance(model, GroupShardedStage3):
        model._gather()
    os.makedirs(output, exist_ok=True)
    save(layer.state_dict(), os.path.join(output, "model.pdmodel"))
    if optimizer is not None:
        save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
