"""Per-leaf cross-replica weight-update sharding (``--update_sharding
sharded``), the port of the JAX package's ``parallel/update_sharding.py``,
and the layout both sharded forms (``sharded``, and ``zero1``'s flat
buffer in ``parallel.data_parallel``) share for their optimizer state.

* **Plan** (:func:`plan_updates`): every parameter leaf's update is
  sharded along its LARGEST dimension over the data ranks, that dimension
  padded to a multiple of the data-rank count N; a leaf under
  ``min_shard_elems`` elements (or any leaf when N <= 1) keeps the
  replicated update.  The decision depends on the leaf's shape only.
* **State** (:func:`init_opt_state`): the optimizer is initialised on
  this rank's 1/N slices of the PADDED params cast to f32 (slots are f32
  whatever the params' dtype).
* **Step** (:func:`sharded_update`): per sharded leaf, the f32 gradient is
  reduce-scattered along its planned axis, divided by the global count,
  the optimizer updates this rank's slice of the padded param with its
  1/N state, and the slices are all-gathered, trimmed and written into
  the param in place.  Replicated leaves and the loss terms take one flat
  all-reduce over the whole world.  ``grad_clip`` clips by the GLOBAL
  norm: the replicated squares plus one scalar all-reduce of the sharded
  squares.  Telemetry (``with_metrics``) takes that norm too, and the
  update norm from the update's own slices: the replicated leaves' plus
  one more scalar all-reduce of the sharded slices' squares.
* **Snapshots** (:class:`ShardedLayout`): a snapshot holds the global
  padded opt-state arrays, as the JAX package writes them; they are
  gathered leaf by leaf to rank 0's host, which writes them, and every
  rank restores into a host template and copies only its own slice to
  its card.

Under ``data x seq`` the sequence ranks of one data index hold the same
slices: a sharded gradient slice is all-reduced over the sequence group
after the data reduce-scatter (JAX's ``extra_reduce_axes``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.optim import Optimizer, global_norm
from ..utils.tree import leaves, tree_map, unflatten

DEFAULT_MIN_SHARD_ELEMS = 1024


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """``axis=None``: the replicated update.  Otherwise the leaf's
    dimension ``axis`` is padded to ``padded`` and each data rank owns a
    ``shard``-long slice of it."""

    axis: Optional[int]
    padded: int = 0
    shard: int = 0


def plan_updates(params: Any, n: int,
                 min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS) -> Any:
    """The params' tree with a :class:`LeafPlan` in place of each tensor."""

    def one(leaf: torch.Tensor) -> LeafPlan:
        shape = tuple(leaf.shape)
        if n <= 1 or not shape or int(np.prod(shape)) < min_shard_elems:
            return LeafPlan(None)
        axis = int(np.argmax(shape))
        padded = -(-shape[axis] // n) * n
        return LeafPlan(axis, padded, padded // n)

    return tree_map(one, params)


def plan_leaves(plan: Any) -> List[LeafPlan]:
    """The plans in the params' leaf order."""
    if isinstance(plan, LeafPlan):
        return [plan]
    values = plan.values() if isinstance(plan, dict) else plan
    return [p for v in values for p in plan_leaves(v)]


def pad_leaf(x: torch.Tensor, plan: LeafPlan) -> torch.Tensor:
    """Zero-pad the planned dimension to ``plan.padded`` (``x`` itself for
    a replicated leaf or an already padded shape)."""
    if plan.axis is None or x.shape[plan.axis] == plan.padded:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - plan.axis) + 1] = plan.padded - x.shape[plan.axis]
    return torch.nn.functional.pad(x, widths)


def _slice(x: torch.Tensor, axis: Optional[int], n: int,
           index: int) -> torch.Tensor:
    """This rank's 1/n of ``x`` along ``axis``, as its own tensor."""
    if axis is None:
        return x
    shard = x.shape[axis] // n
    return x.narrow(axis, index * shard, shard).clone()


def _reduce_scatter(full: torch.Tensor, axis: int, n: int,
                    group=None) -> torch.Tensor:
    """Sum over the group, keeping this rank's slice along ``axis``
    (``reduce_scatter_tensor`` scatters along dim 0 only)."""
    x = full.movedim(axis, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, axis)


def all_gather(part: torch.Tensor, axis: int, n: int,
               group=None) -> torch.Tensor:
    """The group's slices joined along ``axis``."""
    x = part.movedim(axis, 0).contiguous()
    out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, axis)


class ShardedLayout:
    """Where each tensor leaf of a rank's optimizer state sits in the
    global snapshot arrays: ``axes[i]`` is the axis leaf ``i`` (in
    ``leaves`` order) is sliced along, or None for a replicated leaf;
    slices are 1/``n`` over ``group`` (the data ranks), this rank's at
    ``index``."""

    def __init__(self, axes: List[Optional[int]], n: int, index: int,
                 group=None):
        self.axes, self.n, self.index, self.group = axes, n, index, group

    @classmethod
    def mirroring(cls, plans: List[LeafPlan], opt_state: Any, n: int,
                  index: int, group=None) -> "ShardedLayout":
        """The layout of optimizer slots that mirror the param tree
        (momentum, mu, nu, the master copy): slot leaf ``i`` follows
        param leaf ``i % len(plans)``; 0-d leaves (the optimizer's and the
        skip guard's counts) are replicated."""
        slots = [x for x in leaves(opt_state) if x.dim()]
        if len(slots) % len(plans):
            raise ValueError(f"{len(slots)} opt-state leaves do not "
                             f"mirror {len(plans)} params")
        axes, i = [], 0
        for x in leaves(opt_state):
            if x.dim():
                axes.append(plans[i % len(plans)].axis)
                i += 1
            else:
                axes.append(None)
        return cls(axes, n, index, group)

    def scatter(self, opt_state: Any, device=None) -> Any:
        """Global (padded) opt state -> this rank's slices, on ``device``
        (default: where each leaf is); only the slice is copied there."""
        return unflatten(opt_state, [
            _slice(x, a, self.n, self.index).to(device or x.device)
            for x, a in zip(leaves(opt_state), self.axes)])

    def _global_shape(self, x: torch.Tensor, axis: Optional[int]):
        shape = list(x.shape)
        if axis is not None:
            shape[axis] *= self.n
        return shape

    def host_template(self, opt_state: Any) -> Any:
        """Uninitialised host tensors of the global padded shapes of this
        rank's slices ``opt_state``: a restore's template, built with no
        collective."""
        return unflatten(opt_state, [
            torch.empty(self._global_shape(x, a), dtype=x.dtype)
            for x, a in zip(leaves(opt_state), self.axes)])

    def gather_to_host(self, opt_state: Any) -> Optional[Any]:
        """This rank's slices -> the global padded opt state on the host of
        global rank 0 (None on the other ranks), gathered leaf by leaf so a
        card holds one global leaf at a time beside its slices
        (collective over the group: every rank calls it).  With one data
        rank the slices are the global arrays, and stay where they are."""
        if self.n == 1:
            return opt_state
        root = dist.get_rank() == 0
        out = []
        for x, a in zip(leaves(opt_state), self.axes):
            if a is not None:
                x = all_gather(x, a, self.n, self.group)
            out.append(x.cpu() if root else None)
        return unflatten(opt_state, out) if root else None


def init_opt_state(optimizer: Optimizer, params: Any, plan: Any,
                   n: int, index: int, group=None):
    """(this rank's opt state, its :class:`ShardedLayout`): the optimizer
    initialised on this rank's 1/N slices of the padded params in f32, so
    no rank ever holds the full state."""
    plans = plan_leaves(plan)
    sliced = unflatten(params, [
        _slice(pad_leaf(p.detach(), pl).float(), pl.axis, n, index)
        for p, pl in zip(leaves(params), plans)])
    state = optimizer.init(sliced)
    return state, ShardedLayout.mirroring(plans, state, n, index, group)


def _sq(xs: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if not xs:
        return torch.zeros((), dtype=torch.float32, device=like.device)
    return global_norm(xs) ** 2


@torch.no_grad()
def sharded_update(optimizer: Optimizer, params: Any, opt_state: Any,
                   s: torch.Tensor, c: torch.Tensor,
                   grads: List[Optional[torch.Tensor]], world,
                   grad_clip: float = 0.0,
                   plans: Optional[List[LeafPlan]] = None,
                   with_metrics: bool = False):
    """The per-leaf sharded update of one step from this rank's loss sum
    ``s``, count ``c`` and gradient sums ``grads`` (``params``' leaf
    order): returns (opt_state, global mean loss, ``ok``, and with
    ``with_metrics`` the global (grad norm, update norm), else None).
    ``params`` are written in place.  Under the skip guard (``optimizer.update_with_norm``)
    the global norm of the reduced gradient, taken before clipping, goes
    to the guard and ``ok`` is its verdict (None without the guard).
    ``grads`` is consumed: each entry is released once reduced,
    so the full-size gradients are not held through the update (the
    replicated step drops them the same way).  ``plans``: one
    :class:`LeafPlan` per leaf; by default the params' :func:`plan_updates`
    over the data ranks, which depends on their shapes only, as the opt
    state's does (``zero1`` passes its one flat buffer's)."""
    if plans is None:
        plans = plan_leaves(plan_updates(params, world.dp))
    ps = leaves(params)
    n, idx, data_pg = world.dp, world.data_rank, world.data_pg
    rep = [i for i, pl in enumerate(plans) if pl.axis is None]
    vals = [grads[i].float() for i in rep] + [s.reshape(1), c.reshape(1)]
    for i in rep:
        grads[i] = None
    if world.initialized:
        flat = torch.cat([v.reshape(-1).float() for v in vals])
        dist.all_reduce(flat)
        vals = [part.view(v.shape) for part, v in zip(
            torch.split(flat, [v.numel() for v in vals]), vals)]
    total = vals[-1][0]
    loss = vals[-2][0] / total
    g_mixed: List[Optional[torch.Tensor]] = [None] * len(ps)
    p_mixed: List[Optional[torch.Tensor]] = [None] * len(ps)
    for i, g in zip(rep, vals[:-2]):
        g_mixed[i], p_mixed[i] = g / total, ps[i]
    for i, pl in enumerate(plans):
        if pl.axis is None:
            continue
        gs = pad_leaf(grads[i].float(), pl)
        grads[i] = None
        if n > 1:
            gs = _reduce_scatter(gs, pl.axis, n, data_pg)
        if world.sp > 1:
            dist.all_reduce(gs, group=world.seq_pg)
        g_mixed[i] = gs / total
        # this rank's slice of the (padded) param, updated in place
        p_mixed[i] = pad_leaf(ps[i].detach(), pl).narrow(
            pl.axis, idx * pl.shard, pl.shard)
    guarded = optimizer.update_with_norm is not None
    norm = ok = None
    if grad_clip > 0 or guarded or with_metrics:
        sq_sh = _sq([g for g, pl in zip(g_mixed, plans)
                     if pl.axis is not None], total)
        if world.initialized:
            dist.all_reduce(sq_sh, group=data_pg)
        norm = torch.sqrt(_sq([g for g, pl in zip(g_mixed, plans)
                               if pl.axis is None], total) + sq_sh)
    if grad_clip > 0:
        scale = torch.clamp(grad_clip / torch.clamp(norm, min=1e-12),
                            max=1.0)
        g_mixed = torch._foreach_mul(g_mixed, scale)
    deltas = [] if with_metrics else None
    if guarded:
        _, opt_state, ok = optimizer.update_with_norm(
            unflatten(params, g_mixed), opt_state,
            unflatten(params, p_mixed), norm, deltas=deltas)
    else:
        _, opt_state = optimizer.update(unflatten(params, g_mixed),
                                        opt_state,
                                        unflatten(params, p_mixed),
                                        deltas=deltas)
    norms = None
    if with_metrics:
        # each rank's slices are disjoint: their squares sum over the
        # data ranks (the zero padding's delta is 0)
        sq = [d.square() for d in deltas]
        u_rep = _sum([sq[i] for i, pl in enumerate(plans)
                      if pl.axis is None], s)
        u_sh = _sum([sq[i] for i, pl in enumerate(plans)
                     if pl.axis is not None], s)
        if n > 1 and world.initialized:
            dist.all_reduce(u_sh, group=data_pg)
        norms = (norm, torch.sqrt(u_rep + u_sh).float())
    # one data rank: each slice is the whole param, already updated
    for p, part, pl in zip(ps, p_mixed, plans):
        if pl.axis is not None and n > 1:
            full = all_gather(part, pl.axis, n, data_pg)
            p.detach().copy_(full.narrow(pl.axis, 0, p.shape[pl.axis]))
    return opt_state, loss, ok, norms


def _sum(xs: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if not xs:
        return torch.zeros((), dtype=torch.float32, device=like.device)
    return torch.stack(xs).sum()
