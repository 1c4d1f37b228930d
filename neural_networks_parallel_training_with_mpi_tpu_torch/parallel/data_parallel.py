"""Synchronous data-parallel train step, the port of the JAX package's
``parallel/data_parallel.py`` for ``update_sharding="replicated"``.

Per step and rank: the loss SUM and example count of this rank's rows
(microbatched under ``accum_steps``), gradients of the sum by
``torch.autograd.grad``, then ONE ``all_reduce`` over a flat f32 buffer
that carries every gradient plus the loss sum and the count, then the
optimizer update in place on every replica.  The all-reduce runs whenever
a process group is initialised (a world of one included).

Under sequence parallelism (the port of the JAX package's
``parallel/spmd.py`` seq step) nothing here changes: every ``data x seq``
rank holds loss terms over its sequence columns, so the one all-reduce
over the whole world is the JAX step's psum over ``data`` and ``seq``
(``reduce_axes``); the Trainer runs that path with ``global_mean``.

Two gradient semantics (``TrainConfig.grad_reduction``):

* ``global_mean``: gradient of the global-batch mean loss, sum(grad sums)
  / sum(counts) — exact for uneven, padded shards.
* ``per_shard_mean``: the mean over ranks of each rank's mean-loss
  gradient, the reference's semantics (:188-197).

Weight-update sharding (``update_sharding``): ``sharded`` is the per-leaf
form of ``parallel.update_sharding``; ``zero1`` is the JAX package's flat
buffer (:func:`zero1_opt_state`, :func:`zero1_shard_update`): the params
and gradients flattened in JAX's leaf order, one ``reduce_scatter_tensor``
of the flat f32 gradient over the data ranks, the update of this rank's
ceil(P/N) slice with its slice of one flat f32 buffer per optimizer slot,
one ``all_gather_into_tensor``, and the result written back into the
params in place.  Both clip by the global norm inside the step
(``grad_clip``) and imply ``global_mean``.

Multi-step dispatch (``--steps_per_dispatch k``, the JAX package's
``lax.scan`` over k device-staged batches): :class:`GraphedTrainStep`
captures the whole step (forward, backward, the all-reduce, the
``_foreach`` update) once as a ``torch.cuda.CUDAGraph`` and replays it
over static batch buffers, so a step costs the host a few copies and one
graph launch instead of its ~1800 kernel launches.

Not ported yet, and refused: the fp8/int8 matmuls and ``with_metrics``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import flash_attention as fa
from ..ops import losses as losses_lib
from ..ops.optim import Optimizer, advanced, device_scalars
from ..train.state import TrainState
from ..utils.checkpoint import flatten
from ..utils.tree import leaves, unflatten
from . import update_sharding as us
from .distributed import World

Batch = Dict[str, torch.Tensor]


def make_loss_fn(model, loss_name: str) -> Callable[[Any, Batch],
                                                    Tuple[torch.Tensor,
                                                          torch.Tensor]]:
    """(params, batch) -> (loss_sum, count), mask-aware; the model's fused
    path (``fused_loss_sum``) when it offers one for this loss."""
    fused_hook = getattr(model, "fused_loss_sum", None)
    if fused_hook is not None:
        fused = fused_hook(loss_name)
        if fused is not None:
            return fused
    base = losses_lib.get(loss_name)

    def loss_fn(params, batch):
        pred = model.apply(params, batch["x"])
        return base(pred, batch["y"], batch.get("mask"))

    return loss_fn


def _sum_and_grads(loss_fn, params, batch):
    s, c = loss_fn(params, batch)
    ps = leaves(params)
    grads = torch.autograd.grad(s, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    return s.detach(), c.detach(), grads


def _accumulated_sum_and_grads(loss_fn, params, batch: Batch,
                               accum_steps: int):
    """This rank's (loss_sum, count, grads-of-sum as a leaf list),
    microbatched when ``accum_steps > 1``: every loss returns SUMS, so
    adding microbatch sums (grads in f32) is the unsplit computation."""
    if accum_steps == 1:
        return _sum_and_grads(loss_fn, params, batch)
    for k, v in batch.items():
        if v.shape[0] % accum_steps:
            raise ValueError(
                f"per-device batch rows {v.shape[0]} (leaf {k!r}) not "
                f"divisible by accum_steps={accum_steps}")
    micro = {k: v.chunk(accum_steps) for k, v in batch.items()}
    s = c = grads = None
    for i in range(accum_steps):
        ms, mc, mg = _sum_and_grads(loss_fn, params,
                                    {k: v[i] for k, v in micro.items()})
        if grads is None:
            s, c, grads = ms, mc, [g.float() for g in mg]
        else:
            s, c = s + ms, c + mc
            torch._foreach_add_(grads, [g.float() for g in mg])
    return s, c, grads


def zero1_opt_state(optimizer: Optimizer, params: Any, world: World):
    """(this rank's opt state, its ``update_sharding.ShardedLayout``) for
    ``update_sharding='zero1'``: the optimizer initialised on one flat f32
    buffer of the P params padded to a multiple of N, each rank keeping
    its ceil(P/N) slice of every slot."""
    n = world.dp
    size = sum(p.numel() for p in leaves(params))
    shard = -(-size // n)
    device = leaves(params)[0].device
    state = optimizer.init(torch.zeros(shard, dtype=torch.float32,
                                       device=device))
    return state, us.ShardedLayout([0] * len(leaves(state)), n,
                                   world.data_rank, world.data_pg)


@torch.no_grad()
def zero1_shard_update(optimizer: Optimizer, state: TrainState,
                       s: torch.Tensor, c: torch.Tensor,
                       grads: List[torch.Tensor], world: World,
                       grad_clip: float = 0.0,
                       scalars: Optional[torch.Tensor] = None):
    """The zero1 update of one step (see the module docstring):
    ``update_sharding.sharded_update`` of one leaf, the params and
    gradients flattened in JAX's leaf order (``ravel_pytree``'s) into one
    buffer padded to a multiple of N and planned along its only axis.
    Returns (opt_state, global mean loss); params are written in place."""
    n = world.dp
    by_id = {id(p): g for p, g in zip(leaves(state.params), grads)}
    ordered = [p for _, p in flatten(state.params)]
    sizes = [p.numel() for p in ordered]
    shard = -(-sum(sizes) // n)
    pad = shard * n - sum(sizes)
    flat_g = torch.cat([by_id[id(p)].reshape(-1).float() for p in ordered]
                       + [s.new_zeros(pad, dtype=torch.float32)])
    flat_p = torch.cat([p.detach().reshape(-1) for p in ordered]
                       + [ordered[0].new_zeros(pad)])
    opt_state, loss = us.sharded_update(
        optimizer, flat_p, state.opt_state, s, c, [flat_g], world,
        grad_clip, scalars, plans=[us.LeafPlan(0, shard * n, shard)])
    torch._foreach_copy_(
        [p.detach() for p in ordered],
        [part.view(p.shape) for part, p in zip(
            torch.split(flat_p[:sum(sizes)], sizes), ordered)])
    return opt_state, loss


def make_train_step(model, optimizer: Optimizer, world: World,
                    loss_name: str = "mse",
                    grad_reduction: str = "global_mean",
                    accum_steps: int = 1,
                    update_sharding: str = "replicated",
                    grad_clip: float = 0.0,
                    with_metrics: bool = False
                    ) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """(state, this rank's batch[, scalars]) -> (state, global mean loss
    as a device scalar).  Params and optimizer state are updated in place;
    ``scalars`` is the optimizer's device scalars of this step
    (``Optimizer.scalars(state.opt_state.count)`` on the device; None:
    copied from the host).

    ``update_sharding='sharded'`` takes the opt state of
    ``update_sharding.init_opt_state``, ``'zero1'`` that of
    :func:`zero1_opt_state`.  ``grad_clip`` is applied inside those two
    updates; the replicated update takes ``optim.with_clipping``."""
    if grad_reduction not in ("global_mean", "per_shard_mean"):
        raise ValueError(f"unknown grad_reduction {grad_reduction!r}")
    if update_sharding not in ("replicated", "zero1", "sharded"):
        raise ValueError(f"unknown update_sharding {update_sharding!r}")
    if update_sharding != "replicated" and grad_reduction != "global_mean":
        raise ValueError(f"update_sharding={update_sharding!r} implies the "
                         "exact global-mean gradient; per_shard_mean is a "
                         "replicated-path-only compatibility mode")
    if grad_clip > 0 and update_sharding == "replicated":
        raise ValueError(
            "grad_clip is only applied inside the zero1/sharded update "
            "(the gradient is shard-scattered there); on the replicated "
            "path the full mean gradient is local — wrap the optimizer "
            "with optim.with_clipping instead of silently not clipping")
    if with_metrics:
        raise NotImplementedError("with_metrics (on-device telemetry) is "
                                  "not ported yet")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_fn = make_loss_fn(model, loss_name)

    def step(state: TrainState, batch: Batch,
             scalars: Optional[torch.Tensor] = None):
        s, c, grads = _accumulated_sum_and_grads(loss_fn, state.params,
                                                 batch, accum_steps)
        if update_sharding == "zero1":
            opt_state, loss = zero1_shard_update(
                optimizer, state, s, c, grads, world, grad_clip, scalars)
        elif update_sharding == "sharded":
            opt_state, loss = us.sharded_update(
                optimizer, state.params, state.opt_state, s, c, grads,
                world, grad_clip, scalars)
        if update_sharding != "replicated":
            return TrainState(state.step + 1, state.params, opt_state), loss
        if grad_reduction == "per_shard_mean":
            denom = torch.clamp(c, min=1.0)
            vals = [g / denom for g in grads] + [(s / denom).reshape(1)]
        else:
            vals = list(grads) + [s.reshape(1), c.reshape(1)]
        if world.initialized:
            flat = torch.cat([v.reshape(-1).float() for v in vals])
            dist.all_reduce(flat)
            vals = [part.view(v.shape) for part, v in zip(
                torch.split(flat, [v.numel() for v in vals]), vals)]
        if grad_reduction == "per_shard_mean":
            n = world.world_size if world.initialized else 1
            grads = [g / n for g in vals[:-1]]
            loss = vals[-1][0] / n
        else:
            total = vals[-1][0]
            grads = [g / total for g in vals[:-2]]
            loss = vals[-2][0] / total
        params, opt_state = optimizer.update(
            unflatten(state.params, grads), state.opt_state, state.params,
            scalars)
        return TrainState(state.step + 1, params, opt_state), loss

    return step


def _advanced(state: TrainState, n: int) -> TrainState:
    """``state`` after ``n`` steps that updated its tensors in place."""
    return TrainState(state.step + n, state.params,
                      advanced(state.opt_state, n))


class GraphedTrainStep:
    """Multi-step dispatch on the card: ``step`` (a :func:`make_train_step`
    step) captured once as a CUDA graph and replayed once per step.

    ``graphed(state, batches) -> (state, loss)`` runs the steps of one
    dispatch, one per batch of ``batches`` (a ``ShardedLoader.
    epoch_groups`` group), and returns the state and a copy of the last
    step's loss (the graph's loss buffer is rewritten by the next replay).
    The optimizer's scalars of all the group's steps go to the card in one
    copy; each replay is then a copy of the batch and of its scalars into
    the graph's static buffers and one ``cudaGraphLaunch``, on the
    caller's stream, so anything the caller queues after the dispatch (the
    lag-1 loss read, an async snapshot's device-to-host copy) runs after
    the replays.

    The first step is the warm-up: it runs eagerly on a side stream (the
    kernels build, cuBLAS and NCCL set up, the allocator fills), then the
    step is captured on that stream with the warm-up's tensors (capture
    records and runs nothing).  A batch of another shape than the captured
    one (an epoch's shorter last batch) runs eagerly: the same ops and
    kernels.  A failed capture raises.

    The graph reads and writes the state's own tensors (the update is in
    place): a state with other tensors (a resume's) is warmed up and
    captured anew.  The flash wrappers count their launches while the
    step is captured, though nothing launches then; those counts are
    taken back and kept as :attr:`launches_per_replay` (every replay
    launches every kernel node of the graph once), so the wrappers'
    counters hold the eager launches and :attr:`replays` x
    :attr:`launches_per_replay` the graphed ones."""

    def __init__(self, step: Callable, optimizer: Optimizer,
                 device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{device}")
        self.step, self.optimizer, self.device = step, optimizer, device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.state: Optional[TrainState] = None   # the captured tensors
        self.static_batch: Dict[str, torch.Tensor] = {}
        self.static_scalars: Optional[torch.Tensor] = None
        self.static_loss: Optional[torch.Tensor] = None
        self.launches_per_replay: Dict[str, Any] = {}
        self.replays = 0
        self.eager_steps = 0

    def __call__(self, state: TrainState, batches: List[Batch]):
        if self.graph is not None and not self._captured_on(state):
            self.graph = None
        count = state.opt_state.count
        scalars = device_scalars(
            np.stack([self.optimizer.scalars(count + i)
                      for i in range(len(batches))]),
            leaves(state.params)[0])
        loss = None
        for i, batch in enumerate(batches):
            if self.graph is None:
                state, loss = self._warm_up_and_capture(state, batch,
                                                        scalars[i])
            elif any(batch[k].shape != v.shape
                     for k, v in self.static_batch.items()):
                state, loss = self.step(state, batch, scalars[i])
                self.eager_steps += 1
            else:
                for k, v in self.static_batch.items():
                    v.copy_(batch[k])
                self.static_scalars.copy_(scalars[i])
                self.graph.replay()
                self.replays += 1
                state, loss = _advanced(state, 1), self.static_loss
        return state, loss.clone()

    def _warm_up_and_capture(self, state: TrainState, batch: Batch,
                             scalars: torch.Tensor):
        caller = torch.cuda.current_stream(self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            state, loss = self.step(state, batch, scalars)
        caller.wait_stream(self.stream)
        self.eager_steps += 1
        self.static_batch = {k: v.clone() for k, v in batch.items()}
        self.static_scalars = scalars.clone()
        before = fa.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            _, self.static_loss = self.step(state, self.static_batch,
                                            self.static_scalars)
        captured = fa.launch_counts()
        fa.set_launch_counts(before)
        self.launches_per_replay = {
            "all": {k: captured["all"][k] - before["all"][k]
                    for k in fa.COUNTERS},
            "with_lse": captured["with_lse"] - before["with_lse"]}
        self.graph, self.state = graph, state
        return state, loss

    def _captured_on(self, state: TrainState) -> bool:
        """True when the graph reads and writes ``state``'s own tensors."""
        mine = leaves((self.state.params, self.state.opt_state))
        theirs = leaves((state.params, state.opt_state))
        return len(mine) == len(theirs) and all(
            a is b for a, b in zip(mine, theirs))


def make_eval_step(model, world: World, loss_name: str = "mse",
                   with_accuracy: bool = False):
    """(params, batch) -> {"loss", "count"[, "accuracy", "example_count"]}
    as global means over all ranks (device scalars)."""
    base = losses_lib.get(loss_name)

    @torch.no_grad()
    def eval_step(params, batch):
        pred = model.apply(params, batch["x"])
        s, c = base(pred, batch["y"], batch.get("mask"))
        vals = [s, c]
        if with_accuracy:
            vals += list(losses_lib.accuracy(pred, batch["y"],
                                             batch.get("mask")))
        sums = torch.stack([v.float() for v in vals])
        if world.initialized:
            dist.all_reduce(sums)
        out = {"loss": sums[0] / sums[1], "count": sums[1]}
        if with_accuracy:
            out["accuracy"] = sums[2] / sums[3]
            out["example_count"] = sums[3]
        return out

    return eval_step
