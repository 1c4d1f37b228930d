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

Not ported yet, and refused: ``zero1``/``sharded`` update sharding, the
fp8/int8 matmuls and ``with_metrics``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from ..ops import losses as losses_lib
from ..ops.optim import Optimizer
from ..train.state import TrainState
from ..utils.tree import leaves, unflatten
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


def make_train_step(model, optimizer: Optimizer, world: World,
                    loss_name: str = "mse",
                    grad_reduction: str = "global_mean",
                    accum_steps: int = 1,
                    update_sharding: str = "replicated",
                    with_metrics: bool = False
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, torch.Tensor]]:
    """(state, this rank's batch) -> (state, global mean loss as a device
    scalar).  Params and optimizer state are updated in place."""
    if grad_reduction not in ("global_mean", "per_shard_mean"):
        raise ValueError(f"unknown grad_reduction {grad_reduction!r}")
    if update_sharding != "replicated":
        raise NotImplementedError(
            f"update_sharding={update_sharding!r} is not ported yet")
    if with_metrics:
        raise NotImplementedError("with_metrics (on-device telemetry) is "
                                  "not ported yet")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_fn = make_loss_fn(model, loss_name)

    def step(state: TrainState, batch: Batch):
        s, c, grads = _accumulated_sum_and_grads(loss_fn, state.params,
                                                 batch, accum_steps)
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
            unflatten(state.params, grads), state.opt_state, state.params)
        return TrainState(state.step + 1, params, opt_state), loss

    return step


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
