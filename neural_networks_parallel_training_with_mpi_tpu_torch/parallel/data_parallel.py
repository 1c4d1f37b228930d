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

Under tensor parallelism and fsdp (``parallel.gspmd``, ``parallel.spmd``:
the model is a ``tensor_parallel.TensorParallelModel`` whose
``StateLayout`` says which slices this rank holds) the all-reduce runs
over ``World.replica_pg``, the ranks holding the same slices (every rank
but the tensor and fsdp ones: a whole leaf's gradient, equal on each
tensor rank, is counted once), after an fsdp stage: an fsdp-split leaf's
gradient came back reduce-scattered from its gather, and the leaves fsdp
keeps whole, the loss sum and the count are summed over the fsdp group
first.  Under pipeline parallelism (``parallel.pipeline``) the leaves
every stage holds (the embedding, the final norm, the head), the loss sum
and the count are summed over the pipe group the same way.  The norms (guard, telemetry) come from the layout's ``combine``:
JAX's global-view norms over the slices.

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

Quantized compute (``--matmul_dtype``, ``ops.qmm``): int8 needs nothing
here.  Under fp8 the step reads each role's delayed amax from
``state.qstate`` at its top (:func:`make_qloss_fn`), takes the max of the
observations over the microbatches, then over every rank (one
``all_reduce`` with ``MAX``: the data ranks and, under sequence
parallelism, the seq ranks, as the JAX step's ``pmax``), and after the
update rolls the histories in place, in the replicated, ``zero1`` and
``sharded`` forms alike, so a CUDA graph's replay rolls them too.

The guarded update (``ops.optim.with_skip_guard``): the step takes the
global norm of the REDUCED gradient (the replicated step's mean
gradient; under zero1 and ``sharded`` the replicated squares plus the
all-reduced sharded squares, as for clipping) and hands it to the
guard's ``update_with_norm``; a rejected step also leaves the fp8
histories as they were.  Nothing syncs with the host, so a CUDA graph
replays it.

Telemetry (``with_metrics=True``, ``train.telemetry``): the step returns
``(state, metrics)``, the ``METRIC_KEYS`` dict of device scalars, in
place of the loss.  The grad norm is the reduced gradient's (the
replicated step's, handed to the guard as its own norm; under zero1 and
``sharded`` the replicated squares plus the all-reduced sharded
squares); the update norm comes from the update itself (its ``deltas``
list in ``ops.optim``: under zero1 and ``sharded`` each rank's slices,
summed over the data ranks); the param norm from the full params
after the update.  The update writes the same bits with metrics on and
off.  Under :class:`GraphedTrainStep` the metrics are static output
buffers of the graph, written in place by each replay.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops import flash_attention as fa
from ..ops import losses as losses_lib
from ..ops import qmm
from ..ops.optim import Optimizer, combine_norms, global_norm
from ..train import telemetry
from ..train import trace as trace_lib
from ..train.state import TrainState
from ..utils import compile_ledger
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


def make_qloss_fn(model, loss_name: str):
    """(params, batch, qamax) -> (loss_sum, (count, observed)): the fp8
    variant of :func:`make_loss_fn`.  The model reads the per-role delayed
    amax ``qamax`` (``ops.qmm.delayed_amax`` of ``state.qstate``) and
    reports this step's observed amax.  The fused chunked CE is bypassed,
    as in the JAX package (the trainer refuses --ce_chunk with fp8)."""
    base = losses_lib.get(loss_name)

    def loss_fn(params, batch, qamax):
        pred, obs = model.apply(params, batch["x"], qscales=qamax,
                                return_qobs=True)
        s, c = base(pred, batch["y"], batch.get("mask"))
        return s, (c, obs)

    return loss_fn


def _lifted(loss_fn):
    """A (params, batch) loss in :func:`make_qloss_fn`'s contract, with no
    observations."""
    def qfn(params, batch, _qamax):
        s, c = loss_fn(params, batch)
        return s, (c, {})
    return qfn


def _sum_and_grads(loss_fn, params, batch, qamax):
    s, (c, obs) = loss_fn(params, batch, qamax)
    ps = leaves(params)
    grads = torch.autograd.grad(s, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    return s.detach(), c.detach(), grads, obs


def _accumulated_sum_and_grads(loss_fn, params, batch: Batch,
                               accum_steps: int, qamax=None):
    """This rank's (loss_sum, count, grads-of-sum as a leaf list, fp8
    observations), microbatched when ``accum_steps > 1``: every loss
    returns SUMS, so adding microbatch sums (grads in f32) is the unsplit
    computation, and the amax of the union is the max of the
    microbatches' amax.  ``loss_fn`` follows :func:`make_qloss_fn`."""
    if accum_steps == 1:
        return _sum_and_grads(loss_fn, params, batch, qamax)
    for k, v in batch.items():
        if v.shape[0] % accum_steps:
            raise ValueError(
                f"per-device batch rows {v.shape[0]} (leaf {k!r}) not "
                f"divisible by accum_steps={accum_steps}")
    micro = {k: v.chunk(accum_steps) for k, v in batch.items()}
    s = c = grads = obs = None
    for i in range(accum_steps):
        ms, mc, mg, mo = _sum_and_grads(loss_fn, params,
                                        {k: v[i] for k, v in micro.items()},
                                        qamax)
        if grads is None:
            s, c, grads, obs = ms, mc, [g.float() for g in mg], mo
        else:
            s, c = s + ms, c + mc
            torch._foreach_add_(grads, [g.float() for g in mg])
            obs = {r: torch.maximum(obs[r], mo[r]) for r in obs}
    return s, c, grads, obs


def _max_over_ranks(obs: Dict[str, torch.Tensor],
                    world: World) -> Dict[str, torch.Tensor]:
    """The observations' max over every rank (data and seq): one
    ``all_reduce`` of a vector in the roles' order."""
    if not world.initialized or not obs:
        return obs
    roles = sorted(obs)
    flat = torch.stack([obs[r].float() for r in roles])
    dist.all_reduce(flat, op=dist.ReduceOp.MAX)
    return dict(zip(roles, flat.unbind()))


@torch.no_grad()
def _roll_qstate(state: TrainState, obs: Dict[str, torch.Tensor],
                 ok: Optional[torch.Tensor] = None) -> None:
    """Roll ``state.qstate``'s histories in place with ``obs`` (not on a
    step the guard rejected: ``ok`` False)."""
    new = qmm.update_qstate(state.qstate, obs)
    roles = list(state.qstate["amax"])
    old = [state.qstate["amax"][r] for r in roles]
    rolled = [new["amax"][r] for r in roles]
    if ok is None:
        torch._foreach_copy_(old, rolled)
    else:
        for h, n in zip(old, rolled):
            torch.where(ok, n, h, out=h)


def _all_reduce(vals: List[torch.Tensor], group) -> List[torch.Tensor]:
    """``vals`` summed over ``group`` in one flat f32 ``all_reduce``."""
    flat = torch.cat([v.reshape(-1).float() for v in vals])
    dist.all_reduce(flat, group=group)
    return [part.view(v.shape) for part, v in zip(
        torch.split(flat, [v.numel() for v in vals]), vals)]


def _axis_reduce(layout, axis: str, grads: List[torch.Tensor],
                 s: torch.Tensor, c: torch.Tensor):
    """The fsdp or pipe stage of the gradient reduction: the gradients of
    the leaves that ``axis`` keeps whole, and the loss sum and count,
    summed over that axis's group (an fsdp-split leaf's gradient came
    back reduce-scattered from its gather; a pipe-split leaf, a stage's
    block, is its stage's own, while the embedding and the head have
    their gradient on one stage only); ``grads`` is updated in place.
    Returns (s, c)."""
    whole = [i for i, st in enumerate(layout.stored)
             if getattr(st, axis) is None]
    vals = _all_reduce([grads[i] for i in whole] + [s.reshape(1),
                                                     c.reshape(1)],
                       getattr(layout, f"{axis}_pg"))
    for i, v in zip(whole, vals):
        grads[i] = v
    return vals[-2][0], vals[-1][0]


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
    return state, us.ShardedLayout([0 if x.dim() else None
                                    for x in leaves(state)], n,
                                   world.data_rank, world.data_pg)


@torch.no_grad()
def zero1_shard_update(optimizer: Optimizer, state: TrainState,
                       s: torch.Tensor, c: torch.Tensor,
                       grads: List[torch.Tensor], world: World,
                       grad_clip: float = 0.0, with_metrics: bool = False):
    """The zero1 update of one step (see the module docstring):
    ``update_sharding.sharded_update`` of one leaf, the params and
    gradients flattened in JAX's leaf order (``ravel_pytree``'s) into one
    buffer padded to a multiple of N and planned along its only axis.
    Returns (opt_state, global mean loss, the guard's ``ok`` or None,
    (grad norm, update norm) or None); params are written in place."""
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
    opt_state, loss, ok, norms = us.sharded_update(
        optimizer, flat_p, state.opt_state, s, c, [flat_g], world,
        grad_clip, plans=[us.LeafPlan(0, shard * n, shard)],
        with_metrics=with_metrics)
    torch._foreach_copy_(
        [p.detach() for p in ordered],
        [part.view(p.shape) for part, p in zip(
            torch.split(flat_p[:sum(sizes)], sizes), ordered)])
    return opt_state, loss, ok, norms


def make_train_step(model, optimizer: Optimizer, world: World,
                    loss_name: str = "mse",
                    grad_reduction: str = "global_mean",
                    accum_steps: int = 1,
                    update_sharding: str = "replicated",
                    grad_clip: float = 0.0,
                    with_metrics: bool = False
                    ) -> Callable[..., Tuple[TrainState, Any]]:
    """(state, this rank's batch) -> (state, global mean loss as a device
    scalar), or with ``with_metrics`` (state, the telemetry metrics dict
    of device scalars).  Params and optimizer state are updated in place.

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
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    fp8 = qmm.model_format(model) == "fp8"
    guarded = optimizer.update_with_norm is not None
    loss_fn = (make_qloss_fn(model, loss_name) if fp8
               else _lifted(make_loss_fn(model, loss_name)))
    def step(state: TrainState, batch: Batch):
        # fp8: each role's delayed amax, read before anything updates
        qamax = qmm.delayed_amax(state.qstate) if fp8 else None
        s, c, grads, obs = _accumulated_sum_and_grads(
            loss_fn, state.params, batch, accum_steps, qamax)
        # a tensor-parallel / fsdp model's state layout (built by its
        # first forward): the global-view norms, and the fsdp stage
        layout = getattr(model, "layout", None)
        combine = layout.combine if layout is not None else combine_norms
        for axis in ("fsdp", "pipe"):
            if getattr(layout, f"{axis}_pg", None) is not None:
                s, c = _axis_reduce(layout, axis, grads, s, c)
        if fp8:
            obs = _max_over_ranks(obs, world)
        if update_sharding == "zero1":
            opt_state, loss, ok, norms = zero1_shard_update(
                optimizer, state, s, c, grads, world, grad_clip,
                with_metrics)
        elif update_sharding == "sharded":
            opt_state, loss, ok, norms = us.sharded_update(
                optimizer, state.params, state.opt_state, s, c, grads,
                world, grad_clip, with_metrics=with_metrics,
                plans=None if layout is None else layout.update_plans(
                    world.dp), layout=layout)
        if update_sharding != "replicated":
            state = state._replace(step=state.step + 1, opt_state=opt_state)
            if fp8:
                _roll_qstate(state, obs, ok)
            if with_metrics:
                return state, telemetry.metrics_vector(
                    loss, norms[0], state.params, norms[1], opt_state,
                    combine)
            return state, loss
        if grad_reduction == "per_shard_mean":
            denom = torch.clamp(c, min=1.0)
            vals = [g / denom for g in grads] + [(s / denom).reshape(1)]
        else:
            vals = list(grads) + [s.reshape(1), c.reshape(1)]
        if world.initialized:
            vals = _all_reduce(vals, world.replica_pg)
        if grad_reduction == "per_shard_mean":
            n = world.world_size if world.initialized else 1
            grads = [g / n for g in vals[:-1]]
            loss = vals[-1][0] / n
        else:
            total = vals[-1][0]
            grads = [g / total for g in vals[:-2]]
            loss = vals[-2][0] / total
        # grads now names the reduced gradients only: the backward's are
        # freed before the update, whose peak they would otherwise raise
        ok = metrics = None
        if with_metrics:    # the guard takes the metrics' grad norm
            params, opt_state, metrics, ok = telemetry.update_with_metrics(
                optimizer, unflatten(state.params, grads), state.opt_state,
                state.params, loss, combine)
        elif guarded:   # the reduced gradient's norm, before any clipping
            params, opt_state, ok = optimizer.update_with_norm(
                unflatten(state.params, grads), state.opt_state,
                state.params, global_norm(grads, combine))
        else:
            params, opt_state = optimizer.update(
                unflatten(state.params, grads), state.opt_state,
                state.params)
        state = TrainState(state.step + 1, params, opt_state, state.qstate)
        if fp8:
            _roll_qstate(state, obs, ok)
        return state, (loss if metrics is None else metrics)

    return step


class GraphedTrainStep:
    """Multi-step dispatch on the card: ``step`` (a :func:`make_train_step`
    step) captured once as a CUDA graph and replayed once per step.

    ``graphed(state, batches) -> (state, out)`` runs the steps of one
    dispatch, one per batch of ``batches`` (a ``ShardedLoader.
    epoch_groups`` group), and returns the state and a copy of the last
    step's output, its loss or its metrics dict (the graph's output
    buffers are rewritten by the next replay).
    Each replay is a copy of the batch into the graph's static buffers and
    one ``cudaGraphLaunch`` (the optimizer reads its lr and bias
    corrections on the device, at its count), on the caller's stream, so
    anything the caller queues after the dispatch (the lag-1 loss read, an
    async snapshot's device-to-host copy) runs after the replays.

    The first step is the warm-up: it runs eagerly on a side stream (the
    kernels build, cuBLAS and NCCL set up, the allocator fills), then the
    step is captured on that stream with the warm-up's tensors (capture
    records and runs nothing).  A batch of another shape than the captured
    one (an epoch's shorter last batch) runs eagerly: the same ops and
    kernels.  A failed capture raises.

    The graph reads and writes the state's own tensors (the update, and
    the fp8 histories' roll, are in place): a state with other tensors (a
    resume's) is warmed up and captured anew.  The fp8 capability probe
    (``ops.qmm.fp8_dot_supported``) runs here, before any capture.  The
    flash wrappers and ``ops.qmm.library_gemm`` count their launches
    while the step is captured, though nothing launches then; those
    counts are taken back and kept as :attr:`launches_per_replay` (every
    replay launches every kernel node of the graph once), so the
    counters hold the eager launches and :attr:`replays` x
    :attr:`launches_per_replay` the graphed ones.

    Each capture is one event of the installed compile ledger
    (``utils.compile_ledger.record_capture``: ``name``, the state and
    batch signature, the capture's wall time, ``flops(batch)``, the
    ``static`` settings in its fingerprint) inside a ``compile:<name>``
    span; a replay records nothing."""

    def __init__(self, step: Callable, device: torch.device,
                 name: str = "train_step",
                 flops: Optional[Callable[[Batch], Optional[float]]] = None,
                 static: Optional[Dict[str, Any]] = None):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{device}")
        qmm.fp8_dot_supported(device)
        self.step, self.device = step, device
        self.name, self.flops, self.static = name, flops, static
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.state: Optional[TrainState] = None   # the captured tensors
        self.static_batch: Dict[str, torch.Tensor] = {}
        self.static_out: Any = None
        self._signature: Optional[Dict[str, str]] = None
        self.launches_per_replay: Dict[str, Any] = {}
        self.replays = 0
        self.eager_steps = 0
        self.captures = 0

    def __call__(self, state: TrainState, batches: List[Batch]):
        if self.graph is not None and not self._captured_on(state):
            self.graph = None
        out = None
        for batch in batches:
            if self.graph is None:
                state, out = self._warm_up_and_capture(state, batch)
            elif any(batch[k].shape != v.shape
                     for k, v in self.static_batch.items()):
                state, out = self.step(state, batch)
                self.eager_steps += 1
            else:
                for k, v in self.static_batch.items():
                    v.copy_(batch[k])
                self.graph.replay()
                self.replays += 1
                # the replay updated the state's tensors in place
                state, out = (state._replace(step=state.step + 1),
                              self.static_out)
        if isinstance(out, dict):
            return state, {k: v.clone() for k, v in out.items()}
        return state, out.clone()

    def _warm_up_and_capture(self, state: TrainState, batch: Batch):
        caller = torch.cuda.current_stream(self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            state, loss = self.step(state, batch)
        caller.wait_stream(self.stream)
        self.eager_steps += 1
        self.static_batch = {k: v.clone() for k, v in batch.items()}
        before = fa.launch_counts()
        gemms = dict(qmm.library_gemm.launches)
        graph = torch.cuda.CUDAGraph()
        sig = compile_ledger.signature((state, self.static_batch))
        with trace_lib.span(f"compile:{self.name}"):
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=self.stream):
                _, self.static_out = self.step(state, self.static_batch)
            capture_s = time.perf_counter() - t0
        captured = fa.launch_counts()
        fa.set_launch_counts(before)
        self.launches_per_replay = {
            "all": {k: captured["all"][k] - before["all"][k]
                    for k in fa.COUNTERS},
            "with_lse": captured["with_lse"] - before["with_lse"],
            "gemm": {k: v - gemms[k]
                     for k, v in qmm.library_gemm.launches.items()}}
        qmm.library_gemm.launches.update(gemms)
        self.graph, self.state = graph, state
        self.captures += 1
        compile_ledger.record_capture(
            self.name, self.captures, sig, self._signature, capture_s,
            self.flops(batch) if self.flops is not None else None,
            self.static)
        self._signature = sig
        return state, loss

    def _captured_on(self, state: TrainState) -> bool:
        """True when the graph reads and writes ``state``'s own tensors."""
        mine = leaves((self.state.params, self.state.opt_state,
                       self.state.qstate))
        theirs = leaves((state.params, state.opt_state, state.qstate))
        return len(mine) == len(theirs) and all(
            a is b for a, b in zip(mine, theirs))


def make_eval_step(model, world: World, loss_name: str = "mse",
                   with_accuracy: bool = False):
    """(params, batch) -> {"loss", "count"[, "accuracy", "example_count"]}
    as global means over all ranks (device scalars)."""
    base = losses_lib.get(loss_name)
    # a tensor-parallel model: its own sums under --vocab_parallel
    eval_sums = getattr(model, "eval_sums", None)

    @torch.no_grad()
    def eval_step(params, batch):
        vals = (None if eval_sums is None
                else eval_sums(params, batch, with_accuracy))
        if vals is None:
            pred = model.apply(params, batch["x"])
            vals = list(base(pred, batch["y"], batch.get("mask")))
            if with_accuracy:
                vals += list(losses_lib.accuracy(pred, batch["y"],
                                                 batch.get("mask")))
        sums = torch.stack([v.float() for v in vals])
        # every batch rank once: each tensor rank holds the same sums
        world.batch_all_reduce(sums)
        out = {"loss": sums[0] / sums[1], "count": sums[1]}
        if with_accuracy:
            out["accuracy"] = sums[2] / sums[3]
            out["example_count"] = sums[3]
        return out

    return eval_step
