"""Optimizers over parameter trees, the port of the JAX package's
``ops/optim.py``.

An optimizer is ``init(params) -> state`` and ``update(grads, state,
params) -> (params, state)`` with the JAX package's update formulas and
state leaf names (``SGDState(count, momentum_buf)``, ``AdamState(count,
mu, nu)``).  Where JAX builds new arrays, the port updates the parameter
and state tensors IN PLACE with ``torch._foreach_*`` over the leaf lists
(one launch per op for the whole tree instead of one per leaf) and hands
back the same objects; each formula keeps JAX's order of operations, so
the f32 results agree to rounding.

``count`` is a 0-d int32 tensor on the params' device (JAX's leaf),
advanced in place by the update.  The step's scalars (the scheduled lr,
Adam's two bias corrections) are computed on the host in np.float32,
exactly as a Python scalar would be rounded, for every count the run can
reach (``steps``, required), and go to the device once as a table; each
update reads its row at ``count`` on the device.  Nothing is read back
to the host and no Python float reaches a kernel, so a CUDA graph of the
train step (``parallel.data_parallel.GraphedTrainStep``) replays it, and
the f32 results are bitwise those of the scalar form.

``sgd`` is torch-semantics SGD (dampening 0, no Nesterov):
``buf <- momentum * buf + grad``; ``param <- param - lr * buf``.

``with_master_weights`` keeps an f32 master copy of the params in its
state (``MasterState(master, inner)``) and writes it into the params,
cast to their storage dtype, in place.

Telemetry's ``update_ratio`` (``train.telemetry.update_with_metrics``)
needs the norm of (new - old) params, and the updates here are in
place: given a ``deltas`` list, an update forms each param write's new
values out of place (as the guarded write does), appends the per-leaf
f32 norms of (new - old) to it while both are alive, and then writes the
same bits as without it.  The update's own delta, lr * step, is not
used for it: it differs from new - old by the rounding of the f32
subtraction, which is past 1e-5 of the norm once the update is small
against the params.

``with_skip_guard`` (``--skip-nonfinite``, ``--skip_threshold``) rejects
a step whose global gradient norm is not finite (or above the threshold)
on the device, with no host sync, so it runs inside a CUDA graph: every
update takes an optional device bool ``ok``, computes its new values out
of place, and writes ``torch.where(ok, new, old)`` into each tensor, so a
rejected step leaves every bit as it was (``-0.0``, NaN and denormals
included) and an accepted one writes exactly what the unguarded in-place
update writes.  The count advances only on an accepted step, so the lr
schedule does not either.

Not ported yet, and refused at ``make``: lion, adafactor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.platform import h2d
from ..utils.tree import leaves, tree_map

Tree = Any
# constant lr or a host step -> lr schedule (ops.schedules)
LR = Union[float, Callable[[int], float]]


def _lr_at(lr: LR, count: int) -> np.float32:
    """The lr of step ``count`` rounded to f32, as PyTorch rounds a Python
    scalar multiplying an f32 tensor."""
    return np.float32(lr(count) if callable(lr) else lr)


def device_scalars(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host f32 ``values`` as a tensor on ``like``'s device, copied without
    a stream sync (pinned on the card)."""
    return h2d(np.asarray(values, np.float32), like.device)


def leaf_norms(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each f32 tensor's L2 norm.  On the host each accumulates in f64:
    the CPU's f32 norm reduction drifts from the exact norm on a leaf as
    large as the flagship's 32768 x 1024 LM head (the card's tree
    reduction keeps f32's precision)."""
    if xs[0].device.type == "cpu":
        return list(torch._foreach_norm(xs, 2, dtype=torch.float64))
    return list(torch._foreach_norm(xs))


def combine_norms(norms: List[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm from per-leaf norms, as an f32 scalar.  A
    sliced state's ``parallel.tensor_parallel.StateLayout.combine`` takes
    its place where each rank holds only slices."""
    return torch.linalg.vector_norm(torch.stack(list(norms))).float()


def global_norm(grads: Tree, combine: Callable = combine_norms
                ) -> torch.Tensor:
    """L2 norm over every leaf, as an f32 device scalar."""
    return combine(leaf_norms([g.float() for g in leaves(grads)]))


def clip_by_global_norm(grads: Tree, max_norm: float,
                        combine: Callable = combine_norms) -> Tree:
    """Scale the whole tree so its global L2 norm is <= ``max_norm``; the
    scale stays on the device (no sync)."""
    norm = global_norm(grads, combine)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``update(grads, state, params, ok=None, deltas=None)``: ``ok`` a
    device bool; False leaves params and state bitwise as they were.
    ``deltas``, a list, receives the per-leaf f32 norms of each param
    write's (new - old), in the order of the leaves (see the module
    docstring).  The guard adds ``update_with_norm(grads, state, params,
    norm, deltas=None) -> (params, state, ok)``, JAX's seam for a caller
    that has the global gradient norm already."""
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]
    name: str = "optimizer"
    update_with_norm: Optional[Callable[..., Tuple[Tree, Tree,
                                                   torch.Tensor]]] = None


def _new_count(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)


def _rows(host: Callable[[int], np.ndarray],
          steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """count -> ``host(count)`` read on the count's device, from a table of
    ``host(c)`` for c in 0..steps copied there on the first call (which
    runs eagerly, before any CUDA graph capture).  A count past ``steps``
    reads the last row."""
    tables: dict = {}

    def row(count: torch.Tensor) -> torch.Tensor:
        table = tables.get(count.device)
        if table is None:
            table = device_scalars(
                np.stack([host(c) for c in range(steps + 1)]), count)
            tables[count.device] = table
        idx = torch.clamp(count.long(), 0, steps)
        return table.index_select(0, idx.reshape(1))[0]

    return row


def _step_count(count: torch.Tensor, ok: Optional[torch.Tensor]) -> None:
    """count += 1, in place (not on a rejected step)."""
    count.add_(1 if ok is None else ok.to(count.dtype))


def _commit(dst: List[torch.Tensor], new: List[torch.Tensor],
            ok: torch.Tensor) -> None:
    """dst <- new where ``ok``, else dst unchanged, bitwise, in place."""
    for d, n in zip(dst, new):
        torch.where(ok, n, d, out=d)


def _scaled(xs: List[torch.Tensor], factor: float,
            ok: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """xs * factor: in place (unguarded), or as new tensors that
    :func:`_commit` writes back (guarded)."""
    if ok is None:
        torch._foreach_mul_(xs, factor)
        return xs
    return torch._foreach_mul(xs, factor)


def _delta_norms(new: List[torch.Tensor],
                 old: List[torch.Tensor]) -> List[torch.Tensor]:
    if all(n.dtype == torch.float32 for n in new):
        return leaf_norms(torch._foreach_sub(new, old))
    return leaf_norms(torch._foreach_sub([n.float() for n in new],
                                         [o.float() for o in old]))


def _write(params: List[torch.Tensor], new: List[torch.Tensor],
           ok: Optional[torch.Tensor],
           deltas: Optional[List[torch.Tensor]]) -> None:
    """params <- new (where ``ok``); first, given ``deltas``, the per-leaf
    norms of (new - old) appended to it (0 where ``ok`` is False)."""
    if deltas is not None:
        norms = _delta_norms(new, params)
        deltas.extend(norms if ok is None else
                      [torch.where(ok, n, torch.zeros_like(n))
                       for n in norms])
    if ok is None:
        torch._foreach_copy_(params, new)
    else:
        _commit(params, new, ok)


def _apply(params: List[torch.Tensor], steps: List[torch.Tensor],
           lr_t: torch.Tensor, ok: Optional[torch.Tensor],
           deltas: Optional[List[torch.Tensor]]) -> None:
    """param <- param - (lr * step) cast to the param's dtype, in place
    (where ``ok``), recording into ``deltas`` (see :func:`_write`)."""
    upd = torch._foreach_mul([s.float() for s in steps], lr_t)
    upd = [u.to(p.dtype) for u, p in zip(upd, params)]
    if ok is None and deltas is None:
        torch._foreach_sub_(params, upd)
        return
    new = torch._foreach_sub(params, upd)
    del upd
    _write(params, new, ok, deltas)


class SGDState(NamedTuple):
    count: torch.Tensor   # optimizer steps taken (drives lr schedules)
    momentum_buf: Tree    # torch's momentum_buffer


def sgd(lr: LR, momentum: float = 0.0, weight_decay: float = 0.0, *,
        steps: int) -> Optimizer:
    """torch-semantics SGD (see the module docstring); ``steps``: the
    counts the run can reach."""

    def init(params: Tree) -> SGDState:
        return SGDState(_new_count(params), tree_map(torch.zeros_like, params))

    row = _rows(lambda c: np.array([_lr_at(lr, c)], np.float32), steps)

    @torch.no_grad()
    def update(grads: Tree, state: SGDState, params: Tree, ok=None,
               deltas=None):
        p, g = leaves(params), leaves(grads)
        lr_t = row(state.count)[0]
        if weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        step = g
        if momentum:
            buf = leaves(state.momentum_buf)
            step = _scaled(buf, momentum, ok)
            torch._foreach_add_(step, g)
            if ok is not None:
                _commit(buf, step, ok)
        _apply(p, step, lr_t, ok, deltas)
        _step_count(state.count, ok)
        return params, state

    return Optimizer(init, update, f"sgd(lr={lr},m={momentum})")


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Tree
    nu: Tree


def adam(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, decoupled: bool = False, *,
         steps: int) -> Optimizer:
    """Adam / AdamW (``decoupled=True``); ``steps``: the counts the run
    can reach."""

    def init(params: Tree) -> AdamState:
        return AdamState(_new_count(params),
                         tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def scalars(count: int) -> np.ndarray:
        """lr, then the bias corrections of step ``count + 1`` in f32, as
        JAX evaluates b ** t."""
        t = np.float32(count + 1)
        return np.array([_lr_at(lr, count),
                         np.float32(1) - np.float32(b1) ** t,
                         np.float32(1) - np.float32(b2) ** t], np.float32)

    row = _rows(scalars, steps)

    @torch.no_grad()
    def update(grads: Tree, state: AdamState, params: Tree, ok=None,
               deltas=None):
        p, g = leaves(params), leaves(grads)
        lr_t, bc1, bc2 = row(state.count)
        mu, nu = leaves(state.mu), leaves(state.nu)
        if weight_decay and not decoupled:
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        # guarded: each slot's new values are committed as soon as they
        # exist (a rejected step keeps the old ones, and the update below
        # is then discarded too), so at most one slot's copy is alive
        mu_new = _scaled(mu, b1, ok)
        torch._foreach_add_(mu_new, torch._foreach_mul(g, 1 - b1))
        if ok is not None:
            _commit(mu, mu_new, ok)
        g2 = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(g2, g)
        nu_new = _scaled(nu, b2, ok)
        torch._foreach_add_(nu_new, g2)
        del g2
        if ok is not None:
            _commit(nu, nu_new, ok)
        upd = torch._foreach_div(mu_new, bc1)
        del mu_new
        den = torch._foreach_div(nu_new, bc2)
        del nu_new
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        del den
        if weight_decay and decoupled:
            torch._foreach_add_(upd, torch._foreach_mul(p, weight_decay))
        _apply(p, upd, lr_t, ok, deltas)
        _step_count(state.count, ok)
        return params, state

    return Optimizer(init, update,
                     f"{'adamw' if decoupled else 'adam'}(lr={lr})")


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, *, steps: int) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay, decoupled=True, steps=steps)


def with_clipping(opt: Optimizer, max_norm: float,
                  combine: Callable = combine_norms) -> Optimizer:
    """Clip the (already all-reduced) gradients by their global L2 norm
    (per-leaf norms joined by ``combine``) before the wrapped update."""
    if max_norm <= 0:
        return opt

    def update(grads, state, params, ok=None, deltas=None):
        return opt.update(clip_by_global_norm(grads, max_norm, combine),
                          state, params, ok, deltas)

    return Optimizer(opt.init, update, f"clip({max_norm}):{opt.name}")


class GuardedState(NamedTuple):
    """Opt state of :func:`with_skip_guard`: the count of REJECTED updates
    (a 0-d int32 device tensor, advanced in place) and the wrapped
    optimizer's state.  Its leaves flatten as JAX's ``GuardedState(skipped,
    inner)``, so a snapshot's npz layout is the JAX package's."""

    skipped: torch.Tensor
    inner: Tree

    @property
    def count(self) -> torch.Tensor:
        return self.inner.count


def with_skip_guard(opt: Optimizer, skip_threshold: float = 0.0) -> Optimizer:
    """Reject non-finite (and, with ``skip_threshold > 0``, over-threshold)
    updates on the device: the predicate ``ok`` is ``isfinite(norm)`` and
    ``norm <= skip_threshold``, taken on the global norm of the REDUCED
    gradient before any clipping the guard wraps.  A rejected step is a
    bitwise no-op on params and the inner state (see the module
    docstring); ``GuardedState.skipped`` counts it, and the inner count,
    and so the lr schedule, stays where it was."""

    def init(params: Tree) -> GuardedState:
        return GuardedState(_new_count(params), opt.init(params))

    @torch.no_grad()
    def update_with_norm(grads: Tree, state: GuardedState, params: Tree,
                         norm: torch.Tensor, deltas=None):
        ok = torch.isfinite(norm)
        if skip_threshold > 0:
            ok = ok & (norm <= skip_threshold)
        params, inner = opt.update(grads, state.inner, params, ok, deltas)
        state.skipped.add_((~ok).to(state.skipped.dtype))
        return params, GuardedState(state.skipped, inner), ok

    def update(grads: Tree, state: GuardedState, params: Tree, deltas=None):
        return update_with_norm(grads, state, params, global_norm(grads),
                                deltas)[:2]

    return Optimizer(init, update,
                     f"guard(thr={skip_threshold}):{opt.name}",
                     update_with_norm=update_with_norm)


class MasterState(NamedTuple):
    """Opt state of :func:`with_master_weights`: the f32 master copy of
    the parameters plus the wrapped optimizer's state (built over the
    master copy, so every slot is f32)."""

    master: Tree
    inner: Tree

    @property
    def count(self) -> torch.Tensor:
        return self.inner.count


def with_master_weights(opt: Optimizer) -> Optimizer:
    """Mixed-precision master weights: the params may live in a storage
    dtype (bf16) while ``opt`` updates an f32 MASTER copy kept in the
    state; each step writes the updated master into the params, cast to
    their dtype, in place (a captured CUDA graph reads and writes those
    same tensors).  The trainer pairs it with ``update_sharding=
    'sharded'``, where the master is 1/N per rank."""

    def init(params: Tree) -> MasterState:
        # a copy even of f32 params: .float() of an f32 tensor is the
        # tensor itself, and a master aliasing its param would take every
        # in-place update twice
        master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                          params)
        return MasterState(master, opt.init(master))

    @torch.no_grad()
    def update(grads: Tree, state: MasterState, params: Tree, ok=None,
               deltas=None):
        g32 = tree_map(lambda g: g.float(), grads)
        # the recorded deltas are the params', not the master's
        master, inner = opt.update(g32, state.inner, state.master, ok)
        # a rejected step left the master as it was: its cast is the
        # params' bits already
        if deltas is None:
            torch._foreach_copy_(leaves(params), leaves(master))
        else:
            _write(leaves(params), [m.to(p.dtype) for m, p in zip(
                leaves(master), leaves(params))], None, deltas)
        return params, MasterState(master, inner)

    return Optimizer(init, update, f"master:{opt.name}")


def make(name: str, lr: LR, momentum: float = 0.0,
         weight_decay: float = 0.0, grad_clip: float = 0.0, *,
         steps: int, combine: Callable = combine_norms) -> Optimizer:
    """Build from config strings (``TrainConfig.optimizer``); ``steps``:
    the counts the run can reach (its total steps); ``combine`` joins the
    clip's per-leaf norms."""
    if name == "sgd":
        opt = sgd(lr, momentum, weight_decay, steps=steps)
    elif name == "adam":
        opt = adam(lr, weight_decay=weight_decay, steps=steps)
    elif name == "adamw":
        opt = adamw(lr, weight_decay=weight_decay or 0.01, steps=steps)
    elif name in ("lion", "adafactor"):
        raise NotImplementedError(f"--optimizer {name} is not ported yet")
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return with_clipping(opt, grad_clip, combine)
