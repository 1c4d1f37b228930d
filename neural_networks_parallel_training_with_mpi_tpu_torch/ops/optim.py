"""Optimizers over parameter trees, the port of the JAX package's
``ops/optim.py``.

An optimizer is ``init(params) -> state`` and ``update(grads, state,
params) -> (params, state)`` with the JAX package's update formulas and
state leaf names (``SGDState(count, momentum_buf)``, ``AdamState(count,
mu, nu)``).  Where JAX builds new arrays, the port updates the parameter
and state tensors IN PLACE with ``torch._foreach_*`` over the leaf lists
(one launch per op for the whole tree instead of one per leaf) and hands
back the same objects; each formula keeps JAX's order of operations, so
the f32 results agree to rounding.  ``count`` is a host int: the lr
schedule is read without a device sync.

``sgd`` is torch-semantics SGD (dampening 0, no Nesterov):
``buf <- momentum * buf + grad``; ``param <- param - lr * buf``.

Not ported yet, and refused at ``make``: lion, adafactor; and the
wrappers ``with_skip_guard`` and ``with_master_weights``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from ..utils.tree import leaves, tree_map

Tree = Any
# constant lr or a host step -> lr schedule (ops.schedules)
LR = Union[float, Callable[[int], float]]


def _lr_at(lr: LR, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def global_norm(grads: Tree) -> torch.Tensor:
    """L2 norm over every leaf (f32 accumulation), as a device scalar."""
    norms = torch._foreach_norm([g.float() for g in leaves(grads)])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """Scale the whole tree so its global L2 norm is <= ``max_norm``; the
    scale stays on the device (no sync)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]
    name: str = "optimizer"


def _apply(params: List[torch.Tensor], steps: List[torch.Tensor],
           lr_t: float) -> None:
    """param <- param - (lr * step) cast to the param's dtype, in place."""
    upd = torch._foreach_mul([s.float() for s in steps], lr_t)
    torch._foreach_sub_(params, [u.to(p.dtype) for u, p in zip(upd, params)])


class SGDState(NamedTuple):
    count: int            # optimizer steps taken (drives lr schedules)
    momentum_buf: Tree    # torch's momentum_buffer


def sgd(lr: LR, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    """torch-semantics SGD (see the module docstring)."""

    def init(params: Tree) -> SGDState:
        return SGDState(0, tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads: Tree, state: SGDState, params: Tree):
        lr_t = _lr_at(lr, state.count)
        p, g = leaves(params), leaves(grads)
        if weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        step = g
        if momentum:
            buf = leaves(state.momentum_buf)
            torch._foreach_mul_(buf, momentum)
            torch._foreach_add_(buf, g)
            step = buf
        _apply(p, step, lr_t)
        return params, SGDState(state.count + 1, state.momentum_buf)

    return Optimizer(init, update, f"sgd(lr={lr},m={momentum})")


class AdamState(NamedTuple):
    count: int
    mu: Tree
    nu: Tree


def adam(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, decoupled: bool = False) -> Optimizer:
    """Adam / AdamW (``decoupled=True``)."""

    def init(params: Tree) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads: Tree, state: AdamState, params: Tree):
        lr_t = _lr_at(lr, state.count)
        p, g = leaves(params), leaves(grads)
        mu, nu = leaves(state.mu), leaves(state.nu)
        if weight_decay and not decoupled:
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        count = state.count + 1
        # bias corrections in f32, as JAX evaluates b ** t
        t = np.float32(count)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        g2 = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(g2, g)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        del g2
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        del den
        if weight_decay and decoupled:
            torch._foreach_add_(upd, torch._foreach_mul(p, weight_decay))
        _apply(p, upd, lr_t)
        return params, AdamState(count, state.mu, state.nu)

    return Optimizer(init, update,
                     f"{'adamw' if decoupled else 'adam'}(lr={lr})")


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay, decoupled=True)


def with_clipping(opt: Optimizer, max_norm: float) -> Optimizer:
    """Clip the (already all-reduced) gradients by their global L2 norm
    before the wrapped update."""
    if max_norm <= 0:
        return opt

    def update(grads, state, params):
        return opt.update(clip_by_global_norm(grads, max_norm), state, params)

    return Optimizer(opt.init, update, f"clip({max_norm}):{opt.name}")


def with_skip_guard(opt: Optimizer, skip_threshold: float = 0.0) -> Optimizer:
    raise NotImplementedError(
        "--skip-nonfinite/--skip_threshold (the guarded update) is not "
        "ported yet")


def with_master_weights(opt: Optimizer) -> Optimizer:
    raise NotImplementedError("--master_weights is not ported yet")


def make(name: str, lr: LR, momentum: float = 0.0,
         weight_decay: float = 0.0, grad_clip: float = 0.0) -> Optimizer:
    """Build from config strings (``TrainConfig.optimizer``)."""
    if name == "sgd":
        opt = sgd(lr, momentum, weight_decay)
    elif name == "adam":
        opt = adam(lr, weight_decay=weight_decay)
    elif name == "adamw":
        opt = adamw(lr, weight_decay=weight_decay or 0.01)
    elif name in ("lion", "adafactor"):
        raise NotImplementedError(f"--optimizer {name} is not ported yet")
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return with_clipping(opt, grad_clip)
