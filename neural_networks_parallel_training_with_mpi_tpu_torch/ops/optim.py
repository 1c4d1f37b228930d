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

The step's host-computed scalars (the scheduled lr, Adam's two bias
corrections) reach the update as ONE 1-D f32 device tensor,
``Optimizer.scalars(count)`` copied to the card, and never as Python
floats: a CUDA graph of the train step (``parallel.data_parallel.
GraphedTrainStep``) would freeze a float into its kernels, while a
tensor it reads is rewritten before every replay.  The values are
computed in np.float32 on the host exactly as a Python scalar would be
rounded, so the f32 results are bitwise those of the scalar form.

``sgd`` is torch-semantics SGD (dampening 0, no Nesterov):
``buf <- momentum * buf + grad``; ``param <- param - lr * buf``.

Not ported yet, and refused at ``make``: lion, adafactor; and the
wrappers ``with_skip_guard`` and ``with_master_weights``.
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
    """``update(grads, state, params, scalars_t=None)``: ``scalars_t`` is
    the 1-D f32 device tensor of ``scalars(state.count)`` (None: copied
    from the host here); ``scalars(count)`` the step's host values in
    np.float32."""
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]
    name: str = "optimizer"
    scalars: Optional[Callable[[int], np.ndarray]] = None


def _scalars_on(scalars: Optional[torch.Tensor], host: Callable,
                count: int, params: List[torch.Tensor]) -> torch.Tensor:
    return (scalars if scalars is not None
            else device_scalars(host(count), params[0]))


def _apply(params: List[torch.Tensor], steps: List[torch.Tensor],
           lr_t: torch.Tensor) -> None:
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

    def scalars(count: int) -> np.ndarray:
        return np.array([_lr_at(lr, count)], np.float32)

    @torch.no_grad()
    def update(grads: Tree, state: SGDState, params: Tree, scalars_t=None):
        p, g = leaves(params), leaves(grads)
        lr_t = _scalars_on(scalars_t, scalars, state.count, p)[0]
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

    return Optimizer(init, update, f"sgd(lr={lr},m={momentum})", scalars)


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

    def scalars(count: int) -> np.ndarray:
        """lr, then the bias corrections of step ``count + 1`` in f32, as
        JAX evaluates b ** t."""
        t = np.float32(count + 1)
        return np.array([_lr_at(lr, count),
                         np.float32(1) - np.float32(b1) ** t,
                         np.float32(1) - np.float32(b2) ** t], np.float32)

    @torch.no_grad()
    def update(grads: Tree, state: AdamState, params: Tree, scalars_t=None):
        p, g = leaves(params), leaves(grads)
        lr_t, bc1, bc2 = _scalars_on(scalars_t, scalars, state.count, p)
        mu, nu = leaves(state.mu), leaves(state.nu)
        if weight_decay and not decoupled:
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
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
        return params, AdamState(state.count + 1, state.mu, state.nu)

    return Optimizer(init, update,
                     f"{'adamw' if decoupled else 'adam'}(lr={lr})", scalars)


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay, decoupled=True)


def with_clipping(opt: Optimizer, max_norm: float) -> Optimizer:
    """Clip the (already all-reduced) gradients by their global L2 norm
    before the wrapped update."""
    if max_norm <= 0:
        return opt

    def update(grads, state, params, scalars_t=None):
        return opt.update(clip_by_global_norm(grads, max_norm), state, params,
                          scalars_t)

    return Optimizer(opt.init, update, f"clip({max_norm}):{opt.name}",
                     opt.scalars)


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
