"""Train state: the one logical copy of params + optimizer state, the port
of the JAX package's ``train/state.py``.  Every rank holds an identical
replica (same seeded init, same all-reduced gradients); ``step`` is a host
int.

``qstate`` is the fp8 delayed-scaling calibration state (``ops.qmm``):
per-role activation amax histories, read at the top of the step and
rolled in place at its end.  ``()``, with no leaves, for every model that
is not fp8, so those states flatten to the leaves they held before the
field existed and their snapshots restore either way.  Replicated: the
observations are max-reduced over the ranks before they enter."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils.tree import tree_map


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any
    qstate: Any = ()

    @classmethod
    def create(cls, model, optimizer, generator: torch.Generator
               ) -> "TrainState":
        params = model.init(generator)
        return cls.from_params(params, optimizer, model)

    @classmethod
    def from_params(cls, params, optimizer, model=None) -> "TrainState":
        """Parameters become leaf tensors that autograd differentiates;
        ``optimizer=None`` leaves the opt state to the caller (None);
        ``model`` gives the calibration state (``()`` without one)."""
        from ..ops import qmm

        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        return cls(step=0, params=params, opt_state=(
            None if optimizer is None else optimizer.init(params)),
            qstate=() if model is None else qmm.init_qstate(model))
