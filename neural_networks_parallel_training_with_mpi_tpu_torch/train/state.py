"""Train state: the one logical copy of params + optimizer state, the port
of the JAX package's ``train/state.py``.  Every rank holds an identical
replica (same seeded init, same all-reduced gradients); ``step`` is a host
int.  The fp8 calibration state (``qstate``) is absent until the quantized
matmuls are ported."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils.tree import tree_map


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any

    @classmethod
    def create(cls, model, optimizer, generator: torch.Generator
               ) -> "TrainState":
        params = model.init(generator)
        return cls.from_params(params, optimizer)

    @classmethod
    def from_params(cls, params, optimizer) -> "TrainState":
        """Parameters become leaf tensors that autograd differentiates;
        ``optimizer=None`` leaves the opt state to the caller (None)."""
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        return cls(step=0, params=params, opt_state=(
            None if optimizer is None else optimizer.init(params)))
