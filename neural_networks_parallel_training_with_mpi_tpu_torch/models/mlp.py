"""MLP family, the port of the JAX package's ``models/mlp.py``.

``reference_mlp()`` is the parity model: the reference's
``nn.Sequential(nn.Linear(2, 3), nn.ReLU(), nn.Linear(3, 1))``
(dataParallelTraining_NN_MPI.py:41-45).  Parameters are the JAX
package's list ``[{w, b}, {}, {w, b}]`` aligned with the layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..utils.platform import DeviceLike, resolve_device
from .core import Activation, Linear, Sequential


@dataclass(frozen=True)
class MLP:
    in_features: int = 2
    hidden: Tuple[int, ...] = (3,)
    out_features: int = 1
    activation: str = "relu"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: Optional[torch.dtype] = None
    device: DeviceLike = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def net(self) -> Sequential:
        layers, prev = [], self.in_features
        for h in self.hidden:
            layers += [Linear(prev, h, param_dtype=self.param_dtype,
                              compute_dtype=self.compute_dtype),
                       Activation(self.activation)]
            prev = h
        layers.append(Linear(prev, self.out_features,
                             param_dtype=self.param_dtype,
                             compute_dtype=self.compute_dtype))
        return Sequential(tuple(layers))

    def init(self, generator: torch.Generator):
        return self.net.init(generator, self.device)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        return self.net.apply(params, x)

    def fwd_flops(self, x_shape) -> float:
        dims = (self.in_features,) + tuple(self.hidden) + (self.out_features,)
        batch = 1
        for s in x_shape[:-1]:
            batch *= s
        return float(2 * batch * sum(a * b for a, b in zip(dims, dims[1:])))


def reference_mlp(device: DeviceLike = None) -> MLP:
    """The reference's exact architecture: 2 -> 3 (ReLU) -> 1."""
    return MLP(in_features=2, hidden=(3,), out_features=1, activation="relu",
               device=device)
