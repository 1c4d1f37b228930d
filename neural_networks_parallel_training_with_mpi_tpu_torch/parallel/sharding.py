"""Shard-size math (numpy), the port of the JAX package's
``parallel/sharding.py`` without its device placement: the Scatterv split
and the pad + mask that keeps every rank's batch the same shape while the
masked loss still gives the exact global-batch gradient."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def shard_sizes(n_rows: int, n_shards: int) -> np.ndarray:
    """Rows per shard under the reference's Scatterv policy: the first
    ``n_rows % n_shards`` shards get one extra row (int64)."""
    if n_shards <= 0:
        raise ValueError("n_shards must be positive")
    base, residue = divmod(n_rows, n_shards)
    sizes = np.full(n_shards, base, dtype=np.int64)
    sizes[:residue] += 1
    return sizes


def padded_rows(n_rows: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= ``n_rows``."""
    return int(-(-n_rows // n_shards) * n_shards)


def pad_to_multiple(x: np.ndarray, n_shards: int, axis: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad ``x`` along ``axis`` to a multiple of ``n_shards``; returns
    ``(padded, mask)`` with mask 1.0 for real rows and 0.0 for padding."""
    n = x.shape[axis]
    target = padded_rows(n, n_shards)
    mask = np.zeros(target, dtype=np.float32)
    mask[:n] = 1.0
    if target == n:
        return x, mask
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width), mask


def rank_slice(n_rows: int, world_size: int, rank: int) -> slice:
    """The contiguous rows of a padded global batch that ``rank`` holds —
    what dim-0 sharding over the data axis gives each device in the JAX
    package.  ``n_rows`` must be a multiple of ``world_size``."""
    per = n_rows // world_size
    return slice(rank * per, (rank + 1) * per)
