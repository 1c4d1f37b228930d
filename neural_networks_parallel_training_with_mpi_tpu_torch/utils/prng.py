"""Deterministic random streams from the job seed.

The port of the JAX package's ``utils/prng.py``: ``job_key``/``stream``/
``init_key``/``host_key`` there fold a tag (and the process index) into a
``jax.random`` key; here the same (seed, tag[, rank]) tuple seeds an
explicit ``torch.Generator`` through numpy's ``SeedSequence``.  The two
frameworks' streams differ, so parity tests carry weights across instead
of re-drawing them.
"""

from __future__ import annotations

import numpy as np
import torch

# stream tags, as in the JAX package — one per independent consumer
INIT = 0
DATA = 1
HOST = 3


def stream_seed(seed: int, tag: int, *extra: int) -> int:
    """A 63-bit torch seed for the (seed, tag, *extra) stream."""
    state = np.random.SeedSequence((seed, tag) + extra).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def stream(seed: int, tag: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, tag))


def init_generator(seed: int, device="cpu") -> torch.Generator:
    """Model-init stream: the same on every rank, so replicated init needs
    no broadcast (the reference broadcasts rank 0's state dict)."""
    return stream(seed, INIT, device)


def data_generator(seed: int, device="cpu") -> torch.Generator:
    return stream(seed, DATA, device)


def host_generator(seed: int, rank: int, device="cpu") -> torch.Generator:
    """A per-rank stream for rank-local randomness."""
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, HOST, rank))
