"""The world: ranks, devices and the process group.

The port of the world part of the JAX package's ``parallel/mesh.py``
(``world_setup``, ``describe``) and ``parallel/distributed.py``.  The
reference forms its world with ``mpiexec`` + ``MPI.COMM_WORLD``; the port
with ``torchrun``, whose ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` (and
``MASTER_ADDR``/``MASTER_PORT``) environment it reads.  Nothing of a
cluster is discovered otherwise: with no launcher the world is one process.

Under sequence parallelism (``sp > 1``) the world is a ``data x seq``
grid: rank = data_index * sp + seq_index (``seq`` minor to ``data``, as
in the JAX package's ``parallel/mesh.py`` ``AXIS_ORDER``), with one
process group per data index over its ``sp`` sequence ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..utils.platform import DeviceLike, resolve_device


@dataclass(frozen=True)
class World:
    rank: int
    world_size: int
    device: torch.device
    sp: int = 1
    # this rank's sequence process group (sp > 1 only)
    seq_pg: Optional[Any] = None

    @property
    def dp(self) -> int:
        return self.world_size // self.sp

    @property
    def data_rank(self) -> int:
        return self.rank // self.sp

    @property
    def seq_rank(self) -> int:
        return self.rank % self.sp

    @property
    def initialized(self) -> bool:
        """True when a process group carries the collectives (the
        gradient all-reduce runs then, even in a world of one)."""
        return dist.is_available() and dist.is_initialized()


def world_setup(device: DeviceLike = None, sp: int = 1,
                dp: int = -1) -> World:
    """Form the world; returns this process's rank, the world size, its
    device and, for ``sp > 1``, its sequence group.

    * An already initialised process group is used as it is.
    * Under torchrun (``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` set) the group
      is initialised here: ``nccl`` for cuda, ``gloo`` for cpu, from the
      ``env://`` rendezvous torchrun provides.
    * With no launcher the world is one process and no group is formed.

    The device is ``cuda:LOCAL_RANK`` by default (raising without a GPU);
    ``device="cpu"`` asks for the host.

    ``dp`` x ``sp`` must equal the world size (``dp=-1``: whatever ``sp``
    leaves); with ``sp > 1`` every rank takes part in forming every data
    index's sequence group (``dist.new_group`` is collective).
    """
    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not (dist.is_available() and dist.is_initialized()) and \
            "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    if sp < 1 or size % sp or (dp != -1 and dp * sp != size):
        raise ValueError(
            f"--dp {dp} x --sp {sp} does not fit a world of {size} "
            f"process(es){'' if size > 1 else ' (launch with torchrun)'}")
    seq_pg = None
    if sp > 1:
        for d in range(size // sp):
            pg = dist.new_group(list(range(d * sp, (d + 1) * sp)))
            if d == rank // sp:
                seq_pg = pg
    return World(rank, size, dev, sp, seq_pg)


def describe(world: World) -> str:
    """``data=N seq=S`` for a sequence-parallel world, ``data=N`` for a
    data-parallel one, ``single-device`` for one process."""
    if world.sp > 1:
        return f"data={world.dp} seq={world.sp}"
    return f"data={world.world_size}" if world.world_size > 1 \
        else "single-device"
