"""The world: ranks, devices and the process group.

The port of the world part of the JAX package's ``parallel/mesh.py``
(``world_setup``, ``describe``) and ``parallel/distributed.py``.  The
reference forms its world with ``mpiexec`` + ``MPI.COMM_WORLD``; the port
with ``torchrun``, whose ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` (and
``MASTER_ADDR``/``MASTER_PORT``) environment it reads.  Nothing of a
cluster is discovered otherwise: with no launcher the world is one process.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.platform import DeviceLike, resolve_device


@dataclass(frozen=True)
class World:
    rank: int
    world_size: int
    device: torch.device

    @property
    def initialized(self) -> bool:
        """True when a process group carries the collectives (the
        gradient all-reduce runs then, even in a world of one)."""
        return dist.is_available() and dist.is_initialized()


def world_setup(device: DeviceLike = None) -> World:
    """Form the world; returns this process's rank, the world size and its
    device.

    * An already initialised process group is used as it is.
    * Under torchrun (``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` set) the group
      is initialised here: ``nccl`` for cuda, ``gloo`` for cpu, from the
      ``env://`` rendezvous torchrun provides.
    * With no launcher the world is one process and no group is formed.

    The device is ``cuda:LOCAL_RANK`` by default (raising without a GPU);
    ``device="cpu"`` asks for the host.
    """
    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size(), dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
        return World(dist.get_rank(), dist.get_world_size(), dev)
    return World(0, 1, dev)


def describe(world: World) -> str:
    """``data=N`` for a data-parallel world, ``single-device`` for one."""
    return f"data={world.world_size}" if world.world_size > 1 \
        else "single-device"
