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
process group per data index over its ``sp`` sequence ranks, and one per
sequence index over its ``dp`` data ranks (the sharded weight update's
collectives).

Fail-fast world formation (the JAX package's ``parallel/mesh.py``): before
``init_process_group`` a multi-process world meets in a bounded
rendezvous over a ``TCPStore`` on the launcher's port + 1 (override
``NNPT_PREFLIGHT_PORT``), so a missing peer
or coordinator raises a typed :class:`WorldFormationError` within
``NNPT_WORLD_TIMEOUT_S`` seconds (the CLI's ``--probe_timeout``, default
60) instead of hanging; the CLI maps it to exit 43.  ``collective_timeout``
(``--collective_timeout``) bounds every collective: gloo raises and NCCL's
async error handling aborts a rank whose peer is gone.  :func:`probe_world`
runs the rendezvous in a subprocess under a hard timeout and reports the
world that answered.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..utils.platform import DeviceLike, resolve_device

WORLD_TIMEOUT_ENV = "NNPT_WORLD_TIMEOUT_S"
PREFLIGHT_PORT_ENV = "NNPT_PREFLIGHT_PORT"    # default: launcher port + 1
DEFAULT_WORLD_TIMEOUT_S = 60.0


class WorldFormationError(RuntimeError):
    """World formation failed within its timeout (typed: the CLI maps it
    to exit 43, a retryable peer loss, never a silent hang)."""


class CoordinatorUnreachable(WorldFormationError):
    """A rank could not reach rank 0's rendezvous within the timeout."""


class PeerMissing(WorldFormationError):
    """Rank 0 formed the rendezvous but a peer never checked in."""


# the rendezvous stores stay alive with the process: rank 0's serves the
# peers' last reads
_STORES: List[Any] = []


def _wait_keys(store, keys: List[str], deadline: float) -> List[str]:
    """The keys of ``keys`` still absent from ``store`` at ``deadline``."""
    missing = list(keys)
    while missing:
        missing = [k for k in missing if not store.check([k])]
        if not missing or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    return missing


def preflight(host: str, port: int, world_size: int, rank: int,
              timeout_s: float) -> None:
    """Bounded rendezvous of ``world_size`` ranks over a ``TCPStore`` that
    rank 0 serves on ``host:port``: rank 0 waits for every peer to check
    in (else :class:`PeerMissing`, naming them) and then releases them; a
    peer that cannot connect raises :class:`CoordinatorUnreachable`, and
    one that connects but is never released :class:`PeerMissing`."""
    deadline = time.monotonic() + timeout_s
    td = timedelta(seconds=max(timeout_s, 1.0))
    if rank == 0:
        try:
            store = dist.TCPStore(host, port, world_size, True, timeout=td,
                                  wait_for_workers=False)
        except Exception as e:  # noqa: BLE001 — typed below
            raise WorldFormationError(
                f"rank 0 cannot serve the rendezvous on {host}:{port}: "
                f"{e}") from e
        _STORES.append(store)
        missing = _wait_keys(store, [f"preflight/{r}"
                                     for r in range(1, world_size)],
                             deadline)
        if missing:
            ranks = [int(k.rsplit("/", 1)[1]) for k in missing]
            raise PeerMissing(f"rank(s) {ranks} of {world_size} did not "
                              f"check in within {timeout_s:.0f}s")
        store.set("preflight/go", "1")
        return
    try:
        store = dist.TCPStore(host, port, world_size, False, timeout=td)
    except Exception as e:  # noqa: BLE001 — typed below
        raise CoordinatorUnreachable(
            f"rank {rank} could not reach the rendezvous on {host}:{port} "
            f"within {timeout_s:.0f}s: {e}") from e
    _STORES.append(store)
    store.set(f"preflight/{rank}", "1")
    if _wait_keys(store, ["preflight/go"], deadline):
        raise PeerMissing(f"rank {rank}: rank 0 never released the world "
                          f"within {timeout_s:.0f}s (a peer is missing)")


def _launcher_world() -> Optional[tuple]:
    """(host, port, world size, rank) of a torchrun-style launch, or None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (os.environ.get("MASTER_ADDR", "localhost"),
            int(os.environ.get("MASTER_PORT", "29500")),
            int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))


def _world_timeout() -> float:
    return float(os.environ.get(WORLD_TIMEOUT_ENV)
                 or DEFAULT_WORLD_TIMEOUT_S)


def _preflight_port(port: int) -> int:
    return int(os.environ.get(PREFLIGHT_PORT_ENV) or port + 1)


_PROBE_SRC = """
import json, os, sys, torch
sys.path.insert(0, os.environ["_NNPT_PROBE_ROOT"])
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    distributed as d)
w = d._launcher_world()
n = 1
if w is not None and w[2] > 1:
    d.preflight(w[0], d._preflight_port(w[1]), w[2], w[3],
                float(os.environ["_NNPT_PROBE_TIMEOUT"]))
    n = w[2]
local = torch.cuda.device_count() if torch.cuda.is_available() else 1
print("PROBE_WORLD|" + json.dumps({"n_processes": n,
                                   "n_devices": n * local,
                                   "local_devices": local}))
"""


def probe_world(timeout_s: Optional[float] = None) -> Optional[dict]:
    """The world that answers now, found in a SUBPROCESS under a hard
    timeout (so a dead peer can never hang the caller): the launcher
    environment's rendezvous (on the port after the preflight's, so it
    never meets a live world's), then this host's card count.  Returns
    ``{"n_processes", "n_devices", "local_devices"}``, or None when the
    world does not form within ``timeout_s`` (default
    ``NNPT_WORLD_TIMEOUT_S``)."""
    timeout_s = _world_timeout() if timeout_s is None else timeout_s
    env = dict(os.environ, _NNPT_PROBE_ROOT=str(
        Path(__file__).resolve().parents[2]),
        _NNPT_PROBE_TIMEOUT=str(timeout_s))
    w = _launcher_world()
    if w is not None:
        env[PREFLIGHT_PORT_ENV] = str(_preflight_port(w[1]) + 1)
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE_SRC],
                             capture_output=True, text=True, env=env,
                             timeout=timeout_s + 30.0)
    except subprocess.TimeoutExpired:
        return None
    for line in out.stdout.splitlines():
        if line.startswith("PROBE_WORLD|"):
            return json.loads(line.split("|", 1)[1])
    return None


@dataclass(frozen=True)
class World:
    rank: int
    world_size: int
    device: torch.device
    sp: int = 1
    # this rank's sequence process group (sp > 1 only)
    seq_pg: Optional[Any] = None
    # this rank's data process group (sp > 1 only; None: the whole world)
    data_pg: Optional[Any] = None

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
                dp: int = -1, collective_timeout: float = 0.0) -> World:
    """Form the world; returns this process's rank, the world size, its
    device and, for ``sp > 1``, its sequence group.

    * An already initialised process group is used as it is.
    * Under torchrun (``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` set) the group
      is initialised here: ``nccl`` for cuda, ``gloo`` for cpu, from the
      ``env://`` rendezvous torchrun provides, after the bounded
      :func:`preflight` (a world of more than one rank).
      ``collective_timeout`` > 0 bounds its collectives (seconds).
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
    launcher = _launcher_world()
    if not (dist.is_available() and dist.is_initialized()) and launcher:
        host, port, size, rank = launcher
        if size > 1:
            preflight(host, _preflight_port(port), size, rank,
                      _world_timeout())
        kw = {}
        if collective_timeout > 0:
            kw["timeout"] = timedelta(seconds=collective_timeout)
            # a timed-out NCCL collective tears the rank down instead of
            # leaving it blocked on the stream
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="env://", rank=rank, world_size=size, **kw)
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    if sp < 1 or size % sp or (dp != -1 and dp * sp != size):
        raise ValueError(
            f"--dp {dp} x --sp {sp} does not fit a world of {size} "
            f"process(es){'' if size > 1 else ' (launch with torchrun)'}")
    seq_pg = data_pg = None
    if sp > 1:
        for d in range(size // sp):
            pg = dist.new_group(list(range(d * sp, (d + 1) * sp)))
            if d == rank // sp:
                seq_pg = pg
        for s in range(sp):
            pg = dist.new_group(list(range(s, size, sp)))
            if s == rank % sp:
                data_pg = pg
    return World(rank, size, dev, sp, seq_pg, data_pg)


def describe(world: World) -> str:
    """``data=N seq=S`` for a sequence-parallel world, ``data=N`` for a
    data-parallel one, ``single-device`` for one process."""
    if world.sp > 1:
        return f"data={world.dp} seq={world.sp}"
    return f"data={world.world_size}" if world.world_size > 1 \
        else "single-device"
