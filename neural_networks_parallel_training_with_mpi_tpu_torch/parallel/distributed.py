"""The world: ranks, devices and the process group.

The port of the world part of the JAX package's ``parallel/mesh.py``
(``world_setup``, ``describe``) and ``parallel/distributed.py``.  The
reference forms its world with ``mpiexec`` + ``MPI.COMM_WORLD``; the port
with ``torchrun``, whose ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` (and
``MASTER_ADDR``/``MASTER_PORT``) environment it reads.  Nothing of a
cluster is discovered otherwise: with no launcher the world is one process.

Under fsdp, pipeline, expert, sequence and tensor parallelism (``fsdp >
1``, ``pp > 1``, ``ep > 1``, ``sp > 1``, ``tp > 1``) the world is a ``data
x fsdp x pipe x expert x seq x tensor`` grid: rank = ((((data_index *
fsdp + fsdp_index) * pp + pipe_index) * ep + expert_index) * sp +
seq_index) * tp + tensor_index (``tensor`` minor, then ``seq``,
``expert``, ``pipe``, ``fsdp``, ``data``: the JAX package's
``parallel/mesh.py`` ``AXIS_ORDER``, so a tensor group sits on adjacent
ranks, on one node's NVLink).  Its process groups run along one axis each
through every grid point: ``seq_pg`` over the ``sp`` sequence ranks,
``data_pg`` over the ``dp`` data ranks (the sharded weight update's
collectives), ``fsdp_pg`` over the ``fsdp`` ranks (the gathers of
``parallel.fsdp``), ``pipe_pg`` over the ``pp`` pipeline stages
(``parallel.pipeline``'s hops), ``expert_pg`` over the ``ep`` expert
ranks (``parallel.expert``'s all-to-alls) and ``tensor_pg`` over the
``tp`` tensor ranks; ``replica_pg`` runs over the data x expert x seq
ranks of one (fsdp, pipe, tensor) index, the ranks that hold the same
slices of every replicated leaf, over which a gradient is all-reduced,
and ``expert_replica_pg`` over the data x seq ranks of one (expert,
tensor) index, the ranks that hold the same experts (the expert leaves'
gradients reduce over it: JAX's rule in ``parallel/expert.py``).  The
batch is split over data x fsdp x expert (the JAX package's
``DATA_AXES``, and its ``TOKEN_AXES`` on the expert layouts); the stages
of one data index read the same rows.

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
world that answered, or, when the configured world does not form, this
host's cards, marked degraded (the elastic supervisor's probe).

Replica consistency (``utils.consistency``, the trainer's SDC check)
reads the world as ``(nodes, LOCAL_WORLD_SIZE)``: rank r is local rank
``r % L`` of node ``r // L`` (torchrun's ``LOCAL_WORLD_SIZE``, default
the whole world as one node), the counterpart of the JAX package's
``(processes, local devices)`` digest matrix.  :func:`node_group` is the
per-node process group its heal broadcasts over, and
:func:`allgather_host_array` / :func:`cross_host_report` gather small host
arrays over a gloo group (the world's own under gloo, a second one beside
NCCL).
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
from typing import Any, Dict, List, Optional

import numpy as np
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
# groups formed for replica consistency (node groups, the host gloo
# group), and the world's collective timeout that bounds them too
_GROUPS: Dict[Any, Any] = {}


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


def process_count() -> int:
    """The processes of this world: the initialised group's, else the
    launcher's ``WORLD_SIZE``, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    launcher = _launcher_world()
    return launcher[2] if launcher else 1


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
if w is not None and w[2] > 1 and not os.environ.get("_NNPT_PROBE_LOCAL"):
    d.preflight(w[0], d._preflight_port(w[1]), w[2], w[3],
                float(os.environ["_NNPT_PROBE_TIMEOUT"]))
    n = w[2]
local = torch.cuda.device_count() if torch.cuda.is_available() else 1
print("PROBE_WORLD|" + json.dumps({"n_processes": n,
                                   "n_devices": n * local,
                                   "local_devices": local}))
"""


def probe_world(timeout_s: Optional[float] = None,
                log=None) -> Optional[dict]:
    """The world that answers now, found in a SUBPROCESS under a hard
    timeout (so a dead peer can never hang the caller): the launcher
    environment's rendezvous (on the port after the preflight's, so it
    never meets a live world's), then this host's card count.  Returns
    ``{"n_processes", "n_devices", "local_devices", "degraded"}``.  As
    the JAX package's ``parallel/mesh.py`` ``probe_world`` (what the
    elastic supervisor calls): a launcher world that does not form within
    ``timeout_s`` (default ``NNPT_WORLD_TIMEOUT_S``) is probed again as
    this host alone (``n_processes`` 1, ``n_devices`` its cards),
    ``degraded`` True when a bigger world had been configured; None only
    when even that fails."""
    timeout_s = _world_timeout() if timeout_s is None else timeout_s
    w = _launcher_world()

    def attempt(local: bool) -> Optional[dict]:
        env = dict(os.environ, _NNPT_PROBE_ROOT=str(
            Path(__file__).resolve().parents[2]),
            _NNPT_PROBE_TIMEOUT=str(timeout_s))
        env.pop("_NNPT_PROBE_LOCAL", None)
        if local:
            env["_NNPT_PROBE_LOCAL"] = "1"
        if w is not None:
            env[PREFLIGHT_PORT_ENV] = str(_preflight_port(w[1]) + 1)
        try:
            out = subprocess.run([sys.executable, "-c", _PROBE_SRC],
                                 capture_output=True, text=True, env=env,
                                 timeout=timeout_s + 30.0)
        except subprocess.TimeoutExpired:
            if log:
                log(f"[probe] world probe timed out after {timeout_s:.0f}s"
                    + (" (local)" if local else " (full world)"))
            return None
        for line in out.stdout.splitlines():
            if line.startswith("PROBE_WORLD|"):
                return json.loads(line.split("|", 1)[1])
        if log:
            tail = (out.stderr or out.stdout).strip().splitlines()[-1:] \
                or [""]
            log(f"[probe] world probe rc={out.returncode}: {tail[0][:200]}")
        return None

    multi = w is not None and w[2] > 1
    res = attempt(local=False)
    if res is not None:
        res["degraded"] = False
        return res
    if not multi:
        return None
    if log:
        log("[probe] full world unreachable; probing local topology")
    res = attempt(local=True)
    if res is None:
        return None
    res["n_processes"] = 1
    res["n_devices"] = res["local_devices"]
    res["degraded"] = True
    return res


@dataclass(frozen=True)
class World:
    rank: int
    world_size: int
    device: torch.device
    sp: int = 1
    # this rank's sequence process group (sp > 1 only)
    seq_pg: Optional[Any] = None
    # this rank's data process group (a model axis > 1; None: the world)
    data_pg: Optional[Any] = None
    tp: int = 1
    # this rank's tensor process group (tp > 1 only)
    tensor_pg: Optional[Any] = None
    fsdp: int = 1
    # this rank's fsdp process group (fsdp > 1 only)
    fsdp_pg: Optional[Any] = None
    # the data x seq ranks of this rank's (fsdp, pipe, tensor) index (tp,
    # pp or fsdp > 1; None: the whole world)
    replica_pg: Optional[Any] = None
    pp: int = 1
    # this rank's pipe process group (pp > 1 only)
    pipe_pg: Optional[Any] = None
    ep: int = 1
    # this rank's expert process group (ep > 1 only)
    expert_pg: Optional[Any] = None
    # the data x seq ranks of this rank's (expert, tensor) index (ep > 1
    # only)
    expert_replica_pg: Optional[Any] = None

    @property
    def _model(self) -> int:
        return self.fsdp * self.pp * self.ep * self.sp * self.tp

    @property
    def dp(self) -> int:
        return self.world_size // self._model

    @property
    def data_rank(self) -> int:
        return self.rank // self._model

    @property
    def fsdp_rank(self) -> int:
        return (self.rank // (self.pp * self.ep * self.sp * self.tp)
                ) % self.fsdp

    @property
    def pipe_rank(self) -> int:
        return (self.rank // (self.ep * self.sp * self.tp)) % self.pp

    @property
    def expert_rank(self) -> int:
        return (self.rank // (self.sp * self.tp)) % self.ep

    @property
    def seq_rank(self) -> int:
        return (self.rank // self.tp) % self.sp

    @property
    def tensor_rank(self) -> int:
        return self.rank % self.tp

    @property
    def batch_shards(self) -> int:
        """The batch's row shards: data x fsdp x expert."""
        return self.dp * self.fsdp * self.ep

    @property
    def batch_rank(self) -> int:
        """This rank's row shard of the batch (data major, expert minor)."""
        return ((self.data_rank * self.fsdp + self.fsdp_rank) * self.ep
                + self.expert_rank)

    @property
    def initialized(self) -> bool:
        """True when a process group carries the collectives (the
        gradient all-reduce runs then, even in a world of one)."""
        return dist.is_available() and dist.is_initialized()

    def batch_all_reduce(self, x: torch.Tensor) -> None:
        """Sum ``x`` in place over every rank holding other batch rows
        and the same model slices: the fsdp ranks, then the data x seq
        ranks (each tensor rank once)."""
        if self.fsdp_pg is not None:
            dist.all_reduce(x, group=self.fsdp_pg)
        if self.initialized:
            dist.all_reduce(x, group=self.replica_pg)


class BatchGroup:
    """The ranks holding other rows of the global batch and the same model
    slices (data x fsdp), as ``ops.qmm``'s global-view scales read them:
    ``max`` is the elementwise max over them, ``all_gather`` stacks their
    tensors in the global batch's row order (data major, fsdp minor), as
    the MoE layer's global-batch routing reads them (``models.moe``);
    ``size`` is their count and ``index`` this rank's place among
    them."""

    def __init__(self, world: World):
        self.world = world
        fsdp = world.fsdp if world.fsdp_pg is not None else 1
        data = (dist.get_world_size(world.replica_pg)
                if world.initialized else 1)
        self.size = fsdp * data
        self.index = world.batch_rank

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every batch rank's ``x`` (no gradient)."""
        x = x.detach().contiguous()
        if self.world.fsdp_pg is not None:
            parts = [torch.empty_like(x) for _ in range(self.world.fsdp)]
            dist.all_gather(parts, x, group=self.world.fsdp_pg)
            x = torch.stack(parts)
        else:
            x = x[None]
        parts = [torch.empty_like(x)
                 for _ in range(self.size // x.shape[0])]
        dist.all_gather(parts, x, group=self.world.replica_pg)
        return torch.cat(parts)

    def max(self, parts) -> torch.Tensor:
        out = parts[0].detach().clone()
        for p in parts[1:]:
            out = torch.maximum(out, p.detach())
        if self.world.fsdp_pg is not None:
            dist.all_reduce(out, op=dist.ReduceOp.MAX,
                            group=self.world.fsdp_pg)
        dist.all_reduce(out, op=dist.ReduceOp.MAX,
                        group=self.world.replica_pg)
        return out


def world_setup(device: DeviceLike = None, sp: int = 1,
                dp: int = -1, collective_timeout: float = 0.0,
                tp: int = 1, fsdp: int = 1, pp: int = 1,
                ep: int = 1) -> World:
    """Form the world; returns this process's rank, the world size, its
    device and, for ``sp``, ``tp``, ``fsdp``, ``pp`` or ``ep`` > 1, its
    process groups.

    * An already initialised process group is used as it is.
    * Under torchrun (``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` set) the group
      is initialised here: ``nccl`` for cuda, ``gloo`` for cpu, from the
      ``env://`` rendezvous torchrun provides, after the bounded
      :func:`preflight` (a world of more than one rank).
      ``collective_timeout`` > 0 bounds its collectives (seconds).
    * With no launcher the world is one process and no group is formed.

    The device is ``cuda:LOCAL_RANK`` by default (raising without a GPU);
    ``device="cpu"`` asks for the host.

    ``dp`` x ``fsdp`` x ``pp`` x ``ep`` x ``sp`` x ``tp`` must equal the
    world size
    (``dp=-1``: whatever the others leave); every rank takes part in
    forming every group (``dist.new_group`` is collective).
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
            _GROUPS["timeout"] = kw["timeout"]
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
    model = fsdp * pp * ep * sp * tp
    if min(sp, tp, fsdp, pp, ep) < 1 or size % model or (
            dp != -1 and dp * model != size):
        what = (f"--dp {dp}" + (f" x --fsdp {fsdp}" if fsdp > 1 else "")
                + (f" x --pp {pp}" if pp > 1 else "")
                + (f" x --ep {ep}" if ep > 1 else "")
                + f" x --sp {sp}" + (f" x --tp {tp}" if tp > 1 else ""))
        raise ValueError(
            f"{what} does not fit a world of {size} "
            f"process(es){'' if size > 1 else ' (launch with torchrun)'}")
    grid = np.arange(size).reshape(size // model, fsdp, pp, ep, sp, tp)
    pgs: Dict[str, Any] = {}
    if model > 1:
        # (the axes moved last, the groups along them): each rank's group
        # is the one through its own grid point; the groups form in the
        # same order on every rank (the expert ones last)
        for name, axes in (("seq", (4,)), ("data", (0,)), ("tensor", (5,)),
                           ("fsdp", (1,)), ("pipe", (2,)),
                           ("replica", (0, 3, 4)), ("expert", (3,)),
                           ("expert_replica", (0, 4))):
            n = int(np.prod([grid.shape[a] for a in axes]))
            if (name == "replica" and fsdp * pp * tp == 1) or (
                    name == "expert_replica" and ep == 1) or (
                    n == 1 and name not in ("data", "replica",
                                            "expert_replica")):
                continue
            lines = np.moveaxis(grid, axes, range(6 - len(axes), 6)
                                ).reshape(-1, n)
            for line in lines:
                pg = dist.new_group([int(r) for r in line])
                if rank in line:
                    pgs[name] = pg
    return World(rank, size, dev, sp, pgs.get("seq"), pgs.get("data"), tp,
                 pgs.get("tensor"), fsdp, pgs.get("fsdp"),
                 pgs.get("replica"), pp, pgs.get("pipe"), ep,
                 pgs.get("expert"), pgs.get("expert_replica"))


def describe(world: World) -> str:
    """``data=N fsdp=F pipe=P expert=E seq=S tensor=T`` (the axes above 1
    past data) for a world with a model axis, ``data=N`` for a
    data-parallel one, ``single-device`` for one process."""
    axes = (("fsdp", world.fsdp), ("pipe", world.pp), ("expert", world.ep),
            ("seq", world.sp), ("tensor", world.tp))
    if any(n > 1 for _, n in axes):
        return " ".join([f"data={world.dp}"]
                        + [f"{k}={n}" for k, n in axes if n > 1])
    return f"data={world.world_size}" if world.world_size > 1 \
        else "single-device"


# ---- replica consistency: nodes, node groups, host gathers ---------------

LOCAL_WORLD_SIZE_ENV = "LOCAL_WORLD_SIZE"


def _size_rank() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_multi_host() -> bool:
    """True in a world of more than one process (the JAX package's
    multi-host test: here every rank is its own process)."""
    return _size_rank()[0] > 1


def local_world_size() -> int:
    """Ranks per node: torchrun's ``LOCAL_WORLD_SIZE``, else the whole
    world (one node).  It must divide the world size."""
    size, _ = _size_rank()
    local = int(os.environ.get(LOCAL_WORLD_SIZE_ENV) or size)
    if local < 1 or size % local:
        raise ValueError(f"{LOCAL_WORLD_SIZE_ENV}={local} does not divide "
                         f"the world of {size} rank(s)")
    return local


def node_layout() -> tuple:
    """(nodes, ranks per node, this rank's node, its local rank)."""
    size, rank = _size_rank()
    local = local_world_size()
    return size // local, local, rank // local, rank % local


def _new_group(ranks: List[int], backend: Optional[str] = None):
    kw = {}
    if "timeout" in _GROUPS:
        kw["timeout"] = _GROUPS["timeout"]
    if backend is not None:
        kw["backend"] = backend
    return dist.new_group(ranks, **kw)


def node_group():
    """This rank's node's process group, over which a divergence is
    localized and healed.  The first call forms one group per node, so
    every rank must make it, in the same order (``dist.new_group`` is
    collective).  None in a world of one node: the whole world."""
    n_nodes, local, node, _ = node_layout()
    if n_nodes == 1:
        return None
    key = ("node", n_nodes, local)
    if key not in _GROUPS:
        mine = None
        for k in range(n_nodes):
            pg = _new_group(list(range(k * local, (k + 1) * local)))
            if k == node:
                mine = pg
        _GROUPS[key] = mine
    return _GROUPS[key]


def host_group():
    """The gloo group that carries host arrays: the world's own under
    gloo, a second group over every rank beside NCCL (formed at the first
    call: every rank must make it)."""
    if dist.get_backend() == "gloo":
        return None
    if "host" not in _GROUPS:
        size, _ = _size_rank()
        _GROUPS["host"] = _new_group(list(range(size)), backend="gloo")
    return _GROUPS["host"]


def allgather_host_array(x: Any) -> np.ndarray:
    """Every rank's host array ``x``, stacked along a new leading axis in
    rank order (``x[None]`` in a world of one), over :func:`host_group`.
    The transport under every SDC verdict: identical on every rank."""
    a = np.asarray(x)
    if not is_multi_host():
        return a[None]
    wide = np.float64 if a.dtype.kind == "f" else np.int64
    t = torch.from_numpy(np.ascontiguousarray(a.astype(wide)))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t, group=host_group())
    return torch.stack(out).numpy().astype(a.dtype)


def cross_report(gathered: Dict[str, np.ndarray], local: int,
                 atol: float = 0.0) -> dict:
    """Pure host math behind :func:`cross_host_report`: each leaf's
    gathered ``(world, ...)`` array, the node representatives (local rank
    0 of every node) compared with node 0's.  Returns ``{leaf:
    {"processes": [nodes], "max_abs_diff"}}``; both-NaN positions are in
    lockstep, a NaN on one side is an infinite difference."""
    report: dict = {}
    for name, leaf in gathered.items():
        rows = np.asarray(leaf)[::local]
        ref = np.asarray(rows[0], np.float64)
        bad, worst = [], 0.0
        for i in range(1, rows.shape[0]):
            a = np.asarray(rows[i], np.float64)
            diff = np.where(np.isnan(a) & np.isnan(ref), 0.0,
                            np.abs(a - ref))
            m = float(np.max(diff, initial=0.0))
            if np.isnan(m):
                m = float("inf")
            if m > atol:
                bad.append(i)
                worst = max(worst, m)
        if bad:
            report[name] = {"processes": bad, "max_abs_diff": worst}
    return report


def cross_host_report(x: Dict[str, Any], atol: float = 0.0) -> dict:
    """The cross-node sweep (the JAX package's ``cross_host_report``,
    nodes in the place of processes): one gather of every rank's small
    per-leaf arrays, then :func:`cross_report`, identical on every rank.
    A world of one node reports healthy without communicating."""
    n_nodes, local, _, _ = node_layout()
    if n_nodes == 1:
        return {}
    names = sorted(x)
    arrays = [np.asarray(x[n], np.float64) for n in names]
    # one gather of every leaf, flattened end to end (f64 holds the
    # uint32 digests exactly)
    flat = allgather_host_array(np.concatenate(
        [a.reshape(-1) for a in arrays]))
    ends = np.cumsum([a.size for a in arrays])
    return cross_report(
        {n: flat[:, e - a.size:e].reshape((-1,) + a.shape)
         for n, a, e in zip(names, arrays, ends)}, local, atol)
