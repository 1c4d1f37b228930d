"""Training resilience: anomaly policy, preemption-safe exit, supervisor.

The port's own copy of the training half of the JAX package's
``train/resilience.py`` (it imports nothing of that package):

* :func:`ops.optim.with_skip_guard` (wired by the Trainer) rejects
  non-finite or over-threshold updates on the device; one bad batch can
  no longer poison the params.
* :class:`ResilienceMonitor` is the host-side anomaly policy over the
  loss the loop already reads at lag 1: after ``rollback_after``
  consecutive bad dispatches it asks for a rollback to the newest
  verified snapshot; after ``max_rollbacks`` rollbacks it aborts with
  :class:`AnomalyAbort` (exit :data:`EXIT_ANOMALY`).
* :class:`GracefulShutdown` turns SIGTERM/SIGINT into a flag the loop
  checks at each dispatch boundary: final snapshot, exit 0.  SIGUSR1 is
  the advance preemption notice: the same snapshot, then exit
  :data:`EXIT_DECOMMISSION`.
* :func:`supervise` relaunches a crashed child with exponential backoff
  and a bounded number of restarts, by the exit-code contract below.
  With the child's telemetry it also kills a child whose heartbeat went
  stale (exit 42), points the relaunch log at the child's postmortem,
  summarizes the alerts the child emitted, appends lifecycle records to
  an events file (the goodput ledger's join key) and stamps every child
  with the run identity (``NNPT_RUN_ID``, ``NNPT_INCARNATION``) the
  trace files carry.  With ``elastic``, a streak of peer-loss exits
  runs a topology probe and relaunches the child at the world that
  answered (:func:`degrade_env`: one process), parks below
  ``min_devices`` and exits :data:`EXIT_CAPACITY` when the budget runs
  out, and restores the original world when it answers again.
* :class:`SDCPolicy` is the per-device strike ledger of the trainer's
  replica-consistency check (``utils.consistency``): a transient
  divergence is healed, a deterministic one or a device over its strike
  budget aborts with :class:`SDCAbort` (exit :data:`EXIT_SDC`).
  :class:`CapacityAbort` (exit :data:`EXIT_CAPACITY`) is a world below
  ``--min_devices``.

Exit-code contract:

===========  ============================================  =========
code         meaning                                       supervisor
===========  ============================================  =========
0            run completed (or exited cleanly on SIGTERM)  stop
42           watchdog: no step progress (hang)             retry
43           peer loss: a collective raised/timed out or   retry
             world formation failed
44           anomaly abort: rollback budget exhausted      stop
45           SDC abort: a replica divergence the replay    stop
             reproduced, or a device over its strikes
46           capacity abort: fewer devices than            stop
             ``--min_devices``
47           decommission: a preemption notice was         stop
             answered with a final snapshot
other        crash (segfault, OOM, fault injection, ...)   retry
===========  ============================================  =========

:class:`GroupSupervisor` is the multi-child form of :func:`supervise`
for the serving fleet: each :class:`ChildSpec` carries its own exit
contract, backoff, restart budget and heartbeat bound; :meth:`poll` is
non-blocking, and a relaunch never touches a sibling's process.
"""

from __future__ import annotations

import json
import math
import os
import random
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

try:
    from ..utils import ckpt_manifest
except ImportError:      # file-path loaded (utils/chaos.py's stdlib children)
    import importlib.util as _ilu

    _p = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "utils", "ckpt_manifest.py")
    _spec = _ilu.spec_from_file_location("_res_ckpt_manifest", _p)
    ckpt_manifest = _ilu.module_from_spec(_spec)
    sys.modules["_res_ckpt_manifest"] = ckpt_manifest
    _spec.loader.exec_module(ckpt_manifest)

EXIT_OK = 0
EXIT_HANG = 42          # utils.watchdog.HangWatchdog
EXIT_PEER = 43          # a collective raised/timed out, or world formation
                        # failed (parallel.distributed typed errors)
EXIT_ANOMALY = 44       # ResilienceMonitor exhausted its rollback budget
EXIT_SDC = 45           # deterministic replica divergence / SDC strikes
EXIT_CAPACITY = 46      # healthy capacity stayed below --min_devices
EXIT_DECOMMISSION = 47  # preemption notice answered: final snapshot, retire

# exit codes the supervisor must NOT retry: 0 is success; 44 and 45 are
# deterministic training failures a relaunch would only replay; 46 means
# the hardware floor cannot be met (a relaunch cannot create cards); 47
# is a node going away on purpose
_NO_RETRY = (EXIT_OK, EXIT_ANOMALY, EXIT_SDC, EXIT_CAPACITY,
             EXIT_DECOMMISSION)

# exit codes that count toward the elastic peer-loss streak: explicit peer
# loss, and hangs (a dead peer often shows as a stalled collective)
_PEER_LOSS_CODES = (EXIT_PEER, EXIT_HANG)


class AnomalyAbort(RuntimeError):
    """Training diverged past the rollback budget; maps to exit 44."""


class CapacityAbort(RuntimeError):
    """The healthy world is smaller than ``--min_devices``; maps to exit
    46, which the supervisor does not retry (a relaunch cannot create
    cards)."""


class SDCAbort(RuntimeError):
    """Silent data corruption the run must not survive: the replay
    reproduced the divergence (a software bug a relaunch would replay), or
    one device blew its transient-strike budget (hardware to drain).  Maps
    to exit 45, which the supervisor does not retry."""


class SDCPolicy:
    """Per-device strike ledger for TRANSIENT (replay-clean, healed)
    divergences.  ``record(devices)`` charges one strike to each named
    device and returns the devices now over budget (empty: keep going)."""

    def __init__(self, strikes: int = 3):
        if strikes < 1:
            raise ValueError(f"sdc strike budget must be >= 1, got "
                             f"{strikes}")
        self.strikes = strikes
        self.counts: dict = {}
        self.incidents = 0   # fingerprint mismatches observed
        self.healed = 0      # transient incidents healed in-process

    def record(self, devices: Sequence[str]) -> List[str]:
        self.incidents += 1
        for d in devices:
            self.counts[d] = self.counts.get(d, 0) + 1
        return [d for d in devices if self.counts[d] >= self.strikes]


# torch's distributed errors, and the port's world-formation errors
# (parallel.distributed), by class name: this module imports no torch
_PEER_ERROR_TYPES = ("DistBackendError", "DistNetworkError",
                     "DistStoreError", "WorldFormationError",
                     "CoordinatorUnreachable", "PeerMissing")
# multi-word phrases only: a bare "peer" or "connection" would misread
# ordinary crashes as peer loss.  gloo reports a lost peer as "Connection
# closed by peer" / "Connection reset by peer" or a timed-out recv;
# NCCL's watchdog as a collective operation timeout
_PEER_ERROR_MARKERS = ("gloo", "nccl", "all-reduce", "allreduce",
                       "broken pipe", "connection reset",
                       "connection refused", "connection closed",
                       "closed by peer", "lost peer", "connect failed",
                       "failed to connect", "recv failure", "recv error",
                       "socket closed", "socket timeout",
                       "timed out waiting", "operation timeout",
                       "barrier timed out", "peer down")
# statuses that are never transport, checked first: an OOM or a bad
# argument names a local failure even when raised by a collective
_NON_PEER_MARKERS = ("out of memory", "out-of-memory", "invalid argument",
                     "invalid_argument", "illegal memory access")


def is_peer_error(exc: BaseException) -> bool:
    """Does this exception look like a lost or unreachable peer rather
    than a software crash?  The CLI maps such an escaped collective or
    world-formation failure to exit 43.  Both classes are retried; the
    marker lists lean to reading an ambiguous transport failure as peer
    loss, and never a local OOM."""
    msg = str(exc).lower()
    if any(m in msg for m in _NON_PEER_MARKERS):
        return False
    if any(k.__name__ in _PEER_ERROR_TYPES for k in type(exc).__mro__):
        return True
    return any(m in msg for m in _PEER_ERROR_MARKERS)


class ResilienceMonitor:
    """Host-side anomaly policy over the step-loss stream.

    A step is *bad* when its loss is non-finite, or, with ``spike_factor
    > 0``, above ``spike_factor`` times the exponential moving average of
    recent good losses (armed after ``warmup`` good steps).  ``observe``
    returns ``"ok"``, ``"bad"`` (under the consecutive threshold),
    ``"rollback"`` or ``"abort"`` (the budget is spent).  A rollback
    resets the EMA."""

    def __init__(self, rollback_after: int, max_rollbacks: int = 2,
                 spike_factor: float = 0.0, ema_beta: float = 0.9,
                 warmup: int = 5):
        if rollback_after < 1:
            raise ValueError(f"rollback_after must be >= 1, got "
                             f"{rollback_after}")
        self.rollback_after = rollback_after
        self.max_rollbacks = max_rollbacks
        self.spike_factor = spike_factor
        self.ema_beta = ema_beta
        self.warmup = warmup
        self.consecutive = 0   # bad steps since the last good one
        self.rollbacks = 0     # rollbacks performed so far
        self.bad_steps = 0     # total bad steps observed
        self._ema: Optional[float] = None
        self._n_good = 0

    def observe(self, loss: float) -> str:
        bad = not math.isfinite(loss)
        if (not bad and self.spike_factor > 0 and self._ema is not None
                and self._n_good >= self.warmup):
            bad = loss > self.spike_factor * max(self._ema, 1e-12)
        if not bad:
            self.consecutive = 0
            self._ema = (loss if self._ema is None
                         else self.ema_beta * self._ema
                         + (1.0 - self.ema_beta) * loss)
            self._n_good += 1
            return "ok"
        self.bad_steps += 1
        self.consecutive += 1
        if self.consecutive < self.rollback_after:
            return "bad"
        self.consecutive = 0
        if self.rollbacks >= self.max_rollbacks:
            return "abort"
        self.rollbacks += 1
        self._ema = None
        self._n_good = 0
        return "rollback"


# the advance-notice preemption channel: SIGUSR1 plus an optional JSON
# notice file ({"t_unix", "grace_s"}) whose path rides the environment
PREEMPT_SIGNAL = signal.SIGUSR1
PREEMPT_NOTICE_ENV = "NNPT_PREEMPT_NOTICE"
# fallback grace window (seconds) when the signal arrives with no file
PREEMPT_GRACE_ENV = "NNPT_PREEMPT_GRACE_S"


def preempt_notice_path(env: Optional[dict] = None) -> Optional[str]:
    """The notice file's path in ``env`` (default: this process's)."""
    return (env if env is not None else os.environ).get(PREEMPT_NOTICE_ENV)


def write_preempt_notice(path: Optional[str] = None, *,
                         grace_s: float = 2.0) -> Optional[str]:
    """Write the notice file (the sender's half); ``path`` defaults to
    :data:`PREEMPT_NOTICE_ENV`.  Best-effort: None when no path is set."""
    path = path or preempt_notice_path()
    if not path:
        return None
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"t_unix": round(time.time(), 3),
                                "grace_s": float(grace_s)}) + "\n")
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def read_preempt_notice(path: Optional[str] = None) -> Optional[dict]:
    """The receiver's half: the notice file, or None."""
    path = path or preempt_notice_path()
    if not path:
        return None
    try:
        with open(path) as f:
            rec = json.loads(f.read())
        return rec if isinstance(rec, dict) else None
    except (OSError, ValueError):
        return None


class GracefulShutdown:
    """SIGTERM/SIGINT -> a flag the step loop polls at dispatch boundaries.

    ``with GracefulShutdown() as stop:`` installs handlers (the previous
    ones come back on exit); ``stop.requested`` turns True on the first
    signal.  A second termination signal re-raises under the previous
    handler, so a double Ctrl-C still kills a wedged run.  SIGUSR1 is the
    advance notice: it sets ``requested`` and ``noticed`` and reads the
    grace window from the notice file or :data:`PREEMPT_GRACE_ENV`
    (default 2 s); repeats never escalate.  Off the main thread the
    context installs nothing."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,
                                                 signal.SIGINT),
                 notice_signals: Sequence[int] = (PREEMPT_SIGNAL,)):
        self._signals = tuple(signals) + tuple(
            s for s in notice_signals if s not in signals)
        self._notice = frozenset(notice_signals)
        self._previous: dict = {}
        self.requested = False
        self.noticed = False
        self.grace_s: Optional[float] = None
        self.signum: Optional[int] = None
        # monotonic time of the first signal (the exit latency's start)
        self.t_signal: Optional[float] = None
        self._escalated = False

    def _handler(self, signum, frame):
        if self.t_signal is None:
            self.t_signal = time.monotonic()
        if signum in self._notice:
            first = not self.noticed
            self.noticed = self.requested = True
            if self.signum is None:
                self.signum = signum
            if first:
                rec = read_preempt_notice() or {}
                try:
                    self.grace_s = float(
                        rec.get("grace_s")
                        or os.environ.get(PREEMPT_GRACE_ENV) or 2.0)
                except (TypeError, ValueError):
                    self.grace_s = 2.0
                print(f"[resilience] preemption notice (signal {signum}, "
                      f"grace {self.grace_s:.1f}s): finishing the current "
                      "dispatch, writing a final checkpoint, exiting "
                      f"{EXIT_DECOMMISSION} (decommission)",
                      file=sys.stderr, flush=True)
            return
        if self._escalated:
            prev = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            signal.raise_signal(signum)
            return
        self._escalated = self.requested = True
        self.signum = signum
        print(f"[resilience] caught signal {signum}: finishing the current "
              "dispatch, writing a final checkpoint, exiting 0",
              file=sys.stderr, flush=True)

    def __enter__(self) -> "GracefulShutdown":
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread: no handlers
                self._previous.pop(s, None)
                break
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._previous.clear()


# run identity of a supervised job (train.trace reads them): one run id
# across relaunches, the attempt number as the incarnation
RUN_ID_ENV = "NNPT_RUN_ID"
INCARNATION_ENV = "NNPT_INCARNATION"
_PROCESS_ID_ENV = "NNPT_PROCESS_ID"


def _append_event(path: Optional[str], rec: dict) -> None:
    """Append one supervisor lifecycle record (launch / exit / relaunch)
    to the ``events_path`` JSONL: ``utils/goodput.py`` prices the gap
    between an exit and the next incarnation's first span as
    ``relaunch_gap`` from these.  Best-effort: accounting must never take
    down the supervisor."""
    if not path:
        return
    try:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
    except OSError:
        pass


def heartbeat_filename(role: str, process_id: Optional[int] = None
                       ) -> str:
    """Per-role/per-process heartbeat file name,
    ``heartbeat-<role>-p<P>.json``; ``process_id`` defaults to
    ``NNPT_PROCESS_ID``, else 0.  Stdlib-only, so the supervisor derives
    its child's watch target without importing the telemetry module."""
    if process_id is None:
        try:
            process_id = int(os.environ.get(_PROCESS_ID_ENV) or 0)
        except ValueError:
            process_id = 0
    return f"heartbeat-{role}-p{int(process_id)}.json"


def find_heartbeats(dirpath: str) -> List[str]:
    """Every heartbeat file in a telemetry dir (the legacy shared
    ``heartbeat.json`` and the per-role/process files)."""
    import glob

    return sorted(glob.glob(os.path.join(dirpath, "heartbeat*.json")))


def heartbeat_age_s(path: str, now: Optional[float] = None
                    ) -> Optional[float]:
    """Seconds since the heartbeat was last refreshed (mtime: the atomic
    replace bumps it on every write), or None if absent.  ``path`` may be
    an exact heartbeat file, a telemetry DIRECTORY (the freshest
    heartbeat within), or the legacy generic ``<dir>/heartbeat.json``,
    which alone falls back to the freshest sibling: a missing
    ROLE-QUALIFIED file does not, so the hang monitor never answers with
    a co-resident process's fresher heartbeat."""
    candidates = [path]
    if os.path.isdir(path):
        candidates = find_heartbeats(path)
    elif (not os.path.exists(path)
          and os.path.basename(path) == "heartbeat.json"):
        candidates = find_heartbeats(os.path.dirname(path) or ".")
    best: Optional[float] = None
    for p in candidates:
        try:
            mtime = os.stat(p).st_mtime
        except OSError:
            continue
        best = mtime if best is None else max(best, mtime)
    if best is None:
        return None
    return max(0.0, (time.time() if now is None else now) - best)


def alerts_between(path: Optional[str], start_pos: int):
    """(``kind="alert"`` records appended to a metrics JSONL past byte
    ``start_pos``, the new end position): the supervisor remembers the
    size before each launch, so the scan covers one child's lifetime.  A
    file that SHRANK rescans from 0; a torn tail line is skipped."""
    if not path:
        return [], start_pos
    try:
        size = os.path.getsize(path)
    except OSError:
        return [], start_pos
    if size < start_pos:
        start_pos = 0
    if size == start_pos:
        return [], size
    out: List[dict] = []
    try:
        with open(path) as f:
            f.seek(start_pos)
            for line in f:
                line = line.strip()
                if not line or '"alert"' not in line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("kind") == "alert":
                    out.append(rec)
    except OSError:
        return [], start_pos
    return out, size


def strip_supervisor_flags(argv: Sequence[str]) -> List[str]:
    """``argv`` without the supervisor-only flags (``--supervise [N]``,
    ``--supervise_backoff [S]``, ``--supervise_backoff_max [S]``, in the
    ``--flag value`` and ``--flag=value`` forms).  The elastic flags
    (``--elastic``, ``--min_devices``) stay: the child enforces the
    capacity floor itself (exit 46)."""
    flags = ("--supervise", "--supervise_backoff", "--supervise_backoff_max")
    out: List[str] = []
    skip = False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok in flags:
            skip = True
            continue
        if any(tok.startswith(f + "=") for f in flags):
            continue
        out.append(tok)
    return out


def _restore_target(ckpt_dir: str):
    """(step, n_bad, path): the newest snapshot that passes full manifest
    verification, and how many NEWER generations fail it (the ones the
    child's restore will quarantine).  Stops hashing at the first
    verified generation, as restore does."""
    bad = 0
    for step, path in reversed(ckpt_manifest.snapshot_steps(Path(ckpt_dir))):
        if ckpt_manifest.verify(path):
            bad += 1
        else:
            return step, bad, path
    return None, bad, None


# the launcher environment a degraded relaunch rewrites (the port's world
# channel, parallel.distributed): the rendezvous, then the rank keys
_COORD_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "NNPT_PREFLIGHT_PORT")
_RANK_ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
DEGRADED_ENV = "NNPT_ELASTIC_DEGRADED"  # marks a shrunken-world child


def degrade_env(env: dict, probe: dict, model_ranks: int = 1) -> dict:
    """Rewrite a child environment to the probed (shrunken) world: the
    rendezvous and the rank keys are dropped, so the child forms a world
    of one process (``parallel.distributed.world_setup`` without a
    launcher), and :data:`DEGRADED_ENV` records the probed device count.
    Returns the same dict, mutated.

    Only the collapse to one process is supported, as in the JAX package:
    a local probe cannot say which ranks survive, so a degraded world of
    several processes raises instead of relaunching a child with a stale
    ``RANK``.

    ``model_ranks``: the ranks one model replica spans (``--sp`` x
    ``--tp`` x ``--fsdp``).  The JAX package's degraded child keeps its
    mesh flags over the host's devices, and its mesh does not form when
    they do not hold them; the port's child of one process holds one
    card, so a layout over more than one rank raises here instead of
    relaunching a child that cannot form its groups (the snapshots are
    dense: a relaunch at ``--tp 1 --fsdp 1`` resumes them)."""
    n_proc = int(probe.get("n_processes", 1))
    if n_proc > 1:
        raise ValueError(
            "degraded multi-process worlds are unsupported (probe "
            f"reported n_processes={n_proc}): surviving peer ranks "
            "cannot be reassigned from a local probe")
    if model_ranks > 1:
        raise ValueError(
            f"a degraded world of one process holds one card, not the "
            f"{model_ranks} ranks of one replica's seq x tensor x fsdp "
            "groups (snapshots are dense: relaunch with --sp 1 --tp 1 "
            "--fsdp 1 to resume at one card)")
    for k in _COORD_ENV_KEYS + _RANK_ENV_KEYS:
        env.pop(k, None)
    env[_PROCESS_ID_ENV] = "0"
    env[DEGRADED_ENV] = str(int(probe.get("n_devices", 0)))
    return env


_PROBE_LOCAL_SRC = (
    "import json, torch; "
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 1; "
    "print('PROBE_WORLD|' + json.dumps({'n_processes': 1, "
    "'n_devices': n, 'local_devices': n}))"
)


def default_probe(timeout_s: float = 60.0,
                  env: Optional[dict] = None) -> Optional[dict]:
    """LOCAL capacity probe for the generic supervisor: a subprocess
    reports this host's cards under a hard timeout, with the rendezvous
    keys stripped so it can never block on a dead world (the world-aware
    probe is ``parallel.distributed.probe_world``, which the CLI wires).
    ``degraded`` is True whenever the environment had configured a bigger
    world.  Returns the probe dict or None."""
    env = dict(os.environ if env is None else env)
    had_world = (any(k in env for k in _COORD_ENV_KEYS)
                 or int(env.get("WORLD_SIZE") or 1) > 1)
    for k in _COORD_ENV_KEYS + _RANK_ENV_KEYS:
        env.pop(k, None)
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE_LOCAL_SRC],
                             capture_output=True, text=True, env=env,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None
    for line in out.stdout.splitlines():
        if line.startswith("PROBE_WORLD|"):
            res = json.loads(line.split("|", 1)[1])
            res["degraded"] = had_world
            return res
    return None


def supervise(cmd: Sequence[str], max_restarts: int,
              backoff: float = 1.0, backoff_cap: float = 60.0,
              env: Optional[dict] = None,
              log: Callable[[str], None] = None,
              heartbeat_path: Optional[str] = None,
              heartbeat_timeout: float = 0.0,
              postmortem_path: Optional[str] = None,
              ckpt_dir: Optional[str] = None,
              alerts_path: Optional[str] = None,
              jitter: float = 0.5,
              elastic: bool = False,
              min_devices: int = 0,
              probe: Optional[Callable[[], Optional[dict]]] = None,
              elastic_after: int = 2,
              events_path: Optional[str] = None,
              forward_preempt: bool = False,
              model_ranks: int = 1,
              _sleep: Callable[[float], None] = time.sleep,
              _rand: Callable[[], float] = random.random) -> int:
    """Run ``cmd`` under the crash-restart policy; return the final exit
    code.

    ``max_restarts`` bounds RELAUNCHES (the first launch is free).  Exits
    0, 44, 45, 46 and 47 stop at once; anything else (42, 43, a crash, a
    signal death) is retried after ``backoff * 2^k`` seconds, capped at
    ``backoff_cap`` and scaled by a uniform jitter in ``[1 - jitter, 1]``
    (downward only, so the cap stays a hard bound).  The relaunched
    command is the same; resuming is the child's job (the CLI appends
    ``--resume`` when a checkpoint dir is set).  Every child gets
    ``NNPT_RUN_ID`` (the caller's, or one generated here for the whole
    job) and ``NNPT_INCARNATION`` (the attempt number, from 0), so the
    trace files of every incarnation merge into one timeline.

    ``elastic`` (the JAX package's policy): after ``elastic_after``
    CONSECUTIVE peer-loss exits (43 or 42: a world that keeps failing to
    form) run ``probe`` (default :func:`default_probe`; the CLI passes
    ``parallel.distributed.probe_world``, degraded to this host when the
    world does not form) and relaunch at the world that answered: a
    degraded probe rewrites the child's environment (:func:`degrade_env`), so the child forms one
    process and rides its elastic restore.  Only a positively identified
    original rank 0 may continue alone (any other rank is fenced and
    retries its world: two partition survivors must not both lead over
    one checkpoint dir).  A probe that fails retries the same world; one
    below ``min_devices`` parks and re-polls with the same backoff,
    consuming the restart budget, and exhausting it returns
    :data:`EXIT_CAPACITY`.  A probe that finds the full world again after
    a degraded relaunch restores the original environment (grow-back).

    ``heartbeat_path`` + ``heartbeat_timeout``: a child whose heartbeat
    goes stale for longer is killed and counted as :data:`EXIT_HANG`
    (see :func:`_run_child`).  ``postmortem_path``: after an abnormal
    exit, the log points at the postmortem the child's flight recorder
    wrote during its lifetime.  ``alerts_path`` (the child's
    metrics.jsonl): the ``kind="alert"`` records it emitted are
    summarized next to each exit (observe-only: the exit code decides).
    ``ckpt_dir``: each relaunch logs the verified snapshot the child will
    resume from, with its saving world.  ``events_path``: launch / exit /
    relaunch records as JSONL.  ``forward_preempt``: SIGUSR1 delivered to
    the supervisor is re-sent to the running child, which answers the
    notice.  ``model_ranks``: the ranks one replica spans, which a
    degraded world must hold (:func:`degrade_env`)."""
    if log is None:
        log = lambda m: print(m, file=sys.stderr, flush=True)

    def next_delay(restarts_used: int) -> float:
        d = min(backoff * (2.0 ** restarts_used), backoff_cap)
        if jitter > 0:
            d *= 1.0 - jitter * _rand()
        return d

    base_env = env if env is not None else os.environ
    child_env = dict(base_env)
    run_id = child_env.get(RUN_ID_ENV) or (
        f"run-{int(time.time())}-{os.getpid()}")
    # the original world, for grow-back after a degraded relaunch
    world_keys = _COORD_ENV_KEYS + _RANK_ENV_KEYS + (_PROCESS_ID_ENV,)
    orig_world = {k: base_env.get(k) for k in world_keys}
    attempt = 0
    peer_streak = 0
    while True:
        attempt += 1
        child_env[RUN_ID_ENV] = run_id
        child_env[INCARNATION_ENV] = str(attempt - 1)
        log(f"[supervise] attempt {attempt}: {' '.join(cmd)}")
        launched = time.time()
        _append_event(events_path, {
            "kind": "supervisor", "event": "launch",
            "t": round(launched, 6), "run": run_id, "inc": attempt - 1})
        alert_pos = 0
        if alerts_path:
            try:
                alert_pos = os.path.getsize(alerts_path)
            except OSError:
                alert_pos = 0
        rc = _run_child(cmd, child_env, heartbeat_path, heartbeat_timeout,
                        log, (PREEMPT_SIGNAL,) if forward_preempt else ())
        _append_event(events_path, {
            "kind": "supervisor", "event": "exit",
            "t": round(time.time(), 6), "run": run_id,
            "inc": attempt - 1, "rc": rc})
        if alerts_path:
            alerts, _ = alerts_between(alerts_path, alert_pos)
            if alerts:
                by_name: dict = {}
                for a in alerts:
                    key = str(a.get("alert"))
                    by_name[key] = by_name.get(key, 0) + 1
                rendered = ", ".join(f"{k} x{v}"
                                     for k, v in sorted(by_name.items()))
                log(f"[supervise] {len(alerts)} telemetry alert(s) "
                    f"during this child: {rendered} (observe-only; the "
                    "exit code decides the relaunch)")
        # any ABNORMAL exit, the no-retry anomaly abort (44) included,
        # gets the pointer
        if rc != EXIT_OK and postmortem_path:
            try:
                if os.stat(postmortem_path).st_mtime >= launched - 1.0:
                    log(f"[supervise] child left a postmortem: "
                        f"{postmortem_path}")
            except OSError:
                pass
        if rc in _NO_RETRY:
            if rc == EXIT_ANOMALY:
                log("[supervise] child exited 44 (anomaly abort): "
                    "deterministic training failure — not retrying")
            elif rc == EXIT_SDC:
                log("[supervise] child exited 45 (SDC abort): "
                    "deterministic replica divergence or device strike "
                    "budget exhausted — not retrying")
            elif rc == EXIT_CAPACITY:
                log("[supervise] child exited 46 (capacity abort): the "
                    "healthy world is below --min_devices — not retrying "
                    "(a relaunch cannot create devices)")
            elif rc == EXIT_DECOMMISSION:
                log("[supervise] child exited 47 (decommission): retired "
                    "on a preemption notice — not retrying")
            else:
                log("[supervise] child completed (exit 0)")
            return rc
        peer_streak = peer_streak + 1 if rc in _PEER_LOSS_CODES else 0
        restarts_used = attempt - 1
        if restarts_used >= max_restarts:
            log(f"[supervise] giving up: {max_restarts} restarts exhausted "
                f"(last exit {rc})")
            return rc
        delay = next_delay(restarts_used)
        reason = {EXIT_HANG: "watchdog hang",
                  EXIT_PEER: "peer loss"}.get(rc, "crash")
        log(f"[supervise] child exit {rc} ({reason}); relaunching in "
            f"{delay:.1f}s ({restarts_used + 1}/{max_restarts})")
        _append_event(events_path, {
            "kind": "supervisor", "event": "relaunch",
            "t": round(time.time(), 6), "run": run_id,
            "inc": attempt, "delay_s": round(delay, 3), "reason": reason})
        if ckpt_dir:
            step, bad, path = _restore_target(ckpt_dir)
            if step is not None:
                world = ckpt_manifest.world_line(
                    ckpt_manifest.snapshot_meta(path))
                log(f"[supervise] relaunch resumes from verified snapshot "
                    f"step {step}"
                    + (f" [{world}]" if world else "")
                    + (f" ({bad} unverified generation(s) will be "
                       "quarantined on restore)" if bad else ""))
            else:
                log(f"[supervise] no verified snapshot in {ckpt_dir}: "
                    "relaunch restarts from scratch")
        _sleep(delay)
        # ---- elastic probe-and-shrink, after REPEATED peer loss ---------
        if not (elastic and peer_streak >= elastic_after):
            continue
        orig_multi = (any(orig_world.get(k) for k in _COORD_ENV_KEYS)
                      or int(orig_world.get("WORLD_SIZE") or 1) > 1)
        rank_raw = orig_world.get("RANK")
        if orig_multi and (rank_raw is None or int(rank_raw) != 0):
            log("[supervise] elastic: original rank "
                f"{'unknown (no RANK)' if rank_raw is None else rank_raw}"
                " is fenced from degraded relaunch (only a positively-"
                "identified rank 0 may continue as a shrunken world — "
                "two partition survivors must not both become single-"
                "process leaders over the same checkpoint dir); "
                "retrying at the current world")
            continue
        prober = probe if probe is not None else default_probe
        floor = max(1, int(min_devices))
        parked = False
        while True:
            res = prober()
            if res is None and not parked:
                log("[supervise] elastic probe failed (no topology "
                    "answer); retrying at the current world")
                break
            n = int(res.get("n_devices", 0)) if res is not None else -1
            if res is not None and n >= floor:
                if res.get("degraded"):
                    try:
                        child_env = degrade_env(dict(child_env), res,
                                                model_ranks)
                    except ValueError as e:
                        log(f"[supervise] {e}; retrying at the current "
                            "world")
                        break
                    log(f"[supervise] topology probe: {n} healthy "
                        f"device(s) across "
                        f"{res.get('n_processes', '?')} process(es) — "
                        "relaunching at the DEGRADED world")
                else:
                    log(f"[supervise] topology probe: {n} healthy "
                        f"device(s) across "
                        f"{res.get('n_processes', '?')} process(es)")
                    if DEGRADED_ENV in child_env:
                        for k, v in orig_world.items():
                            if v is None:
                                child_env.pop(k, None)
                            else:
                                child_env[k] = v
                        child_env.pop(DEGRADED_ENV, None)
                        log("[supervise] probe reports the full world "
                            "healthy: restoring the original topology "
                            "for the relaunch (grow-back)")
                peer_streak = 0
                break
            # below the floor (or, once parked, a probe that failed):
            # park and re-poll, consuming the restart budget
            parked = True
            shown = (f"{n} healthy device(s)" if res is not None
                     else "no topology answer (probe failed)")
            attempt += 1
            restarts_used = attempt - 1
            if restarts_used >= max_restarts:
                log(f"[supervise] capacity shortfall: probe found "
                    f"{shown} < --min_devices {floor} and the "
                    f"restart budget is exhausted — exiting "
                    f"{EXIT_CAPACITY} (capacity abort)")
                return EXIT_CAPACITY
            delay = next_delay(restarts_used)
            log(f"[supervise] capacity shortfall: {shown} "
                f"< --min_devices {floor}; re-probing in {delay:.1f}s "
                f"({restarts_used + 1}/{max_restarts})")
            _sleep(delay)


def _run_child(cmd: Sequence[str], env: Optional[dict],
               heartbeat_path: Optional[str], heartbeat_timeout: float,
               log: Callable[[str], None],
               forward_signals: Sequence[int] = ()) -> int:
    """One child launch, re-sending ``forward_signals`` delivered to this
    process to the child while it runs.  With a heartbeat to watch, a
    child whose heartbeat goes stale for ``heartbeat_timeout`` seconds is
    killed and reported as :data:`EXIT_HANG` — the EXTERNAL complement
    to the in-process ``utils.watchdog.HangWatchdog``, for a process
    frozen whole (its watchdog thread included).

    The watch ARMS at the child's first heartbeat write (mtime newer than
    the launch), as the in-process watchdog arms at its first pat: the
    first step's kernel builds, warm-up and CUDA-graph capture can take
    long and must not be killed as a hang, and a heartbeat left by an
    earlier run does not count.  The symmetric cost: a child frozen
    before its first dispatch is not caught here."""
    hb = bool(heartbeat_path and heartbeat_timeout > 0)
    if not hb and not forward_signals:
        return subprocess.call(list(cmd), env=env)
    child = subprocess.Popen(list(cmd), env=env)
    restore: dict = {}

    def _forward(signum, frame):
        log(f"[supervise] forwarding signal {signum} to child {child.pid}")
        try:
            child.send_signal(signum)
        except OSError:
            pass

    for s in forward_signals:
        try:
            restore[s] = signal.signal(s, _forward)
        except ValueError:   # not the main thread: no forwarding
            break
    try:
        if not hb:
            return child.wait()
        started = time.time()
        poll_s = max(0.05, min(heartbeat_timeout / 4.0, 5.0))
        armed = False
        while True:
            rc = child.poll()
            if rc is not None:
                return rc
            age = heartbeat_age_s(heartbeat_path)
            if not armed:
                # armed once THIS child wrote it (mtime after launch)
                if age is not None and age < time.time() - started:
                    armed = True
                else:
                    time.sleep(poll_s)
                    continue
            idle = age if age is not None else time.time() - started
            if idle > heartbeat_timeout:
                log(f"[supervise] heartbeat stale for {idle:.0f}s "
                    f"(> {heartbeat_timeout:.0f}s): killing child "
                    f"{child.pid} as hung")
                child.terminate()
                try:
                    child.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    child.kill()
                    child.wait()
                # EXIT_HANG even when the child absorbed the SIGTERM and
                # exited 0 after a final snapshot: a stalled child must be
                # retried, not reported complete
                return EXIT_HANG
            time.sleep(poll_s)
    finally:
        for s, prev in restore.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass


# ---------------------------------------------------------------------------
# process-group supervision (the serving fleet's replicas)
# ---------------------------------------------------------------------------

@dataclass
class ChildSpec:
    """One child of a :class:`GroupSupervisor`: its command, role and its
    own contracts (heartbeat bound, restart budget and backoff, the exit
    codes that stop it).  ``spawn`` replaces process creation (the fleet
    passes one that wires stdio pipes); ``on_spawn`` fires after every
    (re)launch so the owner can re-attach to the new process."""
    name: str
    cmd: Sequence[str] = ()
    role: str = "worker"
    env: Optional[dict] = None
    heartbeat_path: Optional[str] = None
    heartbeat_timeout: float = 0.0
    max_restarts: int = 3
    backoff: float = 0.5
    backoff_cap: float = 30.0
    no_retry: Tuple[int, ...] = _NO_RETRY
    spawn: Optional[Callable] = None      # (spec, env) -> Popen-like
    on_spawn: Optional[Callable] = None   # (spec, proc, incarnation)


@dataclass
class _ChildState:
    spec: ChildSpec
    proc: Any = None
    incarnation: int = -1          # attempts - 1 (stamped into the env)
    restarts_used: int = 0
    launched_at: float = 0.0
    hb_armed: bool = False
    relaunch_at: Optional[float] = None   # pending backoff deadline
    final_rc: Optional[int] = None        # set once the child is done
    gave_up: bool = False
    retired: bool = False          # the next exit is terminal, any rc
    last_rc: Optional[int] = None  # newest reaped rc (retire() uses it)
    events: List[dict] = field(default_factory=list)


class GroupSupervisor:
    """Supervision of a process group: :func:`supervise` for N children,
    each under its own :class:`ChildSpec`, so one failing child is
    relaunched with its own backoff and budget while its siblings run on.

    :meth:`poll` does not block: it reaps exits, kills children whose
    heartbeat went stale (reported as :data:`EXIT_HANG`), runs due
    relaunches and returns the events since the last poll, so the owner
    (a router pumping traffic, a test) keeps the loop.  An exit in
    ``spec.no_retry`` stops that child (``stopped``); any other relaunches
    after ``backoff * 2^k`` (jittered down, capped) until ``max_restarts``
    is spent (``gave_up``).  Every launch stamps :data:`RUN_ID_ENV` and
    the child's :data:`INCARNATION_ENV`, as :func:`supervise` does."""

    def __init__(self, specs: Sequence[ChildSpec],
                 log: Optional[Callable[[str], None]] = None,
                 jitter: float = 0.5,
                 env: Optional[dict] = None,
                 events_path: Optional[str] = None,
                 _rand: Callable[[], float] = random.random,
                 now_fn: Callable[[], float] = time.time):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate child names: {names}")
        self._log = log or (lambda m: print(m, file=sys.stderr,
                                            flush=True))
        self._jitter = float(jitter)
        self._rand = _rand
        self._now = now_fn
        self._base_env = dict(env if env is not None else os.environ)
        self.run_id = self._base_env.get(RUN_ID_ENV) or (
            f"run-{int(time.time())}-{os.getpid()}")
        self._children = {s.name: _ChildState(spec=s) for s in specs}
        self._started = False
        # lifecycle JSONL for the goodput join (supervise()'s events_path),
        # stamped with the wall clock even under a virtual now_fn
        self._events_path = events_path

    def _emit_event(self, st: _ChildState, kind: str, **extra) -> None:
        spec = st.spec
        rec = {"kind": "supervisor", "event": kind,
               "t": round(time.time(), 6), "run": self.run_id,
               "child": spec.name, "role": spec.role,
               "inc": st.incarnation, **extra}
        pid = (spec.env or {}).get(_PROCESS_ID_ENV)
        if pid is not None:
            try:
                rec["p"] = int(pid)
            except (TypeError, ValueError):
                pass
        _append_event(self._events_path, rec)

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self._started = True
        for st in self._children.values():
            self._launch(st)

    def add_child(self, spec: ChildSpec) -> None:
        """Register a new child at run time, launched at once if
        :meth:`start` has run.  Names stay unique for the supervisor's
        lifetime."""
        if spec.name in self._children:
            raise ValueError(f"duplicate child name: {spec.name!r}")
        st = _ChildState(spec=spec)
        self._children[spec.name] = st
        if self._started:
            self._launch(st)

    def retire(self, name: str) -> None:
        """Make the child's next exit terminal whatever its rc (no
        relaunch, no budget spent): retire first, then ask the child to
        drain and exit, so a kill after a stalled drain does not relaunch
        it.  A pending relaunch is cancelled and the child finalized at its
        last reaped rc."""
        st = self._children[name]
        st.retired = True
        if st.relaunch_at is not None:
            st.relaunch_at = None
            st.final_rc = st.last_rc
            self._log(f"[group] {st.spec.role}/{name}: retired while a "
                      "relaunch was pending; relaunch cancelled")
        else:
            self._log(f"[group] {st.spec.role}/{name}: retired (next "
                      "exit is terminal)")

    def notify_preempt(self, name: str, grace_s: float = 2.0) -> bool:
        """Send a live child the advance preemption notice: the notice
        file (where the child's env names one, :data:`PREEMPT_NOTICE_ENV`)
        and :data:`PREEMPT_SIGNAL`.  The child answers by its own contract
        and exits 47, which ``no_retry`` already stops.  False when the
        child is dead or unreachable (the crash path owns what follows)."""
        st = self._children[name]
        if st.proc is None or st.proc.poll() is not None:
            return False
        env = dict(self._base_env)
        env.update(st.spec.env or {})
        path = preempt_notice_path(env)
        if path:
            write_preempt_notice(path, grace_s=grace_s)
        try:
            st.proc.send_signal(PREEMPT_SIGNAL)
        except OSError:
            return False
        self._log(f"[group] {st.spec.role}/{name}: preemption notice "
                  f"delivered (grace {float(grace_s):.1f}s)")
        self._emit_event(st, "preempt_notice",
                         grace_s=round(float(grace_s), 3))
        return True

    def remove_child(self, name: str) -> None:
        """Forget a terminal child (stopped or given up); refuses one that
        could still run."""
        st = self._children[name]
        if st.final_rc is None and not st.gave_up:
            raise ValueError(f"child {name!r} is not terminal")
        del self._children[name]

    def _launch(self, st: _ChildState) -> None:
        spec = st.spec
        env = dict(self._base_env)
        if spec.env:
            env.update(spec.env)
        st.incarnation += 1
        env[RUN_ID_ENV] = self.run_id
        env[INCARNATION_ENV] = str(st.incarnation)
        if spec.spawn is not None:
            st.proc = spec.spawn(spec, env)
        else:
            st.proc = subprocess.Popen(list(spec.cmd), env=env)
        st.launched_at = self._now()
        st.hb_armed = False
        st.relaunch_at = None
        self._log(f"[group] {spec.role}/{spec.name} inc "
                  f"{st.incarnation}: pid {st.proc.pid}")
        self._emit_event(st, "launch", pid=getattr(st.proc, "pid", None))
        if spec.on_spawn is not None:
            spec.on_spawn(spec, st.proc, st.incarnation)

    def _next_delay(self, st: _ChildState) -> float:
        d = min(st.spec.backoff * (2.0 ** st.restarts_used),
                st.spec.backoff_cap)
        if self._jitter > 0:
            d *= 1.0 - self._jitter * self._rand()
        return d

    def _check_heartbeat(self, st: _ChildState) -> bool:
        """True when the child was just killed as hung."""
        spec = st.spec
        if not (spec.heartbeat_path and spec.heartbeat_timeout > 0):
            return False
        age = heartbeat_age_s(spec.heartbeat_path)
        now = self._now()
        if not st.hb_armed:
            # armed at this incarnation's first write: start-up is never a
            # hang, and an earlier incarnation's file does not count
            if age is not None and age < now - st.launched_at:
                st.hb_armed = True
            return False
        if age is not None and age > spec.heartbeat_timeout:
            self._log(f"[group] {spec.role}/{spec.name}: heartbeat "
                      f"stale for {age:.0f}s "
                      f"(> {spec.heartbeat_timeout:.0f}s): killing as "
                      "hung")
            st.proc.terminate()
            try:
                st.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                st.proc.kill()
                st.proc.wait()
            return True
        return False

    def poll(self) -> List[dict]:
        """One non-blocking pass; the events since the last one: ``exit``
        (rc), ``hang_kill``, ``relaunch``, ``stopped`` (a no-retry exit),
        ``gave_up`` (budget spent)."""
        events: List[dict] = []

        def ev(st: _ChildState, kind: str, **extra) -> None:
            e = {"event": kind, "child": st.spec.name,
                 "role": st.spec.role, "incarnation": st.incarnation,
                 **extra}
            st.events.append(e)
            events.append(e)
            self._emit_event(st, kind, **extra)

        now = self._now()
        for st in self._children.values():
            if st.final_rc is not None or st.gave_up:
                continue
            if st.proc is not None and st.proc.poll() is None:
                if self._check_heartbeat(st):
                    ev(st, "hang_kill", rc=st.proc.poll())
                    # EXIT_HANG for the retry contract, as _run_child: a
                    # graceful exit 0 after SIGTERM still means stalled
                    self._after_exit(st, EXIT_HANG, ev)
                continue
            if st.proc is not None and st.relaunch_at is None:
                rc = st.proc.poll()
                ev(st, "exit", rc=rc)
                self._after_exit(st, rc, ev)
                continue
            if st.relaunch_at is not None and now >= st.relaunch_at:
                st.restarts_used += 1
                self._launch(st)
                ev(st, "relaunch", restarts_used=st.restarts_used,
                   max_restarts=st.spec.max_restarts)
        return events

    def _after_exit(self, st: _ChildState, rc: int, ev) -> None:
        spec = st.spec
        st.last_rc = rc
        if st.retired or rc in spec.no_retry:
            st.final_rc = rc
            ev(st, "stopped", rc=rc)
            why = ("retired" if st.retired and rc not in spec.no_retry
                   else "no-retry contract")
            self._log(f"[group] {spec.role}/{spec.name} exited {rc} "
                      f"({why}): stopped")
            return
        if st.restarts_used >= spec.max_restarts:
            st.gave_up = True
            st.final_rc = rc
            ev(st, "gave_up", rc=rc, max_restarts=spec.max_restarts)
            self._log(f"[group] {spec.role}/{spec.name}: "
                      f"{spec.max_restarts} restarts exhausted "
                      f"(last exit {rc}); giving up on this child")
            return
        delay = self._next_delay(st)
        st.relaunch_at = self._now() + delay
        self._log(f"[group] {spec.role}/{spec.name} exit {rc}; "
                  f"relaunching in {delay:.1f}s "
                  f"({st.restarts_used + 1}/{spec.max_restarts}); "
                  "siblings undisturbed")

    # ---- introspection -------------------------------------------------
    def proc(self, name: str):
        return self._children[name].proc

    def incarnation(self, name: str) -> int:
        return self._children[name].incarnation

    def alive(self, name: str) -> bool:
        st = self._children[name]
        return (st.proc is not None and st.relaunch_at is None
                and st.final_rc is None and not st.gave_up
                and st.proc.poll() is None)

    def pending_relaunch(self, name: str) -> bool:
        return self._children[name].relaunch_at is not None

    def done(self, name: str) -> Optional[int]:
        """The final rc once the child will never run again, else None."""
        st = self._children[name]
        return st.final_rc if (st.final_rc is not None or st.gave_up) \
            else None

    def running(self) -> bool:
        """Any child not yet stopped or given up (an exit not yet reaped
        by :meth:`poll` still counts: its retry decision is pending)."""
        return any(st.final_rc is None and not st.gave_up
                   for st in self._children.values())

    def terminate_all(self, grace_s: float = 10.0) -> None:
        for st in self._children.values():
            st.relaunch_at = None
            if st.proc is not None and st.proc.poll() is None:
                st.proc.terminate()
        deadline = time.time() + grace_s
        for st in self._children.values():
            if st.proc is None:
                continue
            try:
                st.proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                st.proc.kill()
                try:
                    st.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
