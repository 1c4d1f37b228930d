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

Exit-code contract:

===========  ============================================  =========
code         meaning                                       supervisor
===========  ============================================  =========
0            run completed (or exited cleanly on SIGTERM)  stop
42           watchdog: no step progress (hang)             retry
43           peer loss: a collective raised/timed out or   retry
             world formation failed
44           anomaly abort: rollback budget exhausted      stop
47           decommission: a preemption notice was         stop
             answered with a final snapshot
other        crash (segfault, OOM, fault injection, ...)   retry
===========  ============================================  =========

Not ported yet: the SDC policy (45, Queue A item 3), the elastic
capacity abort and probe-and-shrink relaunch (46, item 3) and the
process-group supervisor of the serving fleet (item 6).
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
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from ..utils import ckpt_manifest

EXIT_OK = 0
EXIT_HANG = 42          # utils.watchdog.HangWatchdog
EXIT_PEER = 43          # a collective raised/timed out, or world formation
                        # failed (parallel.distributed typed errors)
EXIT_ANOMALY = 44       # ResilienceMonitor exhausted its rollback budget
EXIT_DECOMMISSION = 47  # preemption notice answered: final snapshot, retire

# exit codes the supervisor must NOT retry: 0 is success; 44 is a
# deterministic training failure a relaunch would only replay; 47 is a
# node going away on purpose
_NO_RETRY = (EXIT_OK, EXIT_ANOMALY, EXIT_DECOMMISSION)


class AnomalyAbort(RuntimeError):
    """Training diverged past the rollback budget; maps to exit 44."""


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


def write_preempt_notice(path: Optional[str] = None, *,
                         grace_s: float = 2.0) -> Optional[str]:
    """Write the notice file (the sender's half); ``path`` defaults to
    :data:`PREEMPT_NOTICE_ENV`.  Best-effort: None when no path is set."""
    path = path or os.environ.get(PREEMPT_NOTICE_ENV)
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
    path = path or os.environ.get(PREEMPT_NOTICE_ENV)
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


def strip_supervisor_flags(argv: Sequence[str]) -> List[str]:
    """``argv`` without the supervisor-only flags (``--supervise [N]``,
    ``--supervise_backoff [S]``, ``--supervise_backoff_max [S]``, in the
    ``--flag value`` and ``--flag=value`` forms)."""
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


def supervise(cmd: Sequence[str], max_restarts: int,
              backoff: float = 1.0, backoff_cap: float = 60.0,
              env: Optional[dict] = None,
              log: Callable[[str], None] = None,
              ckpt_dir: Optional[str] = None,
              jitter: float = 0.5,
              forward_preempt: bool = False,
              _sleep: Callable[[float], None] = time.sleep,
              _rand: Callable[[], float] = random.random) -> int:
    """Run ``cmd`` under the crash-restart policy; return the final exit
    code.

    ``max_restarts`` bounds RELAUNCHES (the first launch is free).  Exits
    0, 44 and 47 stop at once; anything else (42, 43, a crash, a signal
    death) is retried after ``backoff * 2^k`` seconds, capped at
    ``backoff_cap`` and scaled by a uniform jitter in ``[1 - jitter, 1]``
    (downward only, so the cap stays a hard bound).  The relaunched
    command is the same; resuming is the child's job (the CLI appends
    ``--resume`` when a checkpoint dir is set).  ``ckpt_dir``: each
    relaunch logs the verified snapshot the child will resume from.
    ``forward_preempt``: SIGUSR1 delivered to the supervisor is re-sent
    to the running child, which answers the notice."""
    if log is None:
        log = lambda m: print(m, file=sys.stderr, flush=True)
    attempt = 0
    while True:
        attempt += 1
        log(f"[supervise] attempt {attempt}: {' '.join(cmd)}")
        rc = _run_child(cmd, env, log, (PREEMPT_SIGNAL,)
                        if forward_preempt else ())
        if rc in _NO_RETRY:
            if rc == EXIT_ANOMALY:
                log("[supervise] child exited 44 (anomaly abort): "
                    "deterministic training failure — not retrying")
            elif rc == EXIT_DECOMMISSION:
                log("[supervise] child exited 47 (decommission): retired "
                    "on a preemption notice — not retrying")
            else:
                log("[supervise] child completed (exit 0)")
            return rc
        restarts_used = attempt - 1
        if restarts_used >= max_restarts:
            log(f"[supervise] giving up: {max_restarts} restarts exhausted "
                f"(last exit {rc})")
            return rc
        delay = min(backoff * (2.0 ** restarts_used), backoff_cap)
        if jitter > 0:
            delay *= 1.0 - jitter * _rand()
        reason = {EXIT_HANG: "watchdog hang",
                  EXIT_PEER: "peer loss"}.get(rc, "crash")
        log(f"[supervise] child exit {rc} ({reason}); relaunching in "
            f"{delay:.1f}s ({restarts_used + 1}/{max_restarts})")
        if ckpt_dir:
            step, bad, _ = _restore_target(ckpt_dir)
            if step is not None:
                log(f"[supervise] relaunch resumes from verified snapshot "
                    f"step {step}"
                    + (f" ({bad} unverified generation(s) will be "
                       "quarantined on restore)" if bad else ""))
            else:
                log(f"[supervise] no verified snapshot in {ckpt_dir}: "
                    "relaunch restarts from scratch")
        _sleep(delay)


def _run_child(cmd: Sequence[str], env: Optional[dict],
               log: Callable[[str], None],
               forward_signals: Sequence[int] = ()) -> int:
    """One child launch: a blocking call, re-sending ``forward_signals``
    delivered to this process to the child while it runs."""
    if not forward_signals:
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
        return child.wait()
    finally:
        for s, prev in restore.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
