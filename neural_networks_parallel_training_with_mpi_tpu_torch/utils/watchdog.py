"""Step-hang watchdog, the port's own copy of the JAX package's
``utils/watchdog.py`` (``--hang_timeout``).

The reference has no failure handling: a lost rank hangs ``comm.gather``
forever and the job blocks until the scheduler kills it.  On the card
the same failure stalls inside a blocking read (the loop's lag-1 loss
read waits on the stream) or inside an NCCL/gloo collective.

:class:`HangWatchdog` turns the silent stall into a loud failure: a
daemon thread watches a heartbeat the train loop pats after each lag-1
read, and when nothing happens for ``timeout_s`` it dumps the stack of
every thread to stderr, calls ``on_timeout`` (the Trainer's flight-
recorder dump, ``train.telemetry.emergency_dump("hang")``) and
hard-exits the process with 42 (a kernel or a collective stuck on the
card cannot be interrupted from Python).
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional


class HangWatchdog:
    """``with HangWatchdog(120):`` + ``wd.pat()`` once per step.

    The clock arms at the FIRST ``pat()``: the first step builds the
    kernels and captures the CUDA graph, which must not count as a hang.
    Known-long host phases (evals, checkpoint writes) run inside ``with
    wd.suspended():``; the clock resets when the phase ends."""

    def __init__(self, timeout_s: Optional[float], _exit=os._exit,
                 on_timeout: Optional[Callable[[], object]] = None):
        self.timeout_s = timeout_s
        self._exit = _exit  # injectable for tests
        # the last act before the hard exit, called once; what it raises
        # is logged, never raised: the exit must happen regardless
        self.on_timeout = on_timeout
        self._beat: Optional[float] = None  # None until armed by first pat
        self._suspended = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def pat(self) -> None:
        self._beat = time.monotonic()

    @contextlib.contextmanager
    def suspended(self):
        """Pause hang detection for a known-long non-step phase."""
        self._suspended += 1
        try:
            yield
        finally:
            # reset the heartbeat BEFORE un-suspending: the thread must
            # never see _suspended == 0 with a beat from before the phase
            if self._beat is not None:
                self.pat()
            self._suspended -= 1

    def _run(self) -> None:
        assert self.timeout_s is not None
        poll = min(self.timeout_s / 4.0, 5.0)
        while not self._stop.wait(poll):
            if self._beat is None or self._suspended:
                continue
            idle = time.monotonic() - self._beat
            if idle > self.timeout_s:
                print(
                    f"HANG DETECTED: no train step progress for "
                    f"{idle:.0f}s (> {self.timeout_s:.0f}s). Dumping all "
                    "thread stacks and aborting this process (exit 42) — "
                    "a stuck kernel or collective cannot be interrupted "
                    "from Python.", file=sys.stderr, flush=True)
                try:  # needs a real fd; stderr may be captured/redirected
                    faulthandler.dump_traceback(file=sys.stderr)
                    sys.stderr.flush()
                except Exception:
                    pass
                if self.on_timeout is not None:
                    try:
                        self.on_timeout()
                    except Exception as e:
                        print(f"[watchdog] on_timeout failed: "
                              f"{type(e).__name__}: {e}", file=sys.stderr,
                              flush=True)
                self._exit(42)
                return  # only reached with an injected _exit (tests)

    def __enter__(self) -> "HangWatchdog":
        if self.timeout_s and self.timeout_s > 0:
            self._thread = threading.Thread(
                target=self._run, name="hang-watchdog", daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
