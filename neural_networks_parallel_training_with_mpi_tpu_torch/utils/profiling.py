"""Tracing / profiling, the port of the JAX package's ``utils/profiling.py``.

Zero-cost when disabled:

* :func:`trace` — a leader-only ``torch.profiler.profile`` over CPU and
  CUDA activity (``--profile_dir``, ``--xla_trace_dir``), writing one
  Chrome trace (``trace-<pid>.json``) under the directory on exit: every
  kernel the card ran (the flash kernels, the ``_foreach`` optimizer
  kernels, cuBLAS GEMMs) beside the host's ops.
* :func:`annotate` — a named region on that timeline
  (``torch.profiler.record_function``).
* :func:`device_memory_stats` — per-device live/peak memory from
  ``torch.cuda.memory_stats`` under the JAX package's key names
  (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``); ``{}`` where
  no card is initialised.
* :class:`StepTimer` — host-side per-step wall-clock stats that never sync
  the device themselves.

The JAX module's ``donation_report`` reads the buffer-donation aliases
XLA wrote into a compiled program's header; eager PyTorch updates the
state's tensors in place and has no donation to audit, so the port has
no counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional

import torch

from .logging import is_leader


@contextlib.contextmanager
def trace(log_dir: Optional[str], leader_only: bool = True):
    """Profiler context; no-op if ``log_dir`` is falsy (or on non-leader
    processes with ``leader_only``).  Yields the profiler (None when
    off)."""
    if not log_dir or (leader_only and not is_leader()):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace-{os.getpid()}.json"))


def annotate(name: str):
    """Named region for the trace timeline: ``with annotate("step"): ...``"""
    return torch.profiler.record_function(name)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card live/peak/limit bytes where a card is initialised (``{}``
    on the host)."""
    out: Dict[str, Dict[str, int]] = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                i).total_memory),
        }
    return out


class StepTimer:
    """Wall-clock per-step statistics.

    Under async launches a ``tick()`` measures dispatch-to-dispatch time,
    which converges to the true step time once the queue is saturated —
    without a device sync in the loop."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self._times: List[float] = []
        self._last: Optional[float] = None
        self._seen = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.skip_first:
                self._times.append(now - self._last)
        self._last = now

    def block(self, value: Any) -> Any:
        """Wait for the card at a measurement boundary and restart the
        interval clock (so the sync isn't charged to the next step)."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._last = time.perf_counter()
        return value

    @staticmethod
    def _pct(sorted_times: List[float], q: float) -> float:
        if not sorted_times:
            return float("nan")
        i = min(len(sorted_times) - 1, int(q * (len(sorted_times) - 1)))
        return sorted_times[i]

    def stats(self) -> Dict[str, float]:
        ts = sorted(self._times)
        if not ts:
            return {}
        return {
            "step_time_p50_ms": 1e3 * self._pct(ts, 0.50),
            "step_time_p95_ms": 1e3 * self._pct(ts, 0.95),
            "step_time_max_ms": 1e3 * ts[-1],
            "steps_per_sec": len(ts) / sum(ts),
        }
