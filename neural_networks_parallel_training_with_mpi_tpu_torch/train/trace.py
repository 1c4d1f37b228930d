"""Distributed host-side tracing: Perfetto-ready span timelines.

The port's own copy of the JAX package's ``train/trace.py``, with the
same file layout under the trace directory, so ``tools/trace_report.py``
merges the port's processes and incarnations unchanged.  The telemetry
channel (``train/telemetry.py``) answers *what* happened — per-step
metrics, heartbeat, flight recorder.  This module answers *where time
went*: a lightweight span API (``with trace.span("dispatch"): ...``)
writing a bounded per-process ``trace-p{P}-i{I}.jsonl`` (append + flush,
atomic lines).  Every record carries the cross-process correlation
triple:

* ``process_id`` — this process's rank (``NNPT_PROCESS_ID``, else
  ``torch.distributed.get_rank()`` when a process group is formed, else
  the ``RANK`` torchrun sets, else 0);
* ``run_id`` — one id for the whole JOB, stable across supervisor
  relaunches (``NNPT_RUN_ID``: set by ``train.resilience.supervise`` for
  its children, by the operator for multi-process worlds, or
  self-generated for a bare run);
* ``incarnation`` — which supervisor attempt this process is
  (``NNPT_INCARNATION``: 0 for the first launch, k for the k-th
  relaunch).

Because timestamps are unix epoch seconds, ``tools/trace_report.py``
(stdlib-only, like ``ckpt_fsck``) can merge the per-process files of a
supervised multi-process run — including files from DIFFERENT
incarnations after a crash-relaunch — onto ONE Chrome/Perfetto timeline
where the relaunch gap is visible, plus a per-phase time-share summary.

Span taxonomy (the fixed vocabulary the report tool groups by):

==============  ========================================================
``load``        host batch assembly (the loader's ``next()``)
``dispatch``    submitting one compiled step (async — host-side cost)
``fetch``       a host read of step output (telemetry/monitor/log)
``eval``        a held-out evaluation pass
``ckpt``        a checkpoint save call (sync write or async staging)
``ckpt_write``  the async writer thread's actual disk write
``rollback``    anomaly/SDC rollback: restore + re-place
``admit`` / ``prefill`` / ``decode`` / ``retire``
                the serving scheduler's tick phases (serve/scheduler.py)
``queue_wait``  serving inter-tick gap with requests queued but no slot
``sched_bubble``
                serving inter-tick gap with decoding streams in flight
                (the scheduler loop, not the model, owned that time)
``compile:<n>`` a ledger-observed CUDA-graph capture (utils/compile_ledger.py)
==============  ========================================================

Besides spans, a tracer can emit **flow points** (:func:`flow`): the
Chrome s/t/f arrow chain that links spans by an id.  The serving
scheduler threads each request id through admit -> every prefill chunk
-> every decode tick -> retire, so ``tools/trace_report.py``'s merged
Perfetto timeline draws one request's whole life as a connected arrow
path across the per-tick phase spans (and, once blocks hand off across
replicas, across processes).

Relationship to the device profiler (``--profile_dir`` →
``utils.profiling.trace``, ``torch.profiler``): the profiler captures
*device* activity — every kernel, one heavyweight capture window,
leader-gated, viewed as a Chrome trace.  This module captures *host*
phases — always-on-able, cross-process, crash-surviving.  Run both on
the card: host spans say which phase starved the device; the profiler
says what the device did inside it.

Everything is zero-cost when no tracer is installed: ``span()`` returns
a shared null context manager and touches one module global.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

RUN_ID_ENV = "NNPT_RUN_ID"
INCARNATION_ENV = "NNPT_INCARNATION"
PROCESS_ID_ENV = "NNPT_PROCESS_ID"  # the DESIGN §10 world env channel

# bounded trace discipline: after this many records the file stops
# growing and the footer reports how many spans were dropped — a
# runaway serving loop must not fill the disk the way an unbounded
# logger would
DEFAULT_MAX_EVENTS = 100_000


def _process_rank() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    try:
        return int(os.environ.get("RANK") or 0)
    except ValueError:
        return 0


def run_identity() -> Dict[str, Any]:
    """The (process_id, run_id, incarnation) triple for THIS process.
    Env-first (the supervisor/operator channel); process_id falls back
    to the rank of the formed ``torch.distributed`` group, then to the
    ``RANK`` torchrun sets, then 0."""
    pid_env = os.environ.get(PROCESS_ID_ENV)
    if pid_env is not None and pid_env != "":
        process_id = int(pid_env)
    else:
        process_id = _process_rank()
    run_id = os.environ.get(RUN_ID_ENV) or ""
    if not run_id:
        run_id = f"run-{int(time.time())}-{os.getpid()}"
    try:
        incarnation = int(os.environ.get(INCARNATION_ENV) or 0)
    except ValueError:
        incarnation = 0
    return {"process_id": process_id, "run_id": run_id,
            "incarnation": incarnation}


class Tracer:
    """Per-process span writer.  One file per (process, incarnation) so
    a supervised relaunch never clobbers its predecessor's timeline;
    thread-safe (the async checkpoint writer emits from its own
    thread)."""

    def __init__(self, dirpath: str, process_id: int, run_id: str,
                 incarnation: int, max_events: int = DEFAULT_MAX_EVENTS):
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.process_id = int(process_id)
        self.run_id = str(run_id)
        self.incarnation = int(incarnation)
        self.max_events = int(max_events)
        self.path = os.path.join(
            dirpath, f"trace-p{self.process_id}-i{self.incarnation}.jsonl")
        self._ident = {"p": self.process_id, "run": self.run_id,
                       "inc": self.incarnation}
        self._lock = threading.Lock()
        self._f: Optional[Any] = open(self.path, "a")
        self.events = 0
        self.dropped = 0
        self._emit({"kind": "meta", "t": round(time.time(), 6),
                    "pid": os.getpid(), **self._ident})

    def _emit(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def _emit_bounded(self, rec: Dict[str, Any]) -> None:
        # bound check + counter update under the SAME lock as the write:
        # the async checkpoint writer emits from its own thread, and an
        # unsynchronized check-then-increment could overshoot the bound
        # or miscount the footer
        with self._lock:
            if self.events >= self.max_events:
                self.dropped += 1
                return
            self.events += 1
            if self._f is None:
                return
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def record_span(self, name: str, t_unix: float, dur_s: float,
                    attrs: Dict[str, Any]) -> None:
        rec = {"kind": "span", "name": name, "t": round(t_unix, 6),
               "dur": round(dur_s, 6), **self._ident}
        thread = threading.current_thread()
        if thread is not threading.main_thread():
            rec["thread"] = thread.name
        if attrs:
            rec.update(attrs)
        self._emit_bounded(rec)
        if _SPAN_LISTENERS:
            for fn in tuple(_SPAN_LISTENERS):
                try:
                    fn(name, t_unix, dur_s, attrs)
                except Exception:
                    pass

    def instant(self, name: str, **attrs) -> None:
        self._emit_bounded({"kind": "instant", "name": name,
                            "t": round(time.time(), 6), **self._ident,
                            **attrs})

    def flow(self, name: str, flow_id: Any, phase: str, **attrs) -> None:
        """One point of a Perfetto FLOW — an arrow chain linking spans
        across ticks/threads/processes by ``flow_id``.  ``phase``:
        ``"s"`` start, ``"t"`` step, ``"f"`` finish (the Chrome
        trace-event flow vocabulary).  The serving scheduler threads a
        request id through admit -> each prefill chunk -> decode ticks
        -> retire this way, so one request's life is one connected
        arrow path across the per-tick phase spans."""
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
        self._emit_bounded({"kind": "flow", "name": name,
                            "id": str(flow_id), "fph": phase,
                            "t": round(time.time(), 6), **self._ident,
                            **attrs})

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.write(json.dumps(
                {"kind": "meta", "t": round(time.time(), 6),
                 "events": self.events, "dropped": self.dropped,
                 "final": True, **self._ident}) + "\n")
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------------
# module-level active tracer + the cheap span() entrypoint
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None

# span listeners: callables ``fn(name, t_unix, dur_s, attrs)`` invoked for
# every recorded span, from whichever thread recorded it.  This is how
# ``utils/goodput.py``'s in-process meter observes the span stream without
# re-reading the trace file; the disabled-path cost is one empty-list
# truthiness check inside record_span.  Listener exceptions are swallowed —
# accounting must never take down the traced process.
_SPAN_LISTENERS: list = []


def add_listener(fn) -> None:
    """Register a span listener (idempotent)."""
    if fn not in _SPAN_LISTENERS:
        _SPAN_LISTENERS.append(fn)


def remove_listener(fn) -> None:
    """Unregister a span listener; missing listeners are ignored."""
    try:
        _SPAN_LISTENERS.remove(fn)
    except ValueError:
        pass


class _NullSpan:
    """Shared no-op context manager: the disabled-path cost of a span is
    one global read and one attribute call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_t_unix", "_t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._t_unix = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tracer = _ACTIVE
        if tracer is not None:
            tracer.record_span(self.name, self._t_unix,
                               time.perf_counter() - self._t0, self.attrs)
        return False


def span(name: str, **attrs):
    """``with trace.span("dispatch", step=k): ...`` — no-op (shared null
    object, no allocation) when no tracer is installed."""
    if _ACTIVE is None:
        return _NULL
    return _Span(name, attrs)


def instant(name: str, **attrs) -> None:
    tracer = _ACTIVE
    if tracer is not None:
        tracer.instant(name, **attrs)


def flow(name: str, flow_id: Any, phase: str, **attrs) -> None:
    """Emit one flow point (see :meth:`Tracer.flow`); no-op when no
    tracer is installed — per-request flow tracing costs nothing on an
    untraced serving process."""
    tracer = _ACTIVE
    if tracer is not None:
        tracer.flow(name, flow_id, phase, **attrs)


def active() -> Optional[Tracer]:
    return _ACTIVE


def install(tracer: Optional[Tracer]) -> None:
    global _ACTIVE
    _ACTIVE = tracer


def traced_iter(name: str, it):
    """Wrap an iterator so each ``next()`` is a span (the trainer's
    ``load`` phase).  Returns the iterator UNCHANGED when tracing is off
    at wrap time; the wrapper closes the inner iterator deterministically
    (the loader's prefetch-worker release contract)."""
    if _ACTIVE is None:
        return it

    def gen():
        inner = iter(it)
        try:
            while True:
                with span(name):
                    try:
                        item = next(inner)
                    except StopIteration:
                        return
                yield item
        finally:
            close = getattr(inner, "close", None)
            if close is not None:
                close()

    return gen()


# ---------------------------------------------------------------------------
# run lifecycle: one call installs the tracer AND the compile ledger
# ---------------------------------------------------------------------------

def dir_from_config(cfg) -> Optional[str]:
    """Resolve the effective trace directory from a TrainConfig-shaped
    object: ``--trace_dir`` wins; bare ``--trace`` rides
    ``--telemetry_dir`` (a ``trace/`` subdir, so one run directory holds
    the whole observability bundle)."""
    trace_dir = getattr(cfg, "trace_dir", None)
    if trace_dir:
        return trace_dir
    if getattr(cfg, "trace", False):
        tdir = getattr(cfg, "telemetry_dir", None)
        if not tdir:
            raise ValueError(
                "--trace needs --telemetry_dir (spans land in its trace/ "
                "subdir) or an explicit --trace_dir")
        return os.path.join(tdir, "trace")
    return None


def start_run(dirpath: str, max_events: int = DEFAULT_MAX_EVENTS,
              ledger: bool = True) -> Tracer:
    """Create + install the process tracer for ``dirpath`` and (by
    default) the compile ledger next to it (``compiles-p{P}-i{I}.jsonl``
    in the same directory).  Returns the tracer; ``stop_run()`` closes
    both."""
    ident = run_identity()
    tracer = Tracer(dirpath, ident["process_id"], ident["run_id"],
                    ident["incarnation"], max_events=max_events)
    install(tracer)
    if ledger:
        from ..utils import compile_ledger

        compile_ledger.install(compile_ledger.Ledger(
            os.path.join(dirpath,
                         f"compiles-p{ident['process_id']}"
                         f"-i{ident['incarnation']}.jsonl"),
            **ident))
    return tracer


def stop_run(tracer: Optional[Tracer] = None) -> None:
    """Close + uninstall the tracer (and the compile ledger, if one is
    installed).  With an explicit ``tracer``, only uninstalls when that
    tracer is still the active one — a later ``start_run`` wins."""
    global _ACTIVE
    from ..utils import compile_ledger

    target = tracer if tracer is not None else _ACTIVE
    if target is not None:
        target.close()
    if target is _ACTIVE:
        _ACTIVE = None
        led = compile_ledger.active()
        if led is not None:
            led.close()
            compile_ledger.install(None)
