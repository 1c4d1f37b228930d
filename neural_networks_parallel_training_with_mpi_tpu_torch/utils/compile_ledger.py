"""Compile-event ledger: one record per program the step builds.

The port's own counterpart of the JAX package's ``utils/compile_ledger.py``.
Where JAX compiles a step through XLA once per argument signature, the
port builds programs two ways, and the ledger records both into the same
``compiles-p{P}-i{I}.jsonl`` (next to the trace files, installed by
``train.trace.start_run``), so ``tools/trace_report.py`` and
``utils/goodput.py`` read it unchanged:

* **CUDA-graph captures** (``parallel.data_parallel.GraphedTrainStep``,
  ``--steps_per_dispatch k`` on the card): one event per capture, with
  the step's name (``train_step[<layout>]``), ``n_compile`` (which
  capture this is), the batch and state signature (tree path →
  ``dtype[shape]``), ``signature_diff``'s ``changed``/``added``/
  ``removed`` against the previous capture, the capture's wall time
  (``capture_s``, and ``compile_ms`` for the tools that sum compile
  time), ``flops`` from the analytic ``train.telemetry.train_step_flops``
  and ``bytes_accessed: null``.  A replay records nothing, and neither
  does a rollback, which copies a snapshot into the captured tensors.
  There is no program text to hash: ``fingerprint_sha256`` is the
  SHA-256 of the signature plus the step's static settings (layout,
  loss, optimizer), so the same step over the same shapes has the same
  fingerprint across runs.
* **Eager callables** (:func:`instrument`, the step at k = 1 and the
  eval step): one signature-only event the first time each argument
  signature is seen, with no cost — the JAX ledger's degradation ladder
  for plain callables.  A changed batch shape is a new event naming the
  changed component.

When no ledger is installed, :func:`instrument`'s wrapper calls straight
through and :func:`record_capture` records nothing.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional

from .tree import leaves

__all__ = ["Ledger", "InstrumentedFn", "instrument", "install", "active",
           "signature", "signature_diff", "record_capture"]


class Ledger:
    """Append-only compile-event sink: a JSONL file (append + flush,
    atomic lines) plus an in-process ``events`` list.  Every record
    carries the (process_id, run_id, incarnation) triple of
    ``train.trace``."""

    def __init__(self, path: Optional[str], process_id: int = 0,
                 run_id: str = "", incarnation: int = 0):
        self.path = path
        self.events: List[Dict[str, Any]] = []
        self._ident = {"p": int(process_id), "run": str(run_id),
                       "inc": int(incarnation)}
        self._lock = threading.Lock()
        self._f = open(path, "a") if path else None

    def record(self, rec: Dict[str, Any]) -> None:
        rec = {**rec, **self._ident}
        with self._lock:
            self.events.append(rec)
            if self._f is not None:
                self._f.write(json.dumps(rec) + "\n")
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


_ACTIVE: Optional[Ledger] = None


def install(ledger: Optional[Ledger]) -> None:
    global _ACTIVE
    _ACTIVE = ledger


def active() -> Optional[Ledger]:
    return _ACTIVE


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def _leaf_str(x) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None or dtype is None:
        return f"py:{type(x).__name__}"
    return (f"{str(dtype).replace('torch.', '')}"
            f"[{','.join(str(d) for d in shape)}]")


def _walk(x, path: str, out: Dict[str, str]) -> None:
    """Tree paths as JAX's ``keystr`` writes them: ``['key']`` for a dict
    entry (sorted keys), ``.field`` for a NamedTuple field, ``[i]`` for a
    list or tuple element; ``None`` is an empty subtree."""
    if x is None:
        return
    if isinstance(x, dict):
        for k in sorted(x):
            _walk(x[k], f"{path}[{k!r}]", out)
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for name, v in zip(x._fields, x):
            _walk(v, f"{path}.{name}", out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _walk(v, f"{path}[{i}]", out)
    else:
        out[path] = _leaf_str(x)


def signature(args) -> Dict[str, str]:
    """Tree path → ``dtype[shape]`` over a call's argument tuple."""
    out: Dict[str, str] = {}
    _walk(tuple(args), "", out)
    return out


def signature_diff(old: Dict[str, str], new: Dict[str, str]
                   ) -> Dict[str, Any]:
    """Name what changed between two signatures: the re-capture (or new
    eager signature) attribution the ledger exists for."""
    changed = {k: {"from": old[k], "to": new[k]}
               for k in new if k in old and old[k] != new[k]}
    added = {k: new[k] for k in new if k not in old}
    removed = {k: old[k] for k in old if k not in new}
    out: Dict[str, Any] = {}
    if changed:
        out["changed"] = changed
    if added:
        out["added"] = added
    if removed:
        out["removed"] = removed
    return out


def fingerprint(sig: Dict[str, str], static: Dict[str, Any]) -> str:
    """SHA-256 of the signature plus the step's static settings."""
    doc = json.dumps({"signature": sig, "static": static}, sort_keys=True,
                     default=str)
    return hashlib.sha256(doc.encode()).hexdigest()


# ---------------------------------------------------------------------------
# CUDA-graph captures
# ---------------------------------------------------------------------------

def record_capture(name: str, n_compile: int, sig: Dict[str, str],
                   prev_sig: Optional[Dict[str, str]], capture_s: float,
                   flops: Optional[float],
                   static: Optional[Dict[str, Any]] = None
                   ) -> Optional[Dict[str, Any]]:
    """One capture event into the installed ledger (None when there is
    none); ``prev_sig`` is the previous capture's signature, if any."""
    ledger = _ACTIVE
    if ledger is None:
        return None
    static = dict(static or {})
    rec: Dict[str, Any] = {
        "kind": "compile", "name": name, "t": round(time.time(), 6),
        "n_compile": int(n_compile), "signature": sig,
        "program": "cuda_graph",
        "capture_s": round(capture_s, 6),
        "compile_ms": round(capture_s * 1e3, 3),
        "fingerprint_sha256": fingerprint(sig, static),
        "flops": float(flops) if flops else None,
        "bytes_accessed": None,
    }
    if prev_sig is not None:
        rec.update(signature_diff(prev_sig, sig))
    ledger.record(rec)
    return rec


# ---------------------------------------------------------------------------
# eager callables
# ---------------------------------------------------------------------------

class InstrumentedFn:
    """Wraps an eager callable.  Ledger installed → the first call with
    each new argument signature records a signature-only event; ledger
    absent → a pure pass-through.  Each call is keyed by its tensors'
    (shape, dtype) alone, and the path-by-path signature (its strings)
    is built only for a new key: an eager step is host-bound."""

    def __init__(self, fn, name: str):
        self._fn = fn
        self.name = name
        self._seen: set = set()
        self._last_sig: Optional[Dict[str, str]] = None
        self._lock = threading.Lock()

    @property
    def wrapped(self):
        return self._fn

    def __call__(self, *args, **kwargs):
        ledger = _ACTIVE
        if ledger is not None and not kwargs:
            key = tuple((x.shape, x.dtype) for x in leaves(args))
            with self._lock:
                new = key not in self._seen
                if new:
                    self._seen.add(key)
                    sig = signature(args)
                    prev, self._last_sig = self._last_sig, sig
            if new:
                rec: Dict[str, Any] = {
                    "kind": "compile", "name": self.name,
                    "t": round(time.time(), 6),
                    "n_compile": len(self._seen), "signature": sig,
                    "program": "eager",
                    "note": "eager callable: signature-only"}
                if prev is not None:
                    rec.update(signature_diff(prev, sig))
                ledger.record(rec)
        return self._fn(*args, **kwargs)


def instrument(fn, name: str):
    """Wrap ``fn`` under the ledger seam; wrapping an instrumented fn
    re-labels it instead of stacking."""
    if isinstance(fn, InstrumentedFn):
        fn.name = name
        return fn
    return InstrumentedFn(fn, name)
