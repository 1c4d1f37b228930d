"""One tolerant JSONL reader for every observability consumer (the
port's own copy of the JAX package's ``utils/jsonl.py``).

``obs_agg``, ``metrics_summary``, ``trace_report``, and
``goodput_report`` all read append-only JSONL written by processes that
may die mid-line: a SIGKILLed writer (the supervisor's hang-kill, an
injected chaos crash, the OOM killer) leaves a torn final line, and a
reader that crashes on it loses the whole file's history at exactly the
moment the history matters most.  Before this module each tool carried
its own silent skip loop; now they share one reader with one contract:

* a line that fails to parse is **skipped and counted**, never fatal;
* a *non-final* torn line is also just skipped — the writer discipline
  (append + flush, atomic lines) makes mid-file tears vanishingly rare,
  but a reader must not assume its input honoured the discipline;
* a missing file reads as empty (the empty-trace-dir case: a process
  died before its first flush);
* only records that parse to JSON **objects** are returned — a bare
  string or number on a line is somebody else's format.

Stdlib-only (``python -S``-proven), loaded by file path from the tools
so it works with no package install.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple


def read_jsonl(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Read ``path`` as JSONL, returning ``(records, skipped)``.

    ``records`` holds every line that parsed to a dict; ``skipped``
    counts lines that were present but unusable (torn tail from a
    killed writer, partial flush, non-object JSON).  A missing or
    unreadable file returns ``([], 0)`` — absence is not corruption.
    Blank lines are ignored and not counted as skipped.
    """
    records: List[Dict[str, Any]] = []
    skipped = 0
    try:
        f = open(path, "r", encoding="utf-8", errors="replace")
    except OSError:
        return records, skipped
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                skipped += 1
    return records, skipped


def read_many(paths) -> Tuple[List[Dict[str, Any]], int]:
    """``read_jsonl`` over an iterable of paths, concatenated; returns
    the combined records and the total skipped-line count."""
    records: List[Dict[str, Any]] = []
    skipped = 0
    for p in paths:
        recs, skip = read_jsonl(p)
        records.extend(recs)
        skipped += skip
    return records, skipped
