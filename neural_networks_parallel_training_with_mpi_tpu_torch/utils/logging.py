"""Structured metrics and rank-0 logging.

The port of the JAX package's ``utils/logging.py``: only rank 0 logs
(each message carries global, already all-reduced values, so one line is
the whole job), optionally mirrored as JSONL records (``--metrics_jsonl``).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional, TextIO

import torch.distributed as dist


def is_leader() -> bool:
    """Rank 0 of the process group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def log(msg: str, *, every_process: bool = False) -> None:
    if every_process or is_leader():
        print(msg, flush=True)


class MetricsLogger:
    """Per-step structured metrics from rank 0 only."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.jsonl: Optional[TextIO] = None
        if jsonl_path and is_leader():
            self.jsonl = open(jsonl_path, "a")
        self._t0 = time.perf_counter()

    def write(self, record: Dict[str, Any]) -> None:
        if not is_leader():
            return
        record = {k: (float(v) if hasattr(v, "item") else v)
                  for k, v in record.items()}
        record["t"] = round(time.perf_counter() - self._t0, 6)
        if self.jsonl:
            self.jsonl.write(json.dumps(record) + "\n")
            self.jsonl.flush()

    def close(self) -> None:
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None


class Throughput:
    """Samples/sec over the steady state: the clock starts at the first
    ``add()`` (after the first step, which carries the first-call costs:
    kernel builds, cuBLAS handles, allocator growth) and that step's
    samples are excluded."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.samples = 0
        self.start: Optional[float] = None
        self._t0 = time.perf_counter()
        self._warmup_samples = 0

    def add(self, n: int) -> None:
        if self.start is None:
            self.start = time.perf_counter()
            self._warmup_samples = int(n)
            return
        self.samples += int(n)

    @property
    def samples_per_sec(self) -> float:
        if self.samples > 0 and self.start is not None:
            dt = time.perf_counter() - self.start
            return self.samples / dt if dt > 0 else 0.0
        # one-step runs have no steady window: the first-call-inclusive rate
        if self._warmup_samples:
            dt = time.perf_counter() - self._t0
            return self._warmup_samples / dt if dt > 0 else 0.0
        return 0.0
