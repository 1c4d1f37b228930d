"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
``StepTimer``, the leader-only profiler capture (``torch.profiler`` in
place of ``jax.profiler``: a Chrome trace under the directory), named
regions, and per-device memory stats under JAX's key names.

Mirrors ``tests/test_profiling_distributed.py``.  On the host the
profiler sees CPU activity only and ``device_memory_stats`` is ``{}``, as
JAX's is on XLA:CPU; the card's side (the flash and ``_foreach`` kernels
on the timeline, the memory keys) is ``chip_smoke.py`` phase 20 (c).
"""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.utils import (
    profiling as jprofiling,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import config
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    profiling,
)

pytestmark = pytest.mark.torch_port


def test_step_timer_stats_like_jax():
    timers = [profiling.StepTimer(skip_first=1),
              jprofiling.StepTimer(skip_first=1)]
    for _ in range(12):
        for t in timers:
            t.tick()
        time.sleep(0.002)
    ours, theirs = (t.stats() for t in timers)
    assert set(ours) == set(theirs)
    assert ours["step_time_p50_ms"] >= 1.5
    assert ours["step_time_p95_ms"] >= ours["step_time_p50_ms"]
    assert ours["steps_per_sec"] > 0
    assert profiling.StepTimer().stats() == {}
    assert timers[0].block(3) == 3


def test_trace_noop_without_dir(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(""):
        pass
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    d = tmp_path / "prof"
    with profiling.trace(str(d)) as prof:
        assert prof is not None
        with profiling.annotate("unit-test-region"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(x[0, 0]) == 64.0
    files = glob.glob(str(d / "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "unit-test-region" in names and "aten::mm" in names


def test_device_memory_stats_empty_on_the_host():
    assert profiling.device_memory_stats() == {}
    from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
        telemetry,
    )
    assert telemetry.device_memory_summary() is None


def test_profile_dir_traces_the_fit(tmp_path):
    """``--profile_dir`` (and ``--xla_trace_dir``, the same capture) runs
    the profiler over the whole fit: the train step's ops and the
    ``_foreach`` optimizer ops are on the timeline."""
    for field in ("profile_dir", "xla_trace_dir"):
        d = tmp_path / field
        t = Trainer(config.TrainConfig(
            nepochs=1, batch_size=8, full_batch=False, optimizer="adam",
            data=config.DataConfig(n_samples=24), **{field: str(d)}),
            device="cpu")
        r = t.fit()
        assert np.isfinite(r["final_loss"])
        files = glob.glob(str(d / "trace-*.json"))
        assert len(files) == 1, field
        with open(files[0]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert any(n and n.startswith("aten::_foreach") for n in names)
        assert "aten::mm" in names or "aten::addmm" in names
