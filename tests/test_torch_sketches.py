"""The port's copies of the stdlib-only observability modules against the
JAX package's, on the CPU: ``utils/sketches.py`` (QuantileSketch,
merge_sketch_dicts, Gauge, EmaZScore, ErrorBudget), ``utils/jsonl.py``
and ``utils/goodput.py`` (the offline ledger, the online meter, the step
anatomy, the goodput record).

``tools/obs_agg.py`` and ``tools/goodput_report.py`` merge both
packages' records, so every dict here must be IDENTICAL to JAX's for the
same inputs (no tolerance); the clock both read is the same stand-in.
"""

import json
import math
import random

import pytest

from neural_networks_parallel_training_with_mpi_tpu.utils import (
    goodput as jgoodput,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import jsonl as jjsonl
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    sketches as jsketches,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import goodput
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import jsonl
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import sketches

pytestmark = pytest.mark.torch_port

class _Clock:
    """A stand-in ``time`` module: ``time()`` steps by 0.25 s."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def time(self):
        self.t += 0.25
        return self.t


@pytest.fixture
def clocks(monkeypatch):
    """Each module pair reads its own stand-in clock, stepped alike."""
    for mod in (sketches, jsketches, goodput, jgoodput):
        monkeypatch.setattr(mod, "time", _Clock())


def _stream(seed, n, dist="normal"):
    rng = random.Random(seed)
    if dist == "normal":
        return [rng.gauss(10.0, 3.0) for _ in range(n)]
    if dist == "heavy":
        return [rng.paretovariate(1.5) for _ in range(n)]
    return [float(rng.randint(0, 5)) for _ in range(n)]


@pytest.mark.parametrize("dist", ["normal", "heavy", "ties"])
@pytest.mark.parametrize("eps", [0.01, 0.05])
def test_quantile_sketch_dicts_identical(dist, eps):
    xs = _stream(7, 3000, dist)
    ours, theirs = sketches.QuantileSketch(eps), jsketches.QuantileSketch(eps)
    for x in xs:
        ours.add(x)
        theirs.add(x)
    assert ours.to_dict() == theirs.to_dict()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    assert ours.summary() == theirs.summary()
    assert ours.rank_error_bound == theirs.rank_error_bound


def test_merges_identical():
    shards = [_stream(s, 500 + 100 * s) for s in range(4)]
    docs, jdocs = [], []
    for xs in shards:
        a, b = sketches.QuantileSketch(), jsketches.QuantileSketch()
        for x in xs:
            a.add(x)
            b.add(x)
        docs.append(a.to_dict())
        jdocs.append(b.to_dict())
    assert docs == jdocs
    assert sketches.merge_sketch_dicts(docs).to_dict() == \
        jsketches.merge_sketch_dicts(jdocs).to_dict()
    a = sketches.QuantileSketch.from_dict(docs[0]).merge(
        sketches.QuantileSketch.from_dict(docs[1]))
    b = jsketches.QuantileSketch.from_dict(jdocs[0]).merge(
        jsketches.QuantileSketch.from_dict(jdocs[1]))
    assert a.to_dict() == b.to_dict()
    # the port's dicts load into JAX's class and back, unchanged
    assert jsketches.QuantileSketch.from_dict(docs[2]).to_dict() == docs[2]


def test_gauge_dicts_identical():
    a, b = sketches.Gauge(), jsketches.Gauge()
    for i, v in enumerate([3.0, -1.5, 7.25, 0.0]):
        a.set(v, t_unix=100.0 + i)
        b.set(v, t_unix=100.0 + i)
    assert a.to_dict() == b.to_dict()
    assert sketches.Gauge.from_dict(b.to_dict()).to_dict() == b.to_dict()


@pytest.mark.parametrize("direction", ["above", "below"])
def test_ema_zscore_alerts_identical(direction, clocks):
    xs = _stream(3, 200) + [1e6, -1e6, float("nan"), float("inf")] + \
        _stream(4, 50)
    a = sketches.EmaZScore("loss", direction=direction)
    b = jsketches.EmaZScore("loss", direction=direction)
    got = [a.observe(x, step=i) for i, x in enumerate(xs)]
    want = [b.observe(x, step=i) for i, x in enumerate(xs)]
    assert json.dumps(got) == json.dumps(want)
    assert any(got)


def test_error_budget_alerts_identical(clocks):
    rng = random.Random(5)
    misses = [rng.random() < (0.05 if i < 100 else 0.6) for i in range(300)]
    a = sketches.ErrorBudget("goodput", target=0.9, window=50, min_events=5,
                             cooldown=10)
    b = jsketches.ErrorBudget("goodput", target=0.9, window=50,
                              min_events=5, cooldown=10)
    got = [a.observe(m) for m in misses]
    want = [b.observe(m) for m in misses]
    assert got == want and any(got)
    assert a.burn_rate == b.burn_rate
    with pytest.raises(ValueError):
        sketches.ErrorBudget(target=1.0)


def test_jsonl_reads_identical(tmp_path):
    p = tmp_path / "m.jsonl"
    p.write_text('{"a": 1}\n[1, 2]\n\nnot json\n{"b": 2}\n{"torn": ')
    assert jsonl.read_jsonl(str(p)) == jjsonl.read_jsonl(str(p))
    recs, skipped = jsonl.read_jsonl(str(p))
    assert recs == [{"a": 1}, {"b": 2}] and skipped >= 2
    paths = [str(p), str(tmp_path / "missing.jsonl")]
    assert jsonl.read_many(paths) == jjsonl.read_many(paths)


# ---------------------------------------------------------------------------
# goodput
# ---------------------------------------------------------------------------

def _span(name, t, dur, run="r", p=0, inc=0, **attrs):
    return {"kind": "span", "name": name, "t": t, "dur": dur, "run": run,
            "p": p, "inc": inc, **attrs}


def _records():
    """Two processes, a crash and relaunch of process 0, overlapping async
    checkpoint writes, a compile, an eval, a rollback and its retrained
    window, and unattributable gaps."""
    recs = [{"kind": "meta", "t": 0.0, "p": 0, "run": "r", "inc": 0}]
    t = 0.0
    recs.append(_span("compile:train_step[dp]", t, 2.0))
    t = 2.0
    for step in range(12):
        recs.append(_span("load", t, 0.01, step=step))
        recs.append(_span("dispatch", t + 0.01, 0.05, step=step))
        recs.append(_span("fetch", t + 0.06, 0.02, step=step))
        t += 0.1
        if step == 5:
            recs.append(_span("ckpt", t, 0.3, step=step))
            recs.append(_span("ckpt_write", t + 0.1, 1.5, step=step,
                              thread="w"))
            t += 0.3
        if step == 8:
            recs.append(_span("rollback", t, 0.4))
            t += 0.4
    recs.append(_span("eval", t, 0.5))
    t += 2.0                                  # an idle gap, then the crash
    recs.append({"kind": "meta", "t": t + 3.0, "p": 0, "run": "r", "inc": 1})
    t2 = t + 3.0
    for step in range(6, 10):
        recs.append(_span("dispatch", t2, 0.05, step=step, inc=1))
        recs[-1]["inc"] = 1
        t2 += 0.1
    for step in range(8):                     # process 1
        recs.append(_span("dispatch", 0.5 + 0.2 * step, 0.05, p=1,
                          step=step))
    return recs


def test_build_ledger_identical():
    recs = _records()
    sup = [{"kind": "supervisor", "event": "exit", "t": 5.0, "run": "r",
            "inc": 0, "rc": 1},
           {"kind": "supervisor", "event": "launch", "t": 6.0, "run": "r",
            "inc": 1}]
    got = goodput.build_ledger(recs, sup)
    want = jgoodput.build_ledger(recs, sup)
    assert got == want
    assert all(p["sum_ok"] for p in got["processes"])
    assert set(got["fleet"]["categories"]) == set(goodput.CATEGORIES)


def test_ledger_from_dir_identical(tmp_path):
    d = tmp_path / "trace"
    d.mkdir()
    with open(d / "trace-p0-i0.jsonl", "w") as f:
        for r in _records():
            f.write(json.dumps(r) + "\n")
        f.write('{"kind": "span", "name": "dis')       # a torn tail
    assert goodput.ledger_from_dir(str(d)) == \
        jgoodput.ledger_from_dir(str(d))


def test_goodput_meter_snapshot_identical():
    a = goodput.GoodputMeter(now_fn=lambda: 100.0)
    b = jgoodput.GoodputMeter(now_fn=lambda: 100.0)
    spans = [("load", 100.1, 0.05), ("dispatch", 100.15, 0.2),
             ("ckpt_write", 100.2, 0.1), ("fetch", 100.4, 0.05),
             ("eval", 101.0, 0.5), ("dispatch", 102.0, 0.1),
             ("compile:x", 102.2, 1.0), ("rollback", 103.5, 0.2)]
    for name, t, dur in spans:
        a.on_span(name, t, dur, None)
        b.on_span(name, t, dur, None)
    assert a.snapshot(now=110.0) == b.snapshot(now=110.0)


@pytest.mark.parametrize("args", [
    (2e12, 1e9, 0.05, 0.002, 989e12, 3.35e12),
    (1e9, None, 0.01, 0.0, 1e11, 5e10),
    (None, 1e9, 0.01, 0.0, 1e11, 5e10),
    (5e13, 4e12, 0.2, 0.01, 989e12, 3.35e12),
])
def test_step_anatomy_identical(args):
    assert goodput.step_anatomy(*args) == jgoodput.step_anatomy(*args)


def test_goodput_record_identical():
    snap = goodput.GoodputMeter(now_fn=lambda: 50.0).snapshot(now=60.0)
    ident = {"process_id": 0, "run_id": "r", "incarnation": 2}
    anat = goodput.step_anatomy(1e12, None, 0.05, 0.001, 989e12, 3.35e12)
    assert goodput.goodput_record(snap, "train", 13, ident, anat, 1.5) == \
        jgoodput.goodput_record(snap, "train", 13, ident, anat, 1.5)


def test_peak_bytes_h100_rows(monkeypatch):
    monkeypatch.delenv(goodput.BW_ENV_VAR, raising=False)
    assert goodput.peak_bytes_per_s("NVIDIA H100 80GB HBM3", "cuda") == \
        3.35e12
    assert goodput.peak_bytes_per_s("NVIDIA H100 PCIe", "cuda") == 2.0e12
    assert goodput.peak_bytes_per_s("NVIDIA H100 80GB HBM3", "cpu") == \
        goodput.NOMINAL_CPU_BW == jgoodput.NOMINAL_CPU_BW
    assert goodput.peak_bytes_per_s("some other card", "cuda") == \
        goodput.NOMINAL_CPU_BW
    monkeypatch.setenv(goodput.BW_ENV_VAR, "1e12")
    assert goodput.peak_bytes_per_s("NVIDIA H100 80GB HBM3", "cuda") == 1e12
    # the taxonomy is JAX's, in JAX's order
    assert goodput.CATEGORIES == jgoodput.CATEGORIES
    assert goodput.PRIORITY == jgoodput.PRIORITY
    assert goodput.SPAN_CATEGORY == jgoodput.SPAN_CATEGORY
    assert not math.isnan(goodput.SUM_TOL)
