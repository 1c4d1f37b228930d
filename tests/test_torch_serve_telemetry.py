"""The port's serving telemetry and tracing against the JAX package's.

Both packages' schedulers run the same requests with ``telemetry_dir``
and ``trace_dir`` under a virtual clock the test advances once per tick,
with deadlines that most requests miss.  Then:

* the ``metrics.jsonl`` record kinds come in the same sequence;
* ``kind="serve"`` records are equal (``t`` and ``tokens_per_sec``, host
  wall-clock readings, left out), ``kind="serve_req"`` records equal
  (``t`` left out; the latencies come from the virtual clock);
* ``kind="rollup"`` records carry equal counters and the same ttft, itl
  and total sketches; the SLO ``kind="alert"`` fires on the same rid;
* the role-qualified heartbeat files have the same names;
* the traces hold the same tick spans (admit/prefill/decode/retire: name
  and tick) and flows (id, phase, rid, stage); the wall-clock gap spans
  (queue_wait, sched_bubble) and JAX's compile spans are left out;
* ``tools/metrics_summary.py --json`` and ``tools/obs_agg.py --json``
  read the port's directory.
"""

import glob
import json
import os
import pathlib
import subprocess
import sys

import pytest

from neural_networks_parallel_training_with_mpi_tpu.serve import (
    Scheduler as JaxScheduler,
    ServeConfig as JaxServeConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
    Scheduler,
    ServeConfig,
)
from test_torch_serve import _blocking, _models
from test_torch_serve_disagg import VClock

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent
# 24 requests: the SLO budget needs 20 events before it may alert; the
# goodput budget needs 5 rollups, and 3 cadence rollups plus the final
# one stay under that (the goodput fraction reads the wall clock)
N_REQ = 24
REQUESTS = [([1 + i % 7, 2 + i % 3, 3, 4 + i % 5][: 1 + i % 4], 2 + i % 5)
            for i in range(N_REQ)]
CFG = dict(slots=4, num_blocks=24, block_size=4, prefill_chunk=4,
           metrics_every=3, rollup_every=20, default_slo_ms=4.0)


def _run(pkg, tmp, role="unified", requests=REQUESTS, **over):
    """One drain with telemetry and tracing on; returns (scheduler, the
    metrics records, the trace records, the telemetry dir)."""
    jm, jp, model, params = _models()
    tdir, trdir = str(tmp / pkg / "t"), str(tmp / pkg / "trace")
    cfg = dict(CFG, telemetry_dir=tdir, trace_dir=trdir, role=role, **over)
    clock = VClock()
    if pkg == "jax":
        sched = _blocking(JaxScheduler(jm, jp, JaxServeConfig(**cfg),
                                       now_fn=clock))
    else:
        sched = Scheduler(model, params, ServeConfig(**cfg), now_fn=clock,
                          device="cpu")
    for p, n in requests:
        assert sched.submit(p, n) is not None
    while sched.queue or sched.in_flight():
        sched.tick()
        sched.take_handoffs()
        clock.advance()
    sched.close()
    with open(os.path.join(tdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    trace = []
    for path in sorted(glob.glob(os.path.join(trdir, "trace-*.jsonl"))):
        with open(path) as f:
            trace += [json.loads(line) for line in f]
    return sched, records, trace, tdir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_telemetry")
    return {pkg: _run(pkg, tmp) for pkg in ("jax", "port")}


def _of(records, kind, drop=()):
    return [{k: v for k, v in r.items() if k not in drop}
            for r in records if r["kind"] == kind]


def test_record_kinds_come_in_the_same_sequence(runs):
    kinds = {pkg: [r["kind"] for r in recs]
             for pkg, (_, recs, _, _) in runs.items()}
    assert kinds["port"] == kinds["jax"]
    assert set(kinds["port"]) == {"serve", "serve_req", "rollup", "alert",
                                  "goodput"}


def test_serve_and_request_records_equal(runs):
    j, p = runs["jax"][1], runs["port"][1]
    drop = ("t", "tokens_per_sec")
    assert _of(p, "serve", drop) == _of(j, "serve", drop)
    reqs = _of(p, "serve_req", ("t",))
    assert reqs == _of(j, "serve_req", ("t",))
    assert len(reqs) == N_REQ
    assert all(0 <= r["ttft_ms"] <= r["total_ms"] for r in reqs)
    assert max(r["total_ms"] for r in reqs) > 0
    final = _of(p, "serve")[-1]
    assert final["final"] and final["completed"] == N_REQ
    assert final["handed_off"] == final["injected"] == 0
    assert "prefill_chunks" not in final and "decode_steps" not in final


def test_rollups_carry_equal_counters_and_sketches(runs):
    j, p = _of(runs["jax"][1], "rollup"), _of(runs["port"][1], "rollup")
    assert len(p) == len(j) >= 2
    for a, b in zip(p, j):
        assert a["counters"] == b["counters"]
        assert a["role"] == b["role"] == "serve"
        assert a["step"] == b["step"] and a["p"] == b["p"]
        for key in ("ttft_ms", "itl_ms", "total_ms", "queue_depth",
                    "block_utilization"):
            assert a["sketches"].get(key) == b["sketches"].get(key), key
    assert p[-1]["counters"]["requests"] == N_REQ
    assert p[-1]["counters"]["deadline_missed"] > 0
    gp = _of(runs["port"][1], "goodput")
    assert gp and gp[-1]["role"] == "serve" and gp[-1]["spans"] > 0


def test_slo_alert_on_the_same_rid(runs):
    j, p = _of(runs["jax"][1], "alert"), _of(runs["port"][1], "alert")
    assert p and [a["rid"] for a in p] == [a["rid"] for a in j]
    drop = ("t", "t_unix")
    assert [{k: v for k, v in a.items() if k not in drop} for a in p] == \
        [{k: v for k, v in a.items() if k not in drop} for a in j]
    assert p[0]["alert"] == "slo_burn_rate" and p[0]["role"] == "serve"


def test_heartbeat_names_equal(runs):
    names = {pkg: sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(tdir, "heartbeat*.json")))
        for pkg, (_, _, _, tdir) in runs.items()}
    assert names["port"] == names["jax"] == ["heartbeat-serve-p0.json"]
    with open(os.path.join(runs["port"][3], names["port"][0])) as f:
        hb = json.load(f)
    assert hb["final"] and hb["step"] == runs["port"][0].tick_no


# the tick's phases; the gap spans read the wall clock, and the JAX
# package's compile spans have no counterpart in the port
TICK_SPANS = ("admit", "prefill", "decode", "retire")


def _spans_and_flows(trace):
    spans = [(r["name"], r.get("tick")) for r in trace
             if r["kind"] == "span" and r["name"] in TICK_SPANS]
    flows = [(r["id"], r["fph"], r.get("rid"), r.get("stage"))
             for r in trace if r["kind"] == "flow"]
    return spans, flows


def test_spans_and_flows_equal(runs):
    jspans, jflows = _spans_and_flows(runs["jax"][2])
    pspans, pflows = _spans_and_flows(runs["port"][2])
    assert pspans == jspans and pflows == jflows
    assert {n for n, _ in pspans} == set(TICK_SPANS)
    chain = [f for f in pflows if f[2] == 0]
    assert chain[0][1:] == ("s", 0, "admit")
    assert chain[-1][1:] == ("f", 0, "retire")
    assert chain[0][0] == "p0-r0"


def _tool(name, *args):
    proc = subprocess.run([sys.executable, str(REPO / "tools" / name),
                           *args], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout)


def test_tools_read_the_ports_directory(runs):
    tdir = runs["port"][3]
    summary = _tool("metrics_summary.py", tdir, "--json")
    assert summary["serving"]["requests"] == N_REQ
    fleet = _tool("obs_agg.py", tdir, "--json")
    assert fleet["roles"]["serve"]["counters"]["requests"] == N_REQ


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_role_qualified_records_and_heartbeats(tmp_path, role):
    """A role scheduler's records, heartbeat and trace against JAX's: a
    prefill side hands every stream off (its TTFT lands in the rollup
    sketch, no serve_req); a decode side serves plain submits."""
    reqs = REQUESTS[:6]
    out = {pkg: _run(pkg, tmp_path, role=role, requests=reqs,
                     rollup_every=5)
           for pkg in ("jax", "port")}
    (js, j, jt, jdir), (ps, p, pt, pdir) = out["jax"], out["port"]
    assert [r["kind"] for r in p] == [r["kind"] for r in j]
    drop = ("t", "tokens_per_sec")
    assert _of(p, "serve", drop) == _of(j, "serve", drop)
    assert [r["counters"] for r in _of(p, "rollup")] == \
        [r["counters"] for r in _of(j, "rollup")]
    assert _of(p, "rollup")[-1]["sketches"]["ttft_ms"] == \
        _of(j, "rollup")[-1]["sketches"]["ttft_ms"]
    assert {r["role"] for r in _of(p, "rollup") + _of(p, "goodput")} == \
        {f"serve-{role}"}
    assert _spans_and_flows(pt) == _spans_and_flows(jt)
    names = [sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(d, "heartbeat*.json"))) for d in (jdir, pdir)]
    assert names[1] == names[0] == [f"heartbeat-serve-{role}-p0.json"]
    if role == "prefill":
        assert ps.handed_off == len(reqs) - sum(n == 1 for _, n in reqs)
        assert not _of(p, "serve_req")
    else:
        assert len(_of(p, "serve_req")) == len(reqs)
    assert ps.load_report()["now"]["role"] == role
