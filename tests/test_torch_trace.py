"""The port's host-side tracing and compile ledger against the JAX
package's, on the CPU: the span API (``train/trace.py``), the ledger
(``utils/compile_ledger.py``: signature events of eager steps, one event
per CUDA-graph capture), the Trainer's span taxonomy, and the repo's
tools reading the port's directories as they read JAX's.

Mirrors ``tests/test_trace.py``'s non-serve, non-RL tests.  The CUDA
graph itself runs only on the card (``chip_smoke.py`` phase 20); here
``GraphedTrainStep``'s control flow runs over stand-ins for the stream
and graph objects, which is what the ledger's event count depends on.
Nothing here compares floats: spans, events and record keys are held
exactly.
"""

import contextlib
import glob
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.train import (
    trace as jtrace,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    compile_ledger as jledger,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import config
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import qmm
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    data_parallel as dp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train import trace
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer, _into,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    compile_ledger as ledger,
)

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = "neural_networks_parallel_training_with_mpi_tpu_torch"


@pytest.fixture(autouse=True)
def _clean_trace_state():
    """No installed tracer or ledger (process-global) and no inherited
    identity env, before and after."""
    saved = {k: os.environ.pop(k, None)
             for k in (trace.RUN_ID_ENV, trace.INCARNATION_ENV,
                       trace.PROCESS_ID_ENV, "RANK")}
    yield
    trace.stop_run()
    ledger.install(None)
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v


def _spans(trace_dir, name=None):
    out = []
    for path in glob.glob(os.path.join(trace_dir, "trace-*.jsonl")):
        for line in open(path):
            rec = json.loads(line)
            if rec.get("kind") == "span" and (name is None
                                              or rec["name"] == name):
                out.append(rec)
    return out


def _compiles(trace_dir):
    out = []
    for path in glob.glob(os.path.join(trace_dir, "compiles-*.jsonl")):
        out.extend(json.loads(line) for line in open(path))
    return out


# ---------------------------------------------------------------------------
# span API
# ---------------------------------------------------------------------------

def test_span_records_identity_and_bounds(tmp_path):
    os.environ[trace.RUN_ID_ENV] = "r-abc"
    os.environ[trace.INCARNATION_ENV] = "3"
    tracer = trace.start_run(str(tmp_path), max_events=5)
    assert os.path.basename(tracer.path) == "trace-p0-i3.jsonl"
    for i in range(8):
        with trace.span("dispatch", step=i):
            pass
    trace.instant("mark", why="x")
    trace.flow("req", 7, "s")
    trace.stop_run()
    recs = [json.loads(line) for line in open(tracer.path)]
    spans = [r for r in recs if r["kind"] == "span"]
    assert len(spans) == 5
    assert all(r["run"] == "r-abc" and r["inc"] == 3 and r["p"] == 0
               for r in spans)
    footer = recs[-1]
    assert footer["kind"] == "meta" and footer["dropped"] == 5


def test_span_is_noop_when_uninstalled_and_listeners_hear_spans(tmp_path):
    assert trace.active() is None
    with trace.span("anything", x=1):
        pass
    assert trace.active() is None
    heard = []
    listener = lambda *a: heard.append(a[0])  # noqa: E731
    trace.add_listener(listener)
    try:
        trace.start_run(str(tmp_path))
        with trace.span("load"):
            pass
        it = trace.traced_iter("load", iter([1, 2]))
        assert list(it) == [1, 2]
    finally:
        trace.remove_listener(listener)
    assert heard == ["load"] * 4     # two items and the final next()


def test_run_identity_env_then_rank_then_zero(monkeypatch):
    assert trace.run_identity()["process_id"] == 0
    monkeypatch.setenv("RANK", "3")
    assert trace.run_identity()["process_id"] == 3
    monkeypatch.setenv(trace.PROCESS_ID_ENV, "5")
    monkeypatch.setenv(trace.RUN_ID_ENV, "job")
    monkeypatch.setenv(trace.INCARNATION_ENV, "2")
    assert trace.run_identity() == {"process_id": 5, "run_id": "job",
                                    "incarnation": 2}
    monkeypatch.delenv(trace.PROCESS_ID_ENV)
    monkeypatch.setenv(jtrace.PROCESS_ID_ENV, "5")
    assert jtrace.PROCESS_ID_ENV == trace.PROCESS_ID_ENV


@pytest.mark.parametrize("args,want", [
    (dict(trace=True, telemetry_dir="/tmp/run"), "/tmp/run/trace"),
    (dict(trace_dir="/tmp/y"), "/tmp/y"),
    (dict(), None),
])
def test_dir_from_config_matches_jax(args, want):
    from neural_networks_parallel_training_with_mpi_tpu.config import (
        TrainConfig as JaxTrainConfig,
    )

    cfg = config.TrainConfig(**args)
    assert trace.dir_from_config(cfg) == want == jtrace.dir_from_config(
        JaxTrainConfig(**args))


# ---------------------------------------------------------------------------
# the ledger: eager signatures
# ---------------------------------------------------------------------------

def test_ledger_records_one_event_per_signature(tmp_path):
    trace.start_run(str(tmp_path))
    fn = ledger.instrument(lambda x: x * 2.0, "double")
    assert float(fn(torch.ones(4, 8))[0, 0]) == 2.0
    fn(torch.ones(4, 8))
    events = ledger.active().events
    assert len(events) == 1
    e = events[0]
    assert e["name"] == "double" and e["n_compile"] == 1
    assert e["signature"] == {"[0]": "float32[4,8]"}
    assert "compile_ms" not in e and "signature-only" in e["note"]
    trace.stop_run()
    assert len(_compiles(str(tmp_path))) == 1


def test_deliberate_shape_change_names_changed_component(tmp_path):
    """A new signature names WHICH component changed, as JAX's ledger
    does for the same calls (same paths, same strings)."""
    trace.start_run(str(tmp_path))
    fn = ledger.instrument(lambda s, b: (s, b.sum()), "step")
    s = torch.zeros(())
    fn(s, torch.ones(4, 8))
    fn(s, torch.ones(4, 16))
    fn(s, torch.ones(4, 16, dtype=torch.bfloat16))
    ev = ledger.active().events
    assert [e["n_compile"] for e in ev] == [1, 2, 3]
    assert ev[1]["changed"] == {"[1]": {"from": "float32[4,8]",
                                        "to": "float32[4,16]"}}
    assert ev[2]["changed"] == {"[1]": {"from": "float32[4,16]",
                                        "to": "bfloat16[4,16]"}}
    jtrace.start_run(str(tmp_path / "jax"))
    try:
        jfn = jledger.instrument(jax.jit(lambda s, b: (s, b.sum())), "step")
        js = jax.numpy.zeros(())
        jfn(js, jax.numpy.ones((4, 8)))
        jfn(js, jax.numpy.ones((4, 16)))
        jfn(js, jax.numpy.ones((4, 16), jax.numpy.bfloat16))
        jev = jledger.active().events
    finally:
        jtrace.stop_run()
    for a, b in zip(ev, jev):
        assert a["signature"] == b["signature"]
        assert a.get("changed") == b.get("changed")


def test_ledger_passthrough_without_install():
    calls = []

    def fake(x):
        calls.append(x)
        return x

    fn = ledger.instrument(fake, "fake")
    assert fn(7) == 7 and calls == [7]
    assert ledger.instrument(fn, "renamed") is fn and fn.name == "renamed"
    assert ledger.record_capture("x", 1, {}, None, 0.1, None) is None


def test_trainer_signature_paths_equal_jax(tmp_path, mesh1):
    """The train step's first event: the port's state + batch paths are
    JAX's (``[0].params['blocks'][0]['attn_out']['w']``, ...); only the
    host step counter differs (a Python int in the port)."""
    from neural_networks_parallel_training_with_mpi_tpu import (
        config as jconfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
        Trainer as JaxTrainer,
    )

    flags = ["--dataset", "lm", "--no-full-batch", "--batch_size", "4",
             "--nepochs", "1", "--n_samples", "8", "--seq_len", "16",
             "--vocab_size", "32", "--n_layers", "1", "--d_model", "16",
             "--n_heads", "2", "--d_ff", "32", "--optimizer", "adam"]
    runs = {}
    for name, mod in (("jax", jconfig), ("port", config)):
        d = str(tmp_path / name)
        cfg = mod.config_from_args(mod.build_argparser().parse_args(
            flags + ["--trace_dir", d]))
        t = (JaxTrainer(cfg, mesh=mesh1) if name == "jax"
             else Trainer(cfg, device="cpu"))
        t.fit()
        runs[name] = [e for e in _compiles(d)
                      if e["name"].startswith("train_step")]
    j, p = runs["jax"][0], runs["port"][0]
    assert j["name"] == p["name"] == "train_step[dp]"
    assert set(j["signature"]) == set(p["signature"])
    diff = {k for k in j["signature"]
            if j["signature"][k] != p["signature"][k]}
    assert diff == {"[0].step"} and p["signature"]["[0].step"] == "py:int"
    assert len(runs["port"]) == 1


# ---------------------------------------------------------------------------
# the ledger: CUDA-graph captures (the graph objects stood in for)
# ---------------------------------------------------------------------------

class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    replays = 0

    def replay(self):
        type(self).replays += 1


@contextlib.contextmanager
def _null_ctx(*args, **kwargs):
    yield


@pytest.fixture
def fake_graphs(monkeypatch):
    """``GraphedTrainStep``'s stream and graph calls as stand-ins: the
    capture runs the step eagerly and a replay runs nothing, so only the
    control flow (and the ledger's events) is under test."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", _null_ctx)
    monkeypatch.setattr(torch.cuda, "graph", _null_ctx)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(qmm, "fp8_dot_supported", lambda d: None)
    return types.SimpleNamespace(type="cuda")


def test_one_capture_event_per_capture_none_per_replay_or_rollback(
        tmp_path, fake_graphs):
    trace.start_run(str(tmp_path))
    t = Trainer(config.TrainConfig(
        nepochs=1, batch_size=8, full_batch=False, optimizer="adam",
        telemetry_dir=str(tmp_path / "t"),
        data=config.DataConfig(n_samples=64)), device="cpu")
    t.init_state()
    g = dp.GraphedTrainStep(t.train_step.wrapped, fake_graphs,
                            name="train_step[dp]",
                            flops=lambda b: 100.0 * b["x"].shape[0],
                            static={"layout": "dp"})
    batches = list(t.loader.epoch(0))
    state, out = g(t.state, batches[:3])        # warm-up, capture, replay
    assert set(out) >= {"loss", "grad_norm", "update_ratio"}
    state, _ = g(state, batches[3:6])           # replays only
    assert (g.captures, g.replays) == (1, 5)
    # a rollback copies a snapshot INTO the captured tensors
    _into(state, t._fresh_state()[0])
    state, _ = g(state, batches[6:8])
    short = {k: v[:4] for k, v in batches[0].items()}
    state, _ = g(state, [short])                # another shape: eager
    assert g.captures == 1 and g.eager_steps == 2
    events = ledger.active().events
    assert len(events) == 1
    e = events[0]
    assert e["name"] == "train_step[dp]" and e["n_compile"] == 1
    assert e["program"] == "cuda_graph" and e["flops"] == 800.0
    assert e["bytes_accessed"] is None and e["capture_s"] >= 0
    assert len(e["fingerprint_sha256"]) == 64
    assert e["signature"]["[1]['x']"] == "float32[8,2]"
    # a resume's state holds other tensors: captured anew, same
    # signature and fingerprint, nothing "changed"
    fresh = t._fresh_state()[0]
    g(fresh, [batches[0]])
    # a new state whose first batch has another shape: the changed
    # component is named
    g(t._fresh_state()[0], [short])
    events = ledger.active().events
    assert [x["n_compile"] for x in events] == [1, 2, 3]
    assert "changed" not in events[1]
    assert events[1]["fingerprint_sha256"] == e["fingerprint_sha256"]
    assert events[2]["changed"]["[1]['x']"] == {"from": "float32[8,2]",
                                                "to": "float32[4,2]"}
    trace.stop_run()
    assert [r["n_compile"] for r in _compiles(str(tmp_path))] == [1, 2, 3]
    assert len(_spans(str(tmp_path), "compile:train_step[dp]")) == 3
    t.telemetry.close()


# ---------------------------------------------------------------------------
# the Trainer's spans
# ---------------------------------------------------------------------------

def test_trainer_span_taxonomy(tmp_path):
    d = tmp_path / "run"
    t = Trainer(config.TrainConfig(
        nepochs=2, batch_size=8, full_batch=False, lr=0.005, eval_every=1,
        telemetry_dir=str(d), trace=True, async_checkpoint=True,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4,
        data=config.DataConfig(dataset="regression", n_samples=40,
                               val_fraction=0.2)), device="cpu")
    r = t.fit()
    assert np.isfinite(r["final_loss"])
    tdir = str(d / "trace")
    names = {s["name"] for s in _spans(tdir)}
    assert {"load", "dispatch", "fetch", "ckpt", "ckpt_write",
            "eval"} <= names
    fetches = {s.get("what") for s in _spans(tdir, "fetch")}
    assert {"metrics", "log"} <= fetches
    ev = _compiles(tdir)
    assert [e["name"] for e in ev] == ["train_step[dp]", "eval_step[dp]"]


def test_rollback_span_and_no_new_ledger_event(tmp_path):
    d = tmp_path / "run"
    t = Trainer(config.TrainConfig(
        nepochs=6, batch_size=8, full_batch=False, lr=1e-3,
        skip_nonfinite=True, rollback_after=2, max_rollbacks=2,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4,
        faults="nan@10-12?max=3", telemetry_dir=str(d), trace=True,
        data=config.DataConfig(n_samples=32)), device="cpu")
    assert t.fit()["rollbacks"] == 1
    tdir = str(d / "trace")
    assert len(_spans(tdir, "rollback")) == 1
    assert len([e for e in _compiles(tdir)
                if e["name"].startswith("train_step")]) == 1


# ---------------------------------------------------------------------------
# the tools read the port's directories as they read JAX's
# ---------------------------------------------------------------------------

CLI_FLAGS = ["--dataset", "lm", "--no-full-batch", "--batch_size", "8",
             "--nepochs", "1", "--seq_len", "32", "--n_samples", "32",
             "--d_model", "32", "--n_heads", "4", "--d_ff", "64",
             "--optimizer", "adam", "--trace"]


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    env.pop("NNPT_FAULTS", None)
    return env


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """The acceptance command through both CLIs (JAX's on the CPU, the
    port's with ``--platform cpu``): their telemetry directories."""
    tmp = tmp_path_factory.mktemp("cli")
    out = {}
    for name, pkg, extra in (
            ("jax", "neural_networks_parallel_training_with_mpi_tpu", []),
            ("port", PKG, ["--platform", "cpu"])):
        d = tmp / name
        proc = subprocess.run(
            [sys.executable, "-m", pkg, *CLI_FLAGS, *extra,
             "--telemetry_dir", str(d)], cwd=REPO, env=_env(),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[name] = d
    return out


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_cli_records_match_jax_in_keys_and_kinds(cli_dirs):
    d = cli_dirs["port"]
    assert (d / "metrics.jsonl").exists()
    assert (d / "heartbeat-train-p0.json").exists()
    assert (d / "trace" / "trace-p0-i0.jsonl").exists()
    recs = {n: _jsonl(cli_dirs[n] / "metrics.jsonl") for n in cli_dirs}
    kinds = {n: [r["kind"] for r in recs[n]] for n in recs}
    assert kinds["port"] == kinds["jax"]
    assert kinds["port"] == ["step"] * 4
    for a, b in zip(recs["port"], recs["jax"]):
        assert set(a) == set(b), (a["kind"], set(a) ^ set(b))
    hb = {n: json.loads((cli_dirs[n] / "heartbeat-train-p0.json").read_text())
          for n in cli_dirs}
    assert set(hb["port"]) == set(hb["jax"])
    spans = {n: {(r["kind"], r.get("name")) for r in _jsonl(
        cli_dirs[n] / "trace" / "trace-p0-i0.jsonl")} for n in cli_dirs}
    # JAX's first step is a compile span; the port's eager step has none
    assert spans["port"] == spans["jax"] - {("span",
                                             "compile:train_step[dp]")}


TOOLS = {
    "metrics_summary": lambda d: [str(d), "--json"],
    "trace_report": lambda d: [str(d / "trace"), "--json", "--no-chrome"],
    "goodput_report": lambda d: [str(d / "trace"), "--json"],
    "obs_agg": lambda d: [str(d), "--json"],
}


def _keys(doc, depth=2):
    if not isinstance(doc, dict) or depth == 0:
        return set()
    out = set(doc)
    for k, v in doc.items():
        out |= {f"{k}.{x}" for x in _keys(v, depth - 1)}
    return out


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tools_render_the_port_dirs_like_jax(tool, cli_dirs):
    docs = {}
    for name, d in cli_dirs.items():
        proc = subprocess.run(
            [sys.executable, str(REPO / "tools" / f"{tool}.py"),
             *TOOLS[tool](d)], cwd=REPO, env=_env(), capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, (name, proc.stderr[-2000:])
        docs[name] = json.loads(proc.stdout)
    # the same fields, whatever the values (run ids, process paths and
    # the compile group JAX's first step has differ)
    volatile = ("compiles.", "groups.", "processes.", "runs.", "by_run.",
                "per_process.", "identities.", "fleet.per_")
    strip = lambda keys: {k for k in keys  # noqa: E731
                          if not any(v in k for v in volatile)}
    assert strip(_keys(docs["port"])) == strip(_keys(docs["jax"]))


def test_supervised_crash_merges_incarnations(tmp_path):
    """A supervised crash and relaunch with ``--trace``: two incarnations
    of one run id, merged by ``tools/trace_report.py`` into one timeline,
    and the goodput report prices the gap as ``relaunch_gap``."""
    d = tmp_path / "t"
    proc = subprocess.run(
        [sys.executable, "-m", PKG, "--platform", "cpu", "--n_samples", "32",
         "--batch_size", "8", "--no-full-batch", "--nepochs", "4",
         "--checkpoint_dir", str(tmp_path / "ck"), "--checkpoint_every", "3",
         "--telemetry_dir", str(d), "--trace",
         "--faults", f"crash@9?once={tmp_path / 'crashed'}",
         "--supervise", "1", "--supervise_backoff", "0.1"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    assert "child left a postmortem" in proc.stderr
    tdir = d / "trace"
    assert sorted(os.path.basename(p) for p in glob.glob(
        str(tdir / "trace-*.jsonl"))) == ["trace-p0-i0.jsonl",
                                          "trace-p0-i1.jsonl"]
    runs = {json.loads(open(p).readline())["run"]
            for p in glob.glob(str(tdir / "trace-*.jsonl"))}
    assert len(runs) == 1
    rep = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "trace_report.py"),
                          str(tdir), "--json"], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stderr
    assert json.loads((tdir / "trace.json").read_text())["traceEvents"]
    summary = json.loads(rep.stdout)
    assert len(summary["runs"]) == 1
    assert sorted(g["incarnation"] for g in summary["groups"]) == [0, 1]
    assert len(summary["relaunch_gaps"]) == 1
    gp = subprocess.run([sys.executable, str(REPO / "tools" /
                                             "goodput_report.py"),
                         str(tdir), "--json"], cwd=REPO, env=_env(),
                        capture_output=True, text=True, timeout=120)
    assert gp.returncode == 0, gp.stderr
    assert json.loads(gp.stdout)["fleet"]["categories"]["relaunch_gap"] > 0
