"""The port's training telemetry against the JAX package's, on the CPU:
the on-device step metrics (``train/telemetry.py``, ``with_metrics`` on
every layout the port has), the flight recorder's postmortems, the
heartbeat and the supervisor's watch of it, the analytic FLOPs and the
peak table, and the watchdog's last act before exit 42.

Mirrors ``tests/test_telemetry.py``.  Tolerances: the metrics records of
both Trainers, from the same params (JAX's init, copied into the port)
over the same batches, agree within ``METRICS_RTOL`` = 1e-5 relative in
f32 (``loss``, ``grad_norm``, ``param_norm``, ``update_ratio``); the
``skipped`` counter and the record steps exactly; the port's own runs
with telemetry on and off bitwise; the FLOPs exactly.
"""

import dataclasses
import json
import math
import os
import pathlib
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.models.registry import (
    build_model as jax_build_model,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import (
    make_mesh,
)
from neural_networks_parallel_training_with_mpi_tpu.train import (
    telemetry as jtelemetry,
)
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import config
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.registry import (
    build_model,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (
    LocalSeqGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
    resilience as res,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
    telemetry,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
    trainer as trainer_mod,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (
    leaves,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.watchdog import (
    HangWatchdog,
)

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = "neural_networks_parallel_training_with_mpi_tpu_torch"
METRICS_RTOL = 1e-5
METRIC_VALUES = ("loss", "grad_norm", "param_norm", "update_ratio")
# the recorded update norm against one recomputed from a copy: the same
# differences, reduced by _foreach_norm vs linalg.vector_norm (f32
# reduction order)
NORM_RTOL = 1e-6
# a host norm (f64-accumulated leaf norms) against the exact f64 norm
HOST_NORM_RTOL = 1e-6


def _mlp_job(pkg, **kw):
    """The regression MLP (8 -> 32 -> 32 -> 1), Adam at lr 1e-2, 4 steps
    an epoch, in either package's config classes."""
    base = dict(nepochs=2, batch_size=8, full_batch=False, shuffle=True,
                lr=1e-2, optimizer="adam", metrics_every=1,
                data=pkg.DataConfig(dataset="regression", n_samples=32,
                                    n_features=8),
                model=pkg.ModelConfig(arch="mlp", in_features=8,
                                      hidden=(32, 32), out_features=1))
    base.update(kw)
    return pkg.TrainConfig(**base)


def _lm_job(pkg, **kw):
    """The small LM (2 layers, d_model 32) with Adam, 2 steps an epoch."""
    base = dict(nepochs=2, batch_size=4, full_batch=False, shuffle=True,
                lr=3e-3, optimizer="adam", metrics_every=1,
                loss="cross_entropy",
                data=pkg.DataConfig(dataset="lm", n_samples=8, seq_len=32,
                                    vocab_size=64),
                model=pkg.ModelConfig(arch="transformer", n_layers=2,
                                      d_model=32, n_heads=4, d_ff=64,
                                      vocab_size=64, max_seq_len=32))
    base.update(kw)
    return pkg.TrainConfig(**base)


def _records(d, kind="step"):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if kind is None or r.get("kind") == kind]


def _jax_run(jcfg, mesh):
    """(JAX's init params, its fit result, the trainer)."""
    jt = JaxTrainer(jcfg, mesh=mesh)
    jt.init_state()
    init = jax.device_get(jt.state.params)
    return init, jt.fit(), jt


def _port_trainer(cfg, init, **kw):
    """A port Trainer whose init is JAX's params."""
    t = Trainer(cfg, device="cpu", **kw)
    if cfg.model.arch == "transformer":
        fn = lambda gen: params_from_jax(init, t.model.cfg, "cpu")  # noqa
    else:
        fn = lambda gen: tree_from_jax(init, "cpu")  # noqa
    object.__setattr__(t.model, "init", fn)     # a frozen dataclass
    return t


def _assert_records_match(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert g["skipped"] == w["skipped"], g["step"]
        for k in METRIC_VALUES:
            np.testing.assert_allclose(g[k], w[k], rtol=METRICS_RTOL,
                                       atol=0, err_msg=f"{k} @ {g['step']}")
        # the same keys (timing keys from the second record on)
        assert set(g) == set(w), (set(g) ^ set(w))


# ---------------------------------------------------------------------------
# the metrics against JAX's, per record, on every ported layout
# ---------------------------------------------------------------------------

LAYOUTS = {
    "dp": dict(),
    "zero1": dict(update_sharding="zero1"),
    "sharded": dict(update_sharding="sharded"),
    "k3": dict(steps_per_dispatch=3),
    "guard": dict(skip_nonfinite=True, faults="nan@2"),
    "sgd_clip": dict(optimizer="sgd", momentum=0.9, grad_clip=0.05,
                     update_sharding="sharded"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_metrics_match_jax(layout, tmp_path, mesh1):
    kw = LAYOUTS[layout]
    init, jres, jt = _jax_run(
        _mlp_job(jconfig, telemetry_dir=str(tmp_path / "jax"), **kw), mesh1)
    t = _port_trainer(
        _mlp_job(config, telemetry_dir=str(tmp_path / "port"), **kw), init)
    r = t.fit()
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert len(got) == (4 if layout == "k3" else 8)
    _assert_records_match(got, want)
    np.testing.assert_allclose(r["final_loss"], jres["final_loss"],
                               rtol=METRICS_RTOL)
    if layout == "k3":      # dispatches end at steps 3, 4, 7, 8
        assert [x["step"] for x in got] == [3, 4, 7, 8]
    if layout == "guard":   # the CUMULATIVE counter, and one skip event
        assert [x["skipped"] for x in got] == [0, 0, 1, 1, 1, 1, 1, 1]
        assert t.telemetry.skipped_total == jt.telemetry.skipped_total == 1
        skips = [e for e in t.telemetry.recorder.records
                 if e.get("event") == "skip"]
        assert [(e["step"], e["fires"]) for e in skips] == [(3, 1)]
    assert r["mfu"] > 0 and "mfu" in jres


def test_lm_metrics_match_jax(tmp_path, mesh1):
    """The transformer LM (dense attention, the chunked CE head) through
    both Trainers: every record's metrics within 1e-5."""
    kw = dict(model=dataclasses.replace(_lm_job(config).model, ce_chunk=8))
    jkw = dict(model=dataclasses.replace(_lm_job(jconfig).model, ce_chunk=8))
    init, _, _ = _jax_run(
        _lm_job(jconfig, telemetry_dir=str(tmp_path / "jax"), **jkw), mesh1)
    t = _port_trainer(
        _lm_job(config, telemetry_dir=str(tmp_path / "port"), **kw), init)
    t.fit()
    _assert_records_match(_records(tmp_path / "port"),
                          _records(tmp_path / "jax"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """JAX's 2-device runs of the child's jobs, then the port's 2 gloo
    ranks (``tests/torch_telemetry_child.py``) from JAX's init."""
    from neural_networks_parallel_training_with_mpi_tpu.models.registry import (
        build_model as jbuild,
    )
    from neural_networks_parallel_training_with_mpi_tpu.utils import (
        prng as jprng,
    )

    sys.path.insert(0, str(REPO / "tests"))
    try:
        from torch_telemetry_child import TWO_RANK_LAYOUTS, two_rank_job
    finally:
        sys.path.pop(0)
    tmp = tmp_path_factory.mktemp("telemetry_two_ranks")
    init = {k: jax.device_get(jbuild(two_rank_job(
        jconfig, layout, None).model).init(jprng.init_key(0)))
        for k, layout in (("mlp", "replicated"), ("lm", "sp2"))}
    with open(tmp / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    devices = jax.devices("cpu")[:2]
    for layout in TWO_RANK_LAYOUTS:
        jcfg = two_rank_job(jconfig, layout, str(tmp / f"jax_{layout}"))
        # the JAX Trainer's own init is ``init`` (the seed's key)
        JaxTrainer(jcfg, mesh=make_mesh(jcfg.mesh, devices=devices)).fit()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("NNPT_FAULTS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_telemetry_child.py"),
         str(r), "2", str(tmp)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return tmp, sorted(TWO_RANK_LAYOUTS)


@pytest.mark.parametrize("layout", ["replicated", "sharded",
                                    "sharded_guard", "sp2", "zero1"])
def test_two_rank_metrics_match_jax_two_devices(two_ranks, layout):
    """Over 2 data ranks the zero1 and sharded norms come from each rank's
    slices, summed over the ranks; over 1 data x 2 seq ranks
    (``ProcessSeqGroup``, ring_flash) the norms are taken after the data x
    seq all-reduce: every record within 1e-5 of JAX's 2-device run."""
    tmp, _ = two_ranks
    _assert_records_match(_records(tmp / f"port_{layout}"),
                          _records(tmp / f"jax_{layout}"))


def test_seq_metrics_over_local_seq_group_match_jax_seq2(tmp_path, devices):
    """The DP x SP step over ``LocalSeqGroup(2)`` (ring_flash: the flash
    plain versions per ring block) against JAX's data=1 x seq=2 mesh: the
    norms are taken after the data x seq reduction, so they match."""
    mesh = make_mesh(jconfig.MeshConfig(seq=2), devices=devices[:2])

    def cfg(pkg, d):
        c = _lm_job(pkg, telemetry_dir=str(d))
        return dataclasses.replace(
            c, mesh=pkg.MeshConfig(data=1, seq=2), model=dataclasses.replace(
                c.model, attention="ring_flash"))

    init, _, _ = _jax_run(cfg(jconfig, tmp_path / "jax"), mesh)
    t = _port_trainer(cfg(config, tmp_path / "port"), init,
                      seq_group=LocalSeqGroup(2))
    t.fit()
    _assert_records_match(_records(tmp_path / "port"),
                          _records(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# pure observation: bitwise equal with telemetry and tracing on and off
# ---------------------------------------------------------------------------

BITWISE = {
    "dp": dict(),
    "guard": dict(skip_nonfinite=True, faults="nan@3"),
    "zero1": dict(update_sharding="zero1"),
    "sharded": dict(update_sharding="sharded"),
    "master": dict(update_sharding="sharded", master_weights=True,
                   param_dtype="bfloat16"),
    "master_guard": dict(update_sharding="sharded", master_weights=True,
                         param_dtype="bfloat16", skip_nonfinite=True,
                         faults="nan@3"),
    "sgd_k3": dict(optimizer="sgd", momentum=0.9, steps_per_dispatch=3),
    "adamw": dict(optimizer="adamw", weight_decay=0.1),
}


def _bits(t):
    t = t.detach()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
        if t.is_floating_point() else t


@pytest.mark.parametrize("layout", sorted(BITWISE))
def test_state_bitwise_equal_with_telemetry_on_and_off(layout, tmp_path):
    runs = []
    for on in (False, True):
        extra = (dict(telemetry_dir=str(tmp_path / "t"), trace=True,
                      rollup_every=3) if on else {})
        t = Trainer(_mlp_job(config, **BITWISE[layout], **extra),
                    device="cpu")
        r = t.fit()
        runs.append((r["final_loss"],
                     leaves((t.state.params, t.state.opt_state))))
    assert runs[0][0] == runs[1][0] or (math.isnan(runs[0][0])
                                        and math.isnan(runs[1][0]))
    assert len(runs[0][1]) == len(runs[1][1])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    recs = _records(tmp_path / "t")
    assert recs and all(k in recs[-1] for k in telemetry.METRIC_KEYS)


def test_update_norm_is_the_norm_of_new_minus_old():
    """An update's ``deltas`` list (recorded by its own write) against a
    copy of the old params: ||new - old|| for every optimizer form, and the
    written bits equal to an unrecorded update's."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        optim,
    )

    gen = torch.Generator().manual_seed(0)

    def tree(dtype=torch.float32):
        return {"a": torch.randn(5, 3, generator=gen).to(dtype),
                "b": [torch.randn(7, generator=gen).to(dtype)]}

    forms = {
        "adam": (optim.adam(1e-2, steps=4), torch.float32),
        "sgd": (optim.sgd(1e-1, momentum=0.9, steps=4), torch.float32),
        "guard": (optim.with_skip_guard(optim.adam(1e-2, steps=4)),
                  torch.float32),
        "master": (optim.with_master_weights(optim.adam(1e-2, steps=4)),
                   torch.bfloat16),
        "bf16": (optim.adam(1e-2, steps=4), torch.bfloat16),
    }
    for name, (opt, dtype) in forms.items():
        p0, g = tree(dtype), tree()
        plain, rec = ({k: (v.clone() if k == "a" else [v[0].clone()])
                       for k, v in p0.items()} for _ in range(2))
        s_plain, s_rec = opt.init(plain), opt.init(rec)
        old = [x.clone().float() for x in leaves(rec)]
        opt.update(g, s_plain, plain)
        deltas = []
        opt.update(g, s_rec, rec, deltas=deltas)
        for a, b in zip(leaves(plain), leaves(rec)):
            assert torch.equal(_bits(a), _bits(b)), name
        want = [torch.linalg.vector_norm(n.float() - o)
                for n, o in zip(leaves(rec), old)]
        assert len(deltas) == len(want), name
        # (the host accumulates them in f64: ops.optim.leaf_norms)
        torch.testing.assert_close(torch.stack(deltas).float(),
                                   torch.stack(want), rtol=NORM_RTOL, atol=0)
    # a rejected step records 0 and writes nothing
    opt = optim.with_skip_guard(optim.adam(1e-2, steps=4))
    p, g = tree(), tree()
    g["a"][0, 0] = float("nan")
    before = [x.clone() for x in leaves(p)]
    deltas = []
    opt.update(g, opt.init(p), p, deltas=deltas)
    assert all(float(d) == 0.0 for d in deltas)
    assert all(torch.equal(_bits(a), _bits(b))
               for a, b in zip(before, leaves(p)))


def test_host_norms_keep_f32_precision_at_the_lm_head_size():
    """The CPU's f32 norm reduction drifts on a 32768 x 1024 leaf (the
    flagship's LM head); the port's norms on the host accumulate in f64,
    so the grad and param norms the host reports are within 1e-6 of the
    exact one (f64 here, as the card's f32 tree reduction reads it)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        optim,
    )

    x = torch.randn(32768, 1024, generator=torch.Generator().manual_seed(0))
    x.mul_(0.02)
    exact = float(torch.linalg.vector_norm(x.double()))
    got = float(optim.global_norm({"head": x, "b": [torch.ones(3)]}))
    want = math.sqrt(exact ** 2 + 3.0)
    assert abs(got - want) / want < HOST_NORM_RTOL


# ---------------------------------------------------------------------------
# records, heartbeat, rollups, goodput; flags
# ---------------------------------------------------------------------------

def test_stream_heartbeat_rollups_and_goodput(tmp_path):
    d = str(tmp_path / "t")
    t = Trainer(_mlp_job(config, telemetry_dir=d, trace=True,
                         rollup_every=3), device="cpu")
    r = t.fit()
    recs = _records(d, kind=None)
    steps = [x for x in recs if x["kind"] == "step"]
    assert len(steps) == r["steps"] == 8
    assert all(x["grad_norm"] > 0 and x["param_norm"] > 0 and
               x["update_ratio"] >= 0 for x in steps)
    assert all("mfu" in x and "step_time_ms" in x and "samples_per_sec" in x
               for x in steps[1:])
    # steps 3 and 6 cross the cadence, and the final flush writes one more
    rollups = [x for x in recs if x["kind"] == "rollup"]
    goodput = [x for x in recs if x["kind"] == "goodput"]
    assert [x["step"] for x in rollups] == [x["step"] for x in goodput] \
        == [3, 6, 8]
    assert set(rollups[-1]["sketches"]) >= {"loss", "grad_norm"}
    assert goodput[-1]["categories"]["step"] > 0
    assert abs(sum(goodput[-1]["categories"].values())
               - goodput[-1]["covered_s"]) < 1e-4
    hb = telemetry.read_heartbeat(os.path.join(d, "heartbeat.json"))
    assert hb["step"] == 8 and hb["final"] is True
    assert res.heartbeat_age_s(os.path.join(
        d, "heartbeat-train-p0.json")) < 60
    assert not os.path.exists(os.path.join(d, "postmortem.json"))


def test_heartbeat_only_mode_final_step(tmp_path):
    d = str(tmp_path / "t")
    t = Trainer(_mlp_job(config, telemetry_dir=d, metrics_every=0),
                device="cpu")
    r = t.fit()
    assert not t.telemetry_metrics
    assert _records(d, kind=None) == []
    hb = telemetry.read_heartbeat(d)
    assert hb["step"] == r["steps"] == 8 and hb["final"] is True


OBS_FLAGS = {"telemetry_dir": "--telemetry_dir",
             "metrics_every": "--metrics_every",
             "flight_recorder": "--flight_recorder",
             "rollup_every": "--rollup_every", "alerts": "--no-alerts",
             "trace": "--trace", "trace_dir": "--trace_dir",
             "goodput": "--no-goodput", "goodput_target": "--goodput_target",
             "profile_dir": "--profile_dir",
             "xla_trace_dir": "--xla_trace_dir"}


@pytest.mark.parametrize("field", sorted(OBS_FLAGS))
def test_observability_flags_are_ported(field, tmp_path):
    """The eleven flags left the unported table: each parses as the JAX
    CLI parses it, and a Trainer is built with it."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
        trace,
    )

    assert field not in trainer_mod._UNPORTED
    flag = OBS_FLAGS[field]
    args = {"alerts": [flag], "goodput": [flag],
            "trace": ["--telemetry_dir", str(tmp_path / "t"), flag],
            "metrics_every": [flag, "2"], "flight_recorder": [flag, "8"],
            "rollup_every": [flag, "4"], "goodput_target": [flag, "0.7"],
            }.get(field, [flag, str(tmp_path / field)])
    cfg = config.config_from_args(config.build_argparser().parse_args(args))
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        args))
    assert getattr(cfg, field) == getattr(jcfg, field) != getattr(
        config.TrainConfig(), field)
    trainer_mod.refuse_unported(cfg)
    t = Trainer(cfg, device="cpu")
    t.telemetry.close()
    if t.tracer is not None:
        trace.stop_run(t.tracer)


def test_trace_needs_a_directory():
    with pytest.raises(ValueError, match="--trace needs --telemetry_dir"):
        Trainer(_mlp_job(config, trace=True), device="cpu")


# ---------------------------------------------------------------------------
# flight recorder postmortems
# ---------------------------------------------------------------------------

def _pm(d):
    with open(os.path.join(d, "postmortem.json")) as f:
        return json.load(f)


def test_postmortem_on_rollback_straddles(tmp_path):
    d = str(tmp_path / "t")
    t = Trainer(_mlp_job(config, nepochs=6, skip_nonfinite=True,
                         rollback_after=2, max_rollbacks=2,
                         checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=4, faults="nan@10-12?max=3",
                         telemetry_dir=d), device="cpu")
    r = t.fit()
    assert r["rollbacks"] == 1
    pm = _pm(d)
    assert pm["reason"] == "rollback"
    ri = [i for i, x in enumerate(pm["records"])
          if x.get("event") == "rollback"]
    assert ri
    assert any(x.get("kind") == "step" for x in pm["records"][:ri[0]])
    assert any(x.get("kind") == "step" for x in pm["records"][ri[0] + 1:])
    assert any(x.get("event") == "skip" for x in pm["records"])


def test_postmortem_on_sigterm(tmp_path):
    d = str(tmp_path / "t")
    r = Trainer(_mlp_job(config, nepochs=10,
                         checkpoint_dir=str(tmp_path / "ck"),
                         faults="sigterm@7", telemetry_dir=d),
                device="cpu").fit()
    assert r.get("preempted") is True
    pm = _pm(d)
    assert pm["reason"].startswith("sigterm")
    assert any(x.get("event") == "sigterm" for x in pm["records"])


def test_postmortem_on_crash_exception(tmp_path):
    d = str(tmp_path / "t")
    t = Trainer(_mlp_job(config, nepochs=4, telemetry_dir=d), device="cpu")
    real, calls = t.train_step, []

    def exploding(state, batch):
        calls.append(1)
        if len(calls) == 6:
            raise RuntimeError("synthetic device loss")
        return real(state, batch)

    t.train_step = exploding
    with pytest.raises(RuntimeError, match="synthetic"):
        t.fit()
    pm = _pm(d)
    assert pm["reason"].startswith("crash: RuntimeError")
    assert any(x.get("kind") == "step" for x in pm["records"])
    assert telemetry._ACTIVE is None     # closed on the error path


def test_postmortem_on_anomaly_abort(tmp_path):
    d = str(tmp_path / "t")
    with pytest.raises(res.AnomalyAbort):
        Trainer(_mlp_job(config, nepochs=8, skip_nonfinite=True,
                         rollback_after=2, max_rollbacks=0,
                         checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=2, faults="nan@7-999",
                         telemetry_dir=d), device="cpu").fit()
    assert _pm(d)["reason"] == "anomaly_abort"


def test_flight_recorder_ring_is_bounded(tmp_path):
    d = str(tmp_path / "t")
    Trainer(_mlp_job(config, nepochs=4, flight_recorder=5,
                     faults="sigterm@14", telemetry_dir=d),
            device="cpu").fit()
    assert _pm(d)["n_records"] <= 5


# ---------------------------------------------------------------------------
# FLOPs and the peak table
# ---------------------------------------------------------------------------

FLOPS_MODELS = {
    "mlp": dict(arch="mlp", in_features=8, hidden=(32, 16), out_features=3),
    "dense": dict(arch="transformer", n_layers=2, d_model=64, n_heads=4,
                  d_ff=128, vocab_size=256, max_seq_len=64),
    "gqa": dict(arch="transformer", n_layers=2, d_model=64, n_heads=8,
                n_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64),
    "swiglu": dict(arch="transformer", n_layers=3, d_model=64, n_heads=4,
                   d_ff=96, vocab_size=256, max_seq_len=64,
                   activation="swiglu"),
}


@pytest.mark.parametrize("name", sorted(FLOPS_MODELS))
def test_train_step_flops_equal_jax(name):
    kw = FLOPS_MODELS[name]
    shape = (4, 8) if kw["arch"] == "mlp" else (4, 64)
    want = jtelemetry.train_step_flops(
        jax_build_model(jconfig.ModelConfig(**kw)), shape)
    got = telemetry.train_step_flops(
        build_model(config.ModelConfig(**kw), device="cpu"), shape)
    assert got == want and got > 0


def test_peak_table_h100_rows_and_overrides(monkeypatch):
    monkeypatch.delenv(telemetry.PEAK_ENV_VAR, raising=False)
    assert telemetry.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert telemetry.peak_flops_per_chip("NVIDIA H100 PCIe") == 756e12
    assert telemetry.peak_flops_per_chip("cpu") is None
    assert telemetry.telemetry_peak_flops(
        "NVIDIA H100 80GB HBM3", "cuda") == 989e12
    assert telemetry.telemetry_peak_flops("cpu", "cpu") == \
        telemetry.NOMINAL_CPU_PEAK_FLOPS == jtelemetry.NOMINAL_CPU_PEAK_FLOPS
    monkeypatch.setenv(telemetry.PEAK_ENV_VAR, "5e12")
    assert telemetry.telemetry_peak_flops("NVIDIA H100 80GB HBM3",
                                          "cuda") == 5e12


# ---------------------------------------------------------------------------
# the watchdog's last act, and the supervisor's heartbeat watch
# ---------------------------------------------------------------------------

def test_watchdog_on_timeout_runs_once_and_never_raises(capsys):
    calls, exits = [], []

    def boom():
        calls.append(1)
        raise RuntimeError("dump failed")

    wd = HangWatchdog(0.2, _exit=exits.append, on_timeout=boom)
    with wd:
        wd.pat()
        deadline = time.monotonic() + 10
        while not exits and time.monotonic() < deadline:
            time.sleep(0.02)
    assert exits == [42] and calls == [1]
    assert "on_timeout failed: RuntimeError: dump failed" in \
        capsys.readouterr().err


def test_watchdog_hang_writes_the_postmortem(tmp_path, monkeypatch):
    """Through the Trainer: the watchdog's hang dumps ``postmortem.json``
    with reason ``hang`` before its exit (injected: no real exit)."""
    exits = []
    real = HangWatchdog.__init__

    def init(self, timeout_s, _exit=None, on_timeout=None):
        real(self, timeout_s, _exit=exits.append, on_timeout=on_timeout)

    monkeypatch.setattr(HangWatchdog, "__init__", init)
    d = str(tmp_path / "t")
    t = Trainer(_mlp_job(config, nepochs=1, hang_timeout=0.3,
                         faults="slow@2?ms=1500", telemetry_dir=d),
                device="cpu")
    t.fit()
    assert exits and exits[0] == 42
    pm = _pm(d)
    assert pm["reason"] == "hang"
    assert any(x.get("event") == "emergency" for x in pm["records"])


def test_supervise_kills_stale_heartbeat_child(tmp_path):
    hb = tmp_path / "heartbeat-train-p0.json"
    hb.write_text("{}")     # a leftover: does not arm the watch
    child = ("import pathlib, time\n"
             "time.sleep(0.3)\n"
             f"pathlib.Path({str(hb)!r}).write_text('{{}}')\n"
             "time.sleep(60)\n")
    logs = []
    rc = res.supervise([sys.executable, "-c", child], max_restarts=0,
                       backoff=0.0, log=logs.append,
                       heartbeat_path=str(hb), heartbeat_timeout=1.0,
                       _sleep=lambda s: None)
    assert rc == res.EXIT_HANG == 42
    assert any("heartbeat stale" in m for m in logs)


def test_supervise_retries_a_stale_child_as_42(tmp_path):
    """The stale child's 42 is a retry: the second attempt completes."""
    hb = tmp_path / "hb.json"
    mark = tmp_path / "first"
    child = ("import pathlib, time, sys\n"
             f"m = pathlib.Path({str(mark)!r})\n"
             f"pathlib.Path({str(hb)!r}).write_text('{{}}')\n"
             "if not m.exists():\n"
             "    m.write_text('x'); time.sleep(60)\n")
    logs = []
    rc = res.supervise([sys.executable, "-c", child], max_restarts=1,
                       backoff=0.0, log=logs.append,
                       heartbeat_path=str(hb), heartbeat_timeout=1.0,
                       _sleep=lambda s: None)
    assert rc == 0
    assert any("child exit 42 (watchdog hang)" in m for m in logs)


def test_supervise_exempts_warm_up_from_the_watch(tmp_path):
    hb = tmp_path / "hb.json"
    child = ("import time, pathlib\n"
             "time.sleep(2.5)\n"
             f"pathlib.Path({str(hb)!r}).write_text('{{}}')\n")
    rc = res.supervise([sys.executable, "-c", child], max_restarts=0,
                       backoff=0.0, heartbeat_path=str(hb),
                       heartbeat_timeout=1.0, _sleep=lambda s: None)
    assert rc == 0


def test_supervise_stamps_identity_annotates_alerts_and_logs_events(
        tmp_path):
    out = tmp_path / "ids.txt"
    metrics = tmp_path / "metrics.jsonl"
    pm = tmp_path / "postmortem.json"
    events = tmp_path / "events.jsonl"
    child = ("import os, json, pathlib, sys\n"
             f"o = pathlib.Path({str(out)!r})\n"
             "inc = os.environ['NNPT_INCARNATION']\n"
             "with open(o, 'a') as f:\n"
             "    f.write(os.environ['NNPT_RUN_ID'] + ' ' + inc + '\\n')\n"
             f"with open({str(metrics)!r}, 'a') as f:\n"
             "    f.write(json.dumps({'kind': 'alert', 'alert': 'loss_spike'})"
             " + '\\n')\n"
             f"pathlib.Path({str(pm)!r}).write_text('{{}}')\n"
             "sys.exit(0 if inc == '1' else 3)\n")
    logs = []
    env = dict(os.environ, NNPT_RUN_ID="job-7")
    rc = res.supervise([sys.executable, "-c", child], max_restarts=2,
                       backoff=0.0, log=logs.append, env=env,
                       alerts_path=str(metrics), postmortem_path=str(pm),
                       events_path=str(events), _sleep=lambda s: None)
    assert rc == 0
    assert out.read_text().split("\n")[:2] == ["job-7 0", "job-7 1"]
    assert any("1 telemetry alert(s) during this child: loss_spike x1" in m
               for m in logs)
    assert sum("child left a postmortem" in m for m in logs) == 1
    ev = [json.loads(x) for x in events.read_text().splitlines()]
    assert [(e["event"], e["inc"]) for e in ev] == [
        ("launch", 0), ("exit", 0), ("relaunch", 1), ("launch", 1),
        ("exit", 1)]
    assert all(e["run"] == "job-7" for e in ev)


def _clean_env():
    env = dict(os.environ)
    env.pop("NNPT_FAULTS", None)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_cli_supervised_crash_leaves_a_postmortem(tmp_path):
    """The injected os._exit crash dumps the flight recorder first; the
    supervisor's log points at it; the relaunch resumes and completes
    with the final heartbeat at the last step."""
    d = tmp_path / "t"
    proc = subprocess.run(
        [sys.executable, "-m", PKG, "--platform", "cpu", "--n_samples", "32",
         "--batch_size", "8", "--no-full-batch", "--nepochs", "4",
         "--checkpoint_dir", str(tmp_path / "ck"), "--checkpoint_every", "3",
         "--telemetry_dir", str(d), "--hang_timeout", "30",
         "--faults", f"crash@9?once={tmp_path / 'crashed'}",
         "--supervise", "2", "--supervise_backoff", "0.1"],
        capture_output=True, text=True, timeout=300, env=_clean_env(),
        cwd=REPO)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-3000:]
    assert "injected crash at step 9" in text
    assert "child left a postmortem" in text
    assert _pm(d)["reason"].startswith("crash@9")
    hb = telemetry.read_heartbeat(str(d / "heartbeat.json"))
    assert hb["step"] == 16 and hb["final"] is True
    ev = [json.loads(x) for x in
          (d / "supervisor-events.jsonl").read_text().splitlines()]
    assert [e["event"] for e in ev] == ["launch", "exit", "relaunch",
                                        "launch", "exit"]
