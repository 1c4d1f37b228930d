"""The port's elastic resume and capacity floor against the JAX package's,
on the CPU: exits 46, ``degrade_env``, ``supervise``'s elastic branch (side
by side with the JAX package's jax-free ``supervise`` on scripted exit
codes and probes), the probes, ``consumed_samples``/``start_for_samples``,
the cross-world reshard of the sharded optimizer state (2 -> 1 -> 2 gloo
ranks of ``tests/torch_sdc_child.py``, bitwise round trip; the JAX
package's elastic restore of the port's 2-rank snapshot), the batch
policies, the topology record, and a real degraded relaunch.

Mirrors ``tests/test_elastic.py``.  Everything compared here is exact:
exit codes, environments, step numbers, batch sizes and snapshot arrays.
"""

import dataclasses
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.data.loader import (
    ShardedLoader as JaxLoader,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import (
    make_mesh,
)
from neural_networks_parallel_training_with_mpi_tpu.train import (
    resilience as jres,
)
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    checkpoint as jckpt,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    ckpt_manifest as jmanifest,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import (
    config as pconfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (
    ShardedLoader,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    distributed,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
    resilience as res,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (
    TrainState,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    ckpt_manifest,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    faults,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_sdc_child import elastic_job  # noqa: E402

pytestmark = pytest.mark.torch_port

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
CHILD = os.path.join(ROOT, "tests", "torch_sdc_child.py")
PKG = "neural_networks_parallel_training_with_mpi_tpu_torch"
LAYOUTS = ("zero1", "sharded")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------- exit-code contract


def test_exit_capacity_pinned():
    assert res.EXIT_CAPACITY == jres.EXIT_CAPACITY == 46
    assert res.EXIT_CAPACITY in res._NO_RETRY
    assert set(res._PEER_LOSS_CODES) == set(jres._PEER_LOSS_CODES) == {42, 43}
    assert set(res._NO_RETRY) == set(jres._NO_RETRY)


def test_strip_supervisor_flags_keeps_elastic():
    argv = ["--elastic", "--min_devices", "2", "--supervise", "3",
            "--supervise_backoff_max=5", "--supervise_backoff", "1",
            "--lr", "0.1"]
    assert res.strip_supervisor_flags(argv) == \
        jres.strip_supervisor_flags(argv) == [
            "--elastic", "--min_devices", "2", "--lr", "0.1"]


def test_degrade_env():
    env = {"MASTER_ADDR": "h", "MASTER_PORT": "1", "RANK": "0",
           "WORLD_SIZE": "4", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "4",
           "NNPT_PREFLIGHT_PORT": "2", "KEEP": "x"}
    out = res.degrade_env(env, {"n_processes": 1, "n_devices": 2})
    assert out is env
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE", "NNPT_PREFLIGHT_PORT"):
        assert k not in out
    assert out["NNPT_PROCESS_ID"] == "0"
    assert out[res.DEGRADED_ENV] == "2" and out["KEEP"] == "x"
    with pytest.raises(ValueError, match="n_processes=2") as e:
        res.degrade_env({"WORLD_SIZE": "4"},
                        {"n_processes": 2, "n_devices": 4})
    with pytest.raises(ValueError) as ej:
        jres.degrade_env({"NNPT_NUM_PROCESSES": "4"},
                         {"n_processes": 2, "n_devices": 4})
    assert str(e.value) == str(ej.value)


# ----------------------------------------- supervise, side by side with JAX


def _jax_env(port_env):
    """The JAX package's world channel for a port launcher environment."""
    if port_env is None:
        return None
    out = {}
    if "MASTER_ADDR" in port_env:
        out["COORDINATOR_ADDRESS"] = (f"{port_env['MASTER_ADDR']}:"
                                      f"{port_env.get('MASTER_PORT', '')}")
    if "WORLD_SIZE" in port_env:
        out["NNPT_NUM_PROCESSES"] = port_env["WORLD_SIZE"]
    if "RANK" in port_env:
        out["NNPT_PROCESS_ID"] = port_env["RANK"]
    return out


def _world(env, port):
    """(rendezvous set, process count, rank, degraded) of a child env."""
    if port:
        return ("MASTER_ADDR" in env, env.get("WORLD_SIZE", "1"),
                env.get("RANK", env.get("NNPT_PROCESS_ID")),
                env.get(res.DEGRADED_ENV))
    return ("COORDINATOR_ADDRESS" in env, env.get("NNPT_NUM_PROCESSES", "1"),
            env.get("NNPT_PROCESS_ID"), env.get(jres.DEGRADED_ENV))


def _run_supervise(mod, code_seq, probe_answers, env, **kw):
    """``mod.supervise`` with a scripted child and probe: (rc, logs, child
    worlds, delays, probe calls)."""
    codes, answers = iter(code_seq), iter(probe_answers)
    envs, delays, logs, probes = [], [], [], []

    def fake_call(cmd, env=None):
        envs.append(dict(env))
        return next(codes)

    def probe():
        probes.append(1)
        return next(answers)

    orig = mod.subprocess.call
    mod.subprocess.call = fake_call
    try:
        rc = mod.supervise(["x"], log=logs.append, _sleep=delays.append,
                           _rand=lambda: 0.5, probe=probe, env=env,
                           **{"max_restarts": 5, "backoff": 1.0, **kw})
    finally:
        mod.subprocess.call = orig
    return (rc, logs, [_world(e, mod is res) for e in envs], delays,
            len(probes))


_MULTI0 = {"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "2",
           "RANK": "0"}
_DEGRADED2 = {"n_processes": 1, "n_devices": 2, "local_devices": 2,
              "degraded": True}
_SCENARIOS = {
    "degrade_after_streak": ([43, 42, 0], [_DEGRADED2], _MULTI0,
                             dict(elastic=True, min_devices=1)),
    "lone_loss_never_probes": ([43, 1, 43, 0], [_DEGRADED2], {},
                               dict(elastic=True)),
    "fence_nonzero_rank": ([43] * 6, [], {**_MULTI0, "RANK": "1"},
                           dict(elastic=True)),
    "fence_unknown_rank": ([43] * 6, [],
                           {k: v for k, v in _MULTI0.items() if k != "RANK"},
                           dict(elastic=True)),
    "single_process_world_degrades": ([43, 43, 0], [_DEGRADED2], {},
                                      dict(elastic=True)),
    "probe_failure_retries_same_world": ([43, 43, 0], [None], _MULTI0,
                                         dict(elastic=True)),
    "capacity_exhaustion_exits_46": (
        [43, 43], [{"n_processes": 1, "n_devices": 1, "local_devices": 1,
                    "degraded": True}] * 4, {},
        dict(elastic=True, min_devices=4, max_restarts=4)),
    "parked_probe_failure_keeps_parking": (
        [43, 43], [{"n_processes": 1, "n_devices": 1, "degraded": True},
                   None, {"n_processes": 1, "n_devices": 1,
                          "degraded": True}, None], {},
        dict(elastic=True, min_devices=2)),
    "grow_back": ([43, 43, 43, 43, 0],
                  [{"n_processes": 1, "n_devices": 1, "degraded": True},
                   {"n_processes": 2, "n_devices": 2, "degraded": False}],
                  _MULTI0, dict(elastic=True)),
    "no_retry_46": ([46], [], {}, dict(elastic=False)),
    "no_retry_45": ([45], [], {}, dict(elastic=True)),
}
_PHRASES = ("fenced from degraded relaunch", "DEGRADED world",
            "capacity shortfall", "exiting 46 (capacity abort)",
            "grow-back", "retrying at the current world", "not retrying",
            "no topology answer (probe failed)", "giving up")


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_supervise_elastic_branch_matches_jax(name):
    """The same exit codes and probe answers through both packages'
    ``supervise``: the same final exit code, child worlds, backoff delays,
    probe calls and policy decisions in the log."""
    codes, answers, env, kw = _SCENARIOS[name]
    got = _run_supervise(res, codes, answers, dict(env), **kw)
    want = _run_supervise(jres, codes, answers, _jax_env(env), **kw)
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[4] == want[4]
    for phrase in _PHRASES:
        assert (any(phrase in m for m in got[1])
                == any(phrase in m for m in want[1])), phrase


def test_supervise_fence_names_the_missing_rank():
    _, logs, _, _, _ = _run_supervise(
        res, [43] * 6, [], {k: v for k, v in _MULTI0.items()
                            if k != "RANK"}, elastic=True)
    assert any("rank unknown (no RANK)" in m for m in logs)


# ------------------------------------------------------------- probes


def test_default_probe_reports_local_topology():
    got = res.default_probe(timeout_s=120, env={})
    assert got == {"n_processes": 1, "n_devices": 1, "local_devices": 1,
                   "degraded": False}
    assert res.default_probe(timeout_s=120, env={"WORLD_SIZE": "2"})[
        "degraded"] is True


def test_probe_world_dead_world_degrades_locally(monkeypatch):
    """A launcher world whose peer never answers: within the probe's
    bound, this host alone, degraded; no launcher world: not degraded."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    logs = []
    t0 = time.monotonic()
    got = distributed.probe_world(timeout_s=2.0, log=logs.append)
    assert got == {"n_processes": 1, "n_devices": 1, "local_devices": 1,
                   "degraded": True}
    assert any("probing local topology" in m for m in logs)
    assert time.monotonic() - t0 < 90
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k)
    assert distributed.probe_world(timeout_s=2.0)["degraded"] is False


# ------------------------------------------------- data-order continuity


def test_consumed_samples_and_inverse_match_jax(mesh8):
    data = {"x": np.random.randn(64, 2).astype(np.float32),
            "y": np.random.randn(64, 1).astype(np.float32)}
    for bs in (8, 16, 24):
        ld = ShardedLoader(data, batch_size=bs, device="cpu")
        jld = JaxLoader(mesh8, data, batch_size=bs)
        for step in (0, 3, 8, 11, 20):
            assert ld.consumed_samples(step) == jld.consumed_samples(step)
        for samples in (0, 24, 40, 64, 64 + 24, 130):
            assert ld.start_for_samples(samples) == \
                jld.start_for_samples(samples)
    ld8 = ShardedLoader(data, batch_size=8, device="cpu")
    for step in (0, 3, 8, 11):
        ep, st = ld8.start_for_samples(ld8.consumed_samples(step))
        assert ep * ld8.steps_per_epoch + st == step
    drop = ShardedLoader(data, batch_size=24, device="cpu", remainder="drop")
    jdrop = JaxLoader(mesh8, data, batch_size=24, remainder="drop")
    assert drop.start_for_samples(60) == jdrop.start_for_samples(60) == (1, 0)


def test_same_epoch_permutation_across_batch_sizes():
    data = {"x": np.arange(64, dtype=np.float32).reshape(64, 1),
            "y": np.zeros((64, 1), np.float32)}
    a = ShardedLoader(data, batch_size=8, device="cpu")
    b = ShardedLoader(data, batch_size=16, device="cpu")
    a.order_salt = b.order_salt = 1234
    np.testing.assert_array_equal(a._epoch_order(3), b._epoch_order(3))


# ------------------------------------------- cross-world resharding


def _spawn(tmp, suite):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop(faults.ENV_VAR, None)
    procs = [subprocess.Popen(
        [sys.executable, CHILD, suite, str(r), "2", str(tmp)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-4000:]
        with open(tmp / f"{suite}_out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _npz(d):
    step = ckpt.latest_step(str(d))
    with np.load(pathlib.Path(d) / f"ckpt-{step}" / "state.npz") as z:
        return [z[f"leaf_{i}"] for i in range(
            sum(k.startswith("leaf_") for k in z.files))]


@pytest.fixture(scope="module")
def reshard(tmp_path_factory):
    """2 ranks train and save each layout; one process resumes each
    snapshot with --elastic and saves it again (dp=1); 2 ranks resume
    that and save it again."""
    tmp = tmp_path_factory.mktemp("elastic")
    saved = _spawn(tmp, "elastic_save")
    one = {}
    for layout in LAYOUTS:
        t = Trainer(elastic_job(pconfig, layout, str(tmp / f"{layout}_dp2"),
                                1, resume=True, elastic=True), device="cpu")
        t.init_state()
        step = t.maybe_resume()
        t.cfg = dataclasses.replace(t.cfg,
                                    checkpoint_dir=str(tmp / f"{layout}_dp1"))
        t.save()
        one[layout] = dict(step=step, host=[a for _, a, _ in
                                            ckpt.host_state(t.state)],
                           change=t._topology_change, cfg=t.cfg)
    grown = _spawn(tmp, "elastic_grow")
    return dict(tmp=tmp, saved=saved, one=one, grown=grown)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_shrink_and_grow_back_round_trip_bitwise(reshard, layout):
    """2 -> 1 -> 2 at the padded width: the opt state re-pads (zeros
    only move), and the snapshot the 2 ranks write after the round trip
    equals the one they wrote first, leaf for leaf, bitwise."""
    tmp = reshard["tmp"]
    assert reshard["one"][layout]["step"] == 4
    assert [o[layout] for o in reshard["grown"]] == [4, 4]
    first, back = _npz(tmp / f"{layout}_dp2"), _npz(tmp / f"{layout}_back")
    assert len(first) == len(back)
    for a, b in zip(first, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the 1-rank snapshot holds the unpadded (replicated-width) arrays
    one = _npz(tmp / f"{layout}_dp1")
    assert any(a.shape != b.shape for a, b in zip(first, one))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_jax_elastic_restore_reads_the_ports_two_rank_snapshot(reshard,
                                                               layout):
    """The JAX package's restore(..., elastic=True) of the port's 2-rank
    snapshot into a 1-device template gives the port's 1-rank arrays."""
    d = reshard["tmp"] / f"{layout}_dp2"
    cfg = elastic_job(jconfig, layout, None, 1)
    t = JaxTrainer(cfg, mesh=make_mesh(cfg.mesh,
                                       devices=jax.devices("cpu")[:1]))
    t.init_state()
    template = jax.device_get(t.state)
    (d / f"ckpt-{jckpt.latest_step(str(d))}" / "treedef.pkl").write_bytes(
        pickle.dumps(jax.tree_util.tree_structure(template)))
    got = jckpt.restore(str(d), template, elastic=True)
    want = reshard["one"][layout]["host"]
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(got)]
    assert len(jl) == len(want)
    for a, b in zip(jl, want):
        np.testing.assert_array_equal(a, b)


def test_cross_world_snapshot_refused_without_elastic(reshard):
    t = Trainer(elastic_job(pconfig, "zero1",
                            str(reshard["tmp"] / "zero1_dp2"), 1,
                            resume=True), device="cpu")
    t.init_state()
    with pytest.raises(ValueError, match="--elastic"):
        t.maybe_resume()


def test_repad_restricted_to_the_opt_state(tmp_path):
    """A 1-D param of another length refuses even with elastic: only the
    optimizer state's padding may move."""
    import torch

    world = {"saved_world": {"dp": 4, "update_sharding": "zero1"}}
    ckpt.save(str(tmp_path), TrainState(3, {"b": torch.arange(4.0)},
                                        {"m": torch.arange(8.0)}),
              extra_meta=world)
    out = ckpt.restore(str(tmp_path), TrainState(
        0, {"b": torch.zeros(4)}, {"m": torch.zeros(12)}), elastic=True)
    np.testing.assert_array_equal(out.opt_state["m"].numpy(),
                                  np.r_[np.arange(8.0), np.zeros(4)])
    with pytest.raises(ValueError, match="wrong model config"):
        ckpt.restore(str(tmp_path), TrainState(
            0, {"b": torch.zeros(6)}, {"m": torch.zeros(8)}), elastic=True)
    with pytest.raises(ValueError, match="--elastic"):
        ckpt.restore(str(tmp_path), TrainState(
            0, {"b": torch.zeros(4)}, {"m": torch.zeros(12)}))


def test_repad_axis_matches_jax():
    buf = np.array([1., 2., 3., 0., 0., 0.], np.float32)
    m = np.zeros((4, 3), np.float32)
    m[:2] = 1.0
    for arr, shape in ((buf, (4,)), (buf, (8,)), (m, (2, 3)), (m, (6, 3))):
        np.testing.assert_array_equal(ckpt._repad_axis(arr, shape, 0),
                                      jckpt._repad_axis(arr, shape, 0))
    for arr, shape in ((np.array([1., 2., 3., 4.], np.float32), (3,)),
                       (np.ones((4, 3), np.float32), (2, 3))):
        with pytest.raises(ValueError, match="nonzero"):
            ckpt._repad_axis(arr, shape, 0)


def test_saved_world_recorded_and_lineage_not_shadowed(reshard):
    """The 1-rank saves carry saved_world dp=1 AND the original dp=2 as
    restored_world; the audit line renders both as JAX's does."""
    meta = ckpt.read_meta(str(reshard["tmp"] / "zero1_dp2"))
    assert meta["saved_world"]["dp"] == 2
    assert meta["saved_world"]["n_devices"] == 2
    assert meta["consumed_samples"] == 64
    assert "restored_world" not in meta
    man = json.loads((reshard["tmp"] / "zero1_dp2" / "ckpt-4" /
                      ckpt_manifest.MANIFEST).read_text())
    assert man["saved_world"]["dp"] == 2
    meta1 = ckpt.read_meta(str(reshard["tmp"] / "zero1_dp1"))
    assert meta1["saved_world"]["dp"] == 1
    assert meta1["restored_world"]["dp"] == 2
    line = ckpt_manifest.world_line(meta1)
    assert line == jmanifest.world_line(meta1)
    assert "dp=1" in line and "restored_world" in line and "dp=2" in line


# ------------------------------------------------- batch policy


@pytest.mark.parametrize("policy", ["global", "per_device"])
def test_elastic_batch_policy_matches_jax(reshard, policy):
    """Resuming the 2-rank snapshot at dp=1: the same batch size,
    accumulation and topology change as the JAX trainer's preflight
    (which reads only the snapshot's meta)."""
    d = str(reshard["tmp"] / "zero1_dp2")
    t = Trainer(elastic_job(pconfig, "zero1", d, 1, resume=True,
                            elastic=True, elastic_batch=policy),
                device="cpu")
    jcfg = elastic_job(jconfig, "zero1", d, 1, resume=True, elastic=True,
                       elastic_batch=policy)
    jt = JaxTrainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                         devices=jax.devices("cpu")[:1]))
    assert t.cfg.batch_size == jt.cfg.batch_size
    assert t.cfg.accum_steps == jt.cfg.accum_steps
    for k in ("policy", "batch_size", "accum_steps"):
        assert t._topology_change[k] == jt._topology_change[k]
    assert t._topology_change["from_world"]["dp"] == 2
    assert t._topology_change["to_world"]["dp"] == 1
    if policy == "global":
        assert (t.cfg.batch_size, t.cfg.accum_steps) == (16, 2)
    else:
        assert (t.cfg.batch_size, t.cfg.accum_steps) == (8, 1)
        t.init_state()
        start = t.maybe_resume()
        # 64 samples consumed = one epoch of the new 8-step loader
        assert start == 4 and t._resume_plan == (1, 0)
        assert start + t._step_offset == 8


def test_rollback_remaps_step_offset(reshard):
    d = str(reshard["tmp"] / "zero1_dp2")
    t = Trainer(elastic_job(pconfig, "zero1", d, 1, resume=True,
                            elastic=True, elastic_batch="per_device"),
                device="cpu")
    t.init_state()
    start = t.maybe_resume()
    want = t._step_offset
    t._step_offset, t._resume_plan = 999, None
    assert t._rollback() == start
    assert t._step_offset == want and t._resume_plan == (1, 0)


def test_topology_record_reaches_telemetry_and_summary(reshard, tmp_path):
    import shutil

    d = tmp_path / "ck"
    shutil.copytree(reshard["tmp"] / "zero1_dp2", d)
    td = tmp_path / "telem"
    t = Trainer(elastic_job(pconfig, "zero1", str(d), 1, resume=True,
                            elastic=True, nepochs=2,
                            telemetry_dir=str(td)), device="cpu")
    r = t.fit()
    assert np.isfinite(r["final_loss"]) and r["steps"] == 8
    recs = [json.loads(x) for x in (td / "metrics.jsonl").read_text()
            .splitlines()]
    (topo,) = [x for x in recs if x.get("kind") == "topology"]
    assert topo["policy"] == "global" and topo["step"] == 4
    assert topo["from_world"]["dp"] == 2 and topo["to_world"]["dp"] == 1
    assert topo["accum_steps"] == [1, 2]
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "metrics_summary.py"),
         str(td)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "topology:" in out.stdout and "dp 2 -> 1" in out.stdout


# ------------------------------------------------- the capacity floor


def test_cli_flags_plumbed():
    args = build_argparser().parse_args(
        ["--elastic", "--min_devices", "2", "--elastic_batch",
         "per_device", "--collective_timeout", "30",
         "--supervise_backoff_max", "7"])
    cfg = config_from_args(args)
    assert cfg.elastic and cfg.min_devices == 2
    assert cfg.elastic_batch == "per_device"
    cfg0 = config_from_args(build_argparser().parse_args([]))
    assert not cfg0.elastic and cfg0.min_devices == 0


def test_trainer_enforces_min_devices_floor():
    with pytest.raises(res.CapacityAbort, match="min_devices") as e:
        Trainer(pconfig.TrainConfig(min_devices=2), device="cpu")
    assert "exit 46" in str(e.value)
    Trainer(pconfig.TrainConfig(min_devices=1), device="cpu")


def test_cli_min_devices_floor_exits_46():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop(faults.ENV_VAR, None)
    out = subprocess.run(
        [sys.executable, "-m", PKG, "--platform", "cpu", "--n_samples",
         "16", "--nepochs", "1", "--min_devices", "99"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 46, (out.stdout, out.stderr)
    assert "capacity abort" in out.stdout + out.stderr


# ------------------------------------------------- a real degraded relaunch


def _spawn_elastic_pair(tmp_path, extra=(), kill_step=5, nepochs=4):
    """Two gloo CLI ranks (RANK/WORLD_SIZE/MASTER_* worlds): rank 0 under
    ``--supervise 2 --elastic``, rank 1 killed by ``peer_kill``.  The
    world-formation and probe bound (``--probe_timeout``) is 12 s: the
    two processes must start within it of each other on a loaded host.
    Returns ((supervisor rc, output), (victim rc, output))."""
    port = _free_port()
    ck = tmp_path / "ckpt"
    common = ["--platform", "cpu", "--dataset", "regression",
              "--n_samples", "32", "--batch_size", "8", "--no-full-batch",
              "--nepochs", str(nepochs), "--checkpoint_dir", str(ck),
              "--checkpoint_every", "2", "--elastic", "--probe_timeout", "12",
              "--collective_timeout", "10", *extra]
    preflight = str(_free_port())

    def env_for(rank):
        env = dict(os.environ, PYTHONPATH=ROOT, RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), NNPT_PREFLIGHT_PORT=preflight)
        env.pop(faults.ENV_VAR, None)
        return env

    sup = subprocess.Popen(
        [sys.executable, "-m", PKG, *common, "--supervise", "2",
         "--supervise_backoff", "0.2", "--supervise_backoff_max", "0.5"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env_for(0), cwd=ROOT)
    victim = subprocess.Popen(
        [sys.executable, "-m", PKG, *common, "--faults",
         f"peer_kill@{kill_step}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env_for(1), cwd=ROOT)
    try:
        v_out, _ = victim.communicate(timeout=240)
        s_out, _ = sup.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        victim.kill()
        sup.kill()
        pytest.fail("the elastic scenario did not complete in time")
    return (sup.returncode, s_out), (victim.returncode, v_out)


def test_peer_kill_degrades_to_world1_and_completes(tmp_path):
    """Rank 1 killed at step 5: rank 0 exits 43, its relaunch cannot form
    the world (43), the probe finds this host alone, and the relaunch at
    world 1 resumes the 2-rank snapshot (elastic) and completes."""
    (rc, out), (v_rc, v_out) = _spawn_elastic_pair(tmp_path)
    assert v_rc in (-9, 137), v_out[-2000:]
    assert "injected peer_kill" in v_out
    assert rc == 0, out[-5000:]
    assert "topology probe: 1 healthy device(s)" in out
    assert "DEGRADED world" in out
    assert "saved_world 2d/2p/dp=2" in out
    assert "resuming a dp=2 checkpoint on dp=1" in out
    assert "elastic restore of a 2-device snapshot onto 1 device(s)" in out
    assert "done: final loss" in out
    assert "nan" not in out.split("done: final loss", 1)[1][:40]
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 16


def test_peer_kill_below_min_devices_exits_46(tmp_path):
    """The same with --min_devices 2: no degraded relaunch; the supervisor
    parks on the shortfall and exits 46 when its budget (2 restarts) runs
    out."""
    (rc, out), (v_rc, v_out) = _spawn_elastic_pair(
        tmp_path, extra=("--min_devices", "2"), kill_step=3, nepochs=2)
    assert v_rc in (-9, 137), v_out[-2000:]
    assert rc == 46, out[-5000:]
    assert "capacity shortfall" in out and "--min_devices 2" in out
    assert "exiting 46 (capacity abort)" in out
    assert "DEGRADED world" not in out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_elastic_restore_reads_jaxs_two_device_snapshot(tmp_path,
                                                             layout):
    """The other direction: the JAX package's 2-device snapshot resumed
    by the port at dp=1 with --elastic gives the arrays of the JAX
    package's own elastic restore into a 1-device template."""
    d = str(tmp_path / "jax")
    cfg = elastic_job(jconfig, layout, d, 2)
    JaxTrainer(cfg, mesh=make_mesh(cfg.mesh,
                                   devices=jax.devices("cpu")[:2])).fit()
    one = elastic_job(jconfig, layout, None, 1)
    jt = JaxTrainer(one, mesh=make_mesh(one.mesh,
                                        devices=jax.devices("cpu")[:1]))
    jt.init_state()
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jckpt.restore(d, jax.device_get(jt.state), elastic=True))]
    t = Trainer(elastic_job(pconfig, layout, d, 1, resume=True,
                            elastic=True), device="cpu")
    t.init_state()
    assert t.maybe_resume() == jckpt.latest_step(d)
    got = [a for _, a, _ in ckpt.host_state(t.snapshot_state())]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------- elastic resume with tp / fsdp kept

TP_ELASTIC = {"tp": (["--dp", "2", "--tp", "2"], ["--tp", "2"]),
              "fsdp": (["--dp", "2", "--fsdp", "2"], ["--fsdp", "2"])}


def _tp_elastic_flags(mesh, ck, resume=False):
    from torch_fsdp_child import LM

    flags = LM + mesh + ["--checkpoint_dir", ck]
    if resume:
        flags += ["--resume", "--elastic", "--nepochs", "2"]
    return flags


@pytest.fixture(scope="module")
def tp_elastic(tmp_path_factory):
    """4 gloo ranks (``--dp 2 --tp 2``; ``--dp 2 --fsdp 2``) save, then 2
    ranks (``--tp 2``; ``--fsdp 2``) resume under ``--elastic``; the JAX
    Trainer does the same on ``data=2 x tensor=2`` -> ``tensor=2`` (and
    the fsdp meshes) of host devices."""
    from torch_fsdp_child import spawn as spawn_fsdp

    tmp = tmp_path_factory.mktemp("tp_elastic")
    want, inits = {}, {}
    for name, (big, small) in TP_ELASTIC.items():
        jd = str(tmp / f"jax_{name}")
        for mesh, resume in ((big, False), (small, True)):
            jcfg = jconfig.config_from_args(jconfig.build_argparser()
                                            .parse_args(_tp_elastic_flags(
                                                mesh, jd, resume)))
            m = jcfg.mesh
            n = max(m.data, 1) * m.fsdp * m.tensor
            jt = JaxTrainer(jcfg, mesh=make_mesh(
                m, devices=jax.devices("cpu")[:n]))
            jt.init_state()
            if not resume:
                inits[name] = jax.device_get(jt.state.params)
            jt.fit()
        want[name] = (jax.device_get(jt.state.params), jt._topology_change)
    for stage, size, resume in (("save", 4, False), ("resume", 2, True)):
        (tmp / stage).mkdir()
        jobs = {name: {"flags": _tp_elastic_flags(
            meshes[1 if resume else 0], str(tmp / name), resume),
            "fit": True, "init": inits[name]}
            for name, meshes in TP_ELASTIC.items()}
        outs = spawn_fsdp(str(tmp / stage), size, jobs)
    return outs, want


@pytest.mark.parametrize("name", list(TP_ELASTIC))
def test_elastic_resume_keeps_tp_and_fsdp(tp_elastic, name):
    """A 4 -> 2 rank elastic resume at tp 2 (and at fsdp 2): the dense
    snapshot restores into each rank's slices of the smaller world, the
    batch policy and the topology record are JAX's, and the run ends
    where JAX's does (its GSPMD tolerance: params rtol 2e-4, atol
    1e-5)."""
    from test_torch_fsdp import assert_params_close

    outs, want = tp_elastic
    params, change = want[name]
    # the batch shards: data (x fsdp), 2 -> 1 under tp, 4 -> 2 under fsdp
    saved = {"tp": 2, "fsdp": 4}[name]
    assert change["from_world"]["dp"] == saved
    assert change["to_world"]["dp"] == saved // 2
    for out in outs:
        got = out[name]
        assert got["layout"] == "gspmd"
        assert_params_close(got["params"], params)


def test_degrade_env_refuses_a_replica_of_several_ranks():
    """A degraded world is one process on one card: a ``--tp`` / ``--fsdp``
    / ``--sp`` replica of several ranks cannot relaunch there."""
    with pytest.raises(ValueError, match="holds one card"):
        res.degrade_env({"WORLD_SIZE": "4"},
                        {"n_processes": 1, "n_devices": 1}, model_ranks=2)
    assert res.degrade_env({"WORLD_SIZE": "4"},
                           {"n_processes": 1, "n_devices": 1},
                           model_ranks=1)["NNPT_PROCESS_ID"] == "0"
