"""The port's training resilience against the JAX package's, on the CPU:
the guarded update (``ops/optim.py`` ``with_skip_guard``), the anomaly
monitor and rollback (``train/resilience.py``, ``Trainer._rollback``),
the preemption-safe exit, the supervisor and its exit-code contract, the
peer-loss exit over gloo ranks, and fail-fast world formation
(``parallel/distributed.py``).

Mirrors ``tests/test_resilience.py``.  Tolerances: the port's own runs are
held bitwise (a skipped step, the guarded happy path, rollback and
resume); against JAX, losses and params to ``TOL`` (the unguarded
trajectories' tolerance of ``tests/test_torch_train.py``: the ops differ
from XLA's in the last bits), the monitor's decisions exactly.
"""

import dataclasses
import os
import pathlib
import pickle
import re
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxTConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.ops import optim as joptim
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train import (
    resilience as jres,
)
from neural_networks_parallel_training_with_mpi_tpu.train.state import (
    TrainState as JaxTrainState,
)
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    checkpoint as jckpt,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.mlp import MLP
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
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
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (
    leaves,
)

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = "neural_networks_parallel_training_with_mpi_tpu_torch"
TOL = dict(rtol=1e-5, atol=1e-5)
SMALL_LM = dict(vocab_size=64, max_seq_len=32, n_layers=2, d_model=32,
                n_heads=4, d_ff=64)


def _bits(t):
    t = t.detach()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
        if t.is_floating_point() else t


def _tensors(state):
    """Every tensor of params, opt state and fp8 histories, in order."""
    return leaves((state.params, state.opt_state, state.qstate))


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# the guard on every layout the port has
# ---------------------------------------------------------------------------

LM_FLAGS = ["--dataset", "lm", "--no-full-batch", "--batch_size", "4",
            "--n_samples", "16", "--seq_len", "16", "--vocab_size", "32",
            "--n_layers", "1", "--d_model", "16", "--n_heads", "2",
            "--d_ff", "32", "--optimizer", "adam", "--lr", "0.01"]
LAYOUTS = {
    "dp": [],
    "zero1": ["--update_sharding", "zero1"],
    "sharded": ["--update_sharding", "sharded"],
    "master": ["--update_sharding", "sharded", "--master-weights",
               "--param_dtype", "bfloat16"],
    "fp8": ["--matmul_dtype", "fp8"],
}


def _lm_trainer(layout, *extra):
    cfg = config_from_args(build_argparser().parse_args(
        LM_FLAGS + LAYOUTS[layout] + list(extra)))
    t = Trainer(cfg, device="cpu")
    t.init_state()
    return t


def _batches(t, n):
    out = []
    for epoch in range(4):
        out += list(t.loader.epoch(epoch))
    return out[:n]


def _poke_specials(t):
    """-0.0 and a denormal into the first two elements of every float
    tensor of params and opt state (the master copy with its params,
    which stay its cast)."""
    with torch.no_grad():
        for x in leaves((t.state.params, t.state.opt_state)):
            if x.dim() and x.is_floating_point() and x.numel() >= 2:
                flat = x.view(-1)
                flat[0] = -0.0
                flat[1] = 1e-40


@pytest.mark.parametrize("trigger", ["nan", "threshold"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_skipped_step_is_a_bitwise_noop(layout, trigger):
    """A NaN batch, or a clean one over ``--skip_threshold``: params, the
    inner state (-0.0 and denormals included) and the fp8 histories keep
    every bit; ``skipped`` advances, the inner count (the lr row) does
    not; ``TrainState.step`` counts the attempt."""
    extra = (["--skip-nonfinite"] if trigger == "nan"
             else ["--skip_threshold", "1e-9"])
    t = _lm_trainer(layout, *extra)
    b0, b1 = _batches(t, 2)
    if trigger == "nan":    # one accepted step first: non-zero slots
        t.state, _ = t.train_step(t.state, b0)
        assert int(t.state.opt_state.skipped) == 0
        b1 = dict(b1, mask=b1["mask"] * float("nan"))
    _poke_specials(t)
    before = [x.clone() for x in _tensors(t.state)]
    count = int(t.state.opt_state.count)
    skipped = int(t.state.opt_state.skipped)
    step = t.state.step
    t.state, loss = t.train_step(t.state, b1)
    assert (trigger == "nan") != bool(torch.isfinite(loss))
    _assert_bitwise([x for x in before if x.dim()],
                    [x for x in _tensors(t.state) if x.dim()])
    assert int(t.state.opt_state.skipped) == skipped + 1
    assert int(t.state.opt_state.count) == count
    assert t.state.step == step + 1
    if layout == "fp8" and trigger == "nan":   # calibrated histories kept
        assert all(h[0] > 0 for h in t.state.qstate["amax"].values())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_guarded_happy_path_equals_the_unguarded_run(layout):
    """Three clean steps: the guarded run's losses and state equal the
    unguarded run's bitwise (the guard's two 0-d counts aside)."""
    runs = []
    for guard in (False, True):
        t = _lm_trainer(layout, *(["--skip-nonfinite"] if guard else []))
        losses = []
        for b in _batches(t, 3):
            t.state, loss = t.train_step(t.state, b)
            losses.append(float(loss))
        runs.append((losses, [x for x in _tensors(t.state) if x.dim()]))
    assert runs[0][0] == runs[1][0]
    _assert_bitwise(runs[0][1], runs[1][1])


def test_guard_refused_on_the_layouts_jax_refuses(devices):
    """The pipe layout has no global norm seam: both packages refuse the
    guard there with the same message."""
    flags = ["--dataset", "lm", "--skip-nonfinite", "--pp", "2"]
    with pytest.raises(NotImplementedError) as want:
        JaxTrainer(jconfig.config_from_args(
            jconfig.build_argparser().parse_args(flags)),
            mesh=make_mesh(jconfig.MeshConfig(pipe=2), devices=devices[:2]))
    with pytest.raises(NotImplementedError) as got:
        Trainer(config_from_args(build_argparser().parse_args(flags)),
                device="cpu")
    assert str(got.value) == str(want.value)


def test_guarded_trajectory_matches_jax(mesh1, monkeypatch):
    """The toy regression with Adam, the guard and a NaN batch at step 2,
    from JAX's init through both Trainers: the same losses, one skipped
    update each, the same params and inner state."""
    flags = ["--no-full-batch", "--batch_size", "8", "--n_samples", "32",
             "--nepochs", "3", "--optimizer", "adam", "--lr", "0.01",
             "--skip-nonfinite", "--faults", "nan@2"]
    jt = JaxTrainer(jconfig.config_from_args(
        jconfig.build_argparser().parse_args(flags)), mesh=mesh1)
    jt.init_state()
    init = jax.device_get(jt.state.params)
    jr = jt.fit()
    monkeypatch.setattr(MLP, "init",
                        lambda self, gen: tree_from_jax(init, "cpu"))
    t = Trainer(config_from_args(build_argparser().parse_args(flags)),
                device="cpu")
    r = t.fit()
    assert jr["skipped_updates"] == r["skipped_updates"] == 1
    np.testing.assert_allclose(r["final_loss"], jr["final_loss"], **TOL)
    js = jax.device_get(jt.state)
    got = tree_to_numpy(t.state.params)
    for a, b in zip(jax.tree_util.tree_leaves(js.params),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(a, b, **TOL)
    assert int(js.opt_state.inner.count) == int(
        t.state.opt_state.count) == 11
    for a, b in zip(jax.tree_util.tree_leaves(js.opt_state.inner.mu),
                    jax.tree_util.tree_leaves(
                        tree_to_numpy(t.state.opt_state.inner.mu))):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# guarded snapshots cross both ways
# ---------------------------------------------------------------------------

def _jax_guarded_state():
    jopt = joptim.with_skip_guard(joptim.adam(1e-3))
    state = JaxTrainState.create(JaxTransformer(JaxTConfig(**SMALL_LM)),
                                 jopt, jprng.init_key(4))
    inner = state.opt_state.inner
    return state._replace(
        step=jnp.asarray(7, jnp.int32),
        opt_state=state.opt_state._replace(
            skipped=jnp.asarray(2, jnp.int32),
            inner=inner._replace(
                count=jnp.asarray(5, jnp.int32),
                mu=jax.tree_util.tree_map(lambda x: x * 0.5, state.params),
                nu=jax.tree_util.tree_map(lambda x: x * x, state.params))))


def _port_guarded_template(params=None):
    cfg = TransformerConfig(**SMALL_LM)
    if params is None:
        params = params_from_jax(jax.device_get(
            _jax_guarded_state().params), cfg, "cpu")
    return TrainState.from_params(params, optim.with_skip_guard(
        optim.adam(1e-3, steps=8)))


def _assert_same_leaves(port_state, jax_state):
    jl = jax.tree_util.tree_leaves(jax.device_get(jax_state))
    pl = ckpt.flatten(port_state)
    assert len(jl) == len(pl)
    for (path, got), want in zip(pl, jl):
        got = got.detach().numpy() if isinstance(got, torch.Tensor) \
            else np.asarray(got)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)


def test_jax_guarded_snapshot_restores_into_the_port(tmp_path):
    jstate = _jax_guarded_state()
    jckpt.save(str(tmp_path), jstate)
    restored = ckpt.restore(str(tmp_path), _port_guarded_template())
    assert isinstance(restored.opt_state, optim.GuardedState)
    assert int(restored.opt_state.skipped) == 2
    assert int(restored.opt_state.inner.count) == 5 and restored.step == 7
    _assert_same_leaves(restored, jstate)


def test_port_guarded_snapshot_restores_through_jax(tmp_path):
    jtemplate = _jax_guarded_state()
    state = _port_guarded_template()
    with torch.no_grad():
        state.opt_state.skipped.fill_(3)
        state.opt_state.inner.count.fill_(9)
        for m in leaves(state.opt_state.inner.mu):
            m.fill_(0.25)
    state = state._replace(step=12)
    target = ckpt.save(str(tmp_path), state)
    (target / "treedef.pkl").write_bytes(pickle.dumps(
        jax.tree_util.tree_structure(jtemplate)))
    restored = jckpt.restore(str(tmp_path), jtemplate)
    assert int(restored.opt_state.skipped) == 3
    assert int(restored.opt_state.inner.count) == 9
    _assert_same_leaves(state, restored)


# ---------------------------------------------------------------------------
# the monitor, rollback and order_salt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(rollback_after=3, max_rollbacks=1),
    dict(rollback_after=2, spike_factor=10.0, warmup=3),
    dict(rollback_after=1, max_rollbacks=0),
    dict(rollback_after=2, max_rollbacks=3, spike_factor=2.0, warmup=2,
         ema_beta=0.5),
], ids=["consecutive", "spike", "abort_first", "tight_spike"])
def test_monitor_decisions_equal_jax(kw):
    rng = np.random.default_rng(5)
    stream = list(rng.uniform(1.0, 2.0, 60))
    for i in (7, 8, 9, 20, 21, 33, 34, 35, 50, 51):
        stream[i] = float("nan")
    for i in (14, 15, 40, 41):
        stream[i] = 100.0
    mine, theirs = res.ResilienceMonitor(**kw), jres.ResilienceMonitor(**kw)
    for loss in stream:
        assert mine.observe(loss) == theirs.observe(loss)
        assert (mine.consecutive, mine.rollbacks, mine.bad_steps) == \
            (theirs.consecutive, theirs.rollbacks, theirs.bad_steps)


def _mlp_cfg(tmp_path=None, **over):
    # lr 1e-3, momentum 0: the optimizer stable, so the only instability
    # is the injected one (as JAX's resilience tests)
    flags = ["--no-full-batch", "--batch_size", "8", "--n_samples", "32",
             "--lr", "1e-3", "--momentum", "0"]
    if tmp_path is not None:
        flags += ["--checkpoint_dir", str(tmp_path)]
    for k, v in over.items():
        flags += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return config_from_args(build_argparser().parse_args(flags))


def test_rollback_and_order_salt_across_a_resume(tmp_path):
    """skip -> 2 bad losses -> rollback to the newest verified snapshot,
    copied into the live tensors (a captured graph stays valid), with
    the data order re-drawn; the salt rides the snapshot's meta into a
    resume, and the run ends at its last step."""
    cfg = _mlp_cfg(tmp_path, nepochs=6, **{"skip-nonfinite": True},
                   rollback_after=2, max_rollbacks=2, checkpoint_every=4,
                   faults="nan@10-12?max=3")
    t = Trainer(cfg, device="cpu")
    t.init_state()
    live = _tensors(t.state)
    r = t.fit()
    assert r["rollbacks"] == 1 and r["steps"] == 24
    assert r["skipped_updates"] >= 1 and r["bad_steps"] >= 2
    assert np.isfinite(r["final_loss"])
    assert [x["step"] for x in t.rollbacks] == [8]
    assert all(a is b for a, b in zip(live, _tensors(t.state)))
    assert t.loader.order_salt == 1
    assert ckpt.read_meta(str(tmp_path))["order_salt"] == 1
    assert ckpt.latest_step(str(tmp_path)) == 24
    t2 = Trainer(dataclasses.replace(cfg, resume=True, faults=""),
                 device="cpu")
    t2.init_state()
    assert t2.maybe_resume() == 24 and t2.loader.order_salt == 1


def test_rollback_without_a_snapshot_restores_the_init():
    cfg = _mlp_cfg(nepochs=3, **{"skip-nonfinite": True}, rollback_after=2,
                   max_rollbacks=2, faults="nan@1-2?max=2")
    r = Trainer(cfg, device="cpu").fit()
    assert np.isfinite(r["final_loss"])
    assert r["rollbacks"] == 1 and r["steps"] == 12


def test_abort_keeps_the_last_good_snapshot(tmp_path):
    """A persistent poison window with max_rollbacks 0 aborts at the
    second bad loss.  The loss is read at lag 1 and before each
    snapshot, so the bad streak skips the step-8 snapshot: the newest is
    step 6's (JAX, reading at lag 2, keeps step 8's)."""
    cfg = _mlp_cfg(tmp_path, nepochs=4, **{"skip-nonfinite": True},
                   rollback_after=2, max_rollbacks=0, checkpoint_every=2,
                   faults="nan@7-999")
    with pytest.raises(res.AnomalyAbort, match="rollback budget"):
        Trainer(cfg, device="cpu").fit()
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_sigterm_in_process_snapshot_and_handlers_restored(tmp_path):
    """SIGTERM at step 7 (k = 1): the step runs, the loop stops at the next
    boundary, the final snapshot is step 8's, and the handlers are
    restored; a preemption notice does the same and says so."""
    for spec, notice in (("sigterm@7", False), ("preempt@7?grace=9", True)):
        d = tmp_path / spec.split("@")[0]
        r = Trainer(_mlp_cfg(d, nepochs=10, faults=spec), device="cpu").fit()
        assert r["preempted"] and r["steps"] == 8
        assert r.get("preempt_notice", False) == notice
        assert r["shutdown_s"] >= 0
        assert ckpt.latest_step(str(d)) == 8
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    assert signal.getsignal(signal.SIGUSR1) is signal.SIG_DFL


# ---------------------------------------------------------------------------
# the CLI and the supervisor, as subprocesses on the reference toy job
# ---------------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ, PYTHONUNBUFFERED="1", **extra)
    env.pop("NNPT_FAULTS", None)
    return env


def _cli(extra, timeout=180, env=None):
    return subprocess.run(
        [sys.executable, "-m", PKG, "--platform", "cpu", "--n_samples", "32",
         "--batch_size", "8", "--no-full-batch", *extra],
        capture_output=True, text=True, timeout=timeout,
        env=env or _env(), cwd=str(REPO))


def test_cli_sigterm_snapshot_exit0_and_resume(tmp_path):
    d = tmp_path / "c"
    out = _cli(["--nepochs", "10", "--checkpoint_dir", str(d),
                "--faults", "sigterm@7"])
    text = out.stdout + out.stderr
    assert out.returncode == 0, text[-3000:]
    assert "caught signal 15" in text and "preempted" in text
    assert ckpt.latest_step(str(d)) == 8
    assert ckpt.read_meta(str(d))["step"] == 8
    out2 = _cli(["--nepochs", "10", "--checkpoint_dir", str(d), "--resume"])
    assert out2.returncode == 0, (out2.stdout + out2.stderr)[-3000:]
    assert ckpt.latest_step(str(d)) == 40


def test_cli_preempt_notice_exits_47_not_retried(tmp_path):
    d = tmp_path / "c"
    out = _cli(["--nepochs", "10", "--checkpoint_dir", str(d),
                "--faults", "preempt@7?grace=9", "--supervise", "3",
                "--supervise_backoff", "0.1"])
    text = out.stdout + out.stderr
    assert out.returncode == res.EXIT_DECOMMISSION == 47, text[-3000:]
    assert "preemption notice" in text
    assert "[supervise] attempt 2" not in text
    assert ckpt.latest_step(str(d)) == 8


def test_supervisor_relaunches_a_crash_and_resumes(tmp_path):
    out = _cli(["--nepochs", "4", "--checkpoint_dir", str(tmp_path / "c"),
                "--checkpoint_every", "3",
                "--faults", f"crash@9?once={tmp_path / 'crashed'}",
                "--supervise", "2", "--supervise_backoff", "0.1"])
    text = out.stdout + out.stderr
    assert out.returncode == 0, text[-3000:]
    assert "injected crash at step 9" in text
    assert "[supervise] attempt 2" in text and "--resume" in text
    assert "relaunch resumes from verified snapshot step 9" in text
    assert "[supervise] child completed" in text
    assert ckpt.latest_step(str(tmp_path / "c")) == 16


def test_supervisor_does_not_retry_an_anomaly_abort(tmp_path):
    out = _cli(["--nepochs", "8", "--checkpoint_dir", str(tmp_path / "c"),
                "--checkpoint_every", "2", "--skip-nonfinite",
                "--rollback_after", "2", "--max_rollbacks", "1",
                "--faults", "nan@4-999", "--supervise", "3",
                "--supervise_backoff", "0.1"])
    text = out.stdout + out.stderr
    assert out.returncode == res.EXIT_ANOMALY == 44, text[-3000:]
    assert "anomaly abort" in text and "not retrying" in text
    assert "[supervise] attempt 2" not in text


@pytest.mark.parametrize("codes,want,launches", [
    ([1, 42, 0], 0, 3), ([43, 0], 0, 2), ([44], 44, 1), ([47], 47, 1),
    ([7, 7, 7], 7, 3)], ids=["crash_hang_ok", "peer_ok", "anomaly",
                             "decommission", "exhausted"])
def test_supervise_policy_equals_jax(monkeypatch, codes, want, launches):
    """Retry by exit code as JAX's supervisor does: 0, 44 and 47 stop,
    the rest is retried up to the budget."""
    outs = []
    for mod in (res, jres):
        it, calls = iter(codes), []

        def fake_call(cmd, env=None):
            calls.append(cmd)
            return next(it)
        monkeypatch.setattr(mod.subprocess, "call", fake_call)
        outs.append((mod.supervise(["x"], max_restarts=2, backoff=0.0,
                                   _sleep=lambda s: None), len(calls)))
    assert outs[0] == outs[1] == (want, launches)


def test_strip_flags_and_exit_codes_equal_jax():
    argv = ["--lr", "0.1", "--supervise", "3", "--supervise_backoff=0.5",
            "--nepochs", "2", "--supervise=4", "--supervise_backoff_max",
            "9"]
    assert res.strip_supervisor_flags(argv) == \
        jres.strip_supervisor_flags(argv) == ["--lr", "0.1", "--nepochs",
                                              "2"]
    for name in ("EXIT_OK", "EXIT_HANG", "EXIT_PEER", "EXIT_ANOMALY",
                 "EXIT_DECOMMISSION"):
        assert getattr(res, name) == getattr(jres, name)


@pytest.mark.parametrize("exc,peer", [
    (torch.distributed.DistBackendError("NCCL communicator was aborted"),
     True),
    (torch.distributed.DistNetworkError("failed to recv"), True),
    (RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] "
                  "Connection closed by peer [127.0.0.1]:1234"), True),
    (RuntimeError("Timed out waiting 5000ms for recv operation"), True),
    (RuntimeError("Watchdog caught collective operation timeout"), True),
    (distributed.PeerMissing("rank(s) [1] did not check in"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (ValueError("bad --lr"), False),
    (FileNotFoundError("/data/peer/x.npz"), False),
], ids=["dist_backend", "dist_network", "gloo_closed", "gloo_timeout",
        "nccl_watchdog", "peer_missing", "oom", "value", "file"])
def test_is_peer_error_reads_torch_errors(exc, peer):
    assert res.is_peer_error(exc) is peer


# ---------------------------------------------------------------------------
# peer loss over 2 gloo ranks, world formation
# ---------------------------------------------------------------------------

def _free_port():
    """A port that is free with the next one: a multi-rank world's
    preflight rendezvous binds the launcher port + 1."""
    while True:
        with socket.socket() as s, socket.socket() as t:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
            try:
                t.bind(("localhost", port + 1))
            except OSError:
                continue
            return port


@pytest.mark.parametrize("kind", ["peer_kill", "peer_hang"])
def test_peer_loss_exits_43_over_two_gloo_ranks(tmp_path, kind):
    """Rank 1 dies (SIGKILL) or wedges at step 3; rank 0's gradient
    all-reduce raises (a closed connection, or --collective_timeout) and
    the CLI exits 43."""
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = _env(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", PKG, "--platform", "cpu", "--n_samples",
             "64", "--batch_size", "8", "--no-full-batch", "--nepochs", "4",
             "--collective_timeout", "3", "--faults", f"{kind}@3?proc=1"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(REPO)))
    t0 = time.monotonic()
    try:
        out0, _ = procs[0].communicate(timeout=120)
        secs = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out1 = procs[1].stdout.read()
    assert procs[0].returncode == res.EXIT_PEER == 43, out0[-3000:]
    assert "peer loss" in out0
    assert f"injected {kind} at step 3" in out1
    if kind == "peer_kill":
        assert procs[1].returncode == -signal.SIGKILL
    assert secs < 90


def test_preflight_raises_typed_errors_within_its_timeout():
    """Rank 0 alone: PeerMissing naming rank 1; a rank with no rank 0:
    CoordinatorUnreachable; both WorldFormationError, which the CLI maps
    to exit 43."""
    t0 = time.monotonic()
    with pytest.raises(distributed.PeerMissing, match=r"\[1\]"):
        distributed.preflight("127.0.0.1", _free_port(), 2, 0, 1.0)
    with pytest.raises(distributed.CoordinatorUnreachable):
        distributed.preflight("127.0.0.1", _free_port(), 2, 1, 1.0)
    assert time.monotonic() - t0 < 30
    assert res.is_peer_error(distributed.CoordinatorUnreachable("x"))


def test_probe_world_reports_the_world_or_none_within_its_timeout(
        monkeypatch):
    """No launcher: the probe reports this host.  A launcher world whose
    rank 0 never answers: this host alone, degraded, within the probe's
    bound."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.probe_world(timeout_s=1.0) == dict(
        n_processes=1, n_devices=1, local_devices=1, degraded=False)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    t0 = time.monotonic()
    assert distributed.probe_world(timeout_s=1.0) == dict(
        n_processes=1, n_devices=1, local_devices=1, degraded=True)
    assert time.monotonic() - t0 < 60


def test_world_setup_sets_the_collective_timeout(tmp_path):
    """--collective_timeout reaches the process group (a 1-rank gloo world
    formed from the launcher's environment, preflight included)."""
    src = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import torch.distributed as dist
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    distributed)
real, seen = dist.init_process_group, {{}}
def spy(*a, **kw):
    seen.update(kw)
    return real(*a, **kw)
dist.init_process_group = spy
w = distributed.world_setup("cpu", collective_timeout=7)
print("FORMED", dist.get_backend(), w.world_size, seen["timeout"])
"""
    proc = subprocess.run(
        [sys.executable, "-c", src], capture_output=True, text=True,
        timeout=120, cwd=str(REPO),
        env=_env(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(_free_port())))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORMED gloo 1 0:00:07" in proc.stdout
