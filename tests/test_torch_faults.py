"""The port's fault injection (``utils/faults.py``) and the checkpoint I/O
faults (``utils/checkpoint.py``) against the JAX package's, on the CPU.

Mirrors the fault tests of ``tests/test_resilience.py`` and
``tests/test_ckpt_durability.py`` (``:314-402``): the grammar parses every
kind and option as JAX's parser does and rejects what it rejects;
``max=``/``once=`` fire as often as JAX's; a NaN fault inside a
``--steps_per_dispatch`` group poisons only its own step's rows;
``corrupt_ckpt`` rots the newest snapshot, which the restore quarantines;
``ckpt_ioerr`` raises on a sync and an async save with older snapshots
intact; ``torn_ckpt`` publishes a snapshot without its manifest and dies
by SIGKILL, and the restore falls back past it.  The kinds of Queue A
items 3 and 6 parse but are refused when a run is built.
"""

import dataclasses
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.utils import (
    faults as jfaults,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.mlp import MLP
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (
    TrainState,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
    faults,
    prng,
)

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent

# one spec per kind, and every option
SPECS = [
    "nan@3-5?max=2", "crash@9?once=/tmp/m", "sigterm@7",
    "torn_ckpt@4?once=/tmp/t", "corrupt_ckpt@6", "ckpt_ioerr@8",
    "bitflip@2?param=w&shard=3&bit=5", "desync@4?eps=0.5",
    "desync@4?det", "peer_kill@3?proc=1", "peer_hang@2-9?proc=0",
    "device_loss@1", "replica_kill@4?proc=2", "stall_drain@1-3",
    "preempt@5?grace=3.5", "preempt@1", "slow@2-4?ms=120", "slow@1",
    "handoff_kill@1", "handoff_kill_post@2", "decode_kill@3",
    "handoff_stall@4", "router_kill@5", "fleet_kill@6",
]
BAD_SPECS = ["boom@3", "nan", "nan@5-2", "nan@3?what=1", "nan@3?grace=1",
             "preempt@3?ms=5", "slow@3?grace=1", "slow@3?ms=-1",
             "preempt@3?grace=-2", "nan@1?det", "crash@1?once="]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_parsing_matches_jax(spec):
    got = faults.FaultPlan.parse(spec).faults
    want = jfaults.FaultPlan.parse(spec).faults
    assert [dataclasses.asdict(f) for f in got] == \
        [dataclasses.asdict(f) for f in want]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_parse_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_fault_firing_and_env_fallback(tmp_path, monkeypatch):
    """max= and once= fire as JAX's do; the NNPT_FAULTS env var is the
    fallback a supervised child inherits; an empty spec is no plan."""
    spec = f"nan@3-5?max=2,crash@9?once={tmp_path / 'm'}"
    plans = [faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)]
    for plan in plans:
        f_nan, f_crash = plan.faults
        fired = []
        for step in range(2, 7):
            if f_nan.should_fire(step):
                f_nan.mark_fired()
                fired.append(step)
        assert fired == [3, 4]
    assert plans[0].faults[1].should_fire(9)
    plans[0].faults[1].mark_fired()
    assert (tmp_path / "m").exists()
    assert not plans[0].faults[1].should_fire(9)
    assert not plans[1].faults[1].should_fire(9)   # the marker persists
    assert faults.FaultPlan.parse("") is None
    monkeypatch.setenv(faults.ENV_VAR, "nan@7")
    assert faults.FaultPlan.from_config("").faults[0].start == 7
    assert faults.FaultPlan.from_config("nan@2").faults[0].start == 2


@pytest.mark.parametrize("spec,item", [
    ("fleet_kill@1", "item 6"), ("handoff_stall@2", "item 6"),
    ("replica_kill@1", "item 6"), ("router_kill@3", "item 6")])
def test_unported_kinds_refused_naming_their_item(spec, item):
    cfg = config_from_args(build_argparser().parse_args(
        ["--faults", spec]))
    with pytest.raises(NotImplementedError, match=item):
        Trainer(cfg, device="cpu")


def test_nan_poisons_only_its_step_in_a_group():
    """A k-group is views into one tensor per leaf: the faulted step gets
    a NaN mask of its own, the other steps and the group's storage keep
    theirs."""
    cfg = config_from_args(build_argparser().parse_args(
        ["--no-full-batch", "--batch_size", "4", "--n_samples", "16"]))
    trainer = Trainer(cfg, device="cpu")
    group, n, _ = next(trainer.loader.epoch_groups(0, 4))
    assert n == 4
    base = group[0]["mask"]._base
    before = base.clone()
    plan = faults.FaultPlan.parse("nan@2")
    out = [plan.apply(i, b) for i, b in enumerate(group)]
    for i, (b, o) in enumerate(zip(group, out)):
        assert torch.isnan(o["mask"]).all().item() == (i == 2)
        assert o["x"] is b["x"]
        if i != 2:
            assert o["mask"] is b["mask"]
    assert torch.equal(base, before)


def test_nan_inside_a_group_equals_the_single_step_run():
    """--steps_per_dispatch 4 with the guard and a NaN at step 5 (inside
    the second group): the same losses and state as k = 1, bitwise; one
    step skipped."""
    def run(k):
        cfg = config_from_args(build_argparser().parse_args(
            ["--no-full-batch", "--batch_size", "4", "--n_samples", "32",
             "--nepochs", "2", "--optimizer", "adam", "--lr", "0.01",
             "--steps_per_dispatch", str(k), "--skip-nonfinite",
             "--faults", "nan@5"]))
        t = Trainer(cfg, device="cpu")
        r = t.fit()
        return r, t.state
    (r1, s1), (r4, s4) = run(1), run(4)
    assert r1["skipped_updates"] == r4["skipped_updates"] == 1
    assert r1["final_loss"] == r4["final_loss"]
    for (_, a), (_, b) in zip(ckpt.flatten(s1), ckpt.flatten(s4)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.view(torch.int32) if a.dtype ==
                               torch.float32 else a,
                               b.view(torch.int32) if b.dtype ==
                               torch.float32 else b)
        else:
            assert a == b


# ---------------------------------------------------------------------------
# checkpoint I/O faults (tests/test_ckpt_durability.py :314-402)
# ---------------------------------------------------------------------------

def make_state(step=0):
    model = MLP(in_features=2, hidden=(3,), out_features=1, device="cpu")
    opt = optim.sgd(lr=0.1, momentum=0.9, steps=0)
    return TrainState.from_params(model.init(prng.init_generator(0)),
                                  opt)._replace(step=step)


def test_corrupt_ckpt_fault_flips_newest(tmp_path):
    for s in (2, 4):
        ckpt.save(str(tmp_path), make_state(step=s), keep=0)
    plan = faults.FaultPlan.parse("corrupt_ckpt@3")
    batch = {"x": torch.ones(2)}
    out = plan.apply(3, batch, ckpt_dir=str(tmp_path))
    assert out["x"] is batch["x"]
    assert not ckpt.verify(str(tmp_path), step=4)
    assert ckpt.verify(str(tmp_path), step=2)
    assert ckpt.restore(str(tmp_path), make_state()).step == 2
    assert (tmp_path / "corrupt-ckpt-4").exists()
    # without a checkpoint dir the fault is a logged no-op
    faults.FaultPlan.parse("corrupt_ckpt@1").apply(1, batch, ckpt_dir=None)


def test_ckpt_ioerr_fault_surfaces_and_recovers(tmp_path):
    ckpt.save(str(tmp_path), make_state(step=1))
    plan = faults.FaultPlan.parse("ckpt_ioerr@2,ckpt_ioerr@3")
    plan.apply(2, {}, ckpt_dir=str(tmp_path))
    with pytest.raises(OSError, match="injected ckpt_ioerr"):
        ckpt.save(str(tmp_path), make_state(step=2))
    plan.apply(3, {}, ckpt_dir=str(tmp_path))
    ckpt.save_async(str(tmp_path), make_state(step=3))
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ckpt.wait_pending()
    assert ckpt.latest_step(str(tmp_path)) == 1
    ckpt.save(str(tmp_path), make_state(step=4))
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.restore(str(tmp_path), make_state()).step == 4


_TORN_CHILD = """
import sys
sys.path.insert(0, {repo!r})
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt, faults)
sys.path.insert(0, {tests!r})
from test_torch_faults import make_state
ckpt.save({d!r}, make_state(step=3))
faults.FaultPlan.parse("torn_ckpt@4").apply(4, {{}})
ckpt.save({d!r}, make_state(step=6))
print("unreachable")
"""


def test_torn_ckpt_dies_and_restore_falls_back(tmp_path):
    """torn_ckpt: the next write publishes its payload without the
    manifest and the process dies by SIGKILL; the newest committed
    snapshot is the older one, and a restore quarantines the torn dir."""
    d = str(tmp_path / "c")
    src = _TORN_CHILD.format(repo=str(REPO), tests=str(REPO / "tests"), d=d)
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "injected torn checkpoint write" in proc.stderr
    assert "unreachable" not in proc.stdout
    assert (tmp_path / "c" / "ckpt-6").exists()
    assert not (tmp_path / "c" / "ckpt-6" / "manifest.json").exists()
    assert ckpt.latest_step(d) == 3
    assert ckpt.restore(d, make_state()).step == 3
    assert not (tmp_path / "c" / "ckpt-6").exists()


def test_inject_io_fault_rejects_other_kinds():
    with pytest.raises(ValueError):
        ckpt.inject_io_fault("nan")


def test_meta_carries_order_salt_for_jax(tmp_path):
    """A port snapshot's meta carries the JAX trainer's ``order_salt``
    key, read back by a resume (JAX ``train/trainer.py:818-826``)."""
    cfg = config_from_args(build_argparser().parse_args(
        ["--no-full-batch", "--batch_size", "4", "--n_samples", "16",
         "--checkpoint_dir", str(tmp_path)]))
    t = Trainer(cfg, device="cpu")
    t.init_state()
    t.loader.order_salt = 3
    t.save()
    assert ckpt.read_meta(str(tmp_path))["order_salt"] == 3
    t2 = Trainer(dataclasses.replace(cfg, resume=True), device="cpu")
    t2.init_state()
    t2.maybe_resume()
    assert t2.loader.order_salt == 3
    assert np.isfinite(t2.fit()["final_loss"])
