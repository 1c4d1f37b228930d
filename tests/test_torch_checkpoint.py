"""The port's checkpoint/resume and ``--generate`` against the JAX package,
on the CPU.

The port's own behaviour mirrors ``tests/test_checkpoint.py`` and
``tests/test_ckpt_durability.py`` (round trip, retention, explicit steps,
template mismatches, quarantine and fallback, truncation, uncommitted and
legacy snapshots, pruning's last-verified guard, the tmp sweep, async
writes).  The layouts cross in both directions: a JAX snapshot restores
into the port, and a port snapshot through the JAX package's own
``restore``.  Resume through the port's ``Trainer`` equals the straight
run bitwise, mid-epoch included.  ``--generate`` prints the JAX CLI's
greedy ids and refuses the same inputs with rc 2.  Comparisons are exact:
a snapshot stores the bytes it was given.
"""

import json
import pathlib
import pickle
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import cli as jcli
from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxTConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.ops import optim as joptim
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
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
from neural_networks_parallel_training_with_mpi_tpu_torch import cli
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.mlp import MLP
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (
    TrainState,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
    ckpt_manifest,
    prng,
)

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent
FSCK = REPO / "tools" / "ckpt_fsck.py"
SMALL_LM = dict(vocab_size=64, max_seq_len=32, n_layers=2, d_model=32,
                n_heads=4, d_ff=64)


def make_state(step=0, in_features=2):
    model = MLP(in_features=in_features, hidden=(3,), out_features=1,
                device="cpu")
    opt = optim.sgd(lr=0.1, momentum=0.9, steps=0)
    state = TrainState.from_params(model.init(prng.init_generator(0)), opt)
    return state._replace(step=step)


def _flip_bytes(path: pathlib.Path):
    b = bytearray(path.read_bytes())
    b[len(b) // 2] ^= 0xFF
    path.write_bytes(b)


def _leaves_equal(a, b):
    """Exact equality of two trees in JAX order (bf16 compared as bits)."""
    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert type(x) is type(y), p
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            assert x == y, p


def _steps(d):
    return sorted(s for s, _ in ckpt_manifest.snapshot_steps(d))


# ---------------------------------------------------------------------------
# the port's own behaviour
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    state = make_state(step=7)
    ckpt.save(str(tmp_path), state)
    snap = tmp_path / "ckpt-7"
    man = json.loads((snap / "manifest.json").read_text())
    assert sorted(man["files"]) == ["leaves.json", "meta.json", "state.npz"]
    assert (man["step"], man["format"], man["leaves"]) == (7, "npz", 10)
    restored = ckpt.restore(str(tmp_path), make_state())
    _leaves_equal(restored, state)
    assert restored.params[0]["w"].requires_grad
    assert not restored.opt_state.momentum_buf[0]["w"].requires_grad
    assert ckpt.verify(str(tmp_path)) and ckpt.verify(str(tmp_path), step=7)
    assert not ckpt.verify(str(tmp_path), step=99)


def test_npz_layout_is_jax_flatten_order(tmp_path):
    """Dict keys sorted, NamedTuple fields in order, ints as 0-d int32."""
    state = make_state(step=3)
    ckpt.save(str(tmp_path), state)
    snap = tmp_path / "ckpt-3"
    paths = json.loads((snap / ckpt.LEAVES).read_text())
    assert paths == ["step", "params/0/b", "params/0/w", "params/2/b",
                     "params/2/w", "opt_state/count",
                     "opt_state/momentum_buf/0/b",
                     "opt_state/momentum_buf/0/w",
                     "opt_state/momentum_buf/2/b",
                     "opt_state/momentum_buf/2/w"]
    with np.load(snap / "state.npz") as z:
        assert z["leaf_0"].dtype == np.int32 and z["leaf_0"].shape == ()
        assert int(z["leaf_0"]) == 3
        assert list(z["__leaf_dtypes__"]) == [
            "int32", "float32", "float32", "float32", "float32", "int32",
            "float32", "float32", "float32", "float32"]
        np.testing.assert_array_equal(z["leaf_2"],
                                      state.params[0]["w"].detach().numpy())


def test_newest_wins_and_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), make_state(step=s), keep=3)
    assert _steps(tmp_path) == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.newest_verified_step(str(tmp_path)) == 5
    assert ckpt.read_meta(str(tmp_path))["step"] == 5
    assert ckpt.read_meta(str(tmp_path), step=4)["step"] == 4
    assert ckpt.restore(str(tmp_path), make_state()).step == 5


def test_restore_specific_step(tmp_path):
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), make_state(step=s), keep=0)
    assert ckpt.restore(str(tmp_path), make_state(), step=2).step == 2
    with pytest.raises(ValueError, match="no checkpoint for step"):
        ckpt.restore(str(tmp_path), make_state(), step=9)


@pytest.mark.parametrize("kind", ["shape", "dtype", "structure"])
def test_template_mismatch_fails_loudly(tmp_path, kind):
    ckpt.save(str(tmp_path), make_state())
    if kind == "shape":
        other = make_state(in_features=5)
    elif kind == "dtype":
        state = make_state()
        other = state._replace(params=[
            {k: v.double() for k, v in layer.items()}
            for layer in state.params])
    else:
        model = MLP(device="cpu")
        other = TrainState.from_params(model.init(prng.init_generator(0)),
                                       optim.adam(1e-3, steps=0))
    with pytest.raises(ValueError, match=kind):
        ckpt.restore(str(tmp_path), other)


@pytest.mark.parametrize("how", ["restore", "restore_params"])
def test_tensor_parallel_snapshot_is_refused(tmp_path, how):
    """A snapshot whose meta records a tensor-parallel qkv layout holds its
    qkv columns in per-shard order.  Tensor parallelism is ported: neither
    restore refuses it any more; both return its leaves as saved, bitwise,
    and its meta keeps ``qkv_tp`` for the caller that reconciles the
    order (the trainer's resume, ``--generate``:
    tests/test_torch_sp_tp.py).  It is not quarantined."""
    state = make_state(step=4)
    ckpt.save(str(tmp_path), state, extra_meta={"qkv_tp": 2})
    if how == "restore":
        got = ckpt.restore(str(tmp_path), make_state())
        _leaves_equal(got, state)
    else:
        step, params = ckpt.restore_params(str(tmp_path),
                                           make_state().params)
        assert step == 4
        _leaves_equal(params, state.params)
    assert ckpt.read_meta(str(tmp_path))["qkv_tp"] == 2
    assert _steps(tmp_path) == [4]


def test_corrupt_generation_quarantined_and_fallback(tmp_path):
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), make_state(step=s), keep=0)
    _flip_bytes(tmp_path / "ckpt-3" / "state.npz")
    assert not ckpt.verify(str(tmp_path), step=3)
    assert ckpt.newest_verified_step(str(tmp_path)) == 2
    assert ckpt.restore(str(tmp_path), make_state()).step == 2
    assert (tmp_path / "corrupt-ckpt-3").exists()
    assert not (tmp_path / "ckpt-3").exists()
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_truncated_payload_falls_back(tmp_path):
    for s in (1, 2):
        ckpt.save(str(tmp_path), make_state(step=s), keep=0)
    p = tmp_path / "ckpt-2" / "state.npz"
    p.write_bytes(p.read_bytes()[:20])
    assert any("bytes" in pr
               for pr in ckpt_manifest.verify(tmp_path / "ckpt-2"))
    assert ckpt.restore(str(tmp_path), make_state()).step == 1


def test_uncommitted_snapshot_is_never_a_crash(tmp_path):
    for s in (1, 2):
        ckpt.save(str(tmp_path), make_state(step=s), keep=0)
    shutil.copytree(tmp_path / "ckpt-2", tmp_path / "ckpt-5")
    (tmp_path / "ckpt-5" / "manifest.json").unlink()
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert ckpt.restore(str(tmp_path), make_state()).step == 2
    assert (tmp_path / "corrupt-ckpt-5").exists()


def test_all_legacy_dir_refuses_instead_of_quarantine(tmp_path):
    for s in (1, 2):
        ckpt.save(str(tmp_path), make_state(step=s), keep=0)
        (tmp_path / f"ckpt-{s}" / "manifest.json").unlink()
    with pytest.raises(RuntimeError, match="adopt"):
        ckpt.restore(str(tmp_path), make_state())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt-1", "ckpt-2"]
    # the fsck tool's --adopt makes the same directory restorable again
    assert _fsck(tmp_path, "--adopt").returncode == 0
    assert ckpt.restore(str(tmp_path), make_state()).step == 2


def test_explicit_step_corrupt_raises(tmp_path):
    ckpt.save(str(tmp_path), make_state(step=4))
    _flip_bytes(tmp_path / "ckpt-4" / "state.npz")
    with pytest.raises(ValueError, match="fails verification"):
        ckpt.restore(str(tmp_path), make_state(), step=4)
    assert (tmp_path / "ckpt-4").exists()


def test_pruning_never_deletes_last_verified(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), make_state(step=s), keep=0)
    for s in (3, 4, 5):
        _flip_bytes(tmp_path / f"ckpt-{s}" / "state.npz")
    ckpt._prune(tmp_path, 3)
    assert _steps(tmp_path) == [1, 2, 3, 4, 5]
    assert ckpt.restore(str(tmp_path), make_state()).step == 2
    # a later healthy save prunes normally again (quarantined dirs left)
    ckpt.save(str(tmp_path), make_state(step=6), keep=2)
    assert _steps(tmp_path) == [2, 6]


def test_stale_tmp_swept_at_save_and_restore(tmp_path):
    (tmp_path / ".tmp-ckpt-99").mkdir(parents=True)
    ckpt.save(str(tmp_path), make_state(step=1))
    assert not (tmp_path / ".tmp-ckpt-99").exists()
    (tmp_path / ".tmp-ckpt-7").mkdir(parents=True)
    ckpt.restore(str(tmp_path), make_state())
    assert not (tmp_path / ".tmp-ckpt-7").exists()


def test_restore_joins_inflight_async_write(tmp_path, monkeypatch):
    orig = ckpt._write_npz

    def slow_write(*a, **k):
        time.sleep(0.3)
        orig(*a, **k)

    monkeypatch.setattr(ckpt, "_write_npz", slow_write)
    state = make_state(step=9)
    ckpt.save_async(str(tmp_path), state)
    restored = ckpt.restore(str(tmp_path), state)   # joined, no sleep here
    assert restored is not None and restored.step == 9
    ckpt.wait_pending()


def test_async_save_copies_before_in_place_updates(tmp_path, monkeypatch):
    """The optimizer updates params in place: the async snapshot holds the
    values at the save call, not at the (later) write."""
    orig = ckpt._write_npz

    def slow_write(*a, **k):
        time.sleep(0.3)
        orig(*a, **k)

    monkeypatch.setattr(ckpt, "_write_npz", slow_write)
    state = make_state(step=4)
    want = [p.detach().clone() for _, p in ckpt.flatten(state.params)]
    ckpt.save_async(str(tmp_path), state)
    with torch.no_grad():
        for _, p in ckpt.flatten(state.params):
            p.add_(1.0)
    ckpt.wait_pending()
    got = ckpt.restore(str(tmp_path), make_state())
    for (_, g), w in zip(ckpt.flatten(got.params), want):
        assert torch.equal(g.detach(), w)


def test_async_write_error_is_raised_on_the_caller(tmp_path, monkeypatch):
    def failing_write(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_npz", failing_write)
    ckpt.save_async(str(tmp_path), make_state(step=1))
    with pytest.raises(RuntimeError, match="async checkpoint") as e:
        ckpt.wait_pending()
    assert isinstance(e.value.__cause__, OSError)


def _fsck(d, *args):
    return subprocess.run([sys.executable, str(FSCK), str(d), *args],
                          capture_output=True, text=True, timeout=60)


def test_ckpt_fsck_audits_port_snapshots(tmp_path):
    """The stdlib-only fsck tool reads the port's snapshots: clean, then
    flagged after one flipped byte."""
    ckpt.save(str(tmp_path), make_state(step=2))
    clean = _fsck(tmp_path, "--json")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    rep = json.loads(clean.stdout)
    assert rep["restore_target"]["step"] == 2
    assert [g["status"] for g in rep["generations"]] == ["ok"]
    _flip_bytes(tmp_path / "ckpt-2" / "state.npz")
    bad = _fsck(tmp_path, "--json")
    assert bad.returncode == 1
    gen = json.loads(bad.stdout)["generations"][0]
    assert gen["status"] == "corrupt"
    assert any("state.npz" in p for p in gen["problems"])


# ---------------------------------------------------------------------------
# cross restores with the JAX package
# ---------------------------------------------------------------------------

def _jax_lm_state(param_dtype):
    jcfg = JaxTConfig(**SMALL_LM, param_dtype=param_dtype)
    state = JaxTrainState.create(JaxTransformer(jcfg), joptim.adam(1e-3),
                                 jprng.init_key(4))
    # non-trivial optimizer state and a non-zero step
    state = state._replace(
        step=jnp.asarray(5, jnp.int32),
        opt_state=state.opt_state._replace(
            count=jnp.asarray(5, jnp.int32),
            mu=jax.tree_util.tree_map(lambda x: x * 0.5, state.params),
            nu=jax.tree_util.tree_map(lambda x: x * x, state.params)))
    return state


def _port_lm_template(param_dtype):
    cfg = TransformerConfig(**SMALL_LM, param_dtype=param_dtype)
    model = Transformer(cfg, device="cpu")
    return TrainState.from_params(model.init(prng.init_generator(0)),
                                  optim.adam(1e-3, steps=0))


def _assert_matches_jax(port_tree, jax_tree):
    jleaves = jax.tree_util.tree_leaves(jax.device_get(jax_tree))
    pleaves = ckpt.flatten(port_tree)
    assert len(jleaves) == len(pleaves)
    for (p, got), want in zip(pleaves, jleaves):
        want = np.asarray(want)
        if isinstance(got, torch.Tensor):
            assert str(got.dtype).replace("torch.", "") == str(want.dtype), p
            if got.dtype == torch.bfloat16:
                got = got.detach().view(torch.int16).numpy()
                want = want.view(np.int16)
            else:
                got = got.detach().numpy()
            np.testing.assert_array_equal(got, want, err_msg=p)
        else:
            assert got == int(want), p


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_snapshot_restores_into_the_port(tmp_path, dtype):
    jstate = _jax_lm_state(getattr(jnp, dtype))
    jckpt.save(str(tmp_path), jstate)
    restored = ckpt.restore(str(tmp_path),
                            _port_lm_template(getattr(torch, dtype)))
    assert restored.step == 5 and restored.opt_state.count == 5
    _assert_matches_jax(restored, jstate)
    # params only, as --generate restores them
    step, params = ckpt.restore_params(
        str(tmp_path), _port_lm_template(getattr(torch, dtype)).params)
    assert step == 5
    _assert_matches_jax(params, jstate.params)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_snapshot_restores_through_jax(tmp_path, dtype):
    """The JAX package's unmodified ``restore`` reads a port snapshot once
    the JAX template's treedef.pkl sits beside it (the manifest covers
    only the files it lists)."""
    jtemplate = _jax_lm_state(getattr(jnp, dtype))
    cfg = TransformerConfig(**SMALL_LM, param_dtype=getattr(torch, dtype))
    params = params_from_jax(jax.device_get(jtemplate.params), cfg, "cpu")
    state = TrainState.from_params(params, optim.adam(1e-3, steps=0))
    # distinct values in every leaf: a training step's worth of update
    with torch.no_grad():
        for _, p in ckpt.flatten(state.params):
            p.mul_(1.5)
        for _, m in ckpt.flatten(state.opt_state.mu):
            m.fill_(0.25)
    state = state._replace(step=11,
                           opt_state=state.opt_state._replace(count=11))
    target = ckpt.save(str(tmp_path), state)
    treedef = jax.tree_util.tree_structure(jtemplate)
    (target / "treedef.pkl").write_bytes(pickle.dumps(treedef))
    restored = jckpt.restore(str(tmp_path), jtemplate)
    assert int(restored.step) == 11
    _assert_matches_jax(state, restored)


# ---------------------------------------------------------------------------
# resume through the Trainer
# ---------------------------------------------------------------------------

def _mlp_cfg(nepochs, ckpt_dir=None, resume=False, **over):
    flags = ["--lr", "0.01", "--nepochs", str(nepochs), "--no-full-batch",
             "--batch_size", "4", "--n_samples", "16", "--seed", "3"]
    if ckpt_dir:
        flags += ["--checkpoint_dir", ckpt_dir]
    if resume:
        flags.append("--resume")
    for k, v in over.items():
        flags += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return config_from_args(build_argparser().parse_args(flags))


def test_trainer_resume_continues_exactly(tmp_path):
    """4 epochs straight == 2 epochs + snapshot + a new Trainer resuming 2
    more: the same params, bit for bit (the same per-(seed, epoch)
    order, the same ops)."""
    straight = Trainer(_mlp_cfg(4), device="cpu")
    straight.fit()
    d = str(tmp_path / "ck")
    Trainer(_mlp_cfg(2, d), device="cpu").fit()
    assert _steps(tmp_path / "ck") == [8]
    second = Trainer(_mlp_cfg(4, d, resume=True), device="cpu")
    result = second.fit()
    assert result["steps"] == 16 and second.state.step == 16
    _leaves_equal(second.state, straight.state)
    assert _steps(tmp_path / "ck") == [8, 16]


@pytest.mark.parametrize("async_ckpt", [False, True],
                         ids=["sync", "async"])
def test_trainer_resume_mid_epoch_continues_exactly(tmp_path, async_ckpt):
    """--checkpoint_every 3 with 4 steps per epoch: snapshots at steps 3
    and 6, then the final one at 8.  Without the final snapshot (a job
    lost after step 6) the resume starts at step 6, two steps into the
    second epoch, and ends where the straight run ends; its losses are
    the straight run's losses of steps 7-16."""
    over = {"checkpoint_every": 3}
    if async_ckpt:
        over["async-checkpoint"] = True
    straight_m = tmp_path / "straight.jsonl"
    straight = Trainer(_mlp_cfg(4, metrics_jsonl=straight_m), device="cpu")
    straight.fit()
    d = tmp_path / "ck"
    first = Trainer(_mlp_cfg(2, str(d), **over), device="cpu")
    first.fit()
    assert _steps(d) == [3, 6, 8]
    assert len(first.save_seconds) == 3
    meta = ckpt.read_meta(str(d), step=6)
    assert meta["consumed_samples"] == 24
    shutil.rmtree(d / "ckpt-8")
    resumed_m = tmp_path / "resumed.jsonl"
    second = Trainer(_mlp_cfg(4, str(d), resume=True, metrics_jsonl=resumed_m,
                              **over), device="cpu")
    second.fit()
    assert second.restore_seconds is not None
    _leaves_equal(second.state, straight.state)

    def losses(p):
        return {r["step"]: r["loss"] for r in map(json.loads,
                                                  open(p).read().splitlines())
                if "loss" in r}

    want, got = losses(straight_m), losses(resumed_m)
    assert sorted(got) == list(range(7, 17))
    assert got == {s: want[s] for s in got}
    # 9 and 12 periodic, 15 too, and the final 16
    assert _steps(d) == [12, 15, 16]


_TWO_RANKS = r"""
import pickle, shutil, sys
import torch.distributed as dist
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import Trainer
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import checkpoint

rank, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", 2),
                        rank=rank, world_size=2)

def cfg(nepochs, *extra):
    return config_from_args(build_argparser().parse_args(
        ["--lr", "0.01", "--nepochs", str(nepochs), "--no-full-batch",
         "--batch_size", "4", "--n_samples", "13", "--seed", "3", *extra]))

def params(trainer):
    return [p.detach().numpy().copy()
            for _, p in checkpoint.flatten(trainer.state.params)]

straight = Trainer(cfg(4), device="cpu")
straight.fit()
ck = tmp + "/ck"
Trainer(cfg(2, "--checkpoint_dir", ck, "--checkpoint_every", "3"),
        device="cpu").fit()
dist.barrier()
if rank == 0:   # the job is lost after step 6's snapshot
    shutil.rmtree(ck + "/ckpt-8")
dist.barrier()
resumed = Trainer(cfg(4, "--checkpoint_dir", ck, "--resume"), device="cpu")
resumed.fit()
with open(f"{tmp}/out{rank}.pkl", "wb") as f:
    pickle.dump({"straight": params(straight), "resumed": params(resumed),
                 "restored": resumed.restore_seconds is not None}, f)
dist.destroy_process_group()
"""


def test_two_gloo_ranks_save_once_and_both_resume(tmp_path):
    """Two data-parallel ranks (13 samples at batch 4: padded, uneven
    shards): rank 0 alone writes the snapshots; both ranks restore step 6,
    mid-epoch, and end bitwise where the straight run ends."""
    root = str(REPO)
    env = dict(__import__("os").environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r),
                               str(tmp_path)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-3000:]
    outs = []
    for r in range(2):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    for out in outs:
        assert out["restored"]
        for a, b in zip(out["resumed"], out["straight"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(outs[0]["resumed"], outs[1]["resumed"]):
        np.testing.assert_array_equal(a, b)
    ck = tmp_path / "ck"
    assert _steps(ck) == [3, 6, 16]
    meta = ckpt.read_meta(str(ck))
    assert meta["saved_world"]["n_processes"] == 2
    assert meta["saved_world"]["dp"] == 2


def test_meta_carries_the_jax_trainer_keys(tmp_path):
    """meta.json holds the keys the JAX Trainer writes, at every level."""
    jflags = ["--nepochs", "1", "--checkpoint_dir", str(tmp_path / "j")]
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        jflags))
    JaxTrainer(jcfg, mesh=make_mesh(jconfig.MeshConfig(data=1),
                                    devices=jax.devices("cpu")[:1])).fit()
    Trainer(_mlp_cfg(1, str(tmp_path / "p")), device="cpu").fit()
    want = jckpt.read_meta(str(tmp_path / "j"))
    got = ckpt.read_meta(str(tmp_path / "p"))

    def keys(m):
        return {k: (keys(v) if isinstance(v, dict) and k != "mesh" else None)
                for k, v in m.items()}

    assert keys(got) == keys(want)
    assert got["saved_world"]["mesh"] == want["saved_world"]["mesh"]
    assert (got["format"], got["qkv_tp"], got["order_salt"]) == ("npz", 1, 0)
    assert got["saved_world"]["dp"] == 1
    assert got["saved_world"]["update_sharding"] == "replicated"


# ---------------------------------------------------------------------------
# --generate
# ---------------------------------------------------------------------------

LM_FLAGS = ["--dataset", "lm", "--n_samples", "32", "--seq_len", "32",
            "--vocab_size", "64", "--n_layers", "2", "--d_model", "32",
            "--n_heads", "4", "--d_ff", "64"]


def _last_ids(text):
    return [int(t) for t in text.strip().splitlines()[-1].split(",")]


def test_generate_greedy_ids_equal_jax(tmp_path, capsys):
    """JAX trains and saves a small LM; the port's --generate restores its
    params (no optimizer flags) and prints JAX's greedy ids."""
    d = str(tmp_path / "ck")
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        LM_FLAGS + ["--no-full-batch", "--batch_size", "8", "--nepochs", "2",
                    "--optimizer", "adam", "--lr", "3e-3",
                    "--checkpoint_dir", d]))
    JaxTrainer(jcfg, mesh=make_mesh(jconfig.MeshConfig(data=1),
                                    devices=jax.devices("cpu")[:1])).fit()
    capsys.readouterr()
    gen = LM_FLAGS + ["--checkpoint_dir", d, "--generate", "1,2,3",
                      "--max_new_tokens", "12", "--platform", "cpu"]
    assert jcli.main(gen) == 0
    want = _last_ids(capsys.readouterr().out)
    assert cli.main(gen) == 0
    out = capsys.readouterr().out
    assert "restored step 8" in out
    got = _last_ids(out)
    assert len(got) == 15 and got[:3] == [1, 2, 3]
    assert got == want


def test_generate_sampling_is_seeded(tmp_path, capsys):
    """--temperature draws from a generator seeded by --seed: the same
    seed gives the same ids, inside the vocabulary."""
    flags = LM_FLAGS + ["--generate", "5,6", "--max_new_tokens", "10",
                        "--temperature", "0.9", "--top_k", "20",
                        "--top_p", "0.9", "--platform", "cpu"]
    runs = []
    for seed in (1, 1, 2):
        assert cli.main(flags + ["--seed", str(seed)]) == 0
        runs.append(_last_ids(capsys.readouterr().out))
    assert runs[0] == runs[1]
    assert all(len(r) == 12 and all(0 <= t < 64 for t in r) for r in runs)


@pytest.mark.parametrize("flags", [
    ["--generate", "1,2"],                              # an MLP model
    LM_FLAGS + ["--generate", "1,x"],
    LM_FLAGS + ["--generate", "1,64"],
    LM_FLAGS + ["--generate", ""],
    LM_FLAGS + ["--generate", "1,2", "--max_new_tokens", "511"],
    LM_FLAGS + ["--generate", "1,2", "--top_k", "65"],
    LM_FLAGS + ["--generate", "1,2", "--checkpoint_dir", "EMPTY"],
], ids=["mlp", "not_ids", "out_of_vocab", "empty", "too_long", "top_k",
        "no_snapshot"])
def test_generate_refusals_match_jax(tmp_path, flags):
    flags = [str(tmp_path / "empty") if f == "EMPTY" else f for f in flags]
    flags = flags + ["--platform", "cpu"]
    assert jcli.main(flags) == 2
    assert cli.main(flags) == 2


def test_generate_refuses_a_snapshot_of_another_model(tmp_path, capsys):
    d = str(tmp_path / "ck")
    Trainer(config_from_args(build_argparser().parse_args(
        LM_FLAGS + ["--no-full-batch", "--batch_size", "16", "--nepochs", "1",
                    "--checkpoint_dir", d])), device="cpu").fit()
    wider = LM_FLAGS + ["--d_model", "48"]   # the last flag wins
    assert cli.main(wider + ["--checkpoint_dir", d, "--generate", "1",
                             "--platform", "cpu"]) == 2
    assert "shape" in capsys.readouterr().out
