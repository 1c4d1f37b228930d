"""The port's training slice against the JAX package, on the CPU.

Losses, schedules, optimizers, the sharded loader, the data-parallel train
step (one process, and two ``gloo`` ranks) and the reference job through
the CLI, each on the same inputs (numpy, from a seed) and the same initial
weights (JAX init, carried across by ``interop``).  Tolerance 1e-5 (rtol
and atol) unless a test says otherwise: both sides compute in f32 and
differ in summation order only.
"""

import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.data.loader import (
    ShardedLoader as JaxLoader,
)
from neural_networks_parallel_training_with_mpi_tpu.models.mlp import (
    reference_mlp as jax_reference_mlp,
)
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxTConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.ops import losses as jlosses
from neural_networks_parallel_training_with_mpi_tpu.ops import optim as joptim
from neural_networks_parallel_training_with_mpi_tpu.ops import (
    schedules as jschedules,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    data_parallel as jdp,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train.state import (
    TrainState as JaxTrainState,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch import cli
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    TrainConfig, build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.data import datasets
from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (
    ShardedLoader,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.mlp import MLP
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import losses
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import schedules
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    data_parallel as dp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (
    world_setup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (
    TrainState,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.tensor(np.asarray(a))


def _flat(tree, prefix=""):
    """path -> array for nested dicts/lists/NamedTuples (field names)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_close(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **(tol or TOL))


# ---------------------------------------------------------------------------
# losses, schedules, optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mse", "cross_entropy",
                                  "cross_entropy@0.1"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_losses_match_jax(name, masked):
    rng = np.random.default_rng(0)
    if name == "mse":
        pred = rng.normal(size=(6, 3)).astype(np.float32)
        y = rng.normal(size=(6, 3)).astype(np.float32)
    else:
        pred = rng.normal(size=(6, 5, 11)).astype(np.float32)
        y = rng.integers(0, 11, (6, 5)).astype(np.int32)
    mask = np.asarray([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    want = jlosses.get(name)(jnp.asarray(pred), jnp.asarray(y),
                             None if mask is None else jnp.asarray(mask))
    got = losses.get(name)(_t(pred), _t(y), None if mask is None else _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if name != "mse":
        wa = jlosses.accuracy(jnp.asarray(pred), jnp.asarray(y),
                              None if mask is None else jnp.asarray(mask))
        ga = losses.accuracy(_t(pred), _t(y),
                             None if mask is None else _t(mask))
        for g, w in zip(ga, wa):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", ["constant", "cosine", "linear"])
def test_schedules_match_jax(name):
    kw = dict(total_steps=20, warmup_steps=4, min_lr=1e-4)
    want = jschedules.make(name, 3e-3, **kw)
    got = schedules.make(name, 3e-3, **kw)
    for step in range(0, 25):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-9)


def _opt_pair(name):
    lr = schedules.make("cosine", 0.05, total_steps=5, warmup_steps=1)
    jlr = jschedules.make("cosine", 0.05, total_steps=5, warmup_steps=1)
    if name == "sgd":
        return optim.sgd(lr, 0.9, 0.01, steps=5), joptim.sgd(jlr, 0.9, 0.01)
    if name == "adam":
        return optim.adam(lr, weight_decay=0.01, steps=5), joptim.adam(
            jlr, weight_decay=0.01)
    if name == "adamw":
        return optim.adamw(lr, steps=5), joptim.adamw(jlr)
    return (optim.make("sgd", 0.05, 0.9, grad_clip=0.5, steps=5),
            joptim.make("sgd", 0.05, 0.9, grad_clip=0.5))


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "sgd_clipped"])
def test_optimizer_updates_match_jax(name):
    """Three updates of a small tree from the same params and gradients:
    params and optimizer state (same leaf names) agree."""
    rng = np.random.default_rng(1)
    params = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
    opt, jopt = _opt_pair(name)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = tree_from_jax(params, "cpu")
    ts = opt.init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                             jp)
        tp, ts = opt.update(tree_from_jax(grads, "cpu"), ts, tp)
    _assert_trees_close(tree_to_numpy(tp), jax.device_get(jp))
    _assert_trees_close(tree_to_numpy(ts), jax.device_get(js))


def test_unported_optimizers_refuse():
    for name in ("lion", "adafactor"):
        with pytest.raises(NotImplementedError):
            optim.make(name, 1e-3, steps=1)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_regression_dataset_is_sklearns():
    """The port's numpy make_regression draws what sklearn draws."""
    from sklearn.datasets import make_regression

    for n, f in ((16, 2), (13, 2), (40, 12)):
        x, y = make_regression(n_samples=n, n_features=f, noise=1.0,
                               random_state=42)
        gx, gy = datasets.make_regression(n, f, 1.0, 42)
        np.testing.assert_array_equal(gx, x)
        np.testing.assert_array_equal(gy, y)


def test_digits_file_is_load_digits():
    """The bundled CSV holds exactly what sklearn's ``load_digits`` loads,
    row for row."""
    from sklearn.datasets import load_digits

    d = load_digits()
    got = datasets.digits_dataset(seed=0, do_standardize=False)
    order = np.random.default_rng(0).permutation(len(d.target))
    np.testing.assert_array_equal(got["x"], d.data.astype(np.float32)[order])
    np.testing.assert_array_equal(got["y"], d.target.astype(np.int32)[order])


@pytest.mark.parametrize("do_standardize", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_digits_dataset_is_jaxs(seed, do_standardize):
    """The port's digits are the JAX package's: same rows, same order, same
    standardization."""
    from neural_networks_parallel_training_with_mpi_tpu.data import (
        datasets as jdatasets,
    )

    want = jdatasets.digits_dataset(seed, do_standardize=do_standardize)
    got = datasets.digits_dataset(seed, do_standardize=do_standardize)
    for k in ("x", "y"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("salt", [0, 3])
@pytest.mark.parametrize("remainder", ["pad", "drop"])
def test_loader_matches_jax_per_rank(salt, remainder):
    """Same seed and salt: each rank's rows, padding and mask are its
    contiguous slice of the JAX loader's 2-device global batch."""
    n = 13
    data = {"x": np.arange(n * 2, dtype=np.float32).reshape(n, 2),
            "y": np.arange(n, dtype=np.int32)}
    mesh = make_mesh(jconfig.MeshConfig(data=2),
                     devices=jax.devices("cpu")[:2])
    jl = JaxLoader(mesh, data, 5, seed=7, remainder=remainder, prefetch=0)
    jl.order_salt = salt
    ranks = [ShardedLoader(data, 5, rank=r, world_size=2, device="cpu",
                           seed=7, remainder=remainder, prefetch=r)
             for r in range(2)]
    for ld in ranks:
        ld.order_salt = salt
        assert ld.steps_per_epoch == jl.steps_per_epoch
        assert ld.consumed_samples(7) == jl.consumed_samples(7)
    for epoch in range(2):
        want = [jax.device_get(b) for b in jl.epoch(epoch)]
        got = [list(ld.epoch(epoch)) for ld in ranks]
        assert len(got[0]) == len(got[1]) == len(want)
        for i, w in enumerate(want):
            for k in ("x", "y", "mask"):
                both = np.concatenate([got[r][i][k].numpy()
                                       for r in range(2)])
                np.testing.assert_array_equal(both, np.asarray(w[k]))


@pytest.mark.parametrize("rows,shards", [(13, 2), (16, 8), (3, 4), (0, 3)])
def test_shard_math_matches_jax(rows, shards):
    from neural_networks_parallel_training_with_mpi_tpu.parallel import (
        sharding as jshd,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        sharding as shd,
    )

    np.testing.assert_array_equal(shd.shard_sizes(rows, shards),
                                  jshd.shard_sizes(rows, shards))
    x = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    for got, want in zip(shd.pad_to_multiple(x, shards),
                         jshd.pad_to_multiple(x, shards)):
        np.testing.assert_array_equal(got, want)


def test_seeded_generators_are_reproducible_and_distinct():
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import prng

    draw = lambda g: torch.rand(4, generator=g)  # noqa: E731
    assert torch.equal(draw(prng.init_generator(3)),
                       draw(prng.init_generator(3)))
    streams = [draw(prng.init_generator(3)), draw(prng.data_generator(3)),
               draw(prng.host_generator(3, 0)), draw(prng.host_generator(3, 1)),
               draw(prng.init_generator(4))]
    assert len({tuple(s.tolist()) for s in streams}) == len(streams)


def test_loader_refuses_native_backend():
    with pytest.raises(NotImplementedError):
        ShardedLoader({"x": np.zeros((4, 2))}, 2, device="cpu",
                      backend="native")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

SMALL_LM = dict(vocab_size=64, max_seq_len=32, n_layers=2, d_model=32,
                n_heads=4, d_ff=64)


def test_lm_flash_ce_chunk_train_steps_match_jax(mesh1):
    """The whole slice at small size: a 2-layer LM with flash attention and
    the fused chunked CE, two SGD-momentum steps from the same params and
    batches, against the JAX data-parallel step on a 1-device mesh.  (Not
    Adam: the key part of the qkv bias has an exactly-zero gradient, since
    softmax ignores it, and Adam's normalisation blows each side's ~1e-9
    summation noise there up to a full-size step.)"""
    jcfg = JaxTConfig(**SMALL_LM, attention="flash", flash_block_q=16,
                      flash_block_k=8, ce_chunk=8)
    jmodel = JaxTransformer(jcfg)
    jopt = joptim.sgd(0.1, 0.9)
    jstate = JaxTrainState.create(jmodel, jopt, jprng.init_key(0))
    jparams0 = jax.device_get(jstate.params)
    jstate = jdp.replicate_state(jstate, mesh1)
    jstep = jdp.make_train_step(jmodel, jopt, mesh1,
                                loss_name="cross_entropy")
    data = datasets.lm_dataset(32, 64, seed=3, n_samples=8)
    jl = JaxLoader(mesh1, data, 4, shuffle=False, prefetch=0)
    jlosses_ = []
    for batch in jl.epoch(0):
        jstate, loss = jstep(jstate, batch)
        jlosses_.append(float(loss))

    model = Transformer(TransformerConfig(
        **SMALL_LM, attention="flash", flash_block_q=16, flash_block_k=8,
        ce_chunk=8), device="cpu")
    opt = optim.sgd(0.1, 0.9, steps=2)
    state = TrainState.from_params(params_from_jax(jparams0, model.cfg,
                                                   "cpu"), opt)
    step = dp.make_train_step(model, opt, world_setup("cpu"),
                              loss_name="cross_entropy")
    got = []
    for batch in ShardedLoader(data, 4, device="cpu", shuffle=False,
                               prefetch=0).epoch(0):
        state, loss = step(state, batch)
        got.append(float(loss))
    np.testing.assert_allclose(got, jlosses_, **TOL)
    _assert_trees_close(tree_to_numpy(state.params),
                        jax.device_get(jstate.params))


def test_accum_steps_is_the_unsplit_step():
    """accum_steps=2 adds microbatch sums: same loss and params as one
    step over the whole batch."""
    data = datasets.regression_dataset(8)
    batch = next(ShardedLoader(data, 8, device="cpu", shuffle=False,
                               prefetch=0).epoch(0))
    results = []
    for accum in (1, 2):
        model = MLP(device="cpu")
        opt = optim.sgd(1e-2, 0.9, steps=1)
        state = TrainState.from_params(
            model.init(torch.Generator().manual_seed(0)), opt)
        step = dp.make_train_step(model, opt, world_setup("cpu"),
                                  accum_steps=accum)
        state, loss = step(state, batch)
        results.append((float(loss), tree_to_numpy(state.params)))
    np.testing.assert_allclose(results[1][0], results[0][0], **TOL)
    _assert_trees_close(results[1][1], results[0][1])


_CHILD = r"""
import pickle, sys
import torch.distributed as dist
from neural_networks_parallel_training_with_mpi_tpu_torch.data import datasets
from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import ShardedLoader
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import tree_from_jax, tree_to_numpy
from neural_networks_parallel_training_with_mpi_tpu_torch.models.mlp import reference_mlp
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import data_parallel as dp
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import world_setup
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import TrainState

rank, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", 2),
                        rank=rank, world_size=2)
world = world_setup("cpu")
with open(tmp + "/init.pkl", "rb") as f:
    init = pickle.load(f)
out = {}
for red in ("global_mean", "per_shard_mean"):
    model, opt = reference_mlp("cpu"), optim.sgd(0.01, 0.9, steps=8)
    state = TrainState.from_params(tree_from_jax(init, "cpu"), opt)
    step = dp.make_train_step(model, opt, world, "mse", grad_reduction=red)
    loader = ShardedLoader(datasets.regression_dataset(13), 4, rank=rank,
                           world_size=2, device="cpu", seed=0)
    losses = []
    for epoch in range(2):
        for batch in loader.epoch(epoch):
            state, loss = step(state, batch)
            losses.append(float(loss))
    out[red] = (losses, tree_to_numpy(state.params))
with open(f"{tmp}/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def test_two_rank_gloo_matches_jax_two_device_dp(tmp_path):
    """Two spawned gloo ranks, 13 samples at batch 4 (uneven padded
    shards), against the JAX 2-device data-parallel trajectory under both
    gradient semantics."""
    mesh = make_mesh(jconfig.MeshConfig(data=2),
                     devices=jax.devices("cpu")[:2])
    jmodel = jax_reference_mlp()
    init = jax.device_get(jmodel.init(jprng.init_key(0)))
    with open(tmp_path / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r),
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    data = datasets.regression_dataset(13)
    want = {}
    for red in ("global_mean", "per_shard_mean"):
        jopt = joptim.sgd(0.01, 0.9)
        jstate = jdp.replicate_state(
            JaxTrainState.create(jmodel, jopt, jprng.init_key(0)), mesh)
        jstep = jdp.make_train_step(jmodel, jopt, mesh, "mse",
                                    grad_reduction=red)
        jl = JaxLoader(mesh, data, 4, seed=0, prefetch=0)
        losses_ = []
        for epoch in range(2):
            for batch in jl.epoch(epoch):
                jstate, loss = jstep(jstate, batch)
                losses_.append(float(loss))
        want[red] = (losses_, jax.device_get(jstate.params))
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    for r in range(2):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            got = pickle.load(f)
        for red, (losses_, params) in want.items():
            np.testing.assert_allclose(got[red][0], losses_, **TOL)
            _assert_trees_close(got[red][1], params)
    # the two semantics really differ on uneven shards
    assert not np.allclose(want["global_mean"][0], want["per_shard_mean"][0])


# ---------------------------------------------------------------------------
# the reference job through the CLI
# ---------------------------------------------------------------------------

REFERENCE_JOB = ["--lr", "0.001", "--momentum", "0.9", "--batch_size", "4",
                 "--nepochs", "3"]


def _epoch_losses(text):
    return [float(x) for x in re.findall(r"epoch \d+: loss ([-\d.e+]+)",
                                         text)]


def test_reference_job_cli_matches_jax_trainer(mesh1, capsys, monkeypatch):
    from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
        Trainer as JaxTrainer,
    )

    jcfg = jconfig.config_from_args(
        jconfig.build_argparser().parse_args(REFERENCE_JOB))
    jt = JaxTrainer(jcfg, mesh=mesh1)
    jt.init_state()
    init = jax.device_get(jt.state.params)
    jt.fit()
    want = _epoch_losses(capsys.readouterr().out)
    # the frameworks' random streams differ: start from JAX's init
    monkeypatch.setattr(MLP, "init",
                        lambda self, gen: tree_from_jax(init, "cpu"))
    assert cli.main(REFERENCE_JOB + ["--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    got = _epoch_losses(out)
    assert len(want) == 3 and len(got) == 3
    np.testing.assert_allclose(got, want, **TOL)
    assert "done: final loss" in out


def test_interop_round_trips_a_jax_train_state():
    """A JAX TrainState (Transformer params + Adam state) into the port and
    back out as numpy under the same leaf names."""
    jmodel = JaxTransformer(JaxTConfig(**SMALL_LM))
    jopt = joptim.adam(1e-3)
    jstate = jax.device_get(JaxTrainState.create(jmodel, jopt,
                                                 jprng.init_key(2)))
    state = tree_from_jax(jstate, "cpu")
    assert isinstance(state, TrainState)
    assert isinstance(state.opt_state, optim.AdamState)
    assert state.step == 0 and state.opt_state.count == 0
    back = tree_to_numpy(state)
    want = jstate._asdict()
    want.pop("qstate")
    _assert_trees_close(back, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# flags of paths the port lacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    # --tp, --fsdp, ulysses, --vocab_parallel, dense_blockwise, --pp and
    # --pp_interleave are ported with their combinations
    # (tests/test_torch_tensor_parallel.py, tests/test_torch_sp_tp.py,
    # tests/test_torch_megatron.py, tests/test_torch_fsdp.py,
    # tests/test_torch_pipeline*.py), MoE with the expert axis
    # (tests/test_torch_expert.py) and on the pipe and GSPMD layouts
    # (tests/test_torch_pipeline_expert.py, tests/test_torch_moe_gspmd.py);
    # the mixes JAX refuses (fsdp beside pipe, seq or expert; MoE on the
    # pipe layout without an expert axis) take their places
    ["--tp", "2", "--pp", "2", "--fsdp", "2", "--dataset", "lm"],
    ["--sp", "2", "--attention", "ulysses", "--fsdp", "2"],
    ["--pp", "2", "--moe_experts", "4", "--dataset", "lm"],
    ["--ep", "2", "--pp", "2", "--fsdp", "2", "--dataset", "lm"],
    ["--fsdp", "2", "--pp", "2"],
    # the observability flags are ported
    # (tests/test_torch_telemetry.py::test_observability_flags_are_ported)
    # the resilience flags are ported (tests/test_torch_resilience.py),
    # and replica consistency and elastic resume
    # (tests/test_torch_sdc.py, tests/test_torch_elastic.py), and the
    # fleet's driver fault kinds (tests/test_torch_ctrlplane.py); the
    # mixes of the model-parallel layouts JAX refuses, adafactor and RL
    # are not
    ["--vocab_parallel", "--sp", "2", "--tp", "2", "--attention", "ring",
     "--dataset", "lm", "--fsdp", "2", "--pp", "2"],
    ["--optimizer", "adafactor"],
    ["--moe_top_k", "2", "--moe_experts", "4", "--pp", "2", "--dataset",
     "lm"],
    ["--pp_interleave", "2", "--pp", "2", "--n_layers", "4", "--dataset",
     "lm", "--fsdp", "2"],
    ["--moe_capacity_factor", "2", "--moe_experts", "4", "--pp", "2",
     "--dataset", "lm"],
    ["--ep", "4", "--fsdp", "2", "--dataset", "lm"],
    ["--workload", "rl"], ["--data_backend", "native"],
    ["--attention", "dense_blockwise", "--tp", "2", "--dataset", "lm",
     "--pp", "2", "--fsdp", "2"],
    # ported, but not over the pipeline layout (JAX's refusals)
    ["--matmul_dtype", "fp8", "--dataset", "lm", "--pp", "2"],
    ["--moe_experts", "4", "--pp", "2", "--dataset", "lm"],
    ["--skip-nonfinite", "--pp", "2", "--dataset", "lm"],
    ["--optimizer", "lion"], ["--dataset", "cifar10"],
], ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_raise(flags):
    cfg = config_from_args(build_argparser().parse_args(flags))
    with pytest.raises(NotImplementedError):
        Trainer(cfg, device="cpu")


# --quantize, --probe_timeout and --supervise are ported
# (tests/test_torch_quant.py, tests/test_torch_resilience.py), and every
# fault kind (tests/test_torch_sdc.py, tests/test_torch_fleet.py,
# tests/test_torch_ctrlplane.py): the driver kinds' cases run the CLI to
# exit 0, --num_devices still raises
@pytest.mark.parametrize("flags", [["--faults", "router_kill@1"],
                                   ["--faults", "fleet_kill@1"],
                                   ["--num_devices", "4"]])
def test_unported_cli_flags_raise(flags):
    if flags[0] == "--faults":
        assert cli.main(flags + ["--platform", "cpu", "--nepochs", "1"]) == 0
        return
    with pytest.raises(NotImplementedError):
        cli.main(flags + ["--platform", "cpu"])


def test_config_copy_keeps_the_jax_flags_and_defaults():
    """Same flag names and defaults as the JAX CLI; only --platform's
    choices differ (gpu in place of tpu)."""
    jp, tp = jconfig.build_argparser(), build_argparser()
    jflags = {a.dest: a.default for a in jp._actions}
    tflags = {a.dest: a.default for a in tp._actions}
    assert jflags == tflags
    assert TrainConfig().to_json() == jconfig.TrainConfig().to_json()
    choices = {a.dest: a.choices for a in tp._actions}
    assert choices["platform"] == ["auto", "cpu", "gpu"]
