"""The port's DP x TP training (``--tp``, the JAX GSPMD step's
counterpart) against the JAX package, on the CPU.

The slice rules against JAX's ``param_specs``; whole trainer runs (the
small LM with MHA, GQA, SwiGLU and RoPE; the digits MLP of Megatron's
alternating rules) over a ``LocalTensorGroup(2)`` and over 2 gloo ranks
(``ProcessTensorGroup``), each against the JAX Trainer on a ``data=1 x
tensor=2`` mesh of fake CPU devices from the same init; the clip and the
telemetry norms; snapshots (dense order, ``qkv_tp`` 1, interchangeable
with the JAX GSPMD trainer's both ways); and the refusals.  f32 on both
sides.  Tolerance 1e-5 (rtol and atol; JAX's own TP test,
``tests/test_composition.py``, holds rtol 2e-4 with atol 1e-4).
"""

import functools
import pickle

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.models.registry import (
    build_model as jax_build_model,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    tensor_parallel as jtp,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch import cli
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.registry import (
    build_model,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    tensor_parallel as tp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (
    LocalTensorGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    QUEUE_A4, Trainer, check_fsdp_layout, check_tensor_layout,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
)
from torch_tp_child import MLP, MLP_STEPS, VARIANTS, lm_flags, run, spawn

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
JOBS = dict({v: lm_flags(v, "--tp", "2") for v in VARIANTS},
            mlp=MLP + ["--tp", "2"])
JOB_STEPS = {"mlp": MLP_STEPS}


def _jax_mesh(flags):
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))
    m = jcfg.mesh
    n = max(m.data, 1) * m.seq * m.tensor
    return jcfg, make_mesh(m, devices=jax.devices("cpu")[:n])


def _jax_trainer(flags):
    jcfg, mesh = _jax_mesh(flags)
    return JaxTrainer(jcfg, mesh=mesh)


@functools.lru_cache(maxsize=None)
def jax_trajectory(name, flags=None, max_steps=None):
    """(init params, per-step outputs, final params) of the JAX Trainer on
    the job's mesh (``data=1 x tensor=2``)."""
    flags = list(flags or JOBS[name])
    max_steps = max_steps or JOB_STEPS.get(name)
    jt = _jax_trainer(flags)
    jt.init_state()
    init = jax.device_get(jt.state.params)
    outs = []
    for epoch in range(jt.cfg.nepochs):
        for batch in jt.loader.epoch(epoch):
            if max_steps is not None and len(outs) == max_steps:
                break
            jt.state, out = jt.train_step(jt.state, batch)
            outs.append({k: float(v) for k, v in jax.device_get(out).items()}
                        if isinstance(out, dict) else float(out))
    return init, outs, jax.device_get(jt.state.params)


def _port(flags, **kw):
    return Trainer(config_from_args(build_argparser().parse_args(flags)),
                   device="cpu", **kw)


def assert_params_close(got, want, **tol):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **(tol or TOL))


def assert_outputs_close(got, want):
    if isinstance(want[0], dict):
        for k in want[0]:
            np.testing.assert_allclose([g[k] for g in got],
                                       [w[k] for w in want], err_msg=k,
                                       **TOL)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the slice rules
# ---------------------------------------------------------------------------

def _spec_dim(spec):
    """A JAX PartitionSpec as the port's rule: the dims of its tensor and
    fsdp axes."""
    def dim(axis):
        dims = [i for i, a in enumerate(spec) if a == axis]
        return dims[0] if dims else None

    return tp.LeafSpec(dim("tensor"), dim("fsdp"))


@pytest.mark.parametrize("flags", [
    lm_flags("mha"), lm_flags("gqa"), lm_flags("swiglu"),
    lm_flags("mha", "--vocab_size", "63"), MLP,
    ["--dataset", "regression"]],
    ids=["transformer", "gqa", "swiglu", "odd_vocab", "mlp", "reference"])
@pytest.mark.parametrize("tensor", [2, 4])
def test_slice_rules_match_jax_param_specs(flags, tensor):
    jcfg, mesh = _jax_mesh(flags + ["--tp", str(tensor)])
    jmodel = jax_build_model(jcfg.model)
    jparams = jmodel.init(jprng.init_key(0))
    want = jax.tree_util.tree_map(_spec_dim, jtp.param_specs(
        jmodel, jparams, mesh), is_leaf=lambda x: isinstance(x, P))
    cfg = config_from_args(build_argparser().parse_args(flags))
    model = build_model(cfg.model, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    got = tp.param_specs(model, params, tensor)
    leaf = lambda x: isinstance(x, tp.LeafSpec)  # noqa: E731
    assert (jax.tree_util.tree_leaves(got, is_leaf=leaf)
            == jax.tree_util.tree_leaves(want, is_leaf=leaf))
    assert jax.tree_util.tree_structure(got, is_leaf=leaf) == \
        jax.tree_util.tree_structure(want, is_leaf=leaf)


# ---------------------------------------------------------------------------
# trajectories: a local group and 2 gloo ranks against JAX's GSPMD Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(JOBS))
def test_local_group_trainer_matches_jax_gspmd(name):
    init, want, want_params = jax_trajectory(name)
    trainer = _port(JOBS[name], tensor_group=LocalTensorGroup(2))
    assert (trainer.layout_tag, trainer.qkv_tp) == ("gspmd", 1)
    got, params = run(trainer, init, JOB_STEPS.get(name))
    assert_outputs_close(got, want)
    assert_params_close(params, want_params)


# --grad_clip below the gradient norm (the clip scales every step), and
# the telemetry metrics of the step (grad, update and param norms)
CLIP = lm_flags("mha", "--tp", "2", "--grad_clip", "0.5")
METRICS = lm_flags("swiglu", "--tp", "2", "--telemetry_dir", "{tmp}",
                   "--metrics_every", "1")


def _metrics_flags(tmp):
    return [f.format(tmp=tmp) for f in METRICS]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every job over 2 gloo ranks (a ProcessTensorGroup of the world),
    from JAX's inits."""
    tmp = tmp_path_factory.mktemp("tp_ranks")
    mflags = tuple(_metrics_flags(str(tmp / "telemetry")))
    jobs = {name: (flags, jax_trajectory(name)[0], JOB_STEPS.get(name))
            for name, flags in JOBS.items()}
    jobs["clip"] = (CLIP, jax_trajectory("clip", tuple(CLIP))[0], None)
    jobs["metrics"] = (list(mflags), jax_trajectory("metrics", mflags)[0],
                       None)
    return mflags, spawn(str(tmp), 2, {"jobs": jobs})


@pytest.mark.parametrize("name", list(JOBS) + ["clip"])
def test_two_gloo_ranks_match_jax_gspmd(two_ranks, name):
    flags = tuple(CLIP) if name == "clip" else None
    _, want, want_params = jax_trajectory(name, flags)
    for out in two_ranks[1]:
        got, params = out[name]
        assert_outputs_close(got, want)
        assert_params_close(params, want_params)


def test_clip_and_metrics_norms_match_jax_global_view(two_ranks, tmp_path):
    """The clipped run and the metrics' grad / update / param norms equal
    the JAX GSPMD Trainer's global-view ones, over a local group and over
    2 gloo ranks: no replicated leaf counted twice."""
    mflags, outs = two_ranks
    init, want, want_params = jax_trajectory("metrics", mflags)
    assert {"grad_norm", "param_norm", "update_ratio"} <= set(want[0])
    trainer = _port(_metrics_flags(str(tmp_path)),
                    tensor_group=LocalTensorGroup(2))
    got, params = run(trainer, init)
    assert_outputs_close(got, want)
    assert_params_close(params, want_params)
    for out in outs:
        assert_outputs_close(out["metrics"][0], want)
    init, want, want_params = jax_trajectory("clip", tuple(CLIP))
    got, params = run(_port(CLIP, tensor_group=LocalTensorGroup(2)), init)
    assert_outputs_close(got, want)
    assert_params_close(params, want_params)
    # the clip fired: the run differs from the unclipped one
    assert not np.allclose(want, jax_trajectory("mha")[1])


def test_guard_and_accumulation_run_on_the_tp_step():
    """--skip-nonfinite and --accum_steps 2 under --tp 2: the same
    trajectory as JAX's GSPMD Trainer with the same flags."""
    flags = tuple(lm_flags("gqa", "--tp", "2", "--skip-nonfinite",
                           "--accum_steps", "2"))
    init, want, want_params = jax_trajectory("guard", flags)
    trainer = _port(list(flags), tensor_group=LocalTensorGroup(2))
    got, params = run(trainer, init)
    assert_outputs_close(got, want)
    assert_params_close(params, want_params)


def test_eval_matches_jax_gspmd():
    flags = lm_flags("mha", "--tp", "2")
    jt = _jax_trainer(flags)
    jt.init_state()
    trainer = _port(flags, tensor_group=LocalTensorGroup(2))
    run(trainer, jax.device_get(jt.state.params), max_steps=0)
    want = jt.evaluate(jt.data)
    got = trainer.evaluate(trainer.data)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def state_arrays(state):
    """A state's leaves in JAX's flatten order (the snapshot's)."""
    return [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
            for _, t in ckpt.flatten(state)]


def _state_arrays(trainer):
    return state_arrays(trainer.state)


def test_snapshot_is_dense_and_resumes_across_layouts_bitwise(tmp_path):
    """A --tp 2 run saves the dense order (qkv_tp 1, the tensor axis in
    saved_world); a dense trainer, a --tp 2 and a --tp 4 one resume it
    with params and optimizer slots bitwise."""
    ck = str(tmp_path / "ck")
    flags = lm_flags("mha", "--optimizer", "adam", "--checkpoint_dir", ck)
    saver = _port(flags + ["--tp", "2"], tensor_group=LocalTensorGroup(2))
    saver.fit()
    meta = ckpt.read_meta(ck)
    assert meta["qkv_tp"] == 1 and meta["saved_world"]["mesh"]["tensor"] == 2
    want = _state_arrays(saver)
    for extra, kw in (([], {}),
                      (["--tp", "2"], dict(tensor_group=LocalTensorGroup(2))),
                      (["--tp", "4"], dict(tensor_group=LocalTensorGroup(4)))):
        t = _port(flags + extra + ["--resume"], **kw)
        t.init_state()
        assert t.maybe_resume() == saver.state.step
        for a, b in zip(_state_arrays(t), want):
            np.testing.assert_array_equal(a, b)


def test_jax_gspmd_trainer_and_the_port_resume_each_other(tmp_path):
    """The port's --tp 2 snapshot restores into the JAX GSPMD Trainer, and
    JAX's into the port, params and optimizer slots bitwise."""
    flags = lm_flags("mha", "--tp", "2", "--optimizer", "adam",
                     "--nepochs", "1")
    port_ck, jax_ck = str(tmp_path / "port"), str(tmp_path / "jax")
    saver = _port(flags + ["--checkpoint_dir", port_ck],
                  tensor_group=LocalTensorGroup(2))
    saver.fit()
    jt = _jax_trainer(flags + ["--checkpoint_dir", port_ck, "--resume"])
    jt.init_state()
    # the JAX package's restore reads its template's treedef beside the
    # leaves (tests/test_torch_checkpoint.py)
    (ckpt._snapshot_dirs(port_ck)[-1][1] / "treedef.pkl").write_bytes(
        pickle.dumps(jax.tree_util.tree_structure(jt.state)))
    assert jt.maybe_resume() == saver.state.step
    want = _state_arrays(saver)
    got = jax.tree_util.tree_leaves(jax.device_get(jt.state))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b)
    js = _jax_trainer(flags + ["--checkpoint_dir", jax_ck])
    js.fit()
    t = _port(flags + ["--checkpoint_dir", jax_ck, "--resume"],
              tensor_group=LocalTensorGroup(2))
    t.init_state()
    t.maybe_resume()
    want = jax.tree_util.tree_leaves(jax.device_get(js.state))
    assert len(_state_arrays(t)) == len(want)
    for a, b in zip(_state_arrays(t), want):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

# JAX's refusals under a tensor axis: the port raises its type and message
JAX_REFUSALS = [
    (lm_flags("mha", "--tp", "2", "--vocab_parallel"), ValueError),
    (lm_flags("mha", "--tp", "2", "--ce_chunk", "8"), ValueError),
    (lm_flags("mha", "--tp", "2", "--update_sharding", "zero1"),
     NotImplementedError),
    (lm_flags("mha", "--tp", "2", "--grad_reduction", "per_shard_mean"),
     ValueError),
    (lm_flags("mha", "--tp", "2", "--scan-layers"), ValueError),
    (lm_flags("mha", "--sp", "2", "--tp", "2", "--attention", "ring",
              "--update_sharding", "sharded"), NotImplementedError),
    (lm_flags("mha", "--sp", "2", "--tp", "2", "--attention", "ring",
              "--update_sharding", "zero1"), NotImplementedError),
    (lm_flags("mha", "--sp", "2", "--tp", "2", "--attention", "ring",
              "--skip-nonfinite"), NotImplementedError),
    (lm_flags("mha", "--sp", "2", "--tp", "2", "--attention", "ring",
              "--matmul_dtype", "int8"), NotImplementedError),
]


@pytest.mark.parametrize("flags,exc", JAX_REFUSALS,
                         ids=lambda x: x[-1] if isinstance(x, list) else "")
def test_jax_refusals_raise_jax_type_and_message(flags, exc):
    jcfg, mesh = _jax_mesh(flags)
    with pytest.raises(exc) as want:
        JaxTrainer(jcfg, mesh=mesh)
    cfg = config_from_args(build_argparser().parse_args(flags))
    groups = {"tensor_group": LocalTensorGroup(2)}
    if cfg.mesh.seq > 1:
        from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
            LocalSeqGroup,
        )

        groups["seq_group"] = LocalSeqGroup(2)
    with pytest.raises(exc) as got:
        Trainer(cfg, device="cpu", **groups)
    assert str(got.value) == str(want.value)


HELD_OUT = [
    lm_flags("mha", "--fsdp", "2"),
    lm_flags("mha", "--tp", "2", "--update_sharding", "sharded"),
    lm_flags("mha", "--tp", "2", "--matmul_dtype", "int8"),
    lm_flags("mha", "--tp", "2", "--matmul_dtype", "fp8"),
    lm_flags("mha", "--tp", "2", "--sdc_check_every", "1"),
    lm_flags("mha", "--tp", "2", "--check_replicas_every", "1"),
    lm_flags("mha", "--tp", "2", "--elastic"),
    lm_flags("mha", "--sp", "2", "--tp", "2", "--attention", "ring",
             "--elastic"),
]


@pytest.mark.parametrize("flags", HELD_OUT, ids=lambda f: "_".join(f[-2:]))
def test_formerly_held_combinations_build(flags):
    """The combinations ROADMAP Queue A item 4 held out of ``--tp`` until
    the state could be sliced now pass the layout checks and build; a
    world of one process has no room for ``--fsdp 2`` but a local fsdp
    group of 2."""
    cfg = config_from_args(build_argparser().parse_args(flags))
    check_fsdp_layout(cfg)
    check_tensor_layout(cfg)
    groups = {"tensor_group": LocalTensorGroup(2)} if cfg.mesh.tensor > 1 \
        else {}
    if cfg.mesh.seq > 1:
        from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
            LocalSeqGroup,
        )

        groups["seq_group"] = LocalSeqGroup(2)
    if cfg.mesh.fsdp > 1:
        from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.fsdp import (  # noqa: E501
            LocalFsdpGroup,
        )

        with pytest.raises(ValueError, match="does not fit a world of 1"):
            Trainer(cfg, device="cpu")
        t = Trainer(cfg, device="cpu", fsdp_group=LocalFsdpGroup(2))
        assert t.gspmd and t.state_layout.fsdp_pg is None
    else:
        assert Trainer(cfg, device="cpu", **groups).state_layout is not None


def test_generate_ignores_mesh_flags(tmp_path, capsys):
    """``--generate`` under ``--tp`` decodes as JAX's CLI does: the mesh
    flags do not apply, and the tokens are those of the run without
    them."""
    flags = lm_flags("mha") + ["--generate", "1,2", "--platform", "cpu",
                               "--max_new_tokens", "4"]
    outs = []
    for extra in ([], ["--tp", "2"], ["--fsdp", "2"]):
        assert cli.main(flags + extra) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("1,2,")])
    assert outs[0] and outs[0] == outs[1] == outs[2]
    assert "Queue A item 4" in QUEUE_A4


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_generate_under_tp_prints_jaxs_tokens(tmp_path, capsys, saver):
    """One ``--tp 2`` snapshot (saved by the port's GSPMD trainer, or by
    JAX's): both CLIs' ``--generate --tp 2`` print the same greedy ids."""
    from neural_networks_parallel_training_with_mpi_tpu import cli as jcli

    d = str(tmp_path / "ck")
    flags = lm_flags("mha", "--tp", "2", "--nepochs", "1",
                     "--checkpoint_dir", d)
    if saver == "port":
        _port(flags, tensor_group=LocalTensorGroup(2)).fit()
        # the JAX package's restore reads its template's treedef beside
        # the arrays
        jt = _jax_trainer(flags)
        jt.init_state()
        (ckpt._snapshot_dirs(d)[-1][1] / "treedef.pkl").write_bytes(
            pickle.dumps(jax.tree_util.tree_structure(jt.state)))
    else:
        _jax_trainer(flags).fit()
    capsys.readouterr()
    gen = flags + ["--generate", "1,2,3", "--max_new_tokens", "8",
                   "--platform", "cpu"]
    lines = []
    for main in (cli.main, jcli.main):
        assert main(gen) == 0
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines[0] == lines[1] and lines[0].startswith("1,2,3,")
    assert len(lines[0].split(",")) == 11


def test_tp_without_a_world_raises_and_the_group_must_fit():
    with pytest.raises(ValueError, match="--tp 2 does not fit"):
        _port(lm_flags("mha", "--tp", "2"))
    with pytest.raises(ValueError, match="--tp 4 != the tensor group's 2"):
        _port(lm_flags("mha", "--tp", "4"), tensor_group=LocalTensorGroup(2))
    with pytest.raises(ValueError, match="n_kv_heads % tp == 0"):
        _port(lm_flags("mha", "--n_heads", "4", "--d_model", "32"),
              tensor_group=LocalTensorGroup(3))


def test_describe_names_the_tensor_axis():
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        World, describe,
    )

    w = World(0, 8, torch.device("cpu"), sp=2, tp=2)
    assert describe(w) == "data=2 seq=2 tensor=2"
    w = World(5, 8, torch.device("cpu"), sp=1, tp=4)
    assert (describe(w), w.data_rank, w.seq_rank, w.tensor_rank) == (
        "data=2 tensor=4", 1, 0, 1)
    w = World(6, 8, torch.device("cpu"), sp=2, tp=2)
    assert (w.data_rank, w.seq_rank, w.tensor_rank) == (1, 1, 0)
