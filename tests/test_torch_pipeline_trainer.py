"""The port's ``--pp`` / ``--pp_interleave`` Trainer against the JAX
package's, on the CPU (the step-level parity is
``tests/test_torch_pipeline.py``'s).

(e) The ``--pp 2`` trajectory, its accumulation fold and the interleave
with the clip against JAX's Trainer on a ``pipe`` mesh of fake CPU
devices from the same stacked init (``interop``), and the eval; the
snapshots: JAX's and the port's ``--pp 2`` runs resume each other bitwise
(the stacked layout), a ``--pp 2 --tp 2`` snapshot (``qkv_tp`` 2, JAX's
and the port's) resumes into ``--pp 2`` (the ``test_composition.py``
case), and ``--generate`` from a JAX ``--pp 2 --pp_interleave 2 --tp 2``
snapshot prints JAX's tokens.  (f) Over gloo ranks (``ProcessPipeGroup``,
``tests/torch_pipeline_child.py``: 2 ranks ``--pp 2`` and ``--pp 2
--pp_interleave 2``, 4 ranks ``--dp 2 --pp 2`` and ``--pp 2 --tp 2``) the
trajectories equal the ``LocalPipeGroup`` runs' within 1e-6, and a
snapshot of 4 ranks gathers the stages to rank 0 and restores each
rank's slices.  (g) The Trainer's refusals under ``--pp``, with JAX's
type and message; ``--moe_experts`` and ``--ep`` stay refused under
``--pp`` (pipe x expert).

f32, SGD-momentum trajectories (loss rtol 1e-5, params rtol 1e-4 / atol
1e-5, JAX's own tolerances).
"""

import dataclasses
import functools
import pickle

import jax
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import cli as jcli
from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.ops import optim as joptim
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    pipeline as jpp,
)
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import cli
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    pipeline as pp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (
    world_setup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (
    LocalTensorGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.pipeline import (
    LocalPipeGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (
    LocalSeqGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
)
from test_torch_pipeline import (LOSS_TOL, _mesh, _np, assert_trees_close,
                                 jax_model, port_model)
from torch_pipeline_child import run as child_run
from torch_pipeline_child import spawn
from torch_tp_child import run as run_from

pytestmark = pytest.mark.torch_port


# ---------------------------------------------------------------------------
# (e) the Trainer against JAX's
# ---------------------------------------------------------------------------

LM = ["--dataset", "lm", "--no-full-batch", "--batch_size", "4",
      "--nepochs", "1", "--n_samples", "16", "--seq_len", "16",
      "--vocab_size", "64", "--n_layers", "4", "--d_model", "32",
      "--n_heads", "4", "--d_ff", "64", "--optimizer", "sgd", "--lr", "0.1",
      "--momentum", "0.9"]


def _jax_trainer(flags):
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))
    m = jcfg.mesh
    return JaxTrainer(jcfg, mesh=_mesh(max(m.data, 1), m.pipe, m.seq,
                                       m.tensor, m.fsdp))


def _port(flags, **kw):
    return Trainer(config_from_args(build_argparser().parse_args(flags)),
                   device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def jax_trajectory(flags):
    jt = _jax_trainer(list(flags))
    assert jt.pipeline
    jt.init_state()
    init = jax.device_get(jt.state.params)
    losses = []
    for epoch in range(jt.cfg.nepochs):
        for batch in jt.loader.epoch(epoch):
            jt.state, loss = jt.train_step(jt.state, batch)
            losses.append(float(loss))
    return init, losses, _np(jt.state.params)


@pytest.mark.parametrize("extra", [
    ["--pp", "2"], ["--pp", "2", "--accum_steps", "2"],
    ["--pp", "2", "--pp_interleave", "2", "--grad_clip", "0.5"]],
    ids=["pp2", "accum2", "interleave2_clip"])
def test_trainer_trajectory_matches_jax(extra):
    flags = tuple(LM + extra)
    init, want, want_params = jax_trajectory(flags)
    trainer = _port(list(flags))
    assert isinstance(trainer.pipe_group, LocalPipeGroup)
    assert trainer.layout_tag == "pipe" and trainer.qkv_tp == 1
    got, params = run_from(trainer, init)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert_trees_close(params, want_params)
    leaf = trainer.state.params["blocks"]["qkv"]["w"]
    assert leaf.shape[:-2] == ((2, 2) if "--pp_interleave" not in extra
                               else (2, 2, 1))


def test_telemetry_is_loss_only_under_pipe(tmp_path):
    """As JAX's trainer: the pipe step returns its loss only, so
    ``--telemetry_dir`` records no on-device metrics."""
    flags = LM + ["--pp", "2", "--telemetry_dir", str(tmp_path)]
    assert not _jax_trainer(flags).telemetry_metrics
    assert not _port(flags).telemetry_metrics


def test_trainer_eval_matches_jax():
    flags = LM + ["--pp", "2", "--val_fraction", "0.25"]
    jt = _jax_trainer(flags)
    jt.init_state()
    trainer = _port(flags)
    run_from(trainer, jax.device_get(jt.state.params), max_steps=0)
    want = jt.evaluate(jt.val_data)
    got = trainer.evaluate(trainer.val_data)
    for k in ("loss", "accuracy", "ppl"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def _resumed(flags, **kw):
    t = _port(flags + ["--resume"], **kw)
    t.init_state()
    t.maybe_resume()
    return t


def _state_arrays(state):
    return [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
            for _, t in ckpt.flatten(state)]


def test_jax_pipe_trainer_and_the_port_resume_each_other(tmp_path):
    """A JAX --pp 2 snapshot restores into the port's --pp 2 run, and the
    port's into JAX's, params and optimizer slots bitwise (the stacked
    layout in both)."""
    flags = LM + ["--pp", "2", "--optimizer", "adam", "--lr", "0.01"]
    port_ck, jax_ck = str(tmp_path / "port"), str(tmp_path / "jax")
    saver = _port(flags + ["--checkpoint_dir", port_ck])
    saver.fit()
    meta = ckpt.read_meta(port_ck)
    assert meta["qkv_tp"] == 1 and meta["saved_world"]["mesh"]["pipe"] == 2
    assert ckpt.block_stack(port_ck, saver.model.init(
        torch.Generator().manual_seed(0))) == (2, 2)
    jt = _jax_trainer(flags + ["--checkpoint_dir", port_ck, "--resume"])
    jt.init_state()
    (ckpt._snapshot_dirs(port_ck)[-1][1] / "treedef.pkl").write_bytes(
        pickle.dumps(jax.tree_util.tree_structure(jt.state)))
    assert jt.maybe_resume() == saver.state.step
    got = jax.tree_util.tree_leaves(jax.device_get(jt.state))
    assert len(got) == len(_state_arrays(saver.state))
    for a, b in zip(got, _state_arrays(saver.state)):
        np.testing.assert_array_equal(np.asarray(a), b)
    js = _jax_trainer(flags + ["--checkpoint_dir", jax_ck])
    js.fit()
    t = _resumed(flags + ["--checkpoint_dir", jax_ck])
    assert t.state.step == int(jax.device_get(js.state.step))
    want = jax.tree_util.tree_leaves(jax.device_get(js.state))
    for a, b in zip(_state_arrays(t.state), want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_pp_tp_snapshot_resumes_into_pp(tmp_path):
    """The JAX package's test_composition resume: a --pp 2 --tp 2
    snapshot (qkv_tp 2, JAX's) resumes into the port's --pp 2 with the
    dense model bitwise, and the port's own --pp 2 --tp 2 snapshot too;
    the resumed run trains."""
    ck, port_ck = str(tmp_path / "jax"), str(tmp_path / "port")
    flags = LM + ["--pp", "2", "--optimizer", "adam", "--lr", "0.01"]
    js = _jax_trainer(flags + ["--tp", "2", "--checkpoint_dir", ck])
    js.fit()
    assert ckpt.read_meta(ck)["qkv_tp"] == 2
    want = _np(js._eval_params())
    t = _resumed(flags + ["--nepochs", "2", "--checkpoint_dir", ck])
    got = tree_to_numpy(dict(t.state.params, blocks=pp.dense_layer_blocks(
        t.state.params["blocks"])))
    assert_trees_close(got, want, rtol=0, atol=0)
    saver = _port(flags + ["--tp", "2", "--checkpoint_dir", port_ck],
                  tensor_group=LocalTensorGroup(2))
    saver.fit()
    dense = tree_to_numpy(dict(saver.state.params,
                               blocks=pp.dense_layer_blocks(
                                   saver.state.params["blocks"],
                                   saver.model.cfg, 2)))
    t2 = _resumed(flags + ["--nepochs", "2", "--checkpoint_dir", port_ck])
    got = tree_to_numpy(dict(t2.state.params, blocks=pp.dense_layer_blocks(
        t2.state.params["blocks"])))
    assert_trees_close(got, dense, rtol=0, atol=0)
    r = t2.fit()
    assert np.isfinite(r["final_loss"]) and r["steps"] == 8


def test_generate_from_a_pipe_snapshot_prints_jax_tokens(tmp_path, capsys):
    """JAX trains --pp 2 --pp_interleave 2 --tp 2 and saves (stacked
    (2, 2, 1) blocks, qkv permuted); JAX's --generate and the port's
    print the same greedy ids from it."""
    ck = str(tmp_path / "ck")
    js = _jax_trainer(LM + ["--pp", "2", "--pp_interleave", "2", "--tp",
                            "2", "--optimizer", "adam", "--lr", "0.01",
                            "--checkpoint_dir", ck])
    js.fit()
    assert ckpt.block_stack(ck, port_model().init(
        torch.Generator().manual_seed(0))) == (2, 2, 1)
    gen = ["--dataset", "lm", "--seq_len", "16", "--vocab_size", "64",
           "--n_layers", "4", "--d_model", "32", "--n_heads", "4",
           "--d_ff", "64", "--checkpoint_dir", ck, "--generate", "1,2,3",
           "--max_new_tokens", "10", "--platform", "cpu"]
    capsys.readouterr()
    assert jcli.main(gen) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert cli.main(gen) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and len(got.split(",")) == 13


# ---------------------------------------------------------------------------
# (f) gloo ranks against the local pipe group
# ---------------------------------------------------------------------------

GLOO = {
    2: {"pp2": ["--pp", "2"],
        "pp2_interleave2": ["--pp", "2", "--pp_interleave", "2"]},
    4: {"dp2_pp2": ["--dp", "2", "--pp", "2"],
        "pp2_tp2": ["--pp", "2", "--tp", "2"]},
}
GLOO_LM = LM + ["--batch_size", "8", "--n_samples", "24"]


# the snapshot over 4 ranks of --pp 2 --tp 2: saved after epoch 1, then
# resumed (each rank its stage's and tensor slices) for epoch 2
GLOO_CKPT = ["--pp", "2", "--tp", "2", "--optimizer", "adam", "--lr",
             "0.01"]


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    outs = {}
    for size, jobs in GLOO.items():
        tmp = tmp_path_factory.mktemp(f"pipe_ranks{size}")
        jobs = {name: GLOO_LM + extra for name, extra in jobs.items()}
        if size == 4:
            ck = ["--checkpoint_dir", str(tmp / "ck")]
            jobs["save"] = GLOO_LM + GLOO_CKPT + ck
            jobs["resume"] = GLOO_LM + GLOO_CKPT + ck + ["--resume",
                                                        "--nepochs", "2"]
        outs[size] = spawn(str(tmp), size, jobs)
        outs[f"{size}_dir"] = tmp
    return outs


@pytest.mark.parametrize("size,name", [(s, n) for s, jobs in GLOO.items()
                                       for n in jobs])
def test_gloo_ranks_match_the_local_pipe_group(gloo_ranks, size, name):
    extra = list(GLOO[size][name])
    if "--dp" in extra:             # one process holds every data row
        del extra[extra.index("--dp"):extra.index("--dp") + 2]
    kw = ({"tensor_group": LocalTensorGroup(2)} if "--tp" in extra else {})
    want, want_params = child_run(_port(GLOO_LM + extra, **kw))
    for out in gloo_ranks[size]:
        got, params = out[name]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert_trees_close(params, want_params, rtol=0, atol=1e-6)


def test_gloo_snapshot_gathers_the_stages_and_restores_each_ranks_slices(
        gloo_ranks, tmp_path):
    """4 ranks of --pp 2 --tp 2 save after epoch 1: the snapshot (the
    stacked layout, qkv_tp 2) holds the local run's state, params and
    Adam's slots, within 1e-6; resumed over the 4 ranks for epoch 2 they
    end where the local 2-epoch run ends."""
    ck = str(gloo_ranks["4_dir"] / "ck")
    assert ckpt.read_meta(ck, step=3)["qkv_tp"] == 2
    tensor = {"tensor_group": LocalTensorGroup(2)}
    local = _port(GLOO_LM + GLOO_CKPT + ["--checkpoint_dir",
                                         str(tmp_path / "one")], **tensor)
    local.fit()
    saved = _port(GLOO_LM + GLOO_CKPT + ["--checkpoint_dir", ck], **tensor)
    saved.init_state()
    restored = ckpt.restore(ck, saved._host_template(), step=3)
    assert restored is not None
    for a, b in zip(_state_arrays(restored), _state_arrays(local.state)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    two = _port(GLOO_LM + GLOO_CKPT + ["--nepochs", "2", "--checkpoint_dir",
                                       str(tmp_path / "two")], **tensor)
    r = two.fit()
    want = tree_to_numpy(two.whole_params())
    for out in gloo_ranks[4]:
        (loss,), params = out["resume"]
        np.testing.assert_allclose(loss, r["final_loss"], rtol=1e-6)
        assert_trees_close(params, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (g) refusals: JAX's type and message
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--pp_interleave", "2"],
    ["--pp", "2", "--pp_interleave", "2", "--n_layers", "2"],
    ["--pp", "2", "--fsdp", "2"],
    ["--pp", "2", "--skip-nonfinite"],
    ["--pp", "2", "--matmul_dtype", "int8"],
    ["--pp", "2", "--update_sharding", "zero1"],
    ["--pp", "2", "--update_sharding", "sharded"],
    ["--pp", "2", "--scan-layers"],
    ["--pp", "2", "--grad_reduction", "per_shard_mean"],
    ["--pp", "2", "--faults", "desync@2?det"],
], ids=["interleave_without_pp", "n_layers", "pipe_x_fsdp", "guard", "matmul_dtype", "zero1",
        "sharded", "scan_layers", "per_shard_mean", "desync_det"])
def test_refusals_raise_jax_messages(extra):
    flags = LM + extra
    with pytest.raises((ValueError, NotImplementedError)) as want:
        _jax_trainer(flags)
    with pytest.raises(want.type) as got:
        _port(flags)
    assert str(got.value) == str(want.value)


def test_seq_attention_without_sp_raises_jax_type_and_message():
    """The CLIs refuse --attention ring without --sp alike; a config made
    in code meets each trainer's own check (a ValueError in both, the
    port's naming its LocalSeqGroup); the pipeline step's own check
    raises JAX's type and message."""
    flags = LM + ["--pp", "2"]
    with pytest.raises(SystemExit) as want:
        jconfig.config_from_args(jconfig.build_argparser().parse_args(
            flags + ["--attention", "ring"]))
    with pytest.raises(SystemExit) as got:
        config_from_args(build_argparser().parse_args(
            flags + ["--attention", "ring"]))
    assert str(got.value) == str(want.value)
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))
    jcfg.model = dataclasses.replace(jcfg.model, attention="ring")
    with pytest.raises(ValueError, match="'seq' mesh axis"):
        JaxTrainer(jcfg, mesh=_mesh())
    cfg = config_from_args(build_argparser().parse_args(flags))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attention="ring"))
    with pytest.raises(ValueError, match="--sp > 1"):
        Trainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError) as want:
        jpp.make_pipeline_train_step(jax_model(attention="ring"),
                                     joptim.sgd(0.1), _mesh())
    with pytest.raises(NotImplementedError) as got:
        pp.make_pipeline_train_step(
            port_model(attention="ring", seq_group=LocalSeqGroup(1)),
            optim.sgd(0.1, steps=1), world_setup("cpu"), LocalPipeGroup(2))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("extra,flag", [
    (["--moe_experts", "4"], "--moe_experts"),
    (["--ep", "2", "--moe_experts", "4"], "--ep")])
def test_moe_and_expert_under_pipe_stay_refused(extra, flag):
    with pytest.raises(NotImplementedError, match=flag):
        _port(LM + ["--pp", "2"] + extra)
