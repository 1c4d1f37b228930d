"""The port's Trainer on the pipe x expert layout (``--pp`` with ``--ep``)
against the JAX package's and against the port's own expert step, on the
CPU (the step-level parity is ``tests/test_torch_pipeline_expert.py``'s).

JAX's ``--pp 2 --ep 2`` Trainer (a ``pipe=2 x expert=2`` mesh of fake CPU
devices) against the port's over ``LocalPipeGroup`` x ``LocalExpertGroup``
from JAX's init: the losses, the final params, and the snapshots crossing
both ways (JAX's restored into the port and the port's into JAX, params
and optimizer slots bitwise, the experts stage-stacked ``(S, per, E,
...)``).  The port's ``--pp 2 --ep 2`` against its ``--ep 2 --accum_steps
2``, a snapshot round trip and ``--generate`` from it; 4 gloo ranks of
``tests/torch_pipeline_expert_child.py`` (pp 2 x ep 2: the hops and the
all-to-alls across processes, each rank's stage slice of its experts,
the clip over the pipe and expert groups, the gathered snapshot); JAX's
refusal of an MoE model on the pipe layout without an expert axis, with
its words.

f32 on both sides.  Tolerances: loss rtol 1e-5, params rtol 1e-4 / atol
1e-5 against JAX (``tests/test_pipeline.py``'s); 1e-6 between the port's
own runs.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.ops import optim as joptim
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    pipeline as jpp,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
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
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.pipeline import (
    LocalPipeGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
)
from test_torch_pipeline_expert import (LOSS_TOL, assert_trees_close,
                                        jax_model, port_model)
from torch_tp_child import run as run_from

pytestmark = pytest.mark.torch_port


LM = ["--dataset", "lm", "--no-full-batch", "--batch_size", "8",
      "--nepochs", "1", "--n_samples", "24", "--seq_len", "16",
      "--vocab_size", "64", "--n_layers", "2", "--d_model", "32",
      "--n_heads", "4", "--d_ff", "64", "--optimizer", "sgd", "--lr", "0.1",
      "--momentum", "0.9", "--moe_experts", "4", "--attention", "dense"]


def _cfg(*extra):
    return config_from_args(build_argparser().parse_args(LM + list(extra)))


def _losses(trainer, steps=3):
    trainer.init_state()
    out = []
    for batch in list(trainer.loader.epoch(0))[:steps]:
        trainer.state, loss = trainer.train_step(trainer.state, batch)
        out.append(float(loss))
    return out


def test_trainer_pp_ep_equals_the_ep_step_and_round_trips(tmp_path, capsys):
    """--pp 2 --ep 2 in one process (LocalPipeGroup x LocalExpertGroup):
    "layout: pipe", its losses those of --ep 2 with --accum_steps 2 (the
    Trainer folds accumulation into 2 x 2 microbatches on the pipe), a
    snapshot restored into a new Trainer bitwise, and --generate from it
    printing the tokens of generate() over the dense params."""
    from neural_networks_parallel_training_with_mpi_tpu_torch import cli
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate import (  # noqa: E501
        generate,
    )

    ck = str(tmp_path / "ck")
    t = Trainer(_cfg("--pp", "2", "--ep", "2", "--checkpoint_dir", ck),
                device="cpu")
    assert t.pp_ep and t.layout_tag == "pipe"
    got = _losses(t)
    # the same seeded init: the pipeline's is the dense one stage-stacked
    ref = Trainer(_cfg("--ep", "2", "--accum_steps", "2"), device="cpu")
    np.testing.assert_allclose(got, _losses(ref), rtol=1e-5)
    assert_trees_close(
        tree_to_numpy(dict(t.state.params, blocks=pp.unstack_blocks(
            t.state.params["blocks"]))),
        tree_to_numpy(ref.state.params))
    t.save(final=True)
    ckpt.wait_pending()
    again = Trainer(_cfg("--pp", "2", "--ep", "2", "--checkpoint_dir", ck,
                         "--resume"), device="cpu")
    again.init_state()
    assert again.maybe_resume() == 3
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(again.state)),
                    jax.tree_util.tree_leaves(tree_to_numpy(t.state))):
        np.testing.assert_array_equal(a, b)
    capsys.readouterr()
    assert cli.main(LM + ["--checkpoint_dir", ck, "--generate", "3,1,4",
                          "--max_new_tokens", "5", "--platform",
                          "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("3,1,4,")]
    dense = dict(t.state.params, blocks=pp.unstack_blocks(
        t.state.params["blocks"]))
    want = generate(port_model(), dense, [[3, 1, 4]], 5, device="cpu")
    assert line == [",".join(str(int(x)) for x in want[0])]


def _jax_trainer(flags):
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))
    m = jcfg.mesh
    return JaxTrainer(jcfg, mesh=make_mesh(jconfig.MeshConfig(
        data=1, pipe=m.pipe, expert=m.expert), devices=jax.devices("cpu")[
            :m.pipe * m.expert]))


def _state_arrays(state):
    return [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
            for _, t in ckpt.flatten(state)]


def test_jax_pp_ep_trainer_matches_and_snapshots_cross_both_ways(tmp_path):
    """JAX's --pp 2 --ep 2 Trainer and the port's from JAX's init: losses
    and params; then a JAX snapshot restored into the port and the
    port's into JAX, params and Adam's slots bitwise."""
    flags = LM + ["--pp", "2", "--ep", "2"]
    jt = _jax_trainer(flags)
    assert jt.pp_ep
    jt.init_state()
    init = jax.device_get(jt.state.params)
    want = []
    for batch in list(jt.loader.epoch(0))[:3]:
        jt.state, loss = jt.train_step(jt.state, batch)
        want.append(float(loss))
    got, params = run_from(Trainer(_cfg(*flags[len(LM):]), device="cpu"),
                           init, 3)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert_trees_close(params, jax.device_get(jt.state.params))
    adam = ["--optimizer", "adam", "--lr", "0.01"]
    port_ck, jax_ck = str(tmp_path / "port"), str(tmp_path / "jax")
    saver = Trainer(_cfg("--pp", "2", "--ep", "2", *adam, "--checkpoint_dir",
                         port_ck), device="cpu")
    saver.fit()
    ckpt.wait_pending()
    meta = ckpt.read_meta(port_ck)
    assert meta["saved_world"]["mesh"]["expert"] == 2
    jr = _jax_trainer(flags + adam + ["--checkpoint_dir", port_ck,
                                      "--resume"])
    jr.init_state()
    (ckpt._snapshot_dirs(port_ck)[-1][1] / "treedef.pkl").write_bytes(
        pickle.dumps(jax.tree_util.tree_structure(jr.state)))
    assert jr.maybe_resume() == saver.state.step
    mine = _state_arrays(saver.state)
    theirs = jax.tree_util.tree_leaves(jax.device_get(jr.state))
    assert len(theirs) == len(mine)
    for a, b in zip(theirs, mine):
        np.testing.assert_array_equal(np.asarray(a), b)
    w_in = saver.state.params["blocks"]["moe"]["experts"]["w_in"]
    assert tuple(w_in.shape[:3]) == (2, 1, 4)      # (S, per, E)
    js = _jax_trainer(flags + adam + ["--checkpoint_dir", jax_ck])
    js.fit()
    t = Trainer(_cfg("--pp", "2", "--ep", "2", *adam, "--checkpoint_dir",
                     jax_ck, "--resume"), device="cpu")
    t.init_state()
    assert t.maybe_resume() == int(jax.device_get(js.state.step))
    for a, b in zip(_state_arrays(t.state),
                    jax.tree_util.tree_leaves(jax.device_get(js.state))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_gloo_pp_ep_equals_local_groups(tmp_path):
    """4 gloo ranks of tests/torch_pipeline_expert_child.py, pp 2 x ep 2
    (rank = pipe * 2 + expert): the hops and the all-to-alls cross
    processes, each rank holds its stage's slice of its experts, the clip
    sums over the pipe and expert buckets; losses and the gathered params
    equal the one-process run within 1e-6, and rank 0's snapshot is that
    tree."""
    from torch_pipeline_expert_child import spawn

    flags = LM + ["--pp", "2", "--ep", "2", "--grad_clip", "0.05"]
    local = Trainer(_cfg("--pp", "2", "--ep", "2", "--grad_clip", "0.05"),
                    device="cpu")
    want = _losses(local)
    ck = str(tmp_path / "ck")
    outs = spawn(str(tmp_path), 4, {"flags": flags + ["--checkpoint_dir",
                                                      ck], "steps": 3})
    whole = tree_to_numpy(local.state.params)
    for rank, (losses, params, held) in enumerate(outs):
        np.testing.assert_allclose(losses, want, rtol=1e-6, atol=1e-6)
        assert_trees_close(params, whole, rtol=1e-6, atol=1e-6)
        w_in = held["blocks"]["moe"]["experts"]["w_in"]
        assert w_in.shape == (1, 1, 2, 32, 64)   # (S/2, per, E/2, d, f)
        s, e = rank // 2, rank % 2
        np.testing.assert_allclose(
            w_in, params["blocks"]["moe"]["experts"]["w_in"][
                s:s + 1, :, 2 * e:2 * e + 2], rtol=0, atol=0)
    step, saved = ckpt.restore_params(ck, jax.tree_util.tree_map(
        torch.tensor, outs[0][1]))
    assert step == 3
    assert_trees_close(tree_to_numpy(saved), outs[0][1], rtol=0, atol=0)


def test_moe_on_the_pipe_layout_without_expert_raises_jaxs_error():
    with pytest.raises(NotImplementedError) as want:
        jpp.make_pipeline_train_step(
            jax_model(), joptim.sgd(0.1),
            make_mesh(jconfig.MeshConfig(data=1, pipe=2),
                      devices=jax.devices("cpu")[:2]))
    with pytest.raises(NotImplementedError) as got:
        Trainer(_cfg("--pp", "2"), device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError) as got:
        pp.make_pipeline_train_step(port_model(), optim.sgd(0.1, steps=1),
                                    world_setup("cpu"), LocalPipeGroup(2))
    assert str(got.value) == str(want.value)
