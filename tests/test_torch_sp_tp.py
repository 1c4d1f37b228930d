"""The port's DP x SP x TP training (``--sp`` x ``--tp``, JAX's ``sp_tp``)
against the JAX package, on the CPU.

The slice rules against JAX's ``sp_tp_param_specs``; whole trainer runs
with ``ring``, ``ring_flash``, ``striped``, ``striped_flash`` and
``ulysses`` attention, with and without ``--vocab_parallel``, over a
``LocalSeqGroup(2)`` x ``LocalTensorGroup(2)`` and over 4 gloo ranks
(``ProcessSeqGroup`` x ``ProcessTensorGroup``), each against the JAX
Trainer on a ``data=1 x seq=2 x tensor=2`` mesh of fake CPU devices from
the same (permuted) init; the eval; snapshots (``qkv_tp`` = tp, resumed
across dense, ``sp_tp`` and tensor sizes bitwise, interchangeable with
the JAX Trainer's both ways, and ``--generate`` from one); and the
``sp_tp`` refusals.  f32 on both sides.  Tolerance 1e-5 (rtol and atol;
JAX's own test of this layout, ``tests/test_composition.py``
``TestSeqTensor``, holds rtol 2e-4 with atol 1e-4).
"""

import functools
import pickle

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    spmd as jspmd,
)
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import cli
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    spmd,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (
    LocalTensorGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (
    LocalSeqGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
)
from test_torch_tensor_parallel import (
    _jax_mesh, _jax_trainer, _port, _state_arrays, assert_outputs_close,
    assert_params_close, state_arrays,
)
from test_torch_tensor_parallel import jax_trajectory as gspmd_trajectory
from torch_tp_child import lm_flags, run, spawn

pytestmark = pytest.mark.torch_port

IMPLS = ("ring", "ring_flash", "striped", "striped_flash", "ulysses")


def flags_of(impl, vocab_parallel=False, *extra):
    return lm_flags("mha", "--sp", "2", "--tp", "2", "--attention", impl,
                    *(["--vocab_parallel"] if vocab_parallel else []),
                    *extra)


def _groups(sp=2, tp=2):
    return dict(seq_group=LocalSeqGroup(sp), tensor_group=LocalTensorGroup(tp))


@functools.lru_cache(maxsize=None)
def jax_trajectory(flags):
    """(init params, per-step losses, final params) of the JAX sp_tp
    Trainer; the init is JAX's, qkv already permuted."""
    jt = _jax_trainer(list(flags))
    assert jt.sp_tp
    jt.init_state()
    init = jax.device_get(jt.state.params)
    losses = []
    for epoch in range(jt.cfg.nepochs):
        for batch in jt.loader.epoch(epoch):
            jt.state, loss = jt.train_step(jt.state, batch)
            losses.append(float(loss))
    return init, losses, jax.device_get(jt.state.params)


# ---------------------------------------------------------------------------
# the slice rules and the init
# ---------------------------------------------------------------------------

def _spec_dim(spec):
    dims = [i for i, a in enumerate(spec) if a == "tensor"]
    return dims[0] if dims else None


@pytest.mark.parametrize("vocab_parallel", [False, True])
@pytest.mark.parametrize("extra", [[], ["--scan-layers"],
                                   ["--ffn_activation", "swiglu"]])
def test_sp_tp_param_specs_match_jax(vocab_parallel, extra):
    flags = flags_of("ring", vocab_parallel, *extra)
    trainer = _port(flags, **_groups())
    trainer.init_state()
    jt = _jax_trainer(flags)
    jt.init_state()
    want = jax.tree_util.tree_map(
        _spec_dim, jspmd.sp_tp_param_specs(jax.device_get(jt.state.params),
                                           vocab_parallel),
        is_leaf=lambda x: isinstance(x, P))
    got = spmd.sp_tp_param_specs(trainer.state.params, vocab_parallel)
    none = dict(is_leaf=lambda x: x is None)
    assert jax.tree_util.tree_leaves(got, **none) == \
        jax.tree_util.tree_leaves(want, **none)


def test_init_is_the_dense_init_permuted():
    dense = _port(lm_flags("mha"))
    dense.init_state()
    trainer = _port(flags_of("ring"), **_groups())
    trainer.init_state()
    want = spmd.permute_params(dense.model, dense.state.params, 2)
    assert trainer.qkv_tp == 2 and trainer.layout_tag == "sp_tp"
    for a, b in zip(_state_arrays(trainer),
                    state_arrays(dense.state._replace(params=want))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab_parallel", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_local_groups_match_jax_sp_tp(impl, vocab_parallel):
    flags = tuple(flags_of(impl, vocab_parallel))
    init, want, want_params = jax_trajectory(flags)
    trainer = _port(list(flags), **_groups())
    got, params = run(trainer, init)
    assert_outputs_close(got, want)
    assert_params_close(params, want_params)


def test_grad_clip_inside_the_sp_tp_step_matches_jax():
    flags = tuple(flags_of("striped", True, "--grad_clip", "0.5"))
    init, want, want_params = jax_trajectory(flags)
    got, params = run(_port(list(flags), **_groups()), init)
    assert_outputs_close(got, want)
    assert_params_close(params, want_params)
    assert not np.allclose(want, jax_trajectory(
        tuple(flags_of("striped", True)))[1])


GLOO = [("ring", False), ("striped_flash", True), ("ulysses", False),
        ("ulysses", True)]


# DP x TP over 2 data x 2 tensor ranks (JAX's GSPMD Trainer on data=2 x
# tensor=2) rides the same 4-rank world
DP_TP = tuple(lm_flags("gqa", "--dp", "2", "--tp", "2"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The jobs over 4 gloo ranks: seq 2 x tensor 2 (rank = seq * 2 +
    tensor), and data 2 x tensor 2, from JAX's inits."""
    tmp = tmp_path_factory.mktemp("sp_tp_ranks")
    jobs = {f"{impl}_{vp}": (flags_of(impl, vp),
                             jax_trajectory(tuple(flags_of(impl, vp)))[0],
                             None) for impl, vp in GLOO}
    jobs["dp_tp"] = (list(DP_TP), gspmd_trajectory("dp_tp", DP_TP)[0], None)
    return spawn(str(tmp), 4, {"jobs": jobs})


def test_four_gloo_ranks_dp2_x_tp2_match_jax_gspmd(four_ranks):
    _, want, want_params = gspmd_trajectory("dp_tp", DP_TP)
    for out in four_ranks:
        got, params = out["dp_tp"]
        assert_outputs_close(got, want)
        assert_params_close(params, want_params)


@pytest.mark.parametrize("impl,vocab_parallel", GLOO)
def test_four_gloo_ranks_match_jax_sp_tp(four_ranks, impl, vocab_parallel):
    _, want, want_params = jax_trajectory(tuple(flags_of(impl,
                                                         vocab_parallel)))
    for out in four_ranks:
        got, params = out[f"{impl}_{vocab_parallel}"]
        assert_outputs_close(got, want)
        assert_params_close(params, want_params)


@pytest.mark.parametrize("vocab_parallel", [False, True])
def test_eval_matches_jax_sp_tp(vocab_parallel):
    flags = flags_of("ring", vocab_parallel)
    jt = _jax_trainer(flags)
    jt.init_state()
    trainer = _port(flags, **_groups())
    run(trainer, jax.device_get(jt.state.params), max_steps=0)
    want = jt.evaluate(jt.data)
    got = trainer.evaluate(trainer.data)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def _resumed(flags, **kw):
    t = _port(flags + ["--resume"], **kw)
    t.init_state()
    t.maybe_resume()
    return t


def test_snapshot_holds_the_permuted_order_and_resumes_across_layouts(
        tmp_path):
    """An sp_tp run saves qkv_tp 2 with its qkv columns permuted.  A dense
    trainer resumes it into the dense order, a --tp 4 sp_tp one into its
    own, and back: params and every Adam slot bitwise."""
    ck = str(tmp_path / "ck")
    extra = ["--optimizer", "adam", "--checkpoint_dir", ck]
    saver = _port(flags_of("ring", False, *extra), **_groups())
    saver.fit()
    assert ckpt.read_meta(ck)["qkv_tp"] == 2
    model = saver.model
    dense_state = saver.state._replace(
        params=spmd.permute_params(model, saver.state.params, 2,
                                   inverse=True),
        opt_state=saver.state.opt_state._replace(
            mu=spmd.permute_params(model, saver.state.opt_state.mu, 2,
                                   inverse=True),
            nu=spmd.permute_params(model, saver.state.opt_state.nu, 2,
                                   inverse=True)))
    want_dense = state_arrays(dense_state)
    dense = _resumed(lm_flags("mha", *extra))
    for a, b in zip(_state_arrays(dense), want_dense):
        np.testing.assert_array_equal(a, b)
    t4 = _resumed(flags_of("ring", False, *extra) + ["--tp", "4"],
                  **_groups(tp=4))
    want4 = spmd.permute_params(model, dense_state.params, 4)
    for (_, a), (_, b) in zip(ckpt.flatten(t4.state.params),
                              ckpt.flatten(want4)):
        assert torch.equal(a, b)
    # and back: the --tp 4 state saved, a --tp 2 sp_tp trainer resumes it
    ck4 = str(tmp_path / "ck4")
    ckpt.save(ck4, t4.state, extra_meta={"qkv_tp": 4})
    back = _resumed(flags_of("ring", False, "--optimizer", "adam",
                             "--checkpoint_dir", ck4), **_groups())
    for a, b in zip(_state_arrays(back), _state_arrays(saver)):
        np.testing.assert_array_equal(a, b)
    # a dense snapshot into sp_tp
    dense_ck = str(tmp_path / "dense")
    ckpt.save(dense_ck, dense.state, extra_meta={"qkv_tp": 1})
    back = _resumed(flags_of("ring", False, "--optimizer", "adam",
                             "--checkpoint_dir", dense_ck), **_groups())
    for a, b in zip(_state_arrays(back), _state_arrays(saver)):
        np.testing.assert_array_equal(a, b)


def test_jax_sp_tp_trainer_and_the_port_resume_each_other(tmp_path):
    flags = flags_of("striped", True, "--optimizer", "adam", "--nepochs",
                     "1")
    port_ck, jax_ck = str(tmp_path / "port"), str(tmp_path / "jax")
    saver = _port(flags + ["--checkpoint_dir", port_ck], **_groups())
    saver.fit()
    jt = _jax_trainer(flags + ["--checkpoint_dir", port_ck, "--resume"])
    jt.init_state()
    (ckpt._snapshot_dirs(port_ck)[-1][1] / "treedef.pkl").write_bytes(
        pickle.dumps(jax.tree_util.tree_structure(jt.state)))
    assert jt.maybe_resume() == saver.state.step
    got = jax.tree_util.tree_leaves(jax.device_get(jt.state))
    assert len(got) == len(_state_arrays(saver))
    for a, b in zip(got, _state_arrays(saver)):
        np.testing.assert_array_equal(np.asarray(a), b)
    js = _jax_trainer(flags + ["--checkpoint_dir", jax_ck])
    js.fit()
    assert ckpt.read_meta(jax_ck)["qkv_tp"] == 2
    t = _resumed(flags + ["--checkpoint_dir", jax_ck], **_groups())
    want = jax.tree_util.tree_leaves(jax.device_get(js.state))
    for a, b in zip(_state_arrays(t), want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_generate_reads_an_sp_tp_snapshot_in_the_dense_order(tmp_path,
                                                            capsys):
    """--generate from an sp_tp snapshot and from the same params saved in
    the dense order print the same tokens."""
    ck, dense_ck = str(tmp_path / "sp_tp"), str(tmp_path / "dense")
    saver = _port(flags_of("ring", False, "--checkpoint_dir", ck),
                  **_groups())
    saver.fit()
    dense = saver.state._replace(params=spmd.permute_params(
        saver.model, saver.state.params, 2, inverse=True))
    ckpt.save(dense_ck, dense, extra_meta={"qkv_tp": 1})
    gen = lm_flags("mha") + ["--generate", "1,2,3", "--max_new_tokens", "6",
                             "--platform", "cpu"]
    outs = []
    for d in (ck, dense_ck):
        capsys.readouterr()
        assert cli.main(gen + ["--checkpoint_dir", d]) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.strip()][-1])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# refusals (JAX's type and message)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,tp", [
    (flags_of("ulysses", False, "--tp", "4"), 4),        # 1 head over 2
    (flags_of("ring", True, "--vocab_size", "63"), 2),
    (flags_of("ring", True, "--label_smoothing", "0.1"), 2),
], ids=["ulysses_heads", "vocab_size", "label_smoothing"])
def test_sp_tp_refusals_raise_jax_messages(flags, tp):
    jcfg, mesh = _jax_mesh(flags)
    with pytest.raises(ValueError) as want:
        JaxTrainer(jcfg, mesh=mesh)
    with pytest.raises(ValueError) as got:
        _port(flags, **_groups(tp=tp))
    assert str(got.value) == str(want.value)
