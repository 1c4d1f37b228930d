"""The port's expert parallelism (``parallel.expert``; ``--ep``, seq x
EP, EP x TP, seq x EP x TP and seq x TP with an MoE FFN) against the JAX
package's, on the CPU.

(a) Whole Trainer runs (three steps) from the JAX init on the same
batches against the JAX Trainer on a mesh of fake CPU devices, over local
groups in one process (``LocalExpertGroup`` beside ``LocalSeqGroup`` /
``LocalTensorGroup``) and over 4 gloo ranks (``ProcessExpertGroup`` with
the seq / tensor process groups; one module fixture spawns them for
every job), with ``--accum_steps`` and ``--grad_clip``; the step's
``aux`` metric against JAX's step; the eval.  (b) The partition rules
against JAX's ``moe_param_specs`` / ``moe_tp_param_specs``; the
``StateLayout`` on the gloo ranks (each rank holds its experts' values
and bytes) and the snapshot gathered from the shards (bitwise the dense
tree); an exact resume under seq x EP x TP; the replica check, which
skips the expert leaves as JAX's ``Fingerprinter`` does.  (c) JAX's
refusals with JAX's type and message, and pipe x expert and MoE under
GSPMD naming ``QUEUE_A4``.

f32 on both sides.  Tolerance 1e-5 (rtol and atol) on the losses and
params after three steps.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.ops import optim as jopt
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    expert as jep,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train.state import (
    TrainState as JaxTrainState,
)
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    expert as ep,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (
    world_setup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.expert import (
    LocalExpertGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (
    LocalTensorGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (
    LocalSeqGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (
    TrainState,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    QUEUE_A4, Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    consistency,
)
from torch_expert_child import moe_flags, run, spawn

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 3

# name -> (layout flags, runs over local groups, runs over 4 gloo ranks)
JOBS = {
    "ep4": (["--ep", "4"], True, False),
    "dp2_ep2_accum_clip": (["--dp", "2", "--ep", "2", "--accum_steps", "2",
                            "--grad_clip", "0.05"], False, True),
    "sp2_ep2_ring_flash": (["--sp", "2", "--ep", "2", "--attention",
                            "ring_flash"], True, True),
    "sp2_ep2_striped_flash_top2_swiglu": (
        ["--sp", "2", "--ep", "2", "--attention", "striped_flash",
         "--accum_steps", "2", "--moe_top_k", "2", "--ffn_activation",
         "swiglu"], True, False),
    "ep2_tp2": (["--ep", "2", "--tp", "2"], True, True),
    "sp2_ep2_tp2_ulysses": (["--sp", "2", "--ep", "2", "--tp", "2",
                             "--attention", "ulysses", "--accum_steps",
                             "2", "--grad_clip", "0.05"], True, False),
    "sp2_tp2_moe_ring": (["--sp", "2", "--tp", "2", "--attention", "ring",
                          "--moe_capacity_factor", "0.5"], True, False),
}


def flags_of(name, *extra):
    return moe_flags(*JOBS[name][0], *extra)


def _jcfg(flags):
    return jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))


def _jax_trainer(flags):
    jcfg = _jcfg(flags)
    m = jcfg.mesh
    n = max(m.data, 1) * m.expert * m.seq * m.tensor
    return JaxTrainer(jcfg, mesh=make_mesh(m, devices=jax.devices("cpu")[:n]))


@functools.lru_cache(maxsize=None)
def jax_trajectory(name):
    """(init params, per-step losses, final params) of the JAX Trainer."""
    jt = _jax_trainer(flags_of(name))
    jt.init_state()
    init = jax.device_get(jt.state.params)
    losses = []
    for batch in jt.loader.epoch(0):
        if len(losses) == STEPS:
            break
        jt.state, loss = jt.train_step(jt.state, batch)
        losses.append(float(loss))
    return init, losses, jax.device_get(jt.state.params)


def _local_groups(flags):
    cfg = config_from_args(build_argparser().parse_args(flags))
    m, kw = cfg.mesh, {}
    if m.expert > 1:
        kw["expert_group"] = LocalExpertGroup(m.expert)
    if m.seq > 1:
        kw["seq_group"] = LocalSeqGroup(m.seq)
    if m.tensor > 1:
        kw["tensor_group"] = LocalTensorGroup(m.tensor)
    return cfg, kw


def _port(flags):
    cfg, kw = _local_groups(flags)
    return Trainer(cfg, device="cpu", **kw)


def assert_params_close(got, want, **tol):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **(tol or TOL))


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Every gloo job (and the state job) over 4 ranks, once."""
    jobs = {name: (flags_of(name), jax_trajectory(name)[0], STEPS)
            for name, (_, _, gloo) in JOBS.items() if gloo}
    ck = str(tmp_path_factory.mktemp("ep_ck"))
    jobs["dp2_ep2_state"] = (
        moe_flags("--dp", "2", "--ep", "2", "--checkpoint_dir", ck),
        jax_trajectory("dp2_ep2_accum_clip")[0], 1)
    outs = spawn(str(tmp_path_factory.mktemp("ep")), 4, {"jobs": jobs})
    return outs, ck


@pytest.mark.parametrize("name", [n for n, j in JOBS.items() if j[1]])
def test_local_groups_trainer_matches_jax(name):
    init, want, want_params = jax_trajectory(name)
    trainer = _port(flags_of(name))
    assert trainer.layout_tag == ("ep_tp" if "tp2" in name else "expert")
    got, params = run(trainer, init, STEPS)
    np.testing.assert_allclose(got, want, **TOL)
    assert_params_close(params, want_params)


@pytest.mark.parametrize("name", [n for n, j in JOBS.items() if j[2]])
def test_gloo_ranks_trainer_matches_jax(gloo_runs, name):
    _, want, want_params = jax_trajectory(name)
    outs, _ = gloo_runs
    for out in outs:
        got, params = out[name]
        np.testing.assert_allclose(got, want, **TOL)
        assert_params_close(params, want_params)


def test_step_aux_metric_matches_jax():
    """The step's metrics {"loss", "aux"} against JAX's
    make_moe_train_step over data=1 x expert=2 (aux weighted into the
    loss, accumulated over 2 microbatches, clipped)."""
    kw = dict(vocab_size=64, max_seq_len=16, n_layers=2, d_model=32,
              n_heads=4, d_ff=64, moe_experts=4, attention="dense")
    from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (  # noqa: E501
        Transformer as JT, TransformerConfig as JC,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (  # noqa: E501
        Transformer, TransformerConfig,
    )

    jm = JT(JC(moe_expert_axis="expert", **kw))
    mesh = make_mesh(jconfig.MeshConfig(data=1, expert=2),
                     devices=jax.devices("cpu")[:2])
    opt = jopt.sgd(lr=0.1, momentum=0.9)
    st = JaxTrainState.create(jm, opt, jprng.init_key(0))
    init = jax.device_get(st.params)
    st = jep.shard_moe_state(st, mesh, opt)
    tok = np.random.default_rng(0).integers(0, 64, (8, 17))
    batch = {"x": tok[:, :-1].astype(np.int32),
             "y": tok[:, 1:].astype(np.int32),
             "mask": np.array([1] * 7 + [0], np.float32)}
    placed = {k: jax.device_put(v, NamedSharding(mesh, P(jep.TOKEN_AXES)))
              for k, v in batch.items()}
    jstep = jep.make_moe_train_step(jm, opt, mesh, donate=False,
                                    accum_steps=2, grad_clip=0.1)
    group = LocalExpertGroup(2)
    m = Transformer(TransformerConfig(**kw), device="cpu",
                    expert_group=group)
    popt = optim.sgd(0.1, 0.9, steps=STEPS)
    ps = TrainState.from_params(params_from_jax(init, m.cfg, "cpu"), popt,
                                m)
    pstep = ep.make_moe_train_step(m, popt, world_setup("cpu"), group,
                                   accum_steps=2, grad_clip=0.1)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    for _ in range(STEPS):
        st, jm_ = jstep(st, placed)
        ps, pm = pstep(ps, tb)
        for k in ("loss", "aux"):
            np.testing.assert_allclose(float(pm[k]), float(jm_[k]), **TOL)
    assert_params_close(tree_to_numpy(ps.params), jax.device_get(st.params))


@pytest.mark.parametrize("layout", [["--ep", "2"], ["--ep", "2", "--tp",
                                                     "2"]],
                         ids=["ep2", "ep2_tp2"])
def test_accum_matches_unaccumulated(layout):
    """tests/test_composition.py's expert case: with a capacity no
    microbatch overflows (factor 8), --accum_steps 2 trains as 1 within
    JAX's bars (the aux is nonlinear in the batch's statistics, so the
    mean of the microbatches' aux is not the batch's)."""
    runs = []
    for accum in ("1", "2"):
        t = _port(moe_flags(*layout, "--moe_capacity_factor", "8",
                            "--accum_steps", accum))
        t.init_state()
        losses = []
        for batch in list(t.loader.epoch(0))[:STEPS]:
            t.state, loss = t.train_step(t.state, batch)
            losses.append(float(loss))
        runs.append((losses, tree_to_numpy(t.state.params)))
    (l1, p1), (l2, p2) = runs
    np.testing.assert_allclose(l2[-1], l1[-1], rtol=1e-3)
    for a, b in zip(jax.tree_util.tree_leaves(p2),
                    jax.tree_util.tree_leaves(p1)):
        np.testing.assert_allclose(a, b, atol=1e-2)
    assert l1 != l2     # the microbatches' routing and aux differ


@pytest.mark.parametrize("name", ["sp2_ep2_tp2_ulysses"])
def test_eval_matches_jax(name):
    """The eval step's loss and accuracy over the data, from JAX's init."""
    jt = _jax_trainer(flags_of(name))
    jt.init_state()
    trainer = _port(flags_of(name))
    run(trainer, jax.device_get(jt.state.params), max_steps=0)
    want = jt.evaluate(jt.data)
    got = trainer.evaluate(trainer.data)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# (b) the partition rules, the state, snapshots, resume, the replica check
# ---------------------------------------------------------------------------

def _spec_dims(spec):
    def dim(axis):
        dims = [i for i, a in enumerate(spec) if a == axis]
        return dims[0] if dims else None

    return [dim("tensor"), dim("expert")]


@pytest.mark.parametrize("tp", [1, 2])
def test_param_specs_match_jax(tp):
    name = "ep2_tp2" if tp > 1 else "ep4"
    init = jax_trajectory(name)[0]
    specs = (jep.moe_tp_param_specs(init) if tp > 1
             else jep.moe_param_specs(init))
    want = jax.tree_util.tree_map(_spec_dims, specs,
                                  is_leaf=lambda x: isinstance(x, P))
    got = jax.tree_util.tree_map(lambda s: [s.tensor, s.expert],
                                 ep.moe_param_specs(
                                     tree_from_jax(init, "cpu"), True, tp))
    lists = dict(is_leaf=lambda x: isinstance(x, list) and (
        not x or not isinstance(x[0], dict)))
    assert jax.tree_util.tree_flatten_with_path(got, **lists)[0] == \
        jax.tree_util.tree_flatten_with_path(want, **lists)[0]


def test_gloo_state_holds_each_ranks_experts(gloo_runs):
    """--dp 2 --ep 2 over 4 gloo ranks: each rank holds the expert slices
    of its expert index (values and bytes), the replicated leaves whole,
    and the snapshot gathered from the shards is the global tree
    bitwise."""
    outs, ck = gloo_runs
    init = jax_trajectory("dp2_ep2_accum_clip")[0]
    whole = outs[0]["dp2_ep2_state"][1]
    for rank, out in enumerate(outs):
        _, params, held = out["dp2_ep2_state"]
        e = rank % 2          # rank = data * ep + expert
        jax.tree_util.tree_map(np.testing.assert_array_equal, params, whole)
        for (path, h), (_, w), (_, i) in zip(
                jax.tree_util.tree_flatten_with_path(held)[0],
                jax.tree_util.tree_flatten_with_path(whole)[0],
                jax.tree_util.tree_flatten_with_path(init)[0]):
            if "experts" in jax.tree_util.keystr(path):
                assert h.shape[0] == np.shape(i)[0] // 2
                assert h.nbytes == np.asarray(i).nbytes // 2
                np.testing.assert_array_equal(h, np.split(w, 2)[e])
            else:
                assert h.shape == np.shape(i)
                np.testing.assert_array_equal(h, w)
    step, saved = ckpt.restore_params(ck, jax.tree_util.tree_map(
        torch.tensor, whole))
    assert step == 1
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           tree_to_numpy(saved), whole)


def test_resume_under_seq_ep_tp_continues_exactly(tmp_path):
    """Three steps straight == one step, a snapshot, a new Trainer's
    resume and two more steps, bitwise (seq x EP x TP over local
    groups; qkv_tp 2 and the expert x seq x tensor mesh in the meta)."""
    flags = flags_of("sp2_ep2_tp2_ulysses")
    straight = _port(flags)
    straight.init_state()
    for i, batch in enumerate(straight.loader.epoch(0)):
        straight.state, _ = straight.train_step(straight.state, batch)
    ck = str(tmp_path / "ck")
    first = _port(flags + ["--checkpoint_dir", ck])
    first.init_state()
    batches = list(first.loader.epoch(0))
    first.state, _ = first.train_step(first.state, batches[0])
    first.save(final=True)
    ckpt.wait_pending()
    meta = ckpt.read_meta(ck, step=1)
    assert meta["qkv_tp"] == 2
    mesh = meta["saved_world"]["mesh"]
    assert (mesh["expert"], mesh["seq"], mesh["tensor"]) == (2, 2, 2)
    resumed = _port(flags + ["--checkpoint_dir", ck, "--resume"])
    resumed.init_state()
    assert resumed.maybe_resume() == 1
    for batch in batches[1:]:
        resumed.state, _ = resumed.train_step(resumed.state, batch)
    for a, b in zip(jax.tree_util.tree_leaves(
            tree_to_numpy(resumed.state)), jax.tree_util.tree_leaves(
            tree_to_numpy(straight.state))):
        np.testing.assert_array_equal(a, b)


def test_replica_check_skips_the_expert_leaves():
    """Under --ep the fingerprint covers JAX's replicated leaves: the
    expert leaves (and their optimizer slots) are skipped."""
    from neural_networks_parallel_training_with_mpi_tpu.utils import (
        consistency as jcons,
    )

    flags = flags_of("ep4")
    jt = _jax_trainer(flags)
    jt.init_state()
    want = set(jcons.Fingerprinter(jt.state, jt.mesh).paths) - {".step"}
    t = _port(flags)
    t.init_state()
    got = set(consistency.Fingerprinter(t.state,
                                        skip=t._unreplicated()).paths)
    assert got == want
    assert not any("experts" in p for p in got)
    assert any("['gate']" in p for p in got)


def test_cli_ep_flag_wires_moe(capsys):
    """--ep 2 without --moe_experts means 4 experts; one process runs
    the shards as a LocalExpertGroup."""
    from neural_networks_parallel_training_with_mpi_tpu_torch import cli

    flags = moe_flags()
    i = flags.index("--moe_experts")
    flags = flags[:i] + flags[i + 2:]
    assert cli.main(flags + ["--ep", "2", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "layout: expert" in out
    cfg = config_from_args(build_argparser().parse_args(flags + ["--ep",
                                                                 "2"]))
    assert cfg.model.moe_experts == 4


# ---------------------------------------------------------------------------
# (c) the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,exc", [
    (["--dataset", "digits", "--ep", "2"], ValueError),
    (["--ep", "2", "--ce_chunk", "8"], ValueError),
    (["--ep", "2", "--update_sharding", "zero1"], NotImplementedError),
    (["--ep", "2", "--update_sharding", "sharded"], NotImplementedError),
    (["--ep", "2", "--tp", "2", "--update_sharding", "sharded"],
     NotImplementedError),
    (["--ep", "2", "--optimizer", "adafactor"], ValueError),
    (["--ep", "2", "--grad_reduction", "per_shard_mean"], ValueError),
    (["--ep", "2", "--matmul_dtype", "int8"], NotImplementedError),
    (["--ep", "2", "--tp", "2", "--matmul_dtype", "fp8"],
     NotImplementedError),
    (["--moe_experts", "4", "--matmul_dtype", "int8"], ValueError),
    (["--ep", "2", "--scan-layers"], ValueError),
    (["--ep", "2", "--tp", "2", "--scan-layers"], ValueError),
    (["--ep", "2", "--skip-nonfinite"], NotImplementedError),
], ids=["no_moe", "ce_chunk", "zero1", "sharded", "ep_tp_sharded",
        "adafactor", "per_shard_mean", "int8", "ep_tp_fp8", "moe_int8",
        "scan", "ep_tp_scan", "guard"])
def test_jax_refusals_raise_jax_type_and_message(extra, exc):
    flags = moe_flags(*extra)
    with pytest.raises(exc) as theirs:
        _jax_trainer(flags)
    with pytest.raises(exc) as ours:
        _port(flags)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("extra", [
    ["--ep", "2", "--pp", "2"], ["--pp", "2"],
    ["--ep", "2", "--tp", "2", "--pp", "2"], ["--tp", "2"],
    ["--fsdp", "2"]], ids=["pp_ep", "pp_moe", "pp_ep_tp", "gspmd_moe",
                           "fsdp_moe"])
def test_held_out_mixes_name_queue_a4(extra):
    with pytest.raises(NotImplementedError, match=QUEUE_A4):
        Trainer(config_from_args(build_argparser().parse_args(
            moe_flags(*extra))), device="cpu")
