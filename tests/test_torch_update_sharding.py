"""The port's weight-update sharding (``--update_sharding sharded|zero1``)
and master weights against the JAX package, on the CPU.

Mirrors ``tests/test_update_sharding.py`` and ``tests/test_zero1.py``:
the per-leaf plan equals JAX's; over 2 spawned ``gloo`` ranks the sharded
and zero1 updates are bitwise equal to the replicated update without
clipping (a 2-rank sum is the same in any order, and the update math is
the same elementwise expressions on slices) and within ``TOL`` with
clipping (the global norm sums its squares in another order); both are
within ``TOL`` of JAX's 2-device trajectories from the same init (carried
across with ``interop``); the optimizer state is 1/N per rank; bf16
params equal the bf16 cast of their f32 master bitwise; snapshots of
every layout at N = 2, at a width 2 does not divide, cross between the
frameworks in both directions; DP x SP (2 data x 2 seq ranks) stays
within JAX's pinned tolerance of JAX's run.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.models.registry import (
    build_model as jax_build_model,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    update_sharding as jus,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    checkpoint as jckpt,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch import config as pconfig
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    data_parallel as dp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    update_sharding as us,
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
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (
    leaves,
)
from torch_update_sharding_child import LAYOUTS, PAD_HIDDEN, job, lm_job

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "torch_update_sharding_child.py")


def _jax_trainer(cfg, n=2):
    devices = jax.devices("cpu")[:n * cfg.mesh.seq]
    return JaxTrainer(cfg, mesh=make_mesh(cfg.mesh, devices=devices))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _host(x):
    """A JAX host array as the port's snapshot stores it (bf16 widened)."""
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _spawn(tmp, size):
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(r), str(size), str(tmp)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(size)]
    return procs


def _collect(tmp, procs):
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-4000:]
    outs = []
    for r in range(len(procs)):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """JAX's 2-device runs and snapshots, then the port's 2 gloo ranks
    (their results per rank), then JAX's restores of the port's
    snapshots."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    init = {h: jax.device_get(jax_build_model(
        job(jconfig, "replicated", hidden=h).model).init(
            jprng.init_key(0))) for h in (64, PAD_HIDDEN)}
    with open(tmp / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    jax_runs, jax_saved = {}, {}
    for layout in ("replicated", "sharded", "zero1"):
        t = _jax_trainer(job(jconfig, layout))
        r = t.fit()
        jax_runs[layout] = (r["final_loss"],
                            jax.device_get(t.state.params))
    for layout in LAYOUTS:
        t = _jax_trainer(job(jconfig, layout, hidden=PAD_HIDDEN,
                              checkpoint_dir=str(tmp / f"jax_{layout}")))
        t.fit()
        jax_saved[layout] = jax.device_get(t.state)
    outs = _collect(tmp, _spawn(tmp, 2))
    jax_restored = {}
    for layout in LAYOUTS:
        t = _jax_trainer(job(jconfig, layout, hidden=PAD_HIDDEN))
        t.init_state()
        template = jax.device_get(t.state)
        d = tmp / f"port_{layout}"
        (d / f"ckpt-{jckpt.latest_step(str(d))}" / "treedef.pkl").write_bytes(
            pickle.dumps(jax.tree_util.tree_structure(template)))
        jax_restored[layout] = jckpt.restore(str(d), template)
    return dict(outs=outs, jax_runs=jax_runs, jax_saved=jax_saved,
                jax_restored=jax_restored)


# ---------------------------------------------------------------- the plan

_SHAPES = {"w": (48, 2048), "e": (4096, 16), "b": (64,), "s": (),
           "odd": (2049, 3), "sq": (65, 65), "small": (31, 32)}


@pytest.mark.parametrize("n", [1, 2, 8])
def test_plan_equals_jax(n):
    want = jus.plan_updates({k: jnp.zeros(s) for k, s in _SHAPES.items()}, n)
    got = us.plan_updates({k: torch.zeros(s) for k, s in _SHAPES.items()}, n)
    for k in _SHAPES:
        assert (got[k].axis, got[k].padded, got[k].shard) == (
            want[k].axis, want[k].padded, want[k].shard), k
    assert us.plan_leaves(got) == [got[k] for k in _SHAPES]


def test_pad_leaf_pads_the_planned_axis_with_zeros():
    x = torch.arange(6.0).reshape(3, 2)
    plan = us.LeafPlan(0, 4, 2)
    padded = us.pad_leaf(x, plan)
    want = np.asarray(jus.pad_leaf(jnp.asarray(x.numpy()),
                                   jus.LeafPlan(0, 4, 2)))
    np.testing.assert_array_equal(padded.numpy(), want)
    assert us.pad_leaf(x, us.LeafPlan(None)) is x


# ------------------------------------------------ 2 ranks against replicated

def test_sharded_and_zero1_bitwise_equal_replicated(two_ranks):
    for out in two_ranks["outs"]:
        rep = out["replicated"]
        for layout in ("sharded", "zero1"):
            assert out[layout]["loss"] == rep["loss"], layout
            for k, (a, b) in enumerate(zip(
                    jax.tree_util.tree_leaves(out[layout]["params"]),
                    jax.tree_util.tree_leaves(rep["params"]))):
                np.testing.assert_array_equal(a, b, err_msg=f"{layout} {k}")
    a, b = two_ranks["outs"]
    assert a["sharded"]["loss"] == b["sharded"]["loss"]


def test_grad_clip_inside_the_sharded_updates(two_ranks):
    for out in two_ranks["outs"]:
        rep_loss, rep_params = out["clip_replicated"]
        for layout in ("sharded", "zero1"):
            loss, params = out["clip_" + layout]
            np.testing.assert_allclose(loss, rep_loss, **TOL)
            for a, b in zip(jax.tree_util.tree_leaves(params),
                            jax.tree_util.tree_leaves(rep_params)):
                np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("layout", ["replicated", "sharded", "zero1"])
def test_two_ranks_match_jax_two_devices(two_ranks, layout):
    want_loss, want_params = two_ranks["jax_runs"][layout]
    for out in two_ranks["outs"]:
        np.testing.assert_allclose(out[layout]["loss"], want_loss, **TOL)
        for a, b in zip(jax.tree_util.tree_leaves(out[layout]["params"]),
                        _leaves(want_params)):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("layout", ["sharded", "zero1"])
def test_opt_state_is_one_over_n(two_ranks, layout):
    for out in two_ranks["outs"]:
        local, glob = out[layout]["local"], out[layout]["glob"]
        assert len(local) == len(glob)
        big = [(lo, gl) for lo, gl in zip(local, glob)
               if np.prod(gl) >= us.DEFAULT_MIN_SHARD_ELEMS]
        assert big
        for lo, gl in big:
            assert 2 * int(np.prod(lo)) == int(np.prod(gl)), (lo, gl)
        if layout == "zero1":     # one flat buffer per slot
            assert all(len(s) == 1 for s in local)


def test_master_weights_bf16_params_f32_master(two_ranks):
    for out in two_ranks["outs"]:
        m = out["master"]
        assert m["dtypes"] == ["torch.bfloat16"]
        assert m["master_dtypes"] == ["torch.float32"]
        # params == bf16(master), bitwise (the master is padded)
        assert m["equal"]
        # the master is 1/N per rank: the (64, 64) leaf's slice
        assert (32, 64) in m["local"]
        # JAX's bar: the loss within 2e-3 of the f32 replicated run
        assert m["loss"] == pytest.approx(out["replicated"]["loss"],
                                          rel=2e-3)


def test_bf16_params_without_master_keep_f32_slots():
    t = Trainer(job(pconfig, "sharded", data=1, param_dtype="bfloat16"),
                device="cpu")
    t.init_state()
    # the slots (every leaf but the optimizer's 0-d int32 count)
    before = [x.dtype for x in leaves(t.state.opt_state) if x.dim()]
    assert set(before) == {torch.float32}
    t.fit()
    assert [x.dtype for x in leaves(t.state.opt_state) if x.dim()] == before
    assert {p.dtype for p in leaves(t.state.params)} == {torch.bfloat16}


def test_master_weights_init_copies_f32_params():
    """The master never aliases an f32 param it shadows (.float() of an
    f32 tensor is that tensor)."""
    params = {"w": torch.ones(3, 2)}
    state = optim.with_master_weights(optim.sgd(0.1, steps=0)).init(params)
    assert state.master["w"] is not params["w"]
    assert state.master["w"].data_ptr() != params["w"].data_ptr()
    assert state.count == 0


# ------------------------------------------------ snapshots across packages

def _check_jax_leaves(port_leaves, jax_tree):
    want = [_host(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    assert len(port_leaves) == len(want)
    for k, (a, b) in enumerate(zip(port_leaves, want)):
        a = np.asarray(a)
        if a.dtype.kind == "V":     # bf16 bytes
            a = a.view(np.uint16).astype(np.uint32) << 16
            a = a.view(np.float32)
        np.testing.assert_array_equal(a, b, err_msg=str(k))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_jax_snapshot_restores_into_the_port(two_ranks, layout):
    saved = two_ranks["jax_saved"][layout]
    for out in two_ranks["outs"]:
        got = out["ckpt_" + layout]
        assert got["step"] == int(saved.step)
        _check_jax_leaves(got["restored"],
                          (saved.step, saved.params, saved.opt_state))
        # the padding really differs from the replicated shapes, and each
        # rank holds half of every large slot
        if layout == "zero1":
            n = sum(int(np.prod(s)) for s in got["params"])
            assert n % 2 == 1 and got["glob"][0] == (n + 1,)
        else:
            assert (PAD_HIDDEN + 1, PAD_HIDDEN) in got["glob"]
            assert (PAD_HIDDEN + 1, PAD_HIDDEN) not in got["params"]
        for lo, gl in zip(got["local"], got["glob"]):
            if np.prod(gl) >= us.DEFAULT_MIN_SHARD_ELEMS:
                assert 2 * int(np.prod(lo)) == int(np.prod(gl))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_snapshot_restores_through_jax(two_ranks, layout):
    restored = two_ranks["jax_restored"][layout]
    written = two_ranks["outs"][0]["ckpt_" + layout]["written"]
    r = jax.device_get(restored)
    _check_jax_leaves(written, (r.step, r.params, r.opt_state))
    # rank 1 joined the gather and kept none of the global arrays
    assert two_ranks["outs"][1]["ckpt_" + layout]["written"] is None
    meta = two_ranks["outs"][0]["ckpt_" + layout]["meta"]
    assert meta["saved_world"]["dp"] == 2
    assert meta["saved_world"]["update_sharding"] == (
        "sharded" if layout == "master" else layout)


def test_restore_template_is_global_on_the_host():
    """The restore template has the global padded shapes on the host, built
    from one rank's slices with no collective; each rank then takes only
    its own slice of the restored arrays."""
    params = {"w": torch.zeros(65, 65), "b": torch.zeros(3)}
    opt = optim.adam(1e-3, steps=0)
    plan = us.plan_updates(params, 2)
    for index in (0, 1):
        local, layout = us.init_opt_state(opt, params, plan, 2, index)
        assert tuple(local.mu["w"].shape) == (33, 65)
        full = layout.host_template(local)
        assert tuple(full.mu["w"].shape) == (66, 65)
        assert tuple(full.mu["b"].shape) == (3,)
        assert {x.device.type for x in leaves(full)} == {"cpu"}
        for x in leaves(full):      # the restored values
            x.copy_(torch.arange(x.numel()).reshape(x.shape))
        mine = layout.scatter(full, torch.device("cpu"))
        np.testing.assert_array_equal(
            mine.mu["w"].numpy(), full.mu["w"][33 * index:33 * (index + 1)])
        np.testing.assert_array_equal(mine.mu["b"].numpy(), full.mu["b"])


def test_other_padding_names_elastic(tmp_path):
    """A snapshot whose padding differs from the template's (here: the
    replicated layout's shapes under the 2-rank sharded template) is
    refused with JAX's message naming --elastic."""
    params = {"w": torch.zeros(65, 65)}
    opt = optim.adam(1e-3, steps=0)
    ckpt.save(str(tmp_path), TrainState.from_params(params, opt))
    local, _ = us.init_opt_state(opt, params, us.plan_updates(params, 2),
                                 2, 0)
    assert tuple(local.mu["w"].shape) == (33, 65)
    template = TrainState(0, params, opt.init({"w": torch.zeros(66, 65)}))
    with pytest.raises(ValueError, match="--elastic"):
        ckpt.restore(str(tmp_path), template)


# ------------------------------------------------------------- DP x SP

def test_dp_sp_sharded_matches_jax(tmp_path):
    """2 data x 2 seq gloo ranks, ring attention: the sharded slices are
    all-reduced over the sequence ranks after the data reduce-scatter;
    against JAX's run on 4 devices within its pinned tolerance."""
    jt = _jax_trainer(lm_job(jconfig, "sharded"))
    jt.init_state()
    init = {"lm": jax.device_get(jt.state.params)}
    with open(tmp_path / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    procs = _spawn(tmp_path, 4)
    r = jt.fit()
    want = _leaves(jax.device_get(jt.state.params))
    for out in _collect(tmp_path, procs):
        loss, params = out["dpsp"]
        assert loss == pytest.approx(r["final_loss"], rel=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(params), want):
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=5e-5)


# ------------------------------------------------------------ refusals

def test_master_weights_requires_sharded():
    for layout in ("replicated", "zero1"):
        with pytest.raises(ValueError, match="master_weights"):
            Trainer(job(pconfig, layout, master_weights=True,
                         data=1), device="cpu")


@pytest.mark.parametrize("layout", ["sharded", "zero1"])
def test_update_sharding_implies_global_mean(layout):
    cfg = job(pconfig, layout, data=1,
               grad_reduction="per_shard_mean")
    with pytest.raises(ValueError, match="global_mean"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="global-mean"):
        dp.make_train_step(None, optim.sgd(0.1, steps=0), world_setup("cpu"),
                           grad_reduction="per_shard_mean",
                           update_sharding=layout)


def test_adafactor_stays_refused_under_update_sharding():
    """JAX refuses adafactor with the sharded updates; the port has no
    adafactor at all and refuses it first, as it always has."""
    with pytest.raises(NotImplementedError, match="adafactor"):
        Trainer(job(pconfig, "sharded", optimizer="adafactor",
                     data=1), device="cpu")


def test_replicated_step_refuses_grad_clip():
    with pytest.raises(ValueError, match="with_clipping"):
        dp.make_train_step(None, optim.sgd(0.1, steps=0), world_setup("cpu"),
                           grad_clip=1.0)


# ---------------------------------------------------------------------------
# --update_sharding sharded on the GSPMD layout (--tp / --fsdp): JAX's
# gspmd_opt_specs on each rank's slices, over 4 gloo ranks
# ---------------------------------------------------------------------------

GSPMD_SHARDED = {
    "fsdp_sharded": ["--dp", "2", "--fsdp", "2", "--update_sharding",
                     "sharded"],
    "fsdp_replicated": ["--dp", "2", "--fsdp", "2"],
    "tp_sharded": ["--dp", "2", "--tp", "2", "--update_sharding", "sharded",
                   "--grad_clip", "0.05", "--skip-nonfinite"],
    "tp_replicated": ["--dp", "2", "--tp", "2", "--grad_clip", "0.05",
                      "--skip-nonfinite"],
}


@pytest.fixture(scope="module")
def gspmd_ranks(tmp_path_factory):
    """The GSPMD jobs over 4 gloo ranks of ``tests/torch_fsdp_child.py``
    from JAX's inits, and a ``qkv_tp`` 2 snapshot (``--sp 2 --tp 2`` over
    local groups) resumed under ``--dp 4`` and ``--dp 2 --tp 2`` with
    ``--update_sharding sharded``, and ``--dp 2 --tp 2`` replicated."""
    from test_torch_fsdp import jax_trajectory
    from torch_fsdp_child import LM
    from torch_fsdp_child import spawn as spawn_fsdp

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        LocalSeqGroup,
    )

    tmp = tmp_path_factory.mktemp("gspmd_sharded")
    ck = str(tmp / "sp_tp")
    saver = Trainer(pconfig.config_from_args(pconfig.build_argparser()
                                             .parse_args(
        LM + ["--sp", "2", "--tp", "2", "--attention", "ring",
              "--checkpoint_dir", ck])), device="cpu",
        seq_group=LocalSeqGroup(2), tensor_group=LocalTensorGroup(2))
    saver.fit()
    jobs = {name: {"flags": LM + extra,
                   "init": jax_trajectory(tuple(LM + extra))[0]}
            for name, extra in GSPMD_SHARDED.items()}
    for name, extra in (("resume_dp", ["--dp", "4"]),
                        ("resume_tp", ["--dp", "2", "--tp", "2"])):
        jobs[name] = {"flags": LM + extra + [
            "--update_sharding", "sharded", "--resume", "--nepochs", "2",
            "--checkpoint_dir", ck], "fit": True}
    jobs["resume_plain"] = {"flags": LM + [
        "--dp", "2", "--tp", "2", "--resume", "--nepochs", "2",
        "--checkpoint_dir", ck], "fit": True}
    return spawn_fsdp(str(tmp), 4, jobs)


@pytest.mark.parametrize("name", ["fsdp_sharded", "tp_sharded"])
def test_gspmd_sharded_matches_jax_and_replicated(gspmd_ranks, name):
    """JAX's ``test_sharded_gspmd_parity_and_opt_specs``: the sharded
    update's trajectory equals JAX's on the same mesh and the replicated
    update's at its pinned tolerance (losses rel 1e-5; params rtol 2e-5,
    atol 1e-6), the clip and the guard included; each rank holds its
    tensor / fsdp slice of the params and 1/dp of that again of each
    optimizer slot the plan splits."""
    from test_torch_fsdp import (assert_outputs_close, assert_params_close,
                                 jax_trajectory)
    from torch_fsdp_child import LM

    _, want, want_params = jax_trajectory(tuple(LM + GSPMD_SHARDED[name]))
    rep = name.replace("sharded", "replicated")
    for out in gspmd_ranks:
        got = out[name]
        assert got["layout"] == "gspmd+sharded"
        assert_outputs_close(got["outs"], want)
        assert_params_close(got["params"], want_params)
        np.testing.assert_allclose(got["outs"], out[rep]["outs"], rtol=1e-5)
        assert_params_close(got["params"], out[rep]["params"],
                            rtol=2e-5, atol=1e-6)
        # SGD momentum: one slot, split over the 2 data ranks where the
        # plan finds a dim
        assert got["held"]["opt"] < out[rep]["held"]["opt"]
        assert got["held"]["params"] == out[rep]["held"]["params"]


def test_qkv_tp_resume_under_sharded_repermutes_every_slot(gspmd_ranks):
    """A ``qkv_tp`` 2 snapshot resumed under ``sharded`` (the slots
    re-permuted into the dense order, on the DP layout's padded arrays and
    on the GSPMD layout's slices) trains on as the replicated update
    does."""
    for out in gspmd_ranks:
        for name in ("resume_dp", "resume_tp"):
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5,
                                                        atol=1e-6),
                out[name]["params"], out["resume_plain"]["params"])


def test_zero1_keeps_refusing_a_qkv_tp_resume(tmp_path, monkeypatch):
    """zero1's flat buffer has no per-leaf slots to re-permute: a zero1
    snapshot whose meta names another qkv_tp still raises, naming ROADMAP
    Queue A item 4 (no layout writes one: zero1 never runs beside a
    tensor axis)."""
    from torch_fsdp_child import LM

    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        checkpoint as pckpt,
    )

    ck = str(tmp_path / "ck")
    flags = LM + ["--update_sharding", "zero1", "--checkpoint_dir", ck]

    def port(extra=()):
        return Trainer(pconfig.config_from_args(pconfig.build_argparser()
                                                .parse_args(flags
                                                            + list(extra))),
                       device="cpu")

    port().fit()
    read_meta = pckpt.read_meta
    monkeypatch.setattr(pckpt, "read_meta", lambda *a, **k: dict(
        read_meta(*a, **k) or {}, qkv_tp=2))
    t = port(["--resume"])
    t.init_state()
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        t.maybe_resume()
