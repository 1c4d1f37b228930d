"""The port's ``--fsdp`` (the GSPMD layout's memory half) against the JAX
package, on the CPU.

Whole trainer runs over gloo ranks of ``tests/torch_fsdp_child.py``, each
rank holding only its tensor / fsdp slices of the state, against the JAX
Trainer on the same ``MeshConfig`` of fake CPU devices from the same init:
``data=2 x fsdp=2`` and ``fsdp=4`` on the small LM (4 ranks), the digits
MLP with Adam under ``data=2 x fsdp=2`` (JAX's ``test_gspmd_fsdp_mlp_adam``
layout family), ``data=2 x tensor=2 x fsdp=2`` (8 ranks); the guard,
``--accum_steps``, ``--grad_clip`` and the telemetry norms under fsdp
(JAX's ``test_resilience.py``, ``test_schedules_clip_accum.py``,
``test_telemetry.py`` cases on fsdp meshes); ``--fsdp 2`` through the
CLI; and JAX's refusals.  f32 on both sides; the tolerance is JAX's own
for its GSPMD meshes (``tests/test_tensor_parallel.py``: losses rtol
2e-5, params rtol 2e-4 with atol 1e-5).
"""

import functools
import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from torch_fsdp_child import LM, MLP, MLP_STEPS, ROOT, spawn

pytestmark = pytest.mark.torch_port

LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=1e-5)

FOUR = {
    "dp_fsdp": LM + ["--dp", "2", "--fsdp", "2"],
    "fsdp4": LM + ["--fsdp", "4"],
    "mlp": MLP + ["--dp", "2", "--fsdp", "2"],
    "guard_accum": LM + ["--dp", "2", "--fsdp", "2", "--skip-nonfinite",
                         "--accum_steps", "2"],
    "clip": LM + ["--dp", "2", "--fsdp", "2", "--grad_clip", "0.05"],
    "metrics": LM + ["--dp", "2", "--fsdp", "2", "--telemetry_dir", "{tmp}",
                     "--metrics_every", "1"],
}
EIGHT = {
    "dp_tp_fsdp": LM + ["--dp", "2", "--tp", "2", "--fsdp", "2"],
    "tp_fsdp_gqa": LM + ["--tp", "2", "--fsdp", "4", "--n_kv_heads", "2",
                         "--ffn_activation", "swiglu"],
}
STEPS = {"mlp": MLP_STEPS}


def jax_mesh(flags):
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))
    m = jcfg.mesh
    n = max(m.data, 1) * m.fsdp * m.seq * m.tensor
    return jcfg, make_mesh(m, devices=jax.devices("cpu")[:n])


@functools.lru_cache(maxsize=None)
def jax_trajectory(flags, max_steps=None):
    """(init params, per-step outputs, final params) of the JAX Trainer on
    the flags' mesh."""
    jcfg, mesh = jax_mesh(list(flags))
    jt = JaxTrainer(jcfg, mesh=mesh)
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


def assert_params_close(got, want, **tol):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **(tol or PARAM_TOL))


def assert_outputs_close(got, want):
    assert len(got) == len(want)
    if isinstance(want[0], dict):
        for k in ("loss", "grad_norm", "param_norm", "update_ratio"):
            np.testing.assert_allclose([g[k] for g in got],
                                       [w[k] for w in want], err_msg=k,
                                       rtol=2e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, **LOSS_TOL)


def _jobs(table, tmp):
    jobs = {}
    for name, flags in table.items():
        flags = tuple(f.format(tmp=tmp) for f in flags)
        jobs[name] = {"flags": list(flags), "steps": STEPS.get(name),
                      "init": jax_trajectory(flags, STEPS.get(name))[0]}
    return jobs


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp4")
    jobs = _jobs(FOUR, str(tmp / "telemetry"))
    return jobs, spawn(str(tmp), 4, jobs)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp8")
    jobs = _jobs(EIGHT, str(tmp))
    return jobs, spawn(str(tmp), 8, jobs)


def _check(ranks, name):
    jobs, outs = ranks
    flags = tuple(jobs[name]["flags"])
    _, want, want_params = jax_trajectory(flags, STEPS.get(name))
    for out in outs:
        got = out[name]
        assert got["layout"] == "gspmd"
        assert_outputs_close(got["outs"], want)
        assert_params_close(got["params"], want_params)


@pytest.mark.parametrize("name", list(FOUR))
def test_four_gloo_ranks_match_jax_fsdp(four_ranks, name):
    _check(four_ranks, name)


@pytest.mark.parametrize("name", list(EIGHT))
def test_eight_gloo_ranks_match_jax_tp_x_fsdp(eight_ranks, name):
    _check(eight_ranks, name)


# the same jobs with every slice in this process (LocalFsdpGroup, and
# LocalTensorGroup beside it): one card's --fsdp
LOCAL = {
    "fsdp4": LM + ["--fsdp", "4"],
    "mlp": MLP + ["--fsdp", "2"],
    "tp_fsdp": LM + ["--tp", "2", "--fsdp", "2"],
    "clip_metrics": LM + ["--fsdp", "2", "--grad_clip", "0.05",
                          "--telemetry_dir", "{tmp}", "--metrics_every",
                          "1"],
}


@pytest.mark.parametrize("name", list(LOCAL))
def test_local_fsdp_group_matches_jax(tmp_path, name):
    """A local fsdp group holds each fsdp-split leaf as its F slices,
    stacked (every value once), gathers them where the block uses them,
    and follows JAX's trajectory on the same mesh."""
    from torch_fsdp_child import run_job

    flags = tuple(f.format(tmp=str(tmp_path)) for f in LOCAL[name])
    steps = STEPS.get(name.split("_")[0])
    init, want, want_params = jax_trajectory(flags, steps)
    got = run_job({"flags": list(flags), "steps": steps, "init": init,
                   "local": True})
    assert got["layout"] == "gspmd"
    assert_outputs_close(got["outs"], want)
    assert_params_close(got["params"], want_params)
    whole = [np.shape(x) for x in jax.tree_util.tree_leaves(init)]
    assert got["held"]["params"] == sum(int(np.prod(s)) for s in whole)
    fsdp = config_from_args(build_argparser().parse_args(
        list(flags))).mesh.fsdp
    stacked = [h for h in got["shapes"] if h not in whole]
    assert stacked and all(h[0] == fsdp for h in stacked)


def test_clip_fired_and_the_guard_counted_nothing(four_ranks):
    """The clip scaled every step (the run differs from the unclipped
    one), and the metrics carry JAX's global-view norms."""
    jobs, outs = four_ranks
    clipped = outs[0]["clip"]["outs"]
    plain = outs[0]["dp_fsdp"]["outs"]
    assert not np.allclose(clipped, plain)
    m = outs[0]["metrics"]["outs"]
    assert all(r["skipped"] == 0.0 and r["grad_norm"] > 0 for r in m)


def _held(flags, tp, fsdp):
    """The values one rank holds of the params by JAX's specs on
    ``flags``' mesh: each split dim divided by its axis."""
    from neural_networks_parallel_training_with_mpi_tpu.models.registry import (  # noqa: E501
        build_model as jbuild,
    )
    from neural_networks_parallel_training_with_mpi_tpu.parallel import (
        tensor_parallel as jtp,
    )
    from neural_networks_parallel_training_with_mpi_tpu.utils import (
        prng as jprng,
    )

    jcfg, mesh = jax_mesh(list(flags))
    model = jbuild(jcfg.model)
    params = model.init(jprng.init_key(0))
    specs = jtp.param_specs(model, params, mesh)
    n = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(params),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))):
        div = 1
        for a in spec:
            div *= {"tensor": tp, "fsdp": fsdp}.get(a, 1)
        n += int(np.prod(leaf.shape)) // div
    return n


def test_each_rank_holds_only_its_slices(four_ranks, eight_ranks):
    """Per rank: params as JAX's specs slice them, and each optimizer slot
    the same count again (Adam's mu and nu on the MLP, SGD's momentum on
    the LM)."""
    for ranks, name, tp, fsdp, slots in (
            (four_ranks, "mlp", 1, 2, 2), (four_ranks, "fsdp4", 1, 4, 1),
            (eight_ranks, "dp_tp_fsdp", 2, 2, 1),
            (eight_ranks, "tp_fsdp_gqa", 2, 4, 1)):
        jobs, outs = ranks
        want = _held(tuple(jobs[name]["flags"]), tp, fsdp)
        whole = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            jobs[name]["init"]))
        assert want < whole
        for out in outs:
            assert out[name]["held"] == {"params": want,
                                         "opt": slots * want}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_fsdp_through_the_cli_matches_one_process(tmp_path):
    """``python -m ..._torch --fsdp 2`` over 2 CLI ranks (torchrun's
    environment): the world prints ``fsdp=2`` and the GSPMD layout, and
    every epoch's loss is the one-process run's."""
    flags = LM + ["--nepochs", "2", "--platform", "cpu"]
    cmd = [sys.executable, "-m",
           "neural_networks_parallel_training_with_mpi_tpu_torch"]
    port, preflight = _free_port(), _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   NNPT_PREFLIGHT_PORT=str(preflight),
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(cmd + flags + ["--fsdp", "2"],
                                      cwd=str(tmp_path), env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    one = subprocess.run(cmd + flags, cwd=str(tmp_path), capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=ROOT),
                         timeout=240)
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][-3000:]
    assert "data=1 fsdp=2" in outs[0] and "gspmd" in outs[0]

    def losses(text):
        return [float(x) for x in re.findall(r"epoch \d+: loss ([0-9.]+)",
                                             text)]

    assert len(losses(outs[0])) == 2
    np.testing.assert_allclose(losses(outs[0]), losses(one.stdout +
                                                       one.stderr),
                               rtol=1e-5)


# JAX's refusals on an fsdp axis: the port raises its type and message
FSDP_REFUSALS = [
    (LM + ["--sp", "2", "--fsdp", "2", "--attention", "ring"],
     NotImplementedError),
    (LM + ["--pp", "2", "--fsdp", "2"], NotImplementedError),
    (LM + ["--fsdp", "2", "--update_sharding", "zero1"],
     NotImplementedError),
    (LM + ["--fsdp", "2", "--ce_chunk", "8"], ValueError),
    (LM + ["--fsdp", "2", "--grad_reduction", "per_shard_mean"], ValueError),
    (LM + ["--fsdp", "2", "--scan-layers"], ValueError),
]


@pytest.mark.parametrize("flags,exc", FSDP_REFUSALS,
                         ids=lambda x: "_".join(x[-2:])
                         if isinstance(x, list) else "")
def test_jax_refusals_on_an_fsdp_axis(flags, exc):
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))
    with pytest.raises(exc) as want:
        JaxTrainer(jcfg, mesh=None)
    with pytest.raises(exc) as got:
        Trainer(config_from_args(build_argparser().parse_args(flags)),
                device="cpu")
    assert str(got.value) == str(want.value)


def test_describe_and_the_grid_carry_the_fsdp_axis():
    import torch

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        World, describe,
    )

    w = World(5, 8, torch.device("cpu"), tp=2, fsdp=2)
    assert describe(w) == "data=2 fsdp=2 tensor=2"
    # rank = (data * fsdp + fsdp_index) * tp + tensor (tensor minor)
    assert (w.data_rank, w.fsdp_rank, w.tensor_rank) == (1, 0, 1)
    assert (w.batch_shards, w.batch_rank) == (4, 2)
    w = World(3, 4, torch.device("cpu"), fsdp=4)
    assert (describe(w), w.dp, w.fsdp_rank, w.batch_rank) == (
        "data=1 fsdp=4", 1, 3, 3)
