"""The port's silent-data-corruption defense against the JAX package's, on
the CPU: the fingerprint check in the trainer loop (lag-2 fetch, gathered
``(nodes, LOCAL_WORLD_SIZE)`` verdict), localization, replay triage, heal,
rollback on a divergence between nodes, the strike budget, exit 45, and
the ``bitflip``/``desync`` fault kinds.

Mirrors ``tests/test_sdc.py``.  Where JAX runs a mesh of host devices, the
port runs 4 gloo ranks of ``tests/torch_sdc_child.py`` with
``LOCAL_WORLD_SIZE=4`` (one node: the counterpart of JAX's 4-device mesh)
on the same jobs; a module fixture runs them once, and JAX's 4-device runs
of the jobs whose records are compared.  Records are compared field by
field (step, leaf names, shards, element counts, verdict, action); the
port's own runs are held bitwise where the property is exact (replicas
after a heal, SDC checking on vs off).
"""

import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import (
    make_mesh,
)
from neural_networks_parallel_training_with_mpi_tpu.train import (
    resilience as jres,
)
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    faults as jfaults,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import (
    config as pconfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
    resilience as res,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
    trainer as trainer_mod,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    faults,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_sdc_child import SDC_JOBS, sdc_job  # noqa: E402

pytestmark = pytest.mark.torch_port

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
CHILD = os.path.join(ROOT, "tests", "torch_sdc_child.py")
PKG = "neural_networks_parallel_training_with_mpi_tpu_torch"
# the jobs whose sdc records are compared with JAX's 4-device runs
JAX_JOBS = ("bitflip", "det", "desync")


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _records(d, kind="sdc"):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("kind") == kind]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices):
    """Every rank's result of each job (4 gloo ranks), and JAX's records
    of ``JAX_JOBS`` on a mesh of 4 host devices."""
    tmp = tmp_path_factory.mktemp("sdc")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop(faults.ENV_VAR, None)
    procs = [subprocess.Popen(
        [sys.executable, CHILD, "sdc", str(r), "4", str(tmp)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    jax_out = {}
    for name in JAX_JOBS:
        cfg = sdc_job(jconfig, name, str(tmp / "jax"))
        t = JaxTrainer(cfg, mesh=make_mesh(jconfig.MeshConfig(data=4),
                                           devices=devices[:4]))
        err = None
        try:
            t.fit()
        except jres.SDCAbort as e:
            err = str(e)
        recs = (_records(cfg.telemetry_dir) if cfg.telemetry_dir else [])
        jax_out[name] = dict(error=err, records=recs,
                             incidents=t._sdc_policy.incidents,
                             healed=t._sdc_policy.healed)
    outs = []
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        with open(tmp / f"sdc_out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return dict(port=outs, jax=jax_out, tmp=tmp)


def _same_record(got, want):
    """The fields both packages must agree on (devices are named per
    package: JAX's host devices, the port's ranks)."""
    assert got["step"] == want["step"]
    assert got["verdict"] == want["verdict"]
    assert got["action"] == want["action"]
    assert sorted(got["leaves"]) == sorted(want["leaves"])
    for name, leaf in want["leaves"].items():
        assert got["leaves"][name]["shards"] == leaf["shards"]
        assert got["leaves"][name]["n_bad_elements"] == \
            leaf["n_bad_elements"]


# ------------------------------------------------------------- the flags


@pytest.mark.parametrize("flags", [
    ["--sdc_check_every", "2"], ["--check_replicas_every", "2"],
    ["--no-sdc-heal", "--sdc_check_every", "1"], ["--sdc_strikes", "5"],
    ["--faults", "bitflip@1"], ["--faults", "desync@1?eps=0.5"],
    ["--faults", "desync@2?det"]], ids=lambda f: "_".join(f))
def test_sdc_flags_and_kinds_are_ported(flags):
    """The flags run, at one rank with the check off (JAX's log line)."""
    cfg = config_from_args(build_argparser().parse_args(
        flags + ["--n_samples", "16", "--batch_size", "8",
                 "--no-full-batch", "--nepochs", "1"]))
    t = Trainer(cfg, device="cpu")
    assert np.isfinite(t.fit()["final_loss"])
    assert t._fp is None


def test_cli_flags_plumbed():
    args = build_argparser().parse_args(
        ["--sdc_check_every", "7", "--no-sdc-heal", "--sdc_strikes", "5",
         "--faults", "bitflip@3?shard=1&bit=4"])
    cfg = config_from_args(args)
    assert cfg.sdc_check_every == 7 and cfg.sdc_heal is False
    assert cfg.sdc_strikes == 5
    cfg2 = config_from_args(build_argparser().parse_args([]))
    assert cfg2.sdc_check_every == 0 and cfg2.sdc_heal is True
    assert cfg2.sdc_strikes == 3


def test_sdc_fault_kinds_parse_like_jax():
    spec = ("bitflip@5?param=blocks&shard=2&bit=7,desync@9?eps=0.01,"
            "desync@3?det")
    got, want = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    for g, w in zip(got.faults, want.faults):
        assert (g.kind, g.start, g.param, g.shard, g.bit, g.eps, g.det) == \
            (w.kind, w.start, w.param, w.shard, w.bit, w.eps, w.det)
    assert got.det_desync().start == want.det_desync().start == 3
    for bad in ("bitflip@5?det",):
        with pytest.raises(ValueError, match="det") as e:
            faults.FaultPlan.parse(bad)
        with pytest.raises(ValueError) as ej:
            jfaults.FaultPlan.parse(bad)
        assert str(e.value) == str(ej.value)


def test_apply_state_flips_one_bit_on_its_shard_only():
    """bitflip corrupts one element of one param leaf on the rank whose
    data-rank index is ``shard``, in place; desync the optimizer state."""
    import torch

    cfg = config_from_args(build_argparser().parse_args(
        ["--n_samples", "16", "--batch_size", "8", "--no-full-batch"]))
    t = Trainer(cfg, device="cpu")
    t.init_state()
    before = [x.clone() for x in _torch_leaves(t.state.params)]
    plan = faults.FaultPlan.parse("bitflip@3?shard=2&bit=9")
    plan.apply_state(3, t.state, replica=1, n_replicas=4)
    assert all(torch.equal(a, b) for a, b in
               zip(before, _torch_leaves(t.state.params)))
    plan = faults.FaultPlan.parse("bitflip@3?shard=2&bit=9")
    plan.apply_state(2, t.state, replica=2, n_replicas=4)
    plan.apply_state(3, t.state, replica=2, n_replicas=4)
    changed = [(a != b).sum().item() for a, b in
               zip(before, _torch_leaves(t.state.params))]
    assert sorted(changed) == [0, 0, 0, 1]
    mom = [x.clone() for x in _torch_leaves(t.state.opt_state)]
    faults.FaultPlan.parse("desync@3?eps=0.5&shard=1").apply_state(
        3, t.state, replica=1, n_replicas=4)
    assert any(not torch.equal(a, b) for a, b in
               zip(mom, _torch_leaves(t.state.opt_state)))


def _torch_leaves(tree):
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    return leaves(tree)


# ------------------------------------------------------- the trainer loop


def test_bitflip_detect_localize_triage_heal_matches_jax(runs):
    """bitflip@5?shard=3&bit=9: detected within the lag-2 cadence,
    localized to the leaf and rank 3, triaged transient, healed; the sdc
    record carries JAX's step, leaf, shard, element count, verdict and
    action; the postmortem carries the sdc event."""
    for out in runs["port"]:
        r = out["bitflip"]
        assert r["error"] is None and r["incidents"] == 1 \
            and r["healed"] == 1
        assert r["diverged"] == {}
    port = runs["port"][0]["bitflip"]
    (got,) = [x for x in port["records"] if x.get("kind") == "sdc"]
    (want,) = runs["jax"]["bitflip"]["records"]
    _same_record(got, want)
    assert got["devices"] == ["rank3"]
    assert 5 <= got["step"] <= 5 + 2
    assert any(r.get("event") == "sdc" for r in port["postmortem"]["records"]
               if r.get("kind") == "event")


def test_bitflip_heal_leaves_identical_replicas_near_the_clean_run(runs):
    """After the heal every rank holds the same params, bitwise.  They
    are not the unfaulted run's bitwise: the corrupted rank's gradients
    of the steps before the lag-2 detection entered the all-reduce (so in
    the JAX package too); they stay within 1e-4 of it."""
    outs = runs["port"]
    for r in outs[1:]:
        for a, b in zip(_leaves(outs[0]["bitflip"]["params"]),
                        _leaves(r["bitflip"]["params"])):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(outs[0]["bitflip"]["params"]),
                    _leaves(outs[0]["clean"]["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_desync_on_optimizer_state_heals_too(runs):
    r = runs["port"][0]["desync"]
    assert r["error"] is None and r["incidents"] == 1 and r["healed"] == 1
    assert r["diverged"] == {}
    want = runs["jax"]["desync"]
    assert (want["incidents"], want["healed"]) == (1, 1)


def test_det_desync_aborts_deterministic_like_jax(runs):
    """desync@4?det&eps=0.001: the replay reproduces the divergence ->
    SDCAbort at JAX's step, naming the leaf; the postmortem names it."""
    port = runs["port"][0]["det"]
    assert port["error"][0] == "SDCAbort"
    assert "REPRODUCED on replay" in port["error"][1]
    assert runs["jax"]["det"]["error"] is not None
    (got,) = [x for x in port["records"] if x.get("kind") == "sdc"]
    (want,) = runs["jax"]["det"]["records"]
    _same_record(got, want)
    assert got["verdict"] == "deterministic" and got["leaves"]
    assert "SDCAbort" in port["postmortem"]["reason"]


def test_strike_budget_aborts_repeatedly_flaky_device(runs):
    r = runs["port"][0]["strikes"]
    assert r["error"][0] == "SDCAbort" and "strike budget" in r["error"][1]
    assert r["policy"] == (2, {"rank3": 2})


def test_no_snapshot_of_unobserved_corrupt_state(runs):
    """A snapshot boundary drains the fingerprint queue first: with one
    strike the drain aborts at the corrupted boundary, and the newest
    snapshot predates the corruption (counter 7, as in JAX)."""
    r = runs["port"][0]["nosnap"]
    assert r["error"][0] == "SDCAbort" and "strike budget" in r["error"][1]
    assert r["latest"] == 7


def test_legacy_check_replicas_is_detect_only(runs):
    r = runs["port"][0]["legacy"]
    assert r["error"][0] == "AssertionError"
    assert "replica divergence" in r["error"][1]


def test_params_bitwise_identical_sdc_on_off(runs):
    """The fingerprint is pure observation: params bitwise equal with the
    check on and off (4 ranks, k = 1)."""
    for out in runs["port"]:
        assert out["on"]["incidents"] == 0
        for a, b in zip(_leaves(out["on"]["params"]),
                        _leaves(out["off"]["params"])):
            np.testing.assert_array_equal(a, b)


def test_params_bitwise_identical_sdc_on_off_multi_step_dispatch(
        monkeypatch):
    """k = 2 runs in one process only: with the replica floor at 1 the
    digest of every dispatch is computed, fetched at lag 2 and judged
    (a (1, 1) matrix), and the params stay bitwise those of the run
    without the check."""
    def fit(sdc):
        cfg = config_from_args(build_argparser().parse_args(
            ["--n_samples", "64", "--batch_size", "8", "--no-full-batch",
             "--nepochs", "2", "--lr", "1e-2", "--steps_per_dispatch", "2",
             "--sdc_check_every", "1" if sdc else "0"]))
        t = Trainer(cfg, device="cpu")
        r = t.fit()
        if sdc:
            assert t._fp is not None and r["sdc_incidents"] == 0
        return tree_to_numpy(t.state.params)

    monkeypatch.setattr(trainer_mod, "SDC_MIN_REPLICAS", 1)
    for a, b in zip(_leaves(fit(True)), _leaves(fit(False))):
        np.testing.assert_array_equal(a, b)


def test_zero1_check_skips_the_optimizer_slices(runs):
    """zero1: the fingerprint covers the params only (the opt state is
    1/N slices); a param flip is re-replicated by the step's all-gather
    of the updated slices before any check sees it, so no incident, and
    the replicas stay identical."""
    r = runs["port"][0]["zero1"]
    assert r["fp_paths"] and all(p.startswith(".params")
                                 for p in r["fp_paths"])
    assert r["error"] is None and r["incidents"] == 0
    for out in runs["port"]:
        assert out["zero1"]["diverged"] == {}


def test_sharded_layout_heals(runs):
    """``sharded``: a small leaf keeps the replicated update, so its flip
    persists; it is detected, localized and healed."""
    r = runs["port"][0]["sharded"]
    assert r["error"] is None and (r["incidents"], r["healed"]) == (1, 1)
    assert r["policy"][1] == {"rank1": 1}
    for out in runs["port"]:
        assert out["sharded"]["diverged"] == {}


def test_dp_x_seq_heals(runs):
    """2 data x 2 seq ranks: data rank 1 (ranks 2 and 3) is flipped; the
    node's majority tie breaks toward ranks 0 and 1, which heal 2 and
    3."""
    r = runs["port"][0]["dpsp"]
    assert r["error"] is None and (r["incidents"], r["healed"]) == (1, 1)
    assert r["policy"][1] == {"rank2": 1, "rank3": 1}
    for out in runs["port"]:
        assert out["dpsp"]["diverged"] == {}


def test_cross_node_divergence_rolls_back(runs):
    """LOCAL_WORLD_SIZE=2 with 4 ranks: node 1 (ranks 2 and 3) flips the
    same bit alike, agrees with itself and not with node 0: a cross
    verdict; the replay (from a copy made consistent across nodes) is
    clean, so the run rolls back to the newest verified snapshot and
    completes with identical replicas."""
    r = runs["port"][0]["cross"]
    assert r["error"] is None
    assert r["incidents"] == 1 and r["healed"] == 0
    assert len(r["rollbacks"]) == 1 and r["latest"] == 16
    assert r["policy"][1] == {"process:1": 1}
    (rec,) = [x for x in r["records"] if x.get("kind") == "sdc"]
    assert rec["action"] == "rollback" and rec["verdict"] == "transient"
    assert rec["leaves"] == {}
    assert rec["cross_host"] == {".params[0]['w']": [1]}
    for out in runs["port"]:
        assert out["cross"]["diverged"] == {}


def test_det_desync_refused_on_sharded_state_layouts():
    for layout in ("zero1", "sharded"):
        cfg = pconfig.TrainConfig(update_sharding=layout,
                                  faults="desync@2?det")
        with pytest.raises(NotImplementedError, match="desync"):
            Trainer(cfg, device="cpu")


# --------------------------------------------------- policy and exit codes


def test_sdc_exit_code_contract_pinned():
    assert res.EXIT_SDC == jres.EXIT_SDC == 45
    assert res.EXIT_SDC in res._NO_RETRY
    p = res.SDCPolicy(strikes=2)
    assert p.record(["devA"]) == []
    assert p.record(["devB"]) == []
    assert p.record(["devA"]) == ["devA"]
    assert p.incidents == 3
    with pytest.raises(ValueError):
        res.SDCPolicy(strikes=0)


def test_supervisor_does_not_retry_exit_45():
    calls = []
    rc = res.supervise([sys.executable, "-c", "import sys; sys.exit(45)"],
                       max_restarts=3, backoff=0.01, log=calls.append,
                       _sleep=lambda s: None)
    assert rc == 45
    assert any("not retrying" in m for m in calls)


def test_cli_det_desync_exits_45_with_postmortem(tmp_path):
    """Two CLI ranks (a RANK/WORLD_SIZE/MASTER_* world): the deterministic
    desync exits 45 on both, with a postmortem naming the leaf."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    d = str(tmp_path / "telem")
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   NNPT_PREFLIGHT_PORT=str(port + 1))
        env.pop(faults.ENV_VAR, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", PKG, "--platform", "cpu", "--nepochs",
             "2", "--batch_size", "8", "--n_samples", "64",
             "--no-full-batch", "--sdc_check_every", "1",
             "--telemetry_dir", d, "--faults", "desync@4?det&eps=0.001"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 45, (o, e[-3000:])
    assert "SDC abort" in outs[0][0] + outs[0][1]
    pm = json.load(open(os.path.join(d, "postmortem.json")))
    assert "SDCAbort" in pm["reason"]
    (sdc,) = [r for r in pm["records"] if r.get("kind") == "event"
              and r.get("event") == "sdc"]
    assert sdc["verdict"] == "deterministic" and sdc["leaves"]


def test_sdc_report_tool_reads_the_ports_records(runs):
    """tools/sdc_report.py (stdlib only) reads the port's sdc records."""
    d = runs["tmp"] / "telem_bitflip"
    rep = subprocess.run(
        [sys.executable, "-S", os.path.join(ROOT, "tools", "sdc_report.py"),
         str(d), "--json"], capture_output=True, text=True)
    assert rep.returncode == 0, rep.stderr
    doc = json.loads(rep.stdout)
    assert doc["last_action"] == "healed"
    assert doc["leaf_histogram"] == {".params[0]['w']": 1}
    assert doc["device_strikes"] == {"rank3": 1}
    text = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "sdc_report.py"),
         str(d)], capture_output=True, text=True)
    assert "healed x1" in text.stdout


def test_the_jobs_cover_every_layout_the_port_has():
    layouts = {SDC_JOBS[n][0].get("update_sharding", "replicated")
               for n in SDC_JOBS}
    assert layouts == {"replicated", "zero1", "sharded"}
    assert any(SDC_JOBS[n][0].get("lm") for n in SDC_JOBS)


# ------------------------------------- the replica check on sliced layouts

SLICED = {"dp_tp": ["--dp", "2", "--tp", "2"],
          "dp_fsdp": ["--dp", "2", "--fsdp", "2"]}


def _sliced_flags(name, extra=()):
    from torch_fsdp_child import LM

    return LM + SLICED[name] + ["--nepochs", "3", "--sdc_check_every", "1",
                                *extra]


@pytest.fixture(scope="module")
def sliced_runs(tmp_path_factory):
    """``--dp 2 --tp 2`` and ``--dp 2 --fsdp 2`` over 4 gloo ranks (one
    node) with the check on every step, and ``--dp 2 --tp 2`` with a bit
    flipped in a whole leaf on data rank 1 at step 3."""
    from torch_fsdp_child import spawn as spawn_fsdp

    tmp = tmp_path_factory.mktemp("sdc_sliced")
    jobs = {name: {"flags": _sliced_flags(name), "fit": True}
            for name in SLICED}
    jobs["flip"] = {"flags": _sliced_flags("dp_tp", [
        "--faults", "bitflip@3?shard=1&bit=9"]), "fit": True}
    return spawn_fsdp(str(tmp), 4, jobs)


@pytest.mark.parametrize("name", list(SLICED))
def test_sliced_layouts_fingerprint_jaxs_replicated_leaves(
        sliced_runs, devices, name):
    """JAX's ``Fingerprinter`` covers the leaves the layout holds fully
    replicated; the port's fingerprint covers the same leaves (JAX's
    ``.step`` is a host int in the port), on every rank, and a clean run
    raises no incident."""
    from neural_networks_parallel_training_with_mpi_tpu.utils import (
        consistency as jcons,
    )

    flags = _sliced_flags(name)
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))
    jt = JaxTrainer(jcfg, mesh=make_mesh(jcfg.mesh, devices=devices[:4]))
    jt.init_state()
    want = set(jcons.Fingerprinter(jt.state, jt.mesh).paths) - {".step"}
    for out in sliced_runs:
        got = out[name]
        assert set(got["fp"]) == want
        assert got["sdc"] == (0, 0)
    assert any("['ln1']" in p for p in want)
    assert not any("['qkv']['w']" in p for p in want)


def test_a_flipped_whole_leaf_is_healed_on_a_sliced_layout(sliced_runs):
    """A bit flipped in a whole (replicated) leaf on data rank 1's ranks
    is detected, localized and healed from the majority; every rank ends
    with the params the ranks gathered on rank 0."""
    outs = [out["flip"] for out in sliced_runs]
    assert outs[0]["sdc"] == (1, 1)
    for out in outs:
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               out["params"], outs[0]["params"])


def test_a_flipped_sliced_leaf_is_not_checked_as_in_jax():
    """The fingerprint leaves out the leaves the layout slices (a
    ``LocalTensorGroup(2)`` holds them whole all the same): a bit
    flipped in a qkv weight leaves the digest as it was; one in a
    LayerNorm scale changes it.  The fault kinds pick no sliced leaf."""
    from torch_fsdp_child import LM

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        consistency,
    )

    t = Trainer(config_from_args(build_argparser().parse_args(
        LM + ["--tp", "2"])), device="cpu",
        tensor_group=LocalTensorGroup(2))
    t.init_state()
    skip = t._unreplicated()
    fp = consistency.Fingerprinter(t.state, skip=skip)

    def digest():
        d, _ = consistency.Fingerprinter.fetch(fp.compute(t.state))
        return int(d[0])

    before = digest()
    faults.flip_bit_in_shard(t.state.params["blocks"][0]["qkv"]["w"], 0, 9)
    assert digest() == before
    faults.flip_bit_in_shard(t.state.params["blocks"][0]["ln1"]["scale"], 0,
                             9)
    assert digest() != before
    names = [n for n, _ in faults._replicated_float_leaves(t.state.params,
                                                           skip)]
    assert names and not any("['qkv']" in n for n in names)


def test_det_desync_refused_on_fsdp_and_tensor_layouts():
    """JAX's ``test_det_desync_refused_on_sharded_state_layouts`` on its
    ``data=4 x fsdp=2`` mesh, and the tensor axis: JAX's message."""
    for mesh in (pconfig.MeshConfig(data=4, fsdp=2),
                 pconfig.MeshConfig(tensor=2)):
        cfg = pconfig.TrainConfig(mesh=mesh, faults="desync@2?det")
        with pytest.raises(NotImplementedError, match="desync"):
            Trainer(cfg, device="cpu")
