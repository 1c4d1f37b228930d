"""The port's control-plane driver (``serve/ctrlplane_driver.py``) and the
driver fault kinds (``router_kill``, ``fleet_kill``) against the JAX
package's.

* The driver kinds parse and no-op in ``apply`` as
  ``tests/test_ctrlplane.py``'s pin has them, and a training run with
  ``--faults router_kill@1`` equals one without a plan.
* The driver's result row: both packages' ``ctrlplane_driver.main`` run
  over in-process replicas (``launch_fleet`` replaced by a router over
  ``InprocReplica``\\ s of equal models, the JAX init carried across by
  ``interop``) write rows with the same keys and the same
  ``tokens_sha256``; a second life on the same ``--wal-dir`` resumes,
  dedupes every request and traces its start as ``recovery``.  The port's
  driver hands ``--platform`` to its workers' serve config.
* A WAL that one package's router wrote (at the driver's prefill/decode
  roles, a committed handoff in it) replays the same read-only in both
  and recovers in the other's router: every request once, tokens equal.
* ``slow``/``chaos``: the chaos ``fleet_ctrlplane`` scenario with CPU
  workers: a ``router_kill`` arm and a ``fleet_kill`` arm, each
  SIGKILLing the driver after 2 completions and relaunching it on the
  same ``--wal-dir``.
"""

import functools
import json

import jax
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import serve as jserve
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer, TransformerConfig as JaxConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.serve import (
    ctrlplane_driver as jdriver,
)
from neural_networks_parallel_training_with_mpi_tpu.serve import wal as jwal
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    faults as jfaults,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng
from neural_networks_parallel_training_with_mpi_tpu_torch import serve
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
    ctrlplane_driver as driver,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import wal
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    chaos, checkpoint as ckpt, faults,
)
from test_torch_fleet_disagg import _first_life, _jobs, _second_life, reference
from test_torch_serve import _blocking

pytestmark = pytest.mark.torch_port


def test_driver_fault_kinds_parse_and_noop_in_apply():
    assert "router_kill" in faults.KINDS and "fleet_kill" in faults.KINDS
    assert faults.DRIVER_KINDS == jfaults.DRIVER_KINDS == (
        "router_kill", "fleet_kill")
    spec = "router_kill@3?max=1,fleet_kill@5?max=1"
    got = []
    for mod in (faults, jfaults):
        plan = mod.FaultPlan.parse(spec)
        batch = {"x": [1, 2]}
        # apply() never fires the driver kinds: the victim cannot kill
        # itself; the parent's due-check fires them, max=1 bounds it
        got.append((plan.apply(3, batch) is batch,
                    plan.apply(5, batch) is batch,
                    plan.fire_if_due("router_kill", 3),
                    plan.fire_if_due("router_kill", 3),
                    plan.fire_if_due("fleet_kill", 4),
                    plan.fire_if_due("fleet_kill", 5)))
    assert got[0] == got[1] == (True, True, True, False, False, True)


def test_router_kill_plan_trains_as_without_a_plan():
    """``--faults router_kill@1`` builds into a run (no refusal) and the
    run equals one without a fault plan, bit for bit."""
    def run(extra):
        cfg = config_from_args(build_argparser().parse_args(
            ["--no-full-batch", "--batch_size", "4", "--n_samples", "16",
             "--nepochs", "2"] + extra))
        t = Trainer(cfg, device="cpu")
        return t.fit(), t.state
    (r0, s0), (r1, s1) = run([]), run(["--faults", "router_kill@1"])
    assert r0["final_loss"] == r1["final_loss"]
    for (_, a), (_, b) in zip(ckpt.flatten(s0), ckpt.flatten(s1)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


# ---------------------------------------------------------------------------
# the driver's result row, over in-process replicas
# ---------------------------------------------------------------------------

# the driver's vocabulary (its load draws ids below 256) at a small width
DRIVER_MODEL = dict(vocab_size=256, max_seq_len=128, n_layers=2, d_model=32,
                    n_heads=4, d_ff=64)


@functools.lru_cache(maxsize=None)
def _models256():
    jm = JaxTransformer(JaxConfig(**DRIVER_MODEL, attention="dense"))
    jp = jm.init(prng.init_key(0))
    model = Transformer(TransformerConfig(**DRIVER_MODEL), device="cpu")
    return jm, jp, model, params_from_jax(jax.device_get(jp), model.cfg,
                                          "cpu")


class _NoSupervisor:
    def poll(self):
        return []

    def terminate_all(self):
        pass


def _inproc_launch(side, seen):
    """``launch_fleet`` of one package replaced by a router over
    in-process replicas of the driver's serve geometry; ``seen`` gets
    each call's arguments."""
    jm, jp, port_model, params = _models256()
    mod = jserve if side == "jax" else serve

    # ``serve`` is launch_fleet's keyword for the serve config
    def launch(n, *, model, serve, router_kwargs, roles=None, **kw):
        seen.append(dict(n=n, model=model, serve=serve,
                         router_kwargs=router_kwargs, roles=roles))
        geo = dict(slots=serve["slots"], block_size=serve["block_size"],
                   prefill_chunk=serve["prefill_chunk"],
                   queue_depth=serve["queue_depth"],
                   num_blocks=1 + serve["slots"] * 8)
        hs = []
        for i in range(n):
            cfg = mod.ServeConfig(replica=i, **geo)
            sched = (_blocking(jserve.Scheduler(jm, jp, cfg))
                     if side == "jax" else
                     mod.Scheduler(port_model, params, cfg, device="cpu"))
            hs.append(mod.InprocReplica(sched, name=f"replica-{i}"))
        return mod.Fleet(router=mod.FleetRouter(hs, **router_kwargs),
                         supervisor=_NoSupervisor(), handles=[])

    return launch


def _drive_driver(side, tmp_path, tag, monkeypatch, seen):
    mod = jdriver if side == "jax" else driver
    monkeypatch.setattr(mod, "launch_fleet", _inproc_launch(side, seen))
    out = tmp_path / f"{side}-{tag}.json"
    argv = ["--out", str(out), "--clients", "2", "--rpc", "2",
            "--wal-dir", str(tmp_path / f"wal-{side}"),
            "--trace-dir", str(tmp_path / f"trace-{side}-{tag}")]
    if side == "port":
        argv += ["--platform", "cpu"]
    assert mod.main(argv) == 0
    return json.loads(out.read_text())


def _keys(doc):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in doc.items()}


# the port's row: JAX's keys, and the workers' kernel launches
PORT_ONLY = {"kernel_launches"}


def test_driver_row_has_jax_keys_and_tokens(tmp_path, monkeypatch):
    seen = {"jax": [], "port": []}
    rows = {side: [_drive_driver(side, tmp_path, life, monkeypatch,
                                 seen[side]) for life in ("1", "2")]
            for side in ("jax", "port")}
    for life in (0, 1):
        got, want = rows["port"][life], rows["jax"][life]
        assert set(got) - set(want) == PORT_ONLY
        assert {k: v for k, v in _keys(got).items()
                if k not in PORT_ONLY} == _keys(want)
        assert got["kernel_launches"] == {}     # no worker in process
        assert got["row"]["tokens_sha256"] == want["row"]["tokens_sha256"]
        assert got["row"]["requests"] == want["row"]["requests"] == 4
        assert got["resumed"] == want["resumed"] == (life == 1)
        assert got["recovery"]["lost"] == 0
    # the second life answers every request from the journal
    again = rows["port"][1]
    assert again["recovery"]["deduped"] == rows["jax"][1]["recovery"][
        "deduped"] == 4
    assert again["completed"] == 4
    # the resumed launch is traced as recovery, the cold one is not
    for life, want in (("1", False), ("2", True)):
        spans = [json.loads(ln)
                 for p in (tmp_path / f"trace-port-{life}").glob("*.jsonl")
                 for ln in p.read_text().splitlines() if ln.strip()]
        assert any(s.get("name") == "recovery" for s in spans) == want
    # the port's driver: JAX's tiny model and serve config, and its
    # --platform handed to the workers; the WAL under the router
    for s_port, s_jax in zip(seen["port"], seen["jax"]):
        assert s_port["model"] == s_jax["model"] == dict(
            vocab=256, seq=128, layers=2, d_model=64, heads=4, d_ff=128,
            init_seed=0)
        assert s_port["serve"] == dict(s_jax["serve"], platform="cpu")
        assert s_port["router_kwargs"]["wal_dir"] == str(
            tmp_path / "wal-port")


def test_driver_raises_without_a_card_unless_cpu(tmp_path, monkeypatch):
    """The default ``--platform gpu`` with no card: the no-CUDA error
    before any fleet is launched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    launched = []
    monkeypatch.setattr(driver, "launch_fleet",
                        lambda *a, **k: launched.append(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["--out", str(tmp_path / "x.json")])
    assert launched == []


# ---------------------------------------------------------------------------
# a driver-geometry WAL across the packages
# ---------------------------------------------------------------------------

def _progress(mod, root):
    """What the chaos scenario polls: (completed rids, handoffs in
    flight), from a read-only replay."""
    recs, _ = mod.replay(root, repair=False)
    done = {r.get("rid") for r in recs if r.get("kind") == "complete"}
    inflight = sum(1 for r in recs if r.get("kind") == "handoff"
                   and r.get("rid") not in done)
    return len(done), inflight


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_driver_wal_replays_across_packages(tmp_path, first, second):
    """A WAL written at the driver's roles (prefill, decode) by one
    package's router, killed with a handoff committed: both packages'
    read-only replays agree record for record, and the other package's
    router recovers it, every request once with equal tokens."""
    jobs = _jobs(4)
    walroot = str(tmp_path / "wal")
    rids, (done1, handoffs) = _first_life(
        first, walroot, jobs, lambda rt: rt.completed >= 1
        and rt.handoffs > rt.completed)
    assert 1 <= done1 < len(jobs) and handoffs >= 1
    recs = {name: mod.replay(walroot, repair=False)[0]
            for name, mod in (("jax", jwal), ("port", wal))}
    assert recs["port"] == recs["jax"] and recs["port"]
    assert _progress(wal, walroot) == _progress(jwal, walroot)
    out = _second_life(second, walroot, jobs, rids)
    assert out["recovery"]["lost"] == 0
    assert out["recovery"]["replayed"] + out["recovery"]["deduped"] > 0
    assert out["completed"] == len(jobs)
    assert out["tokens"] == reference(jobs)


# ---------------------------------------------------------------------------
# slow/chaos: SIGKILL the driver, relaunch on the same WAL (CPU workers)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctrlplane_run():
    sc = {"name": "fleet_ctrlplane", "kind": "fleet", "mode": "ctrlplane",
          "clients": 4, "rpc": 3, "kill_at_completed": 2}
    return chaos.run_scenario(sc, seed=0, platform="cpu")


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("arm", ["router_kill", "fleet_kill"])
def test_ctrlplane_kill_arm_recovers_exactly_once(ctrlplane_run, arm):
    res = ctrlplane_run
    assert res["problems"] == []
    m = res["metrics"][arm]
    assert m["kill_at_completed"] >= 2
    assert m["procs_left"] == 0
    assert m["requests"] == res["metrics"]["submitted"] == 12
    assert m["tokens_sha256"] == res["metrics"]["tokens_sha256"]
    assert m["recovery"]["lost"] == 0
    assert m["recovery"]["replayed"] + m["recovery"]["deduped"] > 0
    assert res["invariants"][f"{arm}_exactly_once"]
