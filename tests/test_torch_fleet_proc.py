"""The port's subprocess fleet on the CPU: the worker process, its wire
protocol, the weight snapshots it loads, and its supervision.

* The worker (``python -m ..._torch.serve._fleet_worker --worker
  --platform cpu``) speaks the JAX package's newline-JSON protocol: a
  port fleet (``launch_fleet``) and a JAX ``FleetRouter`` over a JAX
  ``ProcReplica`` both drive it to the tokens of an in-process scheduler.
  Its params come through ``--ckpt`` from a snapshot the JAX package
  wrote, so its tokens are JAX's scheduler's.
* Weight snapshots cross both ways (``serve.autopilot``): a JAX snapshot
  loads in the port bitwise (bf16 leaves too), a port snapshot in JAX.
* A corrupt snapshot makes the worker exit 44, which the supervisor does
  not relaunch.

Marked ``slow`` (and ``chaos``), as their JAX counterparts
(``tests/test_fleet.py:628-752``): the SIGKILL mid-load end to end under
``GroupSupervisor`` with a relaunch, and ``--crash-at-request``; phase 28
(d) of ``chip_smoke.py`` drives the former on the card.
"""

import functools
import hashlib
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import serve as jserve
from neural_networks_parallel_training_with_mpi_tpu.serve import (
    autopilot as jautopilot,
    fleet as jfleet,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import serve
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import fleet
from neural_networks_parallel_training_with_mpi_tpu_torch.train.resilience import (
    EXIT_ANOMALY, GroupSupervisor,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import prng
from test_torch_fleet import Clock, jax_sched
from test_torch_serve import _blocking, _models

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent
V = 64
MODEL_FLAGS = dict(vocab=V, seq=64, layers=2, d_model=32, heads=4, d_ff=64,
                   init_seed=0)
SERVE_FLAGS = dict(slots=4, num_blocks=17, block_size=16, prefill_chunk=16,
                   queue_depth=16, platform="cpu")


def _plan(seed, clients=2, per_client=2, max_new=(4, 8)):
    return serve.make_requests(clients, per_client, vocab_size=V,
                               prompt_lens=(3, 10), max_new=max_new,
                               seed=seed)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def _seeded_port_params():
    """What a worker with ``--init-seed 0`` builds before ``--ckpt``."""
    _, _, model, _ = _models()
    return model.init(prng.init_generator(0))


@functools.lru_cache(maxsize=None)
def _jax_snapshot(root):
    """The JAX test LM's params as a JAX-written weight snapshot."""
    _, jp, _, _ = _models()
    return jautopilot.save_weight_snapshot(root, jp, step=3)


def _jax_tokens(plan):
    """The plan through one JAX scheduler (JAX's params)."""
    sched = jax_sched(Clock(), queue_depth=64, num_blocks=64)
    rids = [sched.submit(r["prompt"], r["max_new"])
            for reqs in plan for r in reqs]
    sched.run_until_drained()
    out = [sched.result(r) for r in rids]
    sched.close()
    return out


def _port_tokens(plan, params):
    _, _, model, _ = _models()
    sched = serve.Scheduler(model, params, serve.ServeConfig(
        slots=4, num_blocks=64, block_size=16, prefill_chunk=16,
        queue_depth=64), device="cpu")
    rids = [sched.submit(r["prompt"], r["max_new"])
            for reqs in plan for r in reqs]
    sched.run_until_drained()
    out = [sched.result(r) for r in rids]
    sched.close()
    return out


def _drive(fl, plan, timeout_s=60.0):
    rids = [fl.submit(r["prompt"], r["max_new"])
            for reqs in plan for r in reqs]
    assert all(r is not None for r in rids)
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        fl.pump()
        if all(fl.done(r) for r in rids):
            return [fl.result(r) for r in rids]
        time.sleep(0.005)
    raise AssertionError("the fleet never finished the plan")


# ---------------------------------------------------------------------------
# weight snapshots across the packages
# ---------------------------------------------------------------------------

def test_jax_snapshot_loads_in_the_port_and_decodes_to_jax_tokens(tmp_path):
    _, _, _, params = _models()
    snap = _jax_snapshot(str(tmp_path / "jax"))
    got = serve.load_weight_snapshot(snap, _seeded_port_params())
    a, b = dict(_flat(got)), dict(_flat(params))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    plan = _plan(3)
    assert _port_tokens(plan, got) == _jax_tokens(plan)
    # a bf16 leaf (|V2 in a numpy without ml_dtypes) arrives as bfloat16
    w = jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7
    bsnap = jautopilot.save_weight_snapshot(str(tmp_path / "bf16"),
                                            {"w": w, "b": [w[0]]})
    got = serve.load_weight_snapshot(
        bsnap, {"w": torch.zeros(3, 4, dtype=torch.bfloat16),
                "b": [torch.zeros(4, dtype=torch.bfloat16)]})
    want = torch.tensor(np.asarray(w, np.float32)).to(torch.bfloat16)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], want)
    assert torch.equal(got["b"][0], want[0])


def test_port_snapshot_loads_in_jax_and_decodes_to_port_tokens(tmp_path):
    jm, jp, _, params = _models()
    snap = serve.save_weight_snapshot(str(tmp_path / "port"), params,
                                      step=7, meta={"generation": 1})
    assert os.path.basename(snap) == "ckpt-7"
    back = jautopilot.load_weight_snapshot(snap, jp)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    plan = _plan(4)
    sched = _blocking(jserve.Scheduler(jm, back, jserve.ServeConfig(
        slots=4, num_blocks=64, block_size=16, prefill_chunk=16,
        queue_depth=64)))
    rids = [sched.submit(r["prompt"], r["max_new"])
            for reqs in plan for r in reqs]
    sched.run_until_drained()
    assert [sched.result(r) for r in rids] == _port_tokens(plan, params)
    sched.close()


def test_snapshot_mismatches_raise_as_jax(tmp_path):
    _, _, _, params = _models()
    snap = serve.save_weight_snapshot(str(tmp_path / "s"), params)
    tmpl = _seeded_port_params()
    wrong = dict(tmpl, head={"w": tmpl["head"]["w"].double()})
    with pytest.raises(ValueError, match="dtype float32, model expects "
                                         "float64"):
        serve.load_weight_snapshot(snap, wrong)
    with pytest.raises(ValueError, match="shape"):
        serve.load_weight_snapshot(snap, dict(tmpl, head={
            "w": tmpl["head"]["w"][:, :8]}))
    with pytest.raises(ValueError, match="leaves the model does not"):
        serve.load_weight_snapshot(snap, {k: v for k, v in tmpl.items()
                                          if k != "head"})
    with pytest.raises(ValueError, match="missing leaf"):
        serve.load_weight_snapshot(snap, dict(tmpl, extra={"w": tmpl[
            "head"]["w"]}))
    with open(os.path.join(snap, "weights.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\xff" * 8)
    with pytest.raises(ValueError, match="failed verification"):
        serve.load_weight_snapshot(snap, tmpl)


# ---------------------------------------------------------------------------
# the worker process
# ---------------------------------------------------------------------------

def test_worker_protocol_roundtrip(tmp_path):
    """One CPU worker under ``launch_fleet``, params from a JAX-written
    snapshot: ready -> submit -> done with JAX's scheduler's tokens,
    status events carrying the rollup record, telemetry and the role's
    heartbeat in its own dir; then a JAX router over a JAX ``ProcReplica``
    drives the same worker command to the same tokens; a clean exit."""
    snap = _jax_snapshot(str(tmp_path / "jax"))
    plan = _plan(3)
    want = _jax_tokens(plan)
    cfg = dict(SERVE_FLAGS, ckpt=snap)
    fl = fleet.launch_fleet(1, model=MODEL_FLAGS, serve=cfg,
                            telemetry_root=str(tmp_path / "t"),
                            log=lambda m: None)
    try:
        fl.wait_ready(60)
        h = fl.handles[0]
        assert h.ready_s is not None and h.ready_s > 0
        assert _drive(fl, plan) == want
        sig = h.load()
        assert sig is not None and sig.slots == 4 and sig.replica == 0
        assert h.report["kind"] == "rollup"
        tdir = tmp_path / "t" / "replica-0"
        assert fl.supervisor._children["replica-0"].spec.heartbeat_path == \
            str(tdir / "heartbeat-serve-p0.json")
        assert (tdir / "metrics.jsonl").exists()
    finally:
        fl.close()
    assert fl.supervisor.proc("replica-0").poll() is not None
    assert (tmp_path / "t" / "replica-0" / "heartbeat-serve-p0.json").exists()
    # the JAX package's router and handle over the port's worker
    cmd = fleet.worker_cmd(sys.executable, replica=0, model=MODEL_FLAGS,
                           serve=cfg, telemetry_dir=None)
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, bufsize=1,
                            env=dict(os.environ, PYTHONPATH=str(REPO)))
    handle = jfleet.ProcReplica("replica-0")
    handle.attach(proc)
    router = jfleet.FleetRouter([handle], queue_depth=16)
    try:
        t0 = time.time()
        while not handle.ready and time.time() - t0 < 60:
            handle.pump()
            time.sleep(0.01)
        rids = [router.submit(r["prompt"], r["max_new"])
                for reqs in plan for r in reqs]
        while not all(router.done(r) for r in rids):
            assert time.time() - t0 < 120
            router.pump()
            time.sleep(0.005)
        assert [router.result(r) for r in rids] == want
    finally:
        handle.request_exit()
        assert proc.wait(timeout=30) == 0


def test_corrupt_snapshot_exits_44_and_is_not_relaunched(tmp_path):
    _, _, _, params = _models()
    snap = serve.save_weight_snapshot(str(tmp_path / "s"), params)
    with open(os.path.join(snap, "weights.npz"), "r+b") as f:
        f.seek(200)
        f.write(b"\x00" * 16)
    cfg = dict(python=sys.executable, model=MODEL_FLAGS,
               serve=dict(SERVE_FLAGS), telemetry_root=None, status_every=5,
               step_sleep_ms=0.0, tp=0, max_restarts=2, backoff=0.05,
               backoff_cap=0.1, heartbeat_timeout=0.0, prewarm=False,
               repo_root=str(REPO))
    handle, spec, _ = fleet._spawn_replica(cfg, 0, ckpt=snap)
    g = GroupSupervisor([spec], log=lambda m: None)
    g.start()
    evs = []
    t0 = time.time()
    while g.running() and time.time() - t0 < 60:
        evs += g.poll()
        time.sleep(0.05)
    assert g.done("replica-0") == EXIT_ANOMALY
    assert [e["event"] for e in evs] == ["exit", "stopped"]
    assert not handle.ready


# ---------------------------------------------------------------------------
# multi-process end to end (slow / chaos, as JAX's)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.chaos
def test_fleet_kill_replica_mid_load_relaunches(tmp_path):
    """SIGKILL one worker mid-load under the group supervisor: every
    request finishes after the requeue with the in-process tokens, the
    supervisor relaunches only the dead worker, the sibling's pid never
    changes."""
    plan = _plan(5, clients=6, per_client=3, max_new=(6, 10))
    want = _port_tokens(plan, _seeded_port_params())
    fl = fleet.launch_fleet(2, model=MODEL_FLAGS, serve=SERVE_FLAGS,
                            telemetry_root=str(tmp_path), backoff=0.2,
                            backoff_cap=1.0, log=lambda m: None)
    try:
        fl.wait_ready(120)
        sibling = fl.supervisor.proc("replica-1").pid
        rids = [fl.submit(r["prompt"], r["max_new"])
                for reqs in plan for r in reqs]
        killed = False
        t0 = time.time()
        while time.time() - t0 < 120:
            fl.pump()
            if not killed and sum(fl.done(r) for r in rids) >= 3:
                os.kill(fl.supervisor.proc("replica-0").pid, signal.SIGKILL)
                killed = True
            if all(fl.done(r) for r in rids):
                break
            time.sleep(0.002)
        assert killed
        assert [fl.result(r) for r in rids] == want
        assert fl.router.replica_deaths >= 1 and fl.router.requeued >= 1
        while not any(e["child"] == "replica-0" and e["event"] == "relaunch"
                      for e in fl.events):
            assert time.time() - t0 < 180
            fl.pump()
            time.sleep(0.02)
        evs = [(e["child"], e["event"]) for e in fl.events]
        assert ("replica-1", "relaunch") not in evs
        assert fl.supervisor.proc("replica-1").pid == sibling
    finally:
        fl.close()


@pytest.mark.slow
def test_fleet_crash_at_request_fault_injection():
    plan = _plan(9, clients=4, per_client=2)
    want = _port_tokens(plan, _seeded_port_params())
    fl = fleet.launch_fleet(2, model=MODEL_FLAGS, serve=SERVE_FLAGS,
                            backoff=0.2, backoff_cap=1.0,
                            crash_at_request=2, log=lambda m: None)
    try:
        fl.wait_ready(120)
        row = serve.run_fleet_closed_loop(fl, 4, 2, vocab_size=V,
                                          prompt_lens=(3, 10),
                                          max_new=(4, 8), seed=9)
        assert row["requests"] == 8 and row["requeued"] >= 1
        h = hashlib.sha256()
        for k, toks in enumerate(want):
            h.update(repr((k // 2, k % 2, toks)).encode())
        assert row["tokens_sha256"] == h.hexdigest()
    finally:
        fl.close()
