"""The port's fleet autopilot (``serve/autopilot.py``: ``AutopilotConfig``,
``Autopilot``; ``Fleet.pump``'s tick) against the JAX package's.

Holds the port to ``tests/test_autopilot.py``'s in-process cases: the
supervisor's exit-47, retire and add/remove contracts on stdlib
children, the drained-report/death race, and the control loop on a fake
clock over the port's real ``FleetRouter`` with scripted stand-in
replicas (autoscale, backoff, scale-in, stalled drain, health eviction,
rollout, canary judge, generation attribution, breakdown).  Then one
scripted timeline (load, queue depth, a death, a preempt notice, a
stalled drain, a good rollout and a slow canary) goes through JAX's
``Autopilot`` and the port's with identical stand-ins: the decisions
(without their times), the ``breakdown()`` rows and the decision records
written to ``events_path`` are equal entry by entry.

The subprocess chaos cases (``replica_kill`` mid scale-out, a stalled
drain escalated, a corrupt canary rolled back) run CPU workers and are
``slow``/``chaos``, as JAX's are.
"""

import dataclasses
import json
import pathlib
import sys
import time
import types

import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import serve as jserve
from neural_networks_parallel_training_with_mpi_tpu.serve import (
    fleet as jfleet,
)
from neural_networks_parallel_training_with_mpi_tpu.utils.sketches import (
    QuantileSketch as JaxQuantileSketch,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import serve
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
    Autopilot, AutopilotConfig, FleetRouter, InprocReplica, LoadSignal,
    Scheduler, ServeConfig, launch_fleet, make_requests,
    save_weight_snapshot,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve.fleet import (
    GEN_STRIDE, ReplicaHandle,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.resilience import (
    EXIT_ANOMALY, EXIT_DECOMMISSION, ChildSpec, GroupSupervisor, supervise,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    ckpt_manifest, prng,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.sketches import (
    QuantileSketch,
)
from test_torch_serve import _models

pytestmark = pytest.mark.torch_port

V = 64


def _sched(*, slots=4, queue_depth=16, replica=None):
    _, _, model, params = _models()
    return Scheduler(model, params, ServeConfig(
        slots=slots, num_blocks=1 + slots * 4, block_size=16,
        prefill_chunk=16, queue_depth=queue_depth, replica=replica),
        device="cpu")


# ---------------------------------------------------------------------------
# exit-code contract: 47 is terminal
# ---------------------------------------------------------------------------

def test_supervise_decommission_terminal_crash_still_retries(monkeypatch):
    """supervise(): 47 stops at once (one attempt, no backoff); a crash
    code still retries under the capped exponential backoff."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
        resilience as res,
    )

    def run(code_seq, **kw):
        it = iter(code_seq)
        calls, sleeps = [], []

        def fake_call(cmd, env=None):
            rc = next(it)
            calls.append(rc)
            return rc

        monkeypatch.setattr(res.subprocess, "call", fake_call)
        rc = supervise(["x"], _sleep=sleeps.append, _rand=lambda: 0.0,
                       **kw)
        return rc, calls, sleeps

    rc, calls, sleeps = run([EXIT_DECOMMISSION], max_restarts=3,
                            backoff=0.5)
    assert rc == EXIT_DECOMMISSION and len(calls) == 1 and sleeps == []
    rc, calls, sleeps = run([1, 1, 1], max_restarts=2, backoff=0.5,
                            backoff_cap=0.6)
    assert rc == 1 and len(calls) == 3
    assert sleeps == [pytest.approx(0.5), pytest.approx(0.6)]


def _pump_group(g, until, timeout_s=15.0):
    evs = []
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        evs += g.poll()
        if until(evs):
            return evs
        time.sleep(0.02)
    raise AssertionError(f"condition never met; events={evs}")


def test_group_supervisor_exit47_terminal():
    spec = ChildSpec(name="decomm",
                     cmd=[sys.executable, "-c", "raise SystemExit(47)"],
                     max_restarts=3, backoff=0.05)
    g = GroupSupervisor([spec], log=lambda m: None)
    g.start()
    evs = _pump_group(g, lambda evs: not g.running())
    kinds = [(e["child"], e["event"]) for e in evs]
    assert ("decomm", "stopped") in kinds
    assert ("decomm", "relaunch") not in kinds
    assert g.done("decomm") == EXIT_DECOMMISSION


def test_group_supervisor_retire_makes_any_exit_terminal():
    """retire() before the drain: even a SIGKILL escalation stops the
    child for good."""
    spec = ChildSpec(name="victim",
                     cmd=[sys.executable, "-c",
                          "import time; time.sleep(60)"],
                     max_restarts=3, backoff=0.05)
    g = GroupSupervisor([spec], log=lambda m: None)
    g.start()
    try:
        g.retire("victim")
        g.proc("victim").kill()
        evs = _pump_group(g, lambda evs: not g.running())
        kinds = [(e["child"], e["event"]) for e in evs]
        assert ("victim", "stopped") in kinds
        assert ("victim", "relaunch") not in kinds
        assert g.done("victim") is not None
    finally:
        g.terminate_all()


def test_group_supervisor_retire_cancels_pending_relaunch():
    spec = ChildSpec(name="crashy",
                     cmd=[sys.executable, "-c", "raise SystemExit(9)"],
                     max_restarts=5, backoff=30.0, backoff_cap=30.0)
    g = GroupSupervisor([spec], log=lambda m: None)
    g.start()
    try:
        _pump_group(g, lambda evs: any(e["event"] == "exit" for e in evs))
        g.retire("crashy")          # inside the 30 s backoff window
        evs = _pump_group(g, lambda evs: not g.running(), timeout_s=5.0)
        assert not any(e["event"] == "relaunch" for e in evs)
        assert g.done("crashy") == 9
    finally:
        g.terminate_all()


def test_group_supervisor_add_and_remove_child():
    g = GroupSupervisor([], log=lambda m: None)
    g.start()
    try:
        g.add_child(ChildSpec(
            name="late", cmd=[sys.executable, "-c", "raise SystemExit(0)"],
            max_restarts=0, backoff=0.05))
        with pytest.raises(ValueError):
            g.add_child(ChildSpec(name="late", cmd=["x"]))
        _pump_group(g, lambda evs: g.done("late") is not None)
        g.remove_child("late")
        with pytest.raises(KeyError):
            g.done("late")
    finally:
        g.terminate_all()


# ---------------------------------------------------------------------------
# drain/death race
# ---------------------------------------------------------------------------

class _RacyHandle(ReplicaHandle):
    """Completion events buffer like a subprocess pipe; ``drained`` is
    filled like a worker's drained report."""

    def __init__(self, name="racy"):
        self.name = name
        self._assigned = {}
        self.events = []
        self.drained = None
        self._alive = True

    def alive(self):
        return self._alive

    def accepting(self):
        return self._alive

    def load(self):
        return LoadSignal.from_report({
            "kind": "rollup", "role": "serve",
            "now": {"queue_depth": 0, "in_flight": len(self._assigned),
                    "free_slots": max(0, 4 - len(self._assigned)),
                    "slots": 4, "queue_cap": 16, "free_blocks": 100,
                    "block_utilization": 0.0}})

    def submit(self, req):
        if not self._alive:
            return False
        self._assigned[req.rid] = req
        return True

    def pump(self):
        out, self.events = self.events, []
        for rec in out:
            self._assigned.pop(int(rec["rid"]), None)
        return out

    def assigned(self):
        return list(self._assigned)

    def take_assigned(self):
        rids = list(self._assigned)
        self._assigned.clear()
        return rids


def test_drained_report_racing_death_requeues_exactly_once():
    """A decommissioned replica's drained report still buffered when its
    death lands: in-flight requests requeue exactly once, and the
    completion that raced the exit is honored, not re-run."""
    racy = _RacyHandle()
    router = FleetRouter([racy], queue_depth=16)
    rids = [router.submit([1 + i, 2], 3) for i in range(4)]
    router.pump()
    assert sorted(racy.assigned()) == sorted(rids)
    racy.events.append({"ev": "done", "rid": rids[0], "tokens": [1, 2, 9],
                        "ttft_ms": 1.0, "itl_ms": 1.0})
    racy._assigned.pop(rids[0])
    racy.drained = [{"rid": rids[0], "prompt": [1, 2], "max_new": 3,
                     "slo_ms": None}]
    racy._alive = False
    router.on_replica_down(racy.name)
    assert router.requeued == 3
    assert racy.drained is None
    router.on_replica_down(racy.name)
    assert router.requeued == 3
    done = router.pump()
    assert rids[0] in done and router.done(rids[0])
    assert router.result(rids[0]) == [1, 2, 9]
    sink = InprocReplica(_sched(replica=1), name="sink")
    router.add_replica(sink)
    for _ in range(500):
        router.pump()
        if all(router.done(r) for r in rids[1:]):
            break
    assert all(router.done(r) for r in rids[1:])
    assert router.requeued == 3
    sink.close()


# ---------------------------------------------------------------------------
# control loop on a fake clock (the real FleetRouter underneath)
# ---------------------------------------------------------------------------

def _ctrl_cls(handle_base, signal_cls):
    class _CtrlReplica(handle_base):
        """A stand-in whose load, readiness, liveness and notice the test
        scripts."""

        def __init__(self, name, generation=0, slots=4, in_flight=0,
                     ready=True):
            self.name = name
            self.generation = generation
            self.slots = slots
            self.in_flight = in_flight
            self.ready = ready
            self.report = None

        def alive(self):
            return True

        def accepting(self):
            return self.ready

        def load(self):
            return signal_cls.from_report({
                "kind": "rollup", "role": "serve",
                "now": {"queue_depth": 0, "in_flight": self.in_flight,
                        "free_slots": max(0, self.slots - self.in_flight),
                        "slots": self.slots, "queue_cap": 16,
                        "free_blocks": 100, "block_utilization": 0.0}})

        def submit(self, req):
            return False

        def pump(self):
            return []

        def assigned(self):
            return []

        def take_assigned(self):
            return []

    return _CtrlReplica


_CtrlReplica = _ctrl_cls(ReplicaHandle, LoadSignal)
_JaxCtrlReplica = _ctrl_cls(jfleet.ReplicaHandle, jfleet.LoadSignal)


class _FakeFleet:
    """The ``Fleet`` actuation surface over a real router, with scripted
    spawns and exits (no subprocess)."""

    def __init__(self, router, ctrl_cls=_CtrlReplica, gen_stride=GEN_STRIDE):
        self.router = router
        self.ctrl_cls = ctrl_cls
        self.gen_stride = gen_stride
        self.spawned = []
        self.decommissioned = []
        self.killed = []
        self.done_rc = {}
        self.fail_spawn = False
        self._k = len(router.replicas)

    def add_replica(self, *, generation=0, ckpt=None, faults=None,
                    step_sleep_ms=None):
        if self.fail_spawn:
            raise RuntimeError("spawn refused")
        rid = generation * self.gen_stride + self._k
        self._k += 1
        h = self.ctrl_cls(f"replica-{rid}", generation=generation,
                          ready=False)
        h.ckpt = ckpt
        h.step_sleep_ms = step_sleep_ms
        self.router.add_replica(h, generation=generation)
        self.spawned.append(h)
        return h

    def decommission(self, name):
        self.decommissioned.append(name)
        return True

    def force_kill(self, name):
        self.killed.append(name)

    def replica_done(self, name):
        return self.done_rc.get(name)

    def remove_replica(self, name):
        try:
            self.router.remove_replica(name)
        except KeyError:
            pass


def _autopilot(handles, cfg, t0=0.0):
    clock = [t0]
    router = FleetRouter(handles, queue_depth=64)
    fake = _FakeFleet(router)
    ap = Autopilot(fake, cfg, now_fn=lambda: clock[0])
    return ap, fake, router, clock


def _actions(ap):
    return [d["action"] for d in ap.decisions]


def test_scale_out_requires_hold_then_fires_once():
    """Hysteresis: the high signal must hold ``scale_out_hold_s`` (a blip
    resets it); then one action, guarded by cooldown."""
    cfg = AutopilotConfig(min_replicas=1, max_replicas=3, interval_s=0.0,
                          scale_out_hold_s=1.0, cooldown_s=5.0)
    h = _CtrlReplica("replica-0", in_flight=8)      # occupancy 2.0
    ap, fake, router, clock = _autopilot([h], cfg)
    ap.tick()
    assert _actions(ap) == []
    clock[0] = 0.6
    h.in_flight = 2
    ap.tick()
    clock[0] = 1.2
    h.in_flight = 8
    ap.tick()
    assert _actions(ap) == []
    clock[0] = 2.3
    ap.tick()
    assert _actions(ap) == ["scale_out"]
    assert len(fake.spawned) == 1 and fake.spawned[0].generation == 0
    clock[0] = 2.5
    ap.tick()
    assert _actions(ap) == ["scale_out"]
    fake.spawned[0].ready = True
    clock[0] = 3.0
    ap.tick()
    assert _actions(ap)[-1] == "scale_out_ready"
    assert ap.decisions[-1]["reaction_s"] == pytest.approx(0.7)


def test_scale_out_failure_arms_exponential_backoff():
    cfg = AutopilotConfig(min_replicas=1, max_replicas=3, interval_s=0.0,
                          scale_out_hold_s=0.5, cooldown_s=0.0,
                          action_backoff_s=1.0, action_backoff_cap_s=2.5)
    h = _CtrlReplica("replica-0", in_flight=8)
    ap, fake, router, clock = _autopilot([h], cfg)
    fake.fail_spawn = True
    ap.tick()
    clock[0] = 0.6
    ap.tick()
    assert _actions(ap) == ["action_backoff"]
    assert ap.decisions[-1]["backoff_s"] == pytest.approx(1.0)
    clock[0] = 2.3
    ap.tick()
    clock[0] = 3.0
    ap.tick()
    assert ap.decisions[-1]["backoff_s"] == pytest.approx(2.0)
    clock[0] = 6.0
    ap.tick()
    clock[0] = 7.0
    ap.tick()
    assert ap.decisions[-1]["backoff_s"] == pytest.approx(2.5)


def test_scale_in_decommissions_newest_and_respects_min():
    cfg = AutopilotConfig(min_replicas=1, max_replicas=2, interval_s=0.0,
                          scale_in_hold_s=1.0, cooldown_s=0.0,
                          drain_timeout_s=5.0)
    a = _CtrlReplica("replica-0")
    b = _CtrlReplica("replica-1")
    ap, fake, router, clock = _autopilot([a, b], cfg)
    ap.tick()
    clock[0] = 1.1
    ap.tick()
    assert _actions(ap) == ["scale_in"]
    assert fake.decommissioned == ["replica-1"]
    fake.done_rc["replica-1"] = EXIT_DECOMMISSION
    clock[0] = 1.5
    ap.tick()
    assert _actions(ap)[-1] == "drained"
    assert ap.decisions[-1]["rc"] == EXIT_DECOMMISSION
    assert [h.name for h in router.replicas] == ["replica-0"]
    clock[0] = 10.0
    ap.tick()
    clock[0] = 12.0
    ap.tick()
    assert "scale_in" not in _actions(ap)[1:]


def test_stalled_drain_escalates_to_force_kill():
    cfg = AutopilotConfig(min_replicas=1, max_replicas=2, interval_s=0.0,
                          scale_in_hold_s=0.5, cooldown_s=0.0,
                          drain_timeout_s=2.0)
    a = _CtrlReplica("replica-0")
    b = _CtrlReplica("replica-1")
    ap, fake, router, clock = _autopilot([a, b], cfg)
    ap.tick()
    clock[0] = 0.6
    ap.tick()
    assert fake.decommissioned == ["replica-1"]
    clock[0] = 2.7
    ap.tick()
    assert _actions(ap)[-1] == "drain_stalled_kill"
    assert fake.killed == ["replica-1"]
    fake.done_rc["replica-1"] = -9
    clock[0] = 3.0
    ap.tick()
    assert ap.decisions[-1]["action"] == "drained"
    assert ap.decisions[-1]["forced"] is True


def _slow_samples(router, t0, slow="replica-1", fast="replica-0", n=6,
                  slow_ms=100.0):
    for i in range(n):
        router.recent.append({"t": t0 + 0.1 * i, "replica": fast,
                              "ttft_ms": 20.0})
        router.recent.append({"t": t0 + 0.1 * i, "replica": slow,
                              "ttft_ms": slow_ms})


def test_health_eviction_replace_then_drain_respects_floor():
    """The windowed-TTFT verdict must hold ``evict_hold_s``; the
    replacement spawns before the victim drains, under the autoscaler's
    one-action gate and cooldown."""
    cfg = AutopilotConfig(min_replicas=2, max_replicas=2, interval_s=0.0,
                          cooldown_s=5.0, health_eviction=True,
                          evict_ttft_ratio=3.0, health_window_s=60.0,
                          evict_hold_s=1.0, evict_min_samples=4,
                          drain_timeout_s=30.0)
    a = _CtrlReplica("replica-0", in_flight=2)
    b = _CtrlReplica("replica-1", in_flight=2)
    ap, fake, router, clock = _autopilot([a, b], cfg)
    _slow_samples(router, 0.0)
    clock[0] = 1.0
    ap.tick()
    assert _actions(ap) == []
    clock[0] = 2.1
    ap.tick()
    assert _actions(ap) == ["health_evict"]
    d = ap.decisions[-1]
    assert d["replica"] == "replica-1"
    assert d["replacement"] == fake.spawned[0].name
    assert d["ttft_ratio"] == pytest.approx(5.0)
    assert fake.decommissioned == [] and len(router.replicas) == 3
    clock[0] = 2.2
    ap.tick()
    assert _actions(ap) == ["health_evict"]
    fake.spawned[0].ready = True
    clock[0] = 3.0
    ap.tick()
    assert _actions(ap)[-1] == "scale_out_ready"
    assert fake.decommissioned == ["replica-1"]
    fake.done_rc["replica-1"] = EXIT_DECOMMISSION
    clock[0] = 3.5
    ap.tick()
    assert _actions(ap)[-1] == "drained"
    assert sorted(h.name for h in router.replicas) == sorted(
        ["replica-0", fake.spawned[0].name])
    _slow_samples(router, 4.0, slow="replica-0", fast=fake.spawned[0].name)
    clock[0] = 5.0
    ap.tick()
    clock[0] = 6.5
    ap.tick()
    assert _actions(ap).count("health_evict") == 1


def test_health_eviction_needs_peers_and_min_samples():
    cfg = AutopilotConfig(min_replicas=1, max_replicas=2, interval_s=0.0,
                          cooldown_s=0.0, health_eviction=True,
                          evict_ttft_ratio=3.0, health_window_s=60.0,
                          evict_hold_s=0.0, evict_min_samples=4)
    a = _CtrlReplica("replica-0", in_flight=2)
    ap, fake, router, clock = _autopilot([a], cfg)
    _slow_samples(router, 0.0, slow="replica-0", fast="replica-0",
                  slow_ms=500.0)
    clock[0] = 1.0
    ap.tick()
    assert "health_evict" not in _actions(ap)
    router.add_replica(_CtrlReplica("replica-1", in_flight=2))
    router.recent.clear()
    _slow_samples(router, 1.0, n=2)
    clock[0] = 2.0
    ap.tick()
    assert "health_evict" not in _actions(ap)


def test_rollout_rejects_unverified_snapshot(tmp_path):
    ap, fake, router, clock = _autopilot([_CtrlReplica("replica-0")],
                                         AutopilotConfig(interval_s=0.0))
    bad = tmp_path / "nothing"
    bad.mkdir()
    assert ap.start_rollout(bad) is False
    assert fake.spawned == [] and router._primary_gen == 0
    assert _actions(ap) == ["rollout_rejected", "action_backoff"]


def _good_snapshot(tmp_path):
    return save_weight_snapshot(tmp_path, {"w": torch.ones(2, 2)}, step=1)


def test_canary_judge_promotes_healthy_generation(tmp_path):
    cfg = AutopilotConfig(interval_s=0.0, canary_window_s=2.0,
                          canary_min_completed=3, canary_fraction=0.25,
                          canary_max_p50_ratio=3.0)
    a = _CtrlReplica("replica-0")
    b = _CtrlReplica("replica-1")
    ap, fake, router, clock = _autopilot([a, b], cfg)
    assert ap.start_rollout(_good_snapshot(tmp_path)) is True
    canary = fake.spawned[0]
    assert canary.generation == 1 and canary.ckpt is not None
    ap.tick()
    assert router._canary is None
    canary.ready = True
    clock[0] = 1.0
    ap.tick()
    assert "canary_traffic" in _actions(ap)
    assert router._canary == (1, 0.25) and router._primary_gen == 0
    router._completed_by[canary.name] = 6
    for i in range(6):
        router.recent.append({"t": 2.0 + 0.1 * i, "replica": canary.name,
                              "generation": 1, "ttft_ms": 55.0,
                              "missed": False})
        router.recent.append({"t": 2.0 + 0.1 * i, "replica": "replica-0",
                              "generation": 0, "ttft_ms": 50.0,
                              "missed": False})
    clock[0] = 3.1
    ap.tick()
    assert "canary_promote" in _actions(ap)
    assert ap.decisions[-1]["p50_ratio"] == pytest.approx(1.1)
    assert router._primary_gen == 1 and router._canary is None
    assert sorted(fake.decommissioned) == ["replica-0", "replica-1"]
    assert len(fake.spawned) == 2
    fake.done_rc["replica-0"] = EXIT_DECOMMISSION
    fake.done_rc["replica-1"] = EXIT_DECOMMISSION
    clock[0] = 3.5
    ap.tick()
    assert _actions(ap)[-1] == "rollout_complete"
    assert {h.generation for h in router.replicas} == {1}


def test_canary_judge_rolls_back_on_slo_burn(tmp_path):
    cfg = AutopilotConfig(interval_s=0.0, canary_window_s=2.0,
                          canary_min_completed=3, canary_max_miss_frac=0.25)
    ap, fake, router, clock = _autopilot([_CtrlReplica("replica-0")], cfg)
    ap.start_rollout(_good_snapshot(tmp_path))
    canary = fake.spawned[0]
    canary.ready = True
    clock[0] = 1.0
    ap.tick()
    router._completed_by[canary.name] = 4
    router._missed_by[canary.name] = 2
    clock[0] = 3.1
    ap.tick()
    assert _actions(ap)[-2] == "canary_rollback"
    assert "SLO burn" in ap.decisions[-2]["reason"]
    assert router._primary_gen == 0 and router._canary is None
    assert fake.decommissioned == [canary.name]
    assert ap.decisions[-1]["action"] == "action_backoff"


def test_canary_death_rolls_back_old_gen_untouched(tmp_path):
    ap, fake, router, clock = _autopilot([_CtrlReplica("replica-0")],
                                         AutopilotConfig(interval_s=0.0))
    ap.start_rollout(_good_snapshot(tmp_path))
    fake.done_rc[fake.spawned[0].name] = EXIT_ANOMALY
    clock[0] = 0.5
    ap.tick()
    roll = [d for d in ap.decisions if d["action"] == "canary_rollback"]
    assert roll and "died (rc 44)" in roll[0]["reason"]
    assert router._primary_gen == 0
    assert [h.name for h in router.replicas] == ["replica-0"]
    assert fake.decommissioned == []


def test_rollout_in_progress_is_exclusive(tmp_path):
    ap, fake, router, clock = _autopilot([_CtrlReplica("replica-0")],
                                         AutopilotConfig(interval_s=0.0))
    ap.start_rollout(_good_snapshot(tmp_path))
    with pytest.raises(RuntimeError, match="in progress"):
        ap.start_rollout(_good_snapshot(tmp_path))


# ---------------------------------------------------------------------------
# generation-aware traffic and attribution
# ---------------------------------------------------------------------------

def test_canary_slice_is_uniform_over_sequential_rids():
    router = FleetRouter([_CtrlReplica("replica-0")], queue_depth=8)
    router.set_traffic(0, canary_generation=1, canary_fraction=0.25)
    for lo in (0, 500, 5000):
        hits = sum(1 for rid in range(lo, lo + 1000)
                   if router._desired_gen(types.SimpleNamespace(rid=rid))
                   == 1)
        assert 180 <= hits <= 320, (lo, hits)
    router.set_traffic(0)
    assert all(router._desired_gen(types.SimpleNamespace(rid=r)) == 0
               for r in range(100))


def test_generation_attribution_and_placement_preference():
    old = InprocReplica(_sched(replica=0), name="old")
    new = InprocReplica(_sched(replica=1), name="new")
    router = FleetRouter([old], queue_depth=32)
    router.add_replica(new, generation=1)
    assert new.generation == 1
    router.set_traffic(0, canary_generation=1, canary_fraction=1.0)
    plan = make_requests(2, 2, vocab_size=V, prompt_lens=(3, 8),
                         max_new=(4, 6), seed=13)
    rids = [router.submit(r["prompt"], r["max_new"])
            for client in plan for r in client]
    for _ in range(500):
        router.pump()
        if all(router.done(r) for r in rids):
            break
    assert all(router.done(r) for r in rids)
    assert router.per_generation_completed() == {1: len(rids)}
    assert all(router.reqs[r].generation == 1 for r in rids)
    assert (1 * GEN_STRIDE + 2) // GEN_STRIDE == 1
    old.close()
    new.close()


def test_generation_preference_yields_to_availability():
    only = InprocReplica(_sched(replica=0), name="only")
    router = FleetRouter([only], queue_depth=32)
    router.set_traffic(0, canary_generation=1, canary_fraction=1.0)
    rid = router.submit([1, 2, 3], 4)
    for _ in range(200):
        router.pump()
        if router.done(rid):
            break
    assert router.done(rid) and router.reqs[rid].generation == 0
    only.close()


def test_autopilot_breakdown_matches_obs_shape():
    h = InprocReplica(_sched(replica=0), name="r0")
    router = FleetRouter([h], queue_depth=8)
    ap = Autopilot(_FakeFleet(router), AutopilotConfig(interval_s=0.0))
    rid = router.submit([1, 2, 3], 4)
    for _ in range(200):
        router.pump()
        if router.done(rid):
            break
    rows = ap.breakdown()
    assert len(rows) == 1
    row = rows[0]
    assert row["name"] == "r0" and row["generation"] == 0
    assert row["role"] == "serve" and row["ttft_ms_p50"] is not None
    assert "queue_depth" in row and "block_utilization" in row
    h.close()


def test_fleet_pump_ticks_the_attached_autopilot_once():
    """``Fleet.pump`` ticks an attached autopilot once per call, after the
    router's pass (JAX's ``Fleet.pump``); without one it ticks nothing."""
    order = []

    class Sup:
        def poll(self):
            order.append("poll")
            return []

    class Counter:
        def tick(self):
            order.append("tick")
            return []

    router = FleetRouter([_CtrlReplica("replica-0")], queue_depth=8)
    real_pump = router.pump
    router.pump = lambda: order.append("router") or real_pump()
    fl = serve.Fleet(router=router, supervisor=Sup(), handles=[])
    fl.pump()
    assert order == ["poll", "router"]
    order.clear()
    fl.autopilot = Counter()
    for _ in range(3):
        fl.pump()
    assert order == ["poll", "router", "tick"] * 3
    assert "autopilot" in {f.name for f in dataclasses.fields(serve.Fleet)}


# ---------------------------------------------------------------------------
# one scripted timeline through JAX's Autopilot and the port's
# ---------------------------------------------------------------------------

def _rollup(sketch_cls, ttft, itl, queue, in_flight):
    sk_t, sk_i = sketch_cls(), sketch_cls()
    for v in ttft:
        sk_t.add(v)
    for v in itl:
        sk_i.add(v)
    return {"kind": "rollup", "role": "serve", "replica": 0, "step": 7,
            "sketches": {"ttft_ms": sk_t.to_dict(), "itl_ms": sk_i.to_dict()},
            "now": {"queue_depth": queue, "in_flight": in_flight,
                    "block_utilization": 0.25}}


def _timeline(side, good, slow, events_path):
    """The scripted run on one side: (decisions without "t", breakdown
    rows taken along the way, the ``events_path`` records without their
    clocks)."""
    if side == "jax":
        mods = dict(router=jserve.FleetRouter, ap=jserve.Autopilot,
                    cfg=jserve.AutopilotConfig, ctrl=_JaxCtrlReplica,
                    stride=jfleet.GEN_STRIDE, sketch=JaxQuantileSketch)
    else:
        mods = dict(router=FleetRouter, ap=Autopilot, cfg=AutopilotConfig,
                    ctrl=_CtrlReplica, stride=GEN_STRIDE,
                    sketch=QuantileSketch)
    ctrl = mods["ctrl"]
    cfg = mods["cfg"](min_replicas=2, max_replicas=3, interval_s=0.0,
                      scale_out_hold_s=0.5, scale_in_hold_s=1.0,
                      cooldown_s=1.0, action_backoff_s=0.5,
                      action_backoff_cap_s=2.0, drain_timeout_s=2.0,
                      ready_timeout_s=30.0, canary_window_s=2.0,
                      canary_min_completed=3, canary_fraction=0.5,
                      canary_max_p50_ratio=3.0, events_path=events_path)
    a, b = ctrl("replica-0", in_flight=2), ctrl("replica-1", in_flight=2)
    router = mods["router"]([a, b], queue_depth=64)
    fake = _FakeFleet(router, ctrl_cls=ctrl, gen_stride=mods["stride"])
    clock = [0.0]
    ap = mods["ap"](fake, cfg, now_fn=lambda: clock[0])
    rows = []

    def at(t):
        clock[0] = t
        ap.tick()

    def by_name(name):
        return next(h for h in router.replicas if h.name == name)

    # queue depth over its high-water mark (the stand-ins refuse work)
    for i in range(9):
        router.submit([1 + i, 2], 3)
    at(0.0)
    at(0.6)                                   # held 0.6 s: scale_out
    # the new replica dies before it is ready: a failed action
    fake.done_rc[fake.spawned[-1].name] = 1
    at(0.7)
    router.queue.clear()
    a.in_flight = b.in_flight = 8             # occupancy 2.0
    at(1.5)
    at(2.1)                                   # held: scale_out again
    fake.spawned[-1].ready = True
    at(2.2)                                   # scale_out_ready
    for h in router.replicas:
        h.in_flight = 2
    a.report = _rollup(mods["sketch"], [20.0, 22.0, 30.0], [5.0, 6.0], 1, 2)
    b.report = _rollup(mods["sketch"], [40.0, 41.0], [9.0], 0, 3)
    rows.append(ap.breakdown())
    # a preempt notice on replica-1: recorded, backfilled, drained
    b.noticed, b.notice_grace_s = True, 2.0
    at(3.5)
    fake.done_rc["replica-1"] = EXIT_DECOMMISSION
    at(3.6)
    fake.spawned[-1].ready = True
    at(3.7)
    # low load: scale_in of the newest, whose drain stalls and is killed
    for h in router.replicas:
        h.in_flight = 0
    at(5.0)
    at(6.1)
    victim = fake.decommissioned[-1]
    at(8.2)                                   # drain_stalled_kill
    fake.done_rc[victim] = -9
    at(8.3)
    # a good rollout: canary, traffic, judge, promote, old drains out
    for h in router.replicas:
        h.in_flight = 2
    assert ap.start_rollout(good) is True
    at(9.0)
    canary = fake.spawned[-1]
    canary.ready = True
    at(9.5)                                   # canary_traffic
    router._completed_by[canary.name] = 5
    for i in range(5):
        router.recent.append({"t": 10.0 + 0.1 * i, "replica": canary.name,
                              "generation": 1, "ttft_ms": 30.0,
                              "missed": False})
        router.recent.append({"t": 10.0 + 0.1 * i, "replica": "replica-0",
                              "generation": 0, "ttft_ms": 25.0,
                              "missed": False})
    at(11.6)                                  # canary_promote
    for h in list(router.replicas):
        h.ready = True
    for name in list(fake.decommissioned[-2:]):
        fake.done_rc[name] = EXIT_DECOMMISSION
    at(12.0)                                  # drained x2, rollout_complete
    rows.append(ap.breakdown())
    # a slow canary: judged on its p50 and rolled back
    at(20.0)
    assert ap.start_rollout(slow, step_sleep_ms=100.0) is True
    slow_canary = fake.spawned[-1]
    assert slow_canary.step_sleep_ms == 100.0
    slow_canary.ready = True
    at(20.5)
    router._completed_by[slow_canary.name] = 4
    gen1 = [h.name for h in router.replicas
            if h.generation == 1 and h.name != slow_canary.name]
    for i in range(4):
        router.recent.append({"t": 21.0 + 0.1 * i,
                              "replica": slow_canary.name, "generation": 2,
                              "ttft_ms": 400.0, "missed": False})
        router.recent.append({"t": 21.0 + 0.1 * i, "replica": gen1[0],
                              "generation": 1, "ttft_ms": 30.0,
                              "missed": False})
    at(22.6)                                  # canary_rollback
    decisions = [{k: v for k, v in d.items() if k != "t"}
                 for d in ap.decisions]
    with open(events_path) as f:
        recs = [json.loads(ln) for ln in f]
    recs = [{k: v for k, v in r.items() if k not in ("t", "t_unix")}
            for r in recs]
    return decisions, rows, recs, ap.summary()


def test_scripted_timeline_decisions_equal_jax(tmp_path):
    snap_root = tmp_path / "snaps"
    good = save_weight_snapshot(snap_root / "good", {"w": torch.ones(2, 2)},
                                step=1)
    slow = save_weight_snapshot(snap_root / "slow", {"w": torch.ones(2, 2)},
                                step=2)
    got = _timeline("port", good, slow, str(tmp_path / "port.jsonl"))
    want = _timeline("jax", good, slow, str(tmp_path / "jax.jsonl"))
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert g == w
    acts = [d["action"] for d in got[0]]
    for needed in ("scale_out", "action_backoff", "scale_out_ready",
                   "preempt_notice", "preempt_backfill", "preempt_drained",
                   "scale_in", "drain_stalled_kill", "drained",
                   "canary_spawn", "canary_traffic", "canary_promote",
                   "rollout_complete", "canary_rollback"):
        assert needed in acts, (needed, acts)
    assert got[1] == want[1]
    assert got[2] == want[2]
    # one record per decision, as JAX writes them (a decision's own
    # "kind", e.g. a drain's, overrides the record's "autopilot")
    assert [r["action"] for r in got[2]] == acts
    assert {r["kind"] for r in got[2]
            if r["action"] not in ("drained", "drain_stalled_kill")} == {
        "autopilot"}
    assert got[3] == want[3]


# ---------------------------------------------------------------------------
# slow/chaos: subprocess fleets (CPU workers) under the autopilot
# ---------------------------------------------------------------------------

MODEL_FLAGS = dict(vocab=V, seq=64, layers=2, d_model=32, heads=4, d_ff=64,
                   init_seed=0)
SERVE_FLAGS = dict(slots=4, num_blocks=17, block_size=16, prefill_chunk=16,
                   queue_depth=16, platform="cpu")


def _drive(fl, plan, *, timeout_s=300, mid=None, mid_at=3):
    """Closed-loop drive of a subprocess fleet; ``mid`` runs once after
    ``mid_at`` completions.  Returns {key: tokens}."""
    clients = len(plan)
    rids, results = {}, {}
    next_i = {ci: 0 for ci in range(clients)}
    outstanding = {ci: None for ci in range(clients)}
    fired = False
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        for ci in range(clients):
            if outstanding[ci] is not None or next_i[ci] >= len(plan[ci]):
                continue
            r = plan[ci][next_i[ci]]
            rid = fl.submit(r["prompt"], r["max_new"])
            if rid is None:
                continue
            rids[(ci, next_i[ci])] = rid
            outstanding[ci] = rid
            next_i[ci] += 1
        for rid in fl.pump():
            for ci in range(clients):
                if outstanding[ci] == rid:
                    outstanding[ci] = None
        n_done = sum(1 for r in rids.values() if fl.done(r))
        if not fired and mid is not None and n_done >= mid_at:
            fired = True
            mid()
        if (len(rids) == sum(len(p) for p in plan)
                and all(fl.done(r) for r in rids.values())):
            for key, rid in rids.items():
                results[key] = fl.result(rid)
            return results
        time.sleep(0.005)
    raise AssertionError(
        f"fleet never drained: {len(results)}/{sum(map(len, plan))}")


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_replica_kill_fault_mid_scale_out(tmp_path):
    fl = launch_fleet(1, model=MODEL_FLAGS, serve=SERVE_FLAGS,
                      telemetry_root=str(tmp_path), backoff=0.2,
                      backoff_cap=1.0, log=lambda m: None)
    try:
        fl.wait_ready(300)
        h = fl.add_replica(faults="replica_kill@3")
        fl.autopilot = Autopilot(fl, AutopilotConfig(
            min_replicas=2, max_replicas=2, interval_s=0.1))
        # the port's CPU workers serve this load faster than the new one
        # starts: let it take traffic, so its third submit comes
        t0 = time.time()
        while time.time() - t0 < 120 and not h.accepting():
            fl.pump()
            time.sleep(0.01)
        assert h.accepting()
        plan = make_requests(6, 4, vocab_size=V, prompt_lens=(3, 10),
                             max_new=(4, 8), seed=21)
        assert len(_drive(fl, plan)) == 24
        t0 = time.time()
        while time.time() - t0 < 30:
            fl.pump()
            if any(e["event"] == "relaunch" and e["child"] == h.name
                   for e in fl.events):
                break
            time.sleep(0.05)
        evs = [(e["event"], e["child"]) for e in fl.events]
        assert ("relaunch", h.name) in evs
        assert fl.router.requeued >= 1
    finally:
        fl.close()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_stalled_drain_escalates_and_ledger_exact(tmp_path):
    fl = launch_fleet(1, model=MODEL_FLAGS, serve=SERVE_FLAGS,
                      telemetry_root=str(tmp_path), log=lambda m: None)
    try:
        fl.wait_ready(300)
        h = fl.add_replica(faults="stall_drain@0-1000000")
        ap = Autopilot(fl, AutopilotConfig(
            min_replicas=1, max_replicas=2, interval_s=0.1,
            drain_timeout_s=2.0, scale_in_hold_s=3600.0))
        fl.autopilot = ap
        t0 = time.time()
        while time.time() - t0 < 120 and not h.accepting():
            fl.pump()
            time.sleep(0.01)
        assert h.accepting()

        def mid():
            ap._begin_decommission(ap._now(), h.name, kind="test_scale_in")

        plan = make_requests(6, 4, vocab_size=V, prompt_lens=(3, 10),
                             max_new=(4, 8), seed=22)
        assert len(_drive(fl, plan, mid=mid)) == 24
        # the load can end inside the drain timeout: pump until the
        # stalled drain has been escalated and reaped
        t0 = time.time()
        while time.time() - t0 < 60 and not any(
                d["action"] == "drained" for d in ap.decisions):
            fl.pump()
            time.sleep(0.01)
        acts = [d["action"] for d in ap.decisions]
        assert "drain_stalled_kill" in acts
        drained = [d for d in ap.decisions if d["action"] == "drained"]
        assert drained and drained[0]["forced"] is True
        evs = [(e["event"], e["child"]) for e in fl.events]
        assert ("relaunch", h.name) not in evs
    finally:
        fl.close()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_corrupt_canary_checkpoint_rolls_back_e2e(tmp_path):
    model = Transformer(TransformerConfig(
        vocab_size=V, max_seq_len=64, n_layers=2, d_model=32, n_heads=4,
        d_ff=64), device="cpu")
    snap = save_weight_snapshot(tmp_path / "push",
                                model.init(prng.init_generator(0)), step=1)
    p = pathlib.Path(snap) / "weights.npz"
    raw = bytearray(p.read_bytes())
    raw[0:4] = b"XXXX"
    p.write_bytes(bytes(raw))
    ckpt_manifest.commit(pathlib.Path(snap), {"step": 1, "kind": "weights"})
    assert ckpt_manifest.verify(snap) == []
    fl = launch_fleet(1, model=MODEL_FLAGS, serve=SERVE_FLAGS,
                      telemetry_root=str(tmp_path), log=lambda m: None)
    try:
        fl.wait_ready(300)
        ap = Autopilot(fl, AutopilotConfig(min_replicas=1, max_replicas=2,
                                           interval_s=0.1))
        fl.autopilot = ap

        def mid():
            assert ap.start_rollout(snap) is True

        plan = make_requests(4, 4, vocab_size=V, prompt_lens=(3, 10),
                             max_new=(4, 8), seed=23)
        assert len(_drive(fl, plan, mid=mid)) == 16
        t0 = time.time()
        while time.time() - t0 < 60 and ap._rollout is not None:
            fl.pump()
            time.sleep(0.01)
        roll = [d for d in ap.decisions if d["action"] == "canary_rollback"]
        assert roll and "rc 44" in roll[0]["reason"]
        assert fl.router._primary_gen == 0
        assert fl.router.per_generation_completed() == {0: 16}
        assert [h.name for h in fl.router.replicas] == ["replica-0"]
    finally:
        fl.close()
