"""The port's serving fleet (``serve/fleet.py``, ``GroupSupervisor``, the
worker's fault grammar) against the JAX package's, on the CPU.

Holds the port to ``tests/test_fleet.py``'s in-process pins: the JAX
router and the port's run over equal replicas (the JAX init carried
across by ``interop``) and one virtual clock each, advanced once per
pump, and must place every request on the same replica, reject the same
submits, requeue the same requests after a death and return the same
tokens, which also equal one port scheduler's.  Every JAX scheduler runs
through ``test_torch_serve._blocking`` (the JAX package's CPU serving
race).  The tensor-parallel replica runs over ``LocalTensorGroup(2)``
against JAX's over its 2-device CPU mesh.  ``GroupSupervisor``'s
contracts run on stdlib children, as JAX's tests run them; the fault
methods a worker polls are held to JAX's over a table of specs.
"""

import functools
import json
import math
import sys
import time

import jax
import numpy as np
import pytest

from neural_networks_parallel_training_with_mpi_tpu import serve as jserve
from neural_networks_parallel_training_with_mpi_tpu.serve import (
    fleet as jfleet,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    faults as jfaults,
)
from neural_networks_parallel_training_with_mpi_tpu.utils.sketches import (
    QuantileSketch as JaxQuantileSketch,
)
from neural_networks_parallel_training_with_mpi_tpu_torch import serve
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    megatron,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import fleet
from neural_networks_parallel_training_with_mpi_tpu_torch.train.resilience import (
    EXIT_HANG, ChildSpec, GroupSupervisor,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import faults
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.sketches import (
    QuantileSketch,
)
from test_torch_serve import _blocking, _models

pytestmark = pytest.mark.torch_port

V = 64
GEOMETRY = dict(slots=4, num_blocks=17, block_size=16, prefill_chunk=16)


class Clock:
    """A virtual clock: the routers and schedulers of one side read it,
    the driver advances it once per pump."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, dt=0.01):
        self.t += dt


def port_sched(clock, *, queue_depth=16, replica=None, role="unified",
               **kw):
    _, _, model, params = _models()
    cfg = dict(GEOMETRY, queue_depth=queue_depth, replica=replica,
               role=role, **kw)
    return serve.Scheduler(model, params, serve.ServeConfig(**cfg),
                           now_fn=clock, device="cpu")


def jax_sched(clock, *, queue_depth=16, replica=None, role="unified", **kw):
    jm, jp, _, _ = _models()
    cfg = dict(GEOMETRY, queue_depth=queue_depth, replica=replica,
               role=role, **kw)
    return _blocking(jserve.Scheduler(jm, jp, jserve.ServeConfig(**cfg),
                                      now_fn=clock))


def pair(names, **kw):
    """Equal replicas on both sides: ({side: [handles]}, {side: clock})."""
    clocks = {"jax": Clock(), "port": Clock()}
    hs = {"jax": [jserve.InprocReplica(jax_sched(clocks["jax"], replica=i,
                                                 **kw), name=n)
                  for i, n in enumerate(names)],
          "port": [serve.InprocReplica(port_sched(clocks["port"], replica=i,
                                                  **kw), name=n)
                   for i, n in enumerate(names)]}
    return hs, clocks


def routers(hs, clocks, **kw):
    return {"jax": jserve.FleetRouter(hs["jax"], now_fn=clocks["jax"], **kw),
            "port": serve.FleetRouter(hs["port"], now_fn=clocks["port"],
                                      **kw)}


def pump_both(rt, clocks, done):
    for side in ("jax", "port"):
        done[side].update(rt[side].pump())
        clocks[side].tick()


def drive_both(rt, clocks, rids, max_iter=2000):
    done = {"jax": set(), "port": set()}
    for _ in range(max_iter):
        pump_both(rt, clocks, done)
        if all(set(rids[s]) <= done[s] for s in done):
            return
    raise AssertionError(f"never drained: {rids} {done}")


def close(hs):
    for h in hs["jax"] + hs["port"]:
        h.close()


def placements(router, rids):
    return [router.reqs[r].replica for r in rids]


@functools.lru_cache(maxsize=None)
def port_reference(plan_key):
    """Every request of a plan through ONE port scheduler (the undisturbed
    greedy reference)."""
    plan = PLANS[plan_key]()
    sched = port_sched(Clock(), queue_depth=256, num_blocks=64)
    rids = [sched.submit(r["prompt"], r["max_new"])
            for reqs in plan for r in reqs]
    sched.run_until_drained()
    return [sched.result(r) for r in rids]


PLANS = {
    "requeue": lambda: serve.make_requests(4, 2, vocab_size=V,
                                           prompt_lens=(3, 10),
                                           max_new=(4, 8), seed=11),
    "tp": lambda: serve.make_requests(4, 2, vocab_size=V,
                                      prompt_lens=(3, 10), max_new=(4, 8),
                                      seed=7),
}


# ---------------------------------------------------------------------------
# placement, admission, rejection
# ---------------------------------------------------------------------------

def test_load_signal_and_router_placement_match_jax():
    """One replica saturated behind the routers' backs: both routers read
    it off the live rollup and place the same rids on the same replicas
    (all on the idle one); the parsed load signals agree field for
    field."""
    hs, clocks = pair(["hot", "idle"])
    try:
        for side in ("jax", "port"):
            for _ in range(6):
                assert hs[side][0].sched.submit([1, 2, 3, 4], 8) is not None
            hs[side][0].sched.tick()
        sigs = {s: vars(hs[s][0].load()) for s in hs}
        sigs["jax"].pop("t_unix"), sigs["port"].pop("t_unix")
        assert sigs["jax"] == sigs["port"]
        assert sigs["port"]["in_flight"] == 4
        rt = routers(hs, clocks, queue_depth=32)
        rids = {s: [rt[s].submit([5, 6, 7], 4) for _ in range(4)]
                for s in rt}
        assert rids["jax"] == rids["port"]
        drive_both(rt, clocks, rids)
        assert placements(rt["port"], rids["port"]) == \
            placements(rt["jax"], rids["jax"]) == ["idle"] * 4
        assert rt["port"].per_replica_completed() == \
            rt["jax"].per_replica_completed()
        for r in rids["port"]:
            assert rt["port"].result(r) == rt["jax"].result(r)
    finally:
        close(hs)


def test_overload_rejected_at_the_router_as_jax():
    """One bounded fleet queue: the same submits rejected, the same
    shallow replica backlogs after one pass, every accepted request
    finished with the same tokens on the same replica."""
    hs, clocks = pair(["a", "b"])
    try:
        rt = routers(hs, clocks, queue_depth=4, replica_queue_cap=1)
        rids = {s: [rt[s].submit([1, 2], 4) for _ in range(40)] for s in rt}
        assert rids["jax"] == rids["port"]
        assert rt["port"].rejected == rt["jax"].rejected > 0
        pump_both(rt, clocks, {"jax": set(), "port": set()})
        for hj, hp in zip(hs["jax"], hs["port"]):
            assert hp.assigned() == hj.assigned()
            assert len(hp.assigned()) <= 4 + 1
        acc = {s: [r for r in rids[s] if r is not None] for s in rids}
        drive_both(rt, clocks, acc)
        assert placements(rt["port"], acc["port"]) == \
            placements(rt["jax"], acc["jax"])
        for r in acc["port"]:
            assert rt["port"].result(r) == rt["jax"].result(r)
    finally:
        close(hs)


def _stub(module, sketch_cls, name, ttft_p50_ms, slots=4):
    """A load-signal stub of ``module``'s ReplicaHandle (never serves)."""
    sk = sketch_cls()
    sk.add(ttft_p50_ms)
    rec = {"kind": "rollup", "role": "serve",
           "sketches": {"ttft_ms": sk.to_dict()},
           "now": {"queue_depth": 0, "in_flight": 0, "free_slots": slots,
                   "slots": slots, "queue_cap": 16, "free_blocks": 100,
                   "block_utilization": 0.0}}

    class Stub(module.ReplicaHandle):
        def alive(self):
            return True

        def accepting(self):
            return True

        def load(self):
            return module.LoadSignal.from_report(rec)

        def submit(self, req):
            return False

        def pump(self):
            return []

        def assigned(self):
            return []

        def take_assigned(self):
            return []

    h = Stub()
    h.name = name
    return h


@pytest.mark.parametrize("margin", [1.0, 1.5])
def test_slo_infeasible_rejection_matches_jax(margin):
    got = {}
    for side, mod, sk in (("jax", jfleet, JaxQuantileSketch),
                          ("port", fleet, QuantileSketch)):
        rt = mod.FleetRouter([_stub(mod, sk, "slow", 500.0)],
                             queue_depth=8, reject_infeasible=True,
                             feasibility_margin=margin,
                             now_fn=lambda: 0.0)
        got[side] = ([rt.submit([1, 2], 4, slo_ms=slo)
                      for slo in (10.0, 600.0, 800.0, 10_000.0, None)],
                     rt.rejected, rt.rejected_infeasible)
    assert got["port"] == got["jax"]
    assert got["port"][2] >= 1


# ---------------------------------------------------------------------------
# death, requeue, drain, a raced completion
# ---------------------------------------------------------------------------

def test_requeue_on_death_tokens_match_jax():
    """A replica fails part-way: its in-flight requests requeue at the
    front and finish on the sibling; the same victim, requeues, deaths and
    placements as the JAX router, and tokens equal to JAX's and to one
    scheduler's."""
    plan = PLANS["requeue"]()
    hs, clocks = pair(["a", "b"])
    try:
        rt = routers(hs, clocks, queue_depth=32)
        rids = {s: [rt[s].submit(r["prompt"], r["max_new"])
                    for reqs in plan for r in reqs] for s in rt}
        assert rids["jax"] == rids["port"]
        done = {"jax": set(), "port": set()}
        for _ in range(3):
            pump_both(rt, clocks, done)
        victims = {}
        for s in hs:
            a, b = hs[s]
            victims[s] = a if a.assigned() else b
        assert victims["port"].name == victims["jax"].name
        n_inflight = len(victims["port"].assigned())
        assert n_inflight == len(victims["jax"].assigned()) > 0
        for s in hs:
            victims[s].fail()
        drive_both(rt, clocks, rids)
        for s in rt:
            assert rt[s].requeued >= n_inflight
            assert rt[s].replica_deaths == 1
        assert rt["port"].requeued == rt["jax"].requeued
        assert placements(rt["port"], rids["port"]) == \
            placements(rt["jax"], rids["jax"])
        got = [rt["port"].result(r) for r in rids["port"]]
        assert got == [rt["jax"].result(r) for r in rids["jax"]]
        assert got == port_reference("requeue")
    finally:
        close(hs)


def test_drain_feeds_the_router_requeue_as_jax():
    """``drain()`` hands the in-flight set back in submission order;
    resubmitted through the router, the same tokens as JAX's."""
    clocks = {"jax": Clock(), "port": Clock()}
    donors = {"jax": jax_sched(clocks["jax"], replica=0),
              "port": port_sched(clocks["port"], replica=0)}
    hs = {"jax": [jserve.InprocReplica(jax_sched(clocks["jax"], replica=1),
                                       name="sink")],
          "port": [serve.InprocReplica(port_sched(clocks["port"],
                                                  replica=1), name="sink")]}
    try:
        subs = [([1 + i, 2 + i, 3 + i], 5) for i in range(4)]
        drained = {}
        for s, d in donors.items():
            for p, n in subs:
                assert d.submit(p, n) is not None
            for _ in range(3):
                d.tick()
            drained[s] = d.drain()
        donors["port"].server.allocator.assert_drained()
        strip = [{k: v for k, v in x.items() if k != "t_submit"}
                 for x in drained["port"]]
        assert strip == [{k: v for k, v in x.items() if k != "t_submit"}
                         for x in drained["jax"]]
        assert [x["prompt"] for x in drained["port"]] == [p for p, _ in subs]
        rt = routers(hs, clocks, queue_depth=32)
        rids = {s: [rt[s].submit(x["prompt"], x["max_new"],
                                 slo_ms=x["slo_ms"]) for x in drained[s]]
                for s in rt}
        drive_both(rt, clocks, rids)
        assert [rt["port"].result(r) for r in rids["port"]] == \
            [rt["jax"].result(r) for r in rids["jax"]]
    finally:
        close(hs)
        for d in donors.values():
            d.close()


def _racy(module):
    class Racy(module.ReplicaHandle):
        """Completion events buffered like a subprocess pipe: stages
        'completed, then died, events still queued'."""

        def __init__(self):
            self.name = "racy"
            self._assigned = {}
            self.events = []
            self._alive = True

        def alive(self):
            return self._alive

        def accepting(self):
            return self._alive

        def load(self):
            return None

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

    return Racy()


def test_raced_completion_honored_as_jax():
    """A completion buffered when the death notice arrives is honored
    (surfaces from the next pump), never requeued into a second run."""
    got = {}
    for side, mod in (("jax", jfleet), ("port", fleet)):
        racy = _racy(mod)
        rt = mod.FleetRouter([racy], queue_depth=8, now_fn=lambda: 0.0)
        rid = rt.submit([1, 2], 2)
        rt.pump()
        assert racy.assigned() == [rid]
        racy.events.append({"ev": "done", "rid": rid, "tokens": [1, 2, 9, 9],
                            "ttft_ms": 1.0, "itl_ms": 1.0})
        racy._alive = False
        rt.on_replica_down(racy.name)
        requeued = rt.requeued
        done = rt.pump()
        got[side] = (requeued, done, rt.result(rid), len(rt.queue),
                     rt.replica_deaths, rt.completed)
    assert got["port"] == got["jax"]
    assert got["port"][:4] == (0, [0], [1, 2, 9, 9], 0)


# ---------------------------------------------------------------------------
# the tensor-parallel replica
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tp_params():
    jm, jp, model, params = _models()
    ptp = dict(params)
    ptp["blocks"] = megatron.permute_qkv(
        params["blocks"], model.cfg.d_model, model.cfg.n_heads, 2,
        kv_heads=model.cfg.kv_heads)
    return ptp


@functools.lru_cache(maxsize=None)
def _jax_tp_tokens():
    """JAX's TPGenerateReplica over its 2-device CPU mesh, on the tp
    plan."""
    from neural_networks_parallel_training_with_mpi_tpu.config import (
        MeshConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu.parallel import (
        megatron as jmegatron,
        mesh as mesh_lib,
    )

    jm, jp, _, _ = _models()
    mesh = mesh_lib.make_mesh(MeshConfig(data=1, tensor=2),
                              devices=np.asarray(jax.devices()[:2]))
    ptp = dict(jp)
    ptp["blocks"] = jmegatron.permute_qkv(
        jp["blocks"], jm.cfg.d_model, jm.cfg.n_heads, 2,
        kv_heads=jm.cfg.kv_heads)
    tp = jfleet.TPGenerateReplica(jm, ptp, mesh, batch=4, name="tp")
    reqs = [r for client in PLANS["tp"]() for r in client]
    for i, r in enumerate(reqs):
        assert tp.submit(jfleet.FleetRequest(i, list(r["prompt"]),
                                             r["max_new"], None, 0.0,
                                             math.inf))
    got = {}
    while len(got) < len(reqs):
        for rec in tp.pump():
            got[rec["rid"]] = rec["tokens"]
    return [got[i] for i in range(len(reqs))]


def test_tp_replica_tokens_equal_the_paged_replica_and_jax():
    """``TPGenerateReplica`` over ``LocalTensorGroup(2)``: the same greedy
    tokens as the single-device paged replica, and as JAX's TP replica
    over its 2-device mesh."""
    _, _, model, _ = _models()
    tp = serve.TPGenerateReplica(model, _tp_params(),
                                 megatron.LocalTensorGroup(2), batch=4,
                                 name="tp", device="cpu")
    paged = serve.InprocReplica(port_sched(Clock(), queue_depth=32),
                                name="paged")
    reqs = [r for client in PLANS["tp"]() for r in client]
    got = {"tp": {}, "paged": {}}
    try:
        for i, r in enumerate(reqs):
            for h in (tp, paged):
                assert h.submit(fleet.FleetRequest(i, list(r["prompt"]),
                                                   r["max_new"], None, 0.0,
                                                   math.inf))
        for _ in range(500):
            for name, h in (("tp", tp), ("paged", paged)):
                for rec in h.pump():
                    got[name][rec["rid"]] = rec["tokens"]
            if all(len(got[n]) == len(reqs) for n in got):
                break
        tp_tokens = [got["tp"][i] for i in range(len(reqs))]
        assert tp_tokens == [got["paged"][i] for i in range(len(reqs))]
        assert tp_tokens == _jax_tp_tokens()
        assert tp.load().slots == 4 and tp.load_report()["counters"] == {
            "batches": 2}
    finally:
        paged.close()


@pytest.mark.parametrize("prompt_len,max_new", [(40, 8), (33, 31)])
def test_tp_replica_long_prompt_decodes_as_the_paged_replica(prompt_len,
                                                             max_new):
    """A prompt past half of ``max_seq_len`` (64), batched with a short
    one: the power-of-two buckets would pass the model's length, so they
    stop there and the prompt bucket gives way; every row still decodes
    its own ``max_new`` tokens, equal to the paged replica's."""
    _, _, model, _ = _models()
    tp = serve.TPGenerateReplica(model, _tp_params(),
                                 megatron.LocalTensorGroup(2), batch=2,
                                 name="tp", device="cpu")
    paged = serve.InprocReplica(port_sched(Clock(), queue_depth=8),
                                name="paged")
    rng = np.random.default_rng(prompt_len)
    reqs = [(rng.integers(1, V, prompt_len).tolist(), max_new),
            (rng.integers(1, V, 5).tolist(), 8)]
    got = {"tp": {}, "paged": {}}
    try:
        for i, (prompt, n) in enumerate(reqs):
            for h in (tp, paged):
                assert h.submit(fleet.FleetRequest(i, prompt, n, None, 0.0,
                                                   math.inf))
        for _ in range(200):
            for name, h in (("tp", tp), ("paged", paged)):
                for rec in h.pump():
                    got[name][rec["rid"]] = rec["tokens"]
            if all(len(got[n]) == len(reqs) for n in got):
                break
        assert got["tp"] == got["paged"]
        for i, (prompt, n) in enumerate(reqs):
            assert got["tp"][i][:len(prompt)] == prompt
            assert len(got["tp"][i]) == len(prompt) + n
    finally:
        paged.close()


def test_tp_replica_routes_in_a_mixed_fleet():
    """A TP replica is one more handle: a paged + TP fleet drains a closed
    loop, every request once, tokens equal to one scheduler's."""
    _, _, model, _ = _models()
    clock = Clock()
    tp = serve.TPGenerateReplica(model, _tp_params(),
                                 megatron.LocalTensorGroup(2), batch=2,
                                 name="tp", now_fn=clock, device="cpu")
    paged = serve.InprocReplica(port_sched(clock), name="paged")
    router = serve.FleetRouter([paged, tp], queue_depth=32, now_fn=clock)
    try:
        row = serve.run_fleet_closed_loop(router, 4, 2, vocab_size=V,
                                          prompt_lens=(3, 10),
                                          max_new=(4, 8), seed=7)
        assert row["requests"] == 8
        assert sum(row["per_replica_completed"].values()) == 8
        assert row["per_replica_completed"]["tp"] > 0
        sched = port_sched(Clock(), queue_depth=64, num_blocks=64)
        rids = [sched.submit(r["prompt"], r["max_new"])
                for reqs in PLANS["tp"]() for r in reqs]
        sched.run_until_drained()
        import hashlib

        h = hashlib.sha256()
        for k, rid in enumerate(rids):
            h.update(repr((k // 2, k % 2, sched.result(rid))).encode())
        assert row["tokens_sha256"] == h.hexdigest()
    finally:
        paged.close()


# ---------------------------------------------------------------------------
# the router's telemetry, the request plan
# ---------------------------------------------------------------------------

def test_router_load_report_keys_match_jax(tmp_path):
    """The router's own rollup record (role "router") has JAX's keys, and
    with a telemetry dir writes its rollups and heartbeat."""
    hs, clocks = pair(["a"])
    try:
        rt = {"jax": jserve.FleetRouter(hs["jax"], now_fn=clocks["jax"],
                                        telemetry_dir=str(tmp_path / "j"),
                                        rollup_every=2),
              "port": serve.FleetRouter(hs["port"], now_fn=clocks["port"],
                                        telemetry_dir=str(tmp_path / "p"),
                                        rollup_every=2)}
        rids = {s: [rt[s].submit([1, 2, 3], 3)] for s in rt}
        drive_both(rt, clocks, rids)
        reps = {s: rt[s].load_report() for s in rt}
        for key in ("counters", "now"):
            assert sorted(reps["port"][key]) == sorted(reps["jax"][key])
            assert reps["port"][key] == reps["jax"][key] or key == "now"
        assert sorted(reps["port"]) == sorted(reps["jax"])
        assert sorted(reps["port"]["sketches"]) == \
            sorted(reps["jax"]["sketches"])
        assert reps["port"]["role"] == "router"
        assert rt["port"].handoff_stats().keys() == \
            rt["jax"].handoff_stats().keys()
        for s in rt:
            rt[s].close()
        recs = [json.loads(ln) for ln in
                open(tmp_path / "p" / "metrics.jsonl")]
        assert recs and all(r["role"] == "router" for r in recs)
        assert (tmp_path / "p" / "heartbeat-router-p0.json").exists()
    finally:
        close(hs)


def test_make_requests_streams_partitioned_as_jax():
    for stream in (0, 1, 2):
        assert serve.make_requests(2, 3, vocab_size=V, seed=5,
                                   stream=stream) == \
            jserve.make_requests(2, 3, vocab_size=V, seed=5, stream=stream)
    base = serve.make_requests(2, 3, vocab_size=V, seed=5)
    r1 = serve.make_requests(2, 3, vocab_size=V, seed=5, stream=1)
    assert base != r1


# ---------------------------------------------------------------------------
# GroupSupervisor (stdlib children, as tests/test_fleet.py runs them)
# ---------------------------------------------------------------------------

def _pump_group(g, until, timeout_s=15.0):
    evs = []
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        evs += g.poll()
        if until(evs):
            return evs
        time.sleep(0.02)
    raise AssertionError(f"condition never met; events={evs}")


def test_group_supervisor_per_child_exit_contracts():
    crash = ChildSpec(name="crash",
                      cmd=[sys.executable, "-S", "-c", "raise SystemExit(7)"],
                      max_restarts=2, backoff=0.05, backoff_cap=0.1)
    clean = ChildSpec(name="clean",
                      cmd=[sys.executable, "-S", "-c", "raise SystemExit(0)"],
                      max_restarts=2, backoff=0.05)
    noretry = ChildSpec(name="anomaly",
                        cmd=[sys.executable, "-S", "-c",
                             "raise SystemExit(44)"],
                        max_restarts=2, backoff=0.05)
    g = GroupSupervisor([crash, clean, noretry], log=lambda m: None)
    g.start()
    evs = _pump_group(g, lambda evs: not g.running())
    kinds = {(e["child"], e["event"]) for e in evs}
    assert ("clean", "stopped") in kinds
    assert ("anomaly", "stopped") in kinds
    assert ("crash", "gave_up") in kinds
    assert sum(1 for e in evs
               if (e["child"], e["event"]) == ("crash", "relaunch")) == 2
    assert (g.done("crash"), g.done("clean"), g.done("anomaly")) == (7, 0, 44)
    assert g.incarnation("crash") == 2


def test_group_supervisor_relaunch_leaves_siblings_undisturbed():
    crash = ChildSpec(name="crash",
                      cmd=[sys.executable, "-S", "-c", "raise SystemExit(1)"],
                      max_restarts=1, backoff=0.05, backoff_cap=0.1)
    steady = ChildSpec(name="steady",
                       cmd=[sys.executable, "-S", "-c",
                            "import time; time.sleep(60)"],
                       max_restarts=1)
    g = GroupSupervisor([crash, steady], log=lambda m: None)
    g.start()
    steady_pid = g.proc("steady").pid
    try:
        evs = _pump_group(g, lambda evs: any(
            e["child"] == "crash" and e["event"] == "relaunch"
            for e in evs))
        assert g.proc("steady").pid == steady_pid
        assert g.alive("steady")
        assert not any(e["child"] == "steady" for e in evs
                       if e["event"] in ("exit", "relaunch"))
    finally:
        g.terminate_all()
    assert g.proc("steady").poll() is not None


def test_group_supervisor_heartbeat_hang_kill(tmp_path):
    hb = tmp_path / "heartbeat-serve-p0.json"
    # the child beats once, then wedges: the monitor arms on that write
    # and kills at staleness, reporting EXIT_HANG
    src = (f"import pathlib, time; "
           f"pathlib.Path({str(hb)!r}).write_text('{{}}'); "
           "time.sleep(120)")
    spec = ChildSpec(name="wedged",
                     cmd=[sys.executable, "-S", "-c", src],
                     heartbeat_path=str(hb), heartbeat_timeout=0.5,
                     max_restarts=0, backoff=0.05)
    g = GroupSupervisor([spec], log=lambda m: None)
    g.start()
    try:
        evs = _pump_group(g, lambda evs: any(e["event"] == "hang_kill"
                                             for e in evs), timeout_s=30.0)
        assert [e for e in evs if e["event"] == "hang_kill"]
        _pump_group(g, lambda evs: not g.running(), timeout_s=10.0)
        assert g.done("wedged") == EXIT_HANG
    finally:
        g.terminate_all()


# ---------------------------------------------------------------------------
# the worker's side of the fault grammar
# ---------------------------------------------------------------------------

FLEET_SPECS = [
    "replica_kill@3?proc=1", "replica_kill@2-4?max=2", "stall_drain@1-3",
    "handoff_kill@2", "handoff_kill_post@1?proc=0", "decode_kill@1-2",
    "handoff_stall@3", "preempt@2?grace=1.5", "slow@1-3?ms=20&max=2",
    "slow@2?proc=1", "router_kill@5", "fleet_kill@1-2",
]


@pytest.mark.parametrize("spec", FLEET_SPECS)
def test_worker_fault_methods_match_jax(spec):
    """``due_spec`` / ``fire_if_due`` / ``slow_penalty_ms`` fire at the same
    (kind, step, proc) calls as JAX's, with the same knobs."""
    plans = (jfaults.FaultPlan.parse(spec), faults.FaultPlan.parse(spec))
    out = ([], [])
    for step in range(6):
        for proc in (None, 0, 1):
            for i, plan in enumerate(plans):
                row = [plan.slow_penalty_ms(step, proc=proc)]
                for kind in faults.KINDS:
                    d = plan.due_spec(kind, step, proc=proc)
                    row.append(None if d is None else (d.kind, d.grace, d.ms))
                    row.append(plan.fire_if_due(kind, step, proc=proc))
                out[i].append(row)
    assert out[1] == out[0]
    assert faults.FLEET_KINDS == jfaults.FLEET_KINDS
    assert faults.DRIVER_KINDS == jfaults.DRIVER_KINDS
    # the driver kinds are ported (tests/test_torch_ctrlplane.py): no
    # table of refused kinds is left
    assert not hasattr(faults, "UNPORTED_KINDS")
