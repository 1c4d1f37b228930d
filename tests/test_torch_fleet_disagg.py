"""The port's disaggregated fleet and durable ledger against the JAX
package's, on the CPU.

Holds the port to ``tests/test_disagg.py``'s six cases (a request killed
in each handoff state recovers exactly once, tokens byte-identical to the
unified reference) and ``tests/test_ctrlplane.py``'s: the write-ahead
ledger's round trip and rotation, torn tail, mid-file corruption and
corrupt-segment salvage, with ``replay()`` equal to JAX's over the same
bytes; replay exactly once across a restart; idempotent dedupe.  Each case
runs the JAX router and the port's side by side (equal replicas, a
virtual clock each, advanced once per pump) and holds tokens and every
ledger counter equal.  Two cross-package checks: a ledger the JAX router
wrote recovers in the port's router, and the reverse, each completing
every request exactly once with equal tokens.
"""

import os
import shutil

import pytest

from neural_networks_parallel_training_with_mpi_tpu import serve as jserve
from neural_networks_parallel_training_with_mpi_tpu.serve import wal as jwal
from neural_networks_parallel_training_with_mpi_tpu_torch import serve
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import wal
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    ckpt_manifest,
)
from test_torch_fleet import Clock, jax_sched, port_sched

pytestmark = pytest.mark.torch_port

V = 64
SIDES = {"jax": (jserve, jax_sched), "port": (serve, port_sched)}
COUNTERS = ("handoffs", "handoff_retries", "handoff_reprefills", "redecodes",
            "requeued", "degraded_dispatches", "completed",
            "replica_deaths", "duplicates_suppressed")


def fleet(roles, cls=None, **router_kw):
    """``roles``: [(name, role)].  One router a side over equal replicas:
    {side: (router, {name: handle}, clock)}."""
    out = {}
    for side, (mod, make) in SIDES.items():
        clock = Clock()
        hs = {}
        for i, (name, role) in enumerate(roles):
            kind = (cls or {}).get(side, {}).get(name, mod.InprocReplica)
            hs[name] = kind(make(clock, role=role, replica=i), name=name)
        out[side] = (mod.FleetRouter(list(hs.values()), now_fn=clock,
                                     **router_kw), hs, clock)
    return out


def close(fl):
    for rt, hs, _ in fl.values():
        rt.close()
        for h in hs.values():
            h.sched.close()


def pump_until(fl, cond, max_iter=5000):
    """Pump both routers in lockstep until ``cond(side)`` holds for both;
    they must get there at the same pump."""
    reached = {}
    done = {s: set() for s in fl}
    for i in range(max_iter):
        for side, (rt, _, clock) in fl.items():
            if side in reached:
                continue
            done[side].update(rt.pump())
            clock.tick()
            if cond(side, done[side]):
                reached[side] = i
        if len(reached) == len(fl):
            assert reached["port"] == reached["jax"], reached
            return done
    raise AssertionError(f"condition never met: {reached}")


def submit(fl, jobs, idem=False):
    rids = {}
    for side, (rt, _, _) in fl.items():
        rids[side] = [rt.submit(p, m, idem=f"k{i}" if idem else None)
                      for i, (p, m) in enumerate(jobs)]
        assert all(r is not None for r in rids[side])
    assert rids["port"] == rids["jax"]
    return rids["port"]


def drive(fl, rids):
    pump_until(fl, lambda side, done: set(rids) <= done)


def counters(rt):
    return {k: getattr(rt, k) for k in COUNTERS}


def reference(jobs):
    sched = port_sched(Clock(), queue_depth=64, num_blocks=64)
    try:
        rids = [sched.submit(p, m) for p, m in jobs]
        sched.run_until_drained()
        return [sched.result(r) for r in rids]
    finally:
        sched.close()


def check(fl, rids, jobs):
    """Tokens equal to the unified reference and to JAX's; every counter
    equal to JAX's.  Returns the port router's counters."""
    want = reference(jobs)
    for side, (rt, _, _) in fl.items():
        assert [rt.result(r) for r in rids] == want, side
    got = counters(fl["port"][0])
    assert got == counters(fl["jax"][0])
    return got


def drained(fl, *names):
    for n in names:
        fl["port"][1][n].sched.server.allocator.assert_drained()


def fail(fl, name):
    for rt, hs, _ in fl.values():
        hs[name].fail()
        rt.on_replica_down(name)


# ---------------------------------------------------------------------------
# the handoff ledger (tests/test_disagg.py)
# ---------------------------------------------------------------------------

def test_disagg_tokens_byte_identical_to_unified():
    plan = serve.make_requests(4, 2, vocab_size=V, prompt_lens=(4, 20),
                               max_new=(4, 12), seed=5)
    jobs = [(r["prompt"], r["max_new"]) for reqs in plan for r in reqs]
    fl = fleet([("pre-0", "prefill"), ("dec-0", "decode"),
                ("dec-1", "decode")], queue_depth=64)
    try:
        rids = submit(fl, jobs)
        drive(fl, rids)
        c = check(fl, rids, jobs)
        assert c["handoffs"] == len(jobs)
        assert c["handoff_retries"] == c["handoff_reprefills"] == 0
        assert c["redecodes"] == c["requeued"] == 0
        assert c["degraded_dispatches"] == 0
        assert [fl["port"][0].reqs[r].replica for r in rids] == \
            [fl["jax"][0].reqs[r].replica for r in rids]
        drained(fl, "pre-0", "dec-0", "dec-1")
    finally:
        close(fl)


def _phase(fl, rid, phase):
    return lambda side, done: fl[side][0].reqs[rid].phase == phase


def test_prefill_death_before_commit_requeues_to_sibling_prefill():
    jobs = [(list(range(1, 25)), 8)]     # two prefill chunks
    fl = fleet([("pre-0", "prefill"), ("pre-1", "prefill"),
                ("dec-0", "decode")], queue_depth=16)
    try:
        [rid] = submit(fl, jobs)
        pump_until(fl, _phase(fl, rid, "prefilling"))
        victim = fl["port"][0].reqs[rid].replica
        assert victim == fl["jax"][0].reqs[rid].replica
        fail(fl, victim)
        drive(fl, [rid])
        c = check(fl, [rid], jobs)
        assert (c["requeued"], c["handoffs"], c["redecodes"],
                c["handoff_reprefills"]) == (1, 1, 0, 0)
        survivor = "pre-1" if victim == "pre-0" else "pre-0"
        assert fl["port"][0].reqs[rid].prefill_replica == survivor
        drained(fl, survivor, "dec-0")
    finally:
        close(fl)


def test_prefill_pool_death_degrades_to_unified_on_decode():
    jobs = [(list(range(1, 25)), 8)]
    fl = fleet([("pre-0", "prefill"), ("dec-0", "decode")], queue_depth=16)
    try:
        [rid] = submit(fl, jobs)
        pump_until(fl, _phase(fl, rid, "prefilling"))
        fail(fl, "pre-0")
        drive(fl, [rid])
        c = check(fl, [rid], jobs)
        assert (c["requeued"], c["handoffs"]) == (1, 0)
        assert c["degraded_dispatches"] >= 1
        assert fl["port"][0].load_report()["now"]["degraded"] is True
        drained(fl, "dec-0")
    finally:
        close(fl)


class _StallOnce:
    """Accepts the first inject at the wire and swallows it: no ack, no
    stream (the wedge the ledger's timeout is for)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.swallowed = 0

    def inject(self, req, payload):
        if not self.swallowed:
            self.swallowed = 1
            return True
        return super().inject(req, payload)


def test_handoff_timeout_aborts_and_retries_exactly_once():
    jobs = [(list(range(1, 13)), 8)]
    stall = {side: {"dec-0": type("Stall", (_StallOnce, mod.InprocReplica),
                                  {})}
             for side, (mod, _) in SIDES.items()}
    fl = fleet([("pre-0", "prefill"), ("dec-0", "decode")], cls=stall,
               queue_depth=16, handoff_timeout_s=0.05)
    try:
        [rid] = submit(fl, jobs)
        drive(fl, [rid])
        c = check(fl, [rid], jobs)
        assert fl["port"][1]["dec-0"].swallowed == 1
        assert c["handoffs"] == 1 and c["handoff_retries"] >= 1
        assert c["handoff_reprefills"] == c["redecodes"] == 0
        drained(fl, "pre-0", "dec-0")
    finally:
        close(fl)


def test_decode_death_after_commit_redecodes_from_ledger():
    jobs = [(list(range(1, 13)), 10)]
    fl = fleet([("pre-0", "prefill"), ("dec-0", "decode"),
                ("dec-1", "decode")], queue_depth=16)
    try:
        [rid] = submit(fl, jobs)
        pump_until(fl, _phase(fl, rid, "decoding"))
        victim = fl["port"][0].reqs[rid].replica
        assert victim == fl["jax"][0].reqs[rid].replica
        fail(fl, victim)
        drive(fl, [rid])
        c = check(fl, [rid], jobs)
        assert (c["redecodes"], c["handoffs"], c["handoff_reprefills"],
                c["requeued"]) == (1, 1, 0, 0)
        sibling = "dec-1" if victim == "dec-0" else "dec-0"
        assert fl["port"][0].reqs[rid].replica == sibling
        drained(fl, "pre-0", sibling)
    finally:
        close(fl)


def test_decode_pool_death_reprefills_unified_on_prefill_pool():
    jobs = [(list(range(1, 13)), 10)]
    fl = fleet([("pre-0", "prefill"), ("dec-0", "decode")], queue_depth=16)
    try:
        [rid] = submit(fl, jobs)
        pump_until(fl, _phase(fl, rid, "decoding"))
        fail(fl, "dec-0")
        drive(fl, [rid])
        c = check(fl, [rid], jobs)
        assert (c["redecodes"], c["handoff_reprefills"], c["requeued"],
                c["handoffs"]) == (1, 1, 1, 1)
        assert c["degraded_dispatches"] >= 1
        drained(fl, "pre-0")
    finally:
        close(fl)


# ---------------------------------------------------------------------------
# the write-ahead ledger (tests/test_ctrlplane.py)
# ---------------------------------------------------------------------------

def replays_equal(root, tmp_path, repair=True):
    """``replay`` of both packages over copies of the same bytes: equal
    records and reports, and equal bytes left behind.  Returns the port's
    (records, report)."""
    got = {}
    for side, mod in (("jax", jwal), ("port", wal)):
        copy = tmp_path / f"replay-{side}"
        shutil.copytree(root, copy)
        got[side] = mod.replay(str(copy), repair=repair)
    assert got["port"] == got["jax"]
    for dirpath, _, files in os.walk(tmp_path / "replay-port"):
        rel = os.path.relpath(dirpath, tmp_path / "replay-port")
        for f in files:
            other = tmp_path / "replay-jax" / rel / f
            with open(os.path.join(dirpath, f), "rb") as a, \
                    open(other, "rb") as b:
                assert a.read() == b.read(), (rel, f)
    shutil.rmtree(tmp_path / "replay-port")
    shutil.rmtree(tmp_path / "replay-jax")
    return got["port"]


def test_wal_roundtrip_rotation_and_the_format_cross(tmp_path):
    root = str(tmp_path / "wal")
    w = wal.WriteAheadLog(root, segment_records=4)
    assert w.open() == []
    for i in range(10):
        w.append("accept", rid=i, idem=f"k{i}", prompt=[1, 2], slo_ms=None)
    w.close()
    segs = [p for _, p in wal._segments(root)]
    assert len(segs) == 2
    for seg in segs:
        assert ckpt_manifest.verify(seg) == []
    recs, report = replays_equal(root, tmp_path)
    assert [r["rid"] for r in recs] == list(range(10))
    assert [r["seq"] for r in recs] == list(range(10))
    assert report["records"] == 10 and report["quarantined_records"] == 0
    # the JAX package's writer appends on after the port's, and back
    jw = jwal.WriteAheadLog(root, segment_records=4)
    jw.open()
    assert jw.append("complete", rid=0, tokens=[1, 2, 3])["seq"] == 10
    jw.close()
    w2 = wal.WriteAheadLog(root, segment_records=4)
    assert len(w2.open()) == 11
    assert w2.append("complete", rid=1)["seq"] == 11
    w2.close()
    assert wal.encode_record({"seq": 1, "kind": "x"}) == \
        jwal.encode_record({"seq": 1, "kind": "x"})


def test_wal_torn_tail_truncated_not_fatal(tmp_path):
    root = str(tmp_path / "wal")
    w = wal.WriteAheadLog(root)
    w.open()
    for i in range(3):
        w.append("accept", rid=i)
    w.close()
    active = os.path.join(root, wal.ACTIVE)
    good = os.path.getsize(active)
    with open(active, "a") as f:
        f.write(wal.encode_record({"seq": 3, "kind": "accept",
                                   "rid": 3})[:11])
    recs, report = replays_equal(root, tmp_path, repair=False)
    assert len(recs) == 3 and report["torn_tail_bytes"] > 0
    replays_equal(root, tmp_path, repair=True)
    w2 = wal.WriteAheadLog(root)
    assert [r["rid"] for r in w2.open()] == [0, 1, 2]
    assert w2.report["torn_tail_truncated"]
    assert os.path.getsize(active) == good
    w2.append("accept", rid=3)
    w2.close()
    assert [r["rid"] for r in wal.replay(root)[0]] == [0, 1, 2, 3]


def test_wal_midfile_corruption_quarantined(tmp_path):
    root = str(tmp_path / "wal")
    w = wal.WriteAheadLog(root)
    w.open()
    for i in range(4):
        w.append("accept", rid=i)
    w.close()
    active = os.path.join(root, wal.ACTIVE)
    with open(active) as f:
        lines = f.readlines()
    lines[1] = "0" * 16 + lines[1][16:]
    with open(active, "w") as f:
        f.writelines(lines)
    recs, report = replays_equal(root, tmp_path)
    assert [r["rid"] for r in recs] == [0, 2, 3]
    assert report["quarantined_records"] == 1
    assert not report["torn_tail_truncated"]


def test_wal_corrupt_segment_quarantined_and_salvaged(tmp_path):
    root = str(tmp_path / "wal")
    w = wal.WriteAheadLog(root, segment_records=4)
    w.open()
    for i in range(8):
        w.append("accept", rid=i)
    w.close()
    rec_path = os.path.join(root, f"{wal.SEG_PREFIX}0", "records.jsonl")
    with open(rec_path) as f:
        lines = f.readlines()
    lines[2] = "f" * 16 + lines[2][16:]
    with open(rec_path, "w") as f:
        f.writelines(lines)
    recs, report = replays_equal(root, tmp_path)
    assert report["quarantined_segments"] == 1
    assert report["quarantined_records"] == 1
    assert [r["rid"] for r in recs] == [0, 1, 3, 4, 5, 6, 7]
    w2 = wal.WriteAheadLog(root, segment_records=4)
    w2.open()
    w2.close()
    assert os.path.isdir(os.path.join(root, f"corrupt-{wal.SEG_PREFIX}0"))


# ---------------------------------------------------------------------------
# router replay (tests/test_ctrlplane.py) and the ledgers across packages
# ---------------------------------------------------------------------------

def _jobs(n):
    plan = serve.make_requests(n, 1, vocab_size=V, prompt_lens=(4, 20),
                               max_new=(4, 10), seed=7)
    return [(r["prompt"], r["max_new"]) for reqs in plan for r in reqs]


def _life(side, walroot, tag, roles=(("pre", "prefill"), ("dec", "decode"))):
    mod, make = SIDES[side]
    clock = Clock()
    hs = [mod.InprocReplica(make(clock, role=role, replica=i),
                            name=f"{n}{tag}")
          for i, (n, role) in enumerate(roles)]
    return mod.FleetRouter(hs, queue_depth=64, wal_dir=walroot,
                           now_fn=clock), hs, clock


def _crash(rt, hs):
    """The crash: no graceful close (the records are fsynced)."""
    rt._wal.close()
    for h in hs:
        h.sched.close()


def _first_life(side, walroot, jobs, until):
    rt, hs, clock = _life(side, walroot, "-1")
    rids = [rt.submit(p, m, idem=f"k{i}") for i, (p, m) in enumerate(jobs)]
    for _ in range(5000):
        rt.pump()
        clock.tick()
        if until(rt):
            break
    state = (rt.completed, rt.handoffs)
    _crash(rt, hs)
    return rids, state


def _second_life(side, walroot, jobs, rids, roles=None):
    rt, hs, clock = _life(side, walroot, "-2",
                          **({"roles": roles} if roles else {}))
    try:
        restored = rt.completed
        again = [rt.submit(p, m, idem=f"k{i}")
                 for i, (p, m) in enumerate(jobs)]
        assert again == rids
        done = set()
        for _ in range(5000):
            done.update(rt.pump())
            clock.tick()
            if set(rids) <= done:
                break
        toks = [rt.result(r) for r in rids]
        recovery = dict(rt.recovery)
        recovery.pop("wall_s")          # host seconds, not the ledger
        out = dict(restored=restored, completed=rt.completed,
                   recovery=recovery, tokens=toks,
                   post_recovery=rt.load_report()["now"]["post_recovery"])
        for h in hs:
            h.sched.server.allocator.assert_drained()
        return out
    finally:
        rt.close()
        for h in hs:
            h.sched.close()


def _replay_case(tmp_path, first, second, jobs):
    walroot = str(tmp_path / f"wal-{first}-{second}")
    rids, (done1, _) = _first_life(first, walroot, jobs,
                                   lambda rt: rt.completed >= 1)
    assert 1 <= done1 < len(jobs)
    out = _second_life(second, walroot, jobs, rids)
    assert out["restored"] == done1                   # restored, not re-run
    assert out["recovery"]["replayed"] == len(jobs) - done1
    assert out["recovery"]["deduped"] == len(jobs)
    assert out["recovery"]["lost"] == 0
    assert out["completed"] == len(jobs)              # exactly once
    assert out["tokens"] == reference(jobs)
    assert out["post_recovery"] is True
    return out


def test_replay_exactly_once_across_restart(tmp_path):
    jobs = _jobs(4)
    assert _replay_case(tmp_path, "port", "port", jobs) == \
        _replay_case(tmp_path, "jax", "jax", jobs)


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_ledger_recovers_across_packages(tmp_path, first, second):
    """A ledger one package's router wrote (handoff payloads included)
    recovers in the other's: every request once, tokens equal."""
    jobs = _jobs(4)
    _replay_case(tmp_path, first, second, jobs)


def test_replay_committed_handoff_converts_without_decode_pool(tmp_path):
    jobs = _jobs(3)
    got = {}
    for side in ("jax", "port"):
        walroot = str(tmp_path / f"wal-{side}")
        rids, _ = _first_life(side, walroot, jobs,
                              lambda rt: rt.handoffs >= 1)
        got[side] = _second_life(side, walroot, jobs, rids,
                                 roles=(("pre", "prefill"),))
    assert got["port"] == got["jax"]
    assert got["port"]["recovery"]["converted"] >= 1
    assert got["port"]["tokens"] == reference(jobs)


def test_idempotency_dedupe_same_life(tmp_path):
    (prompt, max_new), = _jobs(1)
    got = {}
    for side, (mod, make) in SIDES.items():
        clock = Clock()
        rep = mod.InprocReplica(make(clock), name="u0")
        rt = mod.FleetRouter([rep], queue_depth=8, now_fn=clock,
                             wal_dir=str(tmp_path / f"wal-{side}"))
        try:
            rid = rt.submit(prompt, max_new, idem="dup-key")
            while rid not in rt.pump():
                clock.tick()
            again = rt.submit(prompt, max_new, idem="dup-key")
            got[side] = (again == rid, rt.recovery["deduped"], rt.completed,
                         rid in rt.pump(), rt.result(rid))
        finally:
            rt.close()
            rep.sched.close()
    assert got["port"] == got["jax"]
    assert got["port"][:4] == (True, 1, 1, True)
