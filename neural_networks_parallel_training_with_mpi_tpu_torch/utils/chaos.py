"""Deterministic chaos campaigns: planned failures, real processes,
machine-checkable invariants.  The port of the JAX package's
``utils/chaos.py``.

Every resilience mechanism of the port (crash relaunch with the
exit-code contract, ``train/resilience.py``; the router's requeue ledger
and its write-ahead log, ``serve/fleet.py`` and ``serve/wal.py``; goodput
pricing of every fleet second, ``utils/goodput.py``; the autopilot's
drain, evict and backfill decisions, ``serve/autopilot.py``; the
advance-notice preemption drain) claims an invariant.  This module
checks those claims by killing real processes on a plan:

* A **plan** is a JSON document or a builtin name: a seed and a list of
  scenarios.  ``lite`` runs supervised stdlib ``python -S`` children
  (no torch import) that emit real trace spans: one crashed mid-run, one
  preempted with advance notice, a disaggregated handoff killed before
  its commit and a write-ahead log torn and replayed, priced by the
  real offline goodput ledger.  ``full`` adds the subprocess-fleet
  scenarios (each worker its own process and device): a SIGKILLed
  replica against an advance-notice drain, a slow-but-alive replica
  evicted by the autopilot's health scorer, the prefill/decode handoff
  under a crash-looping prefill pool, and control-plane death
  (``router_kill``/``fleet_kill`` of ``serve/ctrlplane_driver.py``).
* Every scenario ends in :func:`check_invariants`: request-ledger
  exactness (submitted == completed, no drops, no duplicate deliveries),
  goodput classifying 100% of wall-clock (``sum_ok``), the notice arm's
  ``rollback``/``relaunch_gap``/requeue at zero, and retired-stays-down
  (a drained child is never relaunched).  A violated invariant is a
  non-empty problem list, which ``tools/chaos_campaign.py`` turns into a
  nonzero exit code.
* **Determinism**: :func:`canonical_digest` covers wall-clock-free facts
  only: per-child supervisor event kinds and rcs, sorted autopilot
  (action, replica) multisets, the fleet's ``tokens_sha256`` and every
  invariant's verdict.  The same plan and seed run twice (``repeat``)
  give the same digest; timing (MTTR, reaction, requeue counts) is
  reported but left out of it.

The module imports the stdlib only at module level: the port's
``tools/chaos_campaign.py`` loads it by file path, so the ``lite`` plan
runs under ``python -S`` with no torch, and its children load the
port's own ``utils/jsonl.py``, ``utils/goodput.py``,
``train/resilience.py``, ``train/trace.py`` and ``serve/wal.py`` by file
path.  The fleet scenarios import the package lazily, and take the
workers' ``platform`` as an argument: ``gpu`` (the default) runs them on
the card or raises the no-CUDA error, ``cpu`` on the plain PyTorch path.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_mod(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # registered BEFORE exec: dataclasses resolves cls.__module__
    # through sys.modules while the class body is being processed
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_cache: Dict[str, Any] = {}


def _mods() -> Dict[str, Any]:
    """File-path-loaded resilience + goodput (+ the tolerant jsonl
    reader goodput needs injected): the stub half of the runner works
    with no package import, so the ``lite`` plan needs no torch."""
    if not _cache:
        jz = _load_mod("_chaos_jsonl",
                       os.path.join(_PKG, "utils", "jsonl.py"))
        gp = _load_mod("_chaos_goodput",
                       os.path.join(_PKG, "utils", "goodput.py"))
        gp._jsonl = jz
        res = _load_mod("_chaos_res",
                        os.path.join(_PKG, "train", "resilience.py"))
        _cache.update(jsonl=jz, goodput=gp, res=res)
    return _cache


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

BUILTIN_PLANS: Dict[str, Dict[str, Any]] = {
    # supervised stdlib children, crash-vs-notice A/B, priced by the
    # real goodput ledger
    "lite": {
        "name": "lite",
        "seed": 0,
        "scenarios": [
            {"name": "stub_crash", "kind": "stub", "fault": "crash",
             "steps": 8, "at_step": 3},
            {"name": "stub_preempt", "kind": "stub", "fault": "preempt",
             "steps": 8, "at_step": 3, "grace_s": 5.0},
            {"name": "stub_handoff_kill", "kind": "stub_handoff",
             "rids": 6, "at": 3},
            {"name": "stub_router_kill", "kind": "stub_wal",
             "rids": 6, "at": 3},
        ],
    },
    # lite plus the subprocess-fleet scenarios: SIGKILL vs advance-
    # notice A/B, health eviction, the disaggregated prefill/decode
    # handoff under a crash-looping prefill pool, and control-plane
    # death
    "full": {
        "name": "full",
        "seed": 0,
        "scenarios": [
            {"name": "stub_crash", "kind": "stub", "fault": "crash",
             "steps": 8, "at_step": 3},
            {"name": "stub_preempt", "kind": "stub", "fault": "preempt",
             "steps": 8, "at_step": 3, "grace_s": 5.0},
            {"name": "stub_handoff_kill", "kind": "stub_handoff",
             "rids": 6, "at": 3},
            {"name": "stub_router_kill", "kind": "stub_wal",
             "rids": 6, "at": 3},
            {"name": "fleet_crash", "kind": "fleet", "mode": "kill",
             "replicas": 2, "clients": 8, "rpc": 5,
             "after_completed": 4},
            {"name": "fleet_preempt_notice", "kind": "fleet",
             "mode": "notice", "replicas": 2, "clients": 8, "rpc": 5,
             "after_completed": 4, "grace_s": 30.0, "backfill": True},
            {"name": "fleet_slow_evict", "kind": "fleet",
             "mode": "slow_evict", "replicas": 2, "clients": 6,
             "rpc": 6, "slow_ms": 120.0},
            {"name": "fleet_disagg_handoff", "kind": "fleet",
             "mode": "disagg_handoff", "clients": 6, "rpc": 4,
             "kill_at_handoff": 2},
            {"name": "fleet_ctrlplane", "kind": "fleet",
             "mode": "ctrlplane", "clients": 4, "rpc": 3,
             "kill_at_completed": 2},
        ],
    },
}


def load_plan(spec: str) -> Dict[str, Any]:
    """A builtin plan name (``lite``/``full``) or a path to a JSON plan
    document ``{"name", "seed", "scenarios": [...]}``."""
    if spec in BUILTIN_PLANS:
        return json.loads(json.dumps(BUILTIN_PLANS[spec]))  # deep copy
    with open(spec) as f:
        plan = json.load(f)
    if not isinstance(plan.get("scenarios"), list):
        raise ValueError(f"plan {spec}: missing 'scenarios' list")
    plan.setdefault("name", os.path.basename(spec))
    plan.setdefault("seed", 0)
    return plan


# ---------------------------------------------------------------------------
# stub scenarios: supervised stdlib children, real spans, real ledger
# ---------------------------------------------------------------------------

# the chaos child: a trainer-shaped stdlib process (``python -S``)
# emitting real trace spans.  mode "steady" runs to completion; "crash"
# dies once mid-run (marker file = already crashed, the relaunch
# re-runs every step so the ledger must price rollback + relaunch_gap);
# "preempt" installs the REAL GracefulShutdown notice machinery and,
# when the supervisor's SIGUSR1 + notice file land, cuts a final
# checkpoint span and exits 47 — the advance-notice contract.
_STUB_CHILD = r'''
import importlib.util
import os
import sys
import time


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod      # dataclasses needs the registration
    spec.loader.exec_module(mod)
    return mod


trace = _load("_nnpt_trace", sys.argv[1])
res = _load("_nnpt_res", sys.argv[2])
trace_dir, mode, steps, at_step, aux = (
    sys.argv[3], sys.argv[4], int(sys.argv[5]), int(sys.argv[6]),
    sys.argv[7])

shutdown = (res.GracefulShutdown().__enter__()   # installs handlers
            if mode == "preempt" else None)
tracer = trace.start_run(trace_dir, ledger=False)
crash = mode == "crash" and not os.path.exists(aux)
last = 0
for i in range(steps):
    last = i
    with trace.span("fetch", step=i):
        time.sleep(0.004)
    with trace.span("dispatch", step=i):
        time.sleep(0.02)
    if crash and i == at_step:
        open(aux, "w").close()
        os._exit(1)
    if mode == "preempt":
        # progress file: the campaign runner sends the notice only
        # after the child demonstrably reached at_step (deterministic
        # trigger without guessing at scheduling)
        tmp = aux + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(i))
        os.replace(tmp, aux)
        if shutdown.requested:
            break
if shutdown is not None and shutdown.noticed:
    with trace.span("checkpoint", step=last):
        time.sleep(0.01)
    tracer.close()
    time.sleep(0.05)      # final-state upload stand-in: priced as drain
    sys.exit(res.EXIT_DECOMMISSION)
tracer.close()
'''


def _run_stub_scenario(sc: Dict[str, Any], tmp: str,
                       log: Callable[[str], None]) -> Dict[str, Any]:
    m = _mods()
    res, gp = m["res"], m["goodput"]
    fault = sc["fault"]
    steps = int(sc.get("steps", 8))
    at_step = int(sc.get("at_step", 3))
    grace_s = float(sc.get("grace_s", 5.0))

    trace_dir = os.path.join(tmp, "trace")
    os.makedirs(trace_dir, exist_ok=True)
    script = os.path.join(tmp, "chaos_child.py")
    with open(script, "w") as f:
        f.write(_STUB_CHILD)
    trace_py = os.path.join(_PKG, "train", "trace.py")
    res_py = os.path.join(_PKG, "train", "resilience.py")
    marker = os.path.join(tmp, "crashed.marker")
    progress = os.path.join(tmp, "progress.txt")
    notice = os.path.join(tmp, "notice.json")

    def cmd(mode, aux):
        # steady children still run the preempt-capable loop but with a
        # plain mode so the A/B arms differ in exactly one child
        return [sys.executable, "-S", script, trace_py, res_py,
                trace_dir, mode, str(steps), str(at_step), aux]

    w1_mode = "crash" if fault == "crash" else "preempt"
    w1_aux = marker if fault == "crash" else progress
    specs = [
        res.ChildSpec(name="w0", cmd=cmd("steady", ""), role="train",
                      env={"NNPT_PROCESS_ID": "0"}, backoff=0.2),
        res.ChildSpec(name="w1", cmd=cmd(w1_mode, w1_aux), role="train",
                      env={"NNPT_PROCESS_ID": "1",
                           res.PREEMPT_NOTICE_ENV: notice},
                      backoff=0.2),
    ]
    sup = res.GroupSupervisor(
        specs, log=lambda msg: None,
        events_path=os.path.join(trace_dir, "supervisor-events.jsonl"))
    sup.start()
    noticed_at: Optional[float] = None
    deadline = time.time() + 120.0
    while sup.running() and time.time() < deadline:
        sup.poll()
        if fault == "preempt" and noticed_at is None:
            try:
                with open(progress) as f:
                    reached = int(f.read().strip() or -1)
            except (OSError, ValueError):
                reached = -1
            if reached >= at_step:
                sup.notify_preempt("w1", grace_s=grace_s)
                noticed_at = time.time()
        time.sleep(0.005)
    if sup.running():
        sup.terminate_all()
        raise AssertionError(f"{sc['name']}: children not done in 120s")
    rcs = {name: sup.done(name) for name in ("w0", "w1")}

    led = gp.ledger_from_dir(trace_dir)
    fleet = led["fleet"]
    cats = fleet["categories"]
    events = _read_events(
        os.path.join(trace_dir, "supervisor-events.jsonl"))
    exit_t = {e["child"]: e["t"] for e in events
              if e.get("event") == "exit"}
    notice_t = next((e["t"] for e in events
                     if e.get("event") == "preempt_notice"), None)
    reaction_s = (round(exit_t["w1"] - notice_t, 3)
                  if notice_t is not None and "w1" in exit_t else None)
    first_exit = next((e["t"] for e in events
                       if e.get("event") == "exit"
                       and e.get("child") == "w1"), None)
    relaunch_t = next((e["t"] for e in events
                       if e.get("event") == "relaunch"
                       and e.get("child") == "w1"), None)
    mttr_s = None
    if fault == "crash":
        # time from the crash to the lost progress being re-earned:
        # the supervisor gap plus the ledger's re-trained window
        mttr_s = round(cats.get("relaunch_gap", 0.0)
                       + cats.get("rollback", 0.0), 3)
    elif reaction_s is not None:
        mttr_s = reaction_s        # notice -> clean 47: nothing to redo

    inv: Dict[str, bool] = {
        "goodput_sums_to_100pct": (fleet["sum_ok"]
                                   and all(p["sum_ok"]
                                           for p in led["processes"])),
    }
    if fault == "crash":
        inv.update({
            "crash_relaunched": fleet["relaunches"] >= 1,
            "both_children_finished_ok": all(v == 0
                                             for v in rcs.values()),
            "rollback_priced": cats.get("rollback", 0.0) > 0.0,
            "relaunch_gap_priced": cats.get("relaunch_gap", 0.0) > 0.0,
        })
    else:
        inv.update({
            "no_relaunch_on_notice": fleet["relaunches"] == 0,
            "notice_child_exited_47": rcs["w1"] == 47,
            "zero_rollback": cats.get("rollback", 0.0) == 0.0,
            "zero_relaunch_gap": cats.get("relaunch_gap", 0.0) == 0.0,
            "drain_priced": cats.get("drain", 0.0) > 0.0,
            "notice_counted": fleet.get("preempt_notices", 0) == 1,
        })

    return {
        "name": sc["name"], "kind": "stub", "fault": fault,
        "metrics": {
            "mttr_s": mttr_s,
            "reaction_s": (reaction_s if fault == "preempt" else
                           (round(relaunch_t - first_exit, 3)
                            if relaunch_t is not None
                            and first_exit is not None else None)),
            "tokens_lost": 0,     # trainer-shaped: steps, not tokens
            "steps_replayed": (steps if fault == "crash" else 0),
            "relaunches": fleet["relaunches"],
            "goodput_fraction": fleet["goodput_fraction"],
            "covered_s": fleet["covered_s"],
            "categories": cats,
            "final_rcs": rcs,
        },
        "invariants": inv,
        "canonical": {
            "events": _canonical_events(events),
            "final_rcs": rcs,
            "invariants": inv,
        },
    }


def _read_events(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if ln:
                    try:
                        out.append(json.loads(ln))
                    except ValueError:
                        pass
    except OSError:
        pass
    return out


def _canonical_events(events: List[Dict[str, Any]]) -> Dict[str, List]:
    """Per-child ordered (event, rc) sequences with every wall-clock
    field stripped — the supervisor-side half of the determinism
    digest.  launch/relaunch carry no rc; exits carry theirs."""
    seq: Dict[str, List] = {}
    for e in events:
        kind = e.get("event")
        if kind not in ("launch", "relaunch", "exit", "hang_kill",
                        "gave_up", "retired", "preempt_notice"):
            continue
        row = [kind] if "rc" not in e else [kind, e.get("rc")]
        seq.setdefault(e.get("child", "?"), []).append(row)
    return seq


# ---------------------------------------------------------------------------
# stub handoff scenario: the disagg commit protocol, stdlib only
# ---------------------------------------------------------------------------

# Two supervised stdlib children model the disaggregated handoff
# protocol's commit discipline (serve/fleet.py) with a
# filesystem ledger: the PREFILL child computes a payload per request
# id and commits it with an atomic link (the handoff-file appearing IS
# the commit point — exactly the router's `handoff` event); the DECODE
# child consumes committed payloads and link-commits the decoded
# tokens.  A duplicate commit attempt (link onto an existing row) is
# counted, never silently absorbed.  The fault: the prefill child
# SIGKILLs itself (os._exit) just BEFORE committing request ``at`` on
# its first life — the pre-commit death.  The supervisor relaunches it
# and the second life re-prefills ONLY the uncommitted rows, so every
# request is decoded exactly once and the tokens are byte-identical to
# the no-fault expectation.
_HANDOFF_CHILD = r'''
import hashlib
import os
import sys
import time

role, spool, n, at = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                      int(sys.argv[4]))
hand = os.path.join(spool, "handoff")
done = os.path.join(spool, "done")
marker = os.path.join(spool, "crashed.marker")
dup = os.path.join(spool, "dup-%s.count" % role)


def commit(path, text):
    # link-commit: atomic publish that FAILS if the row exists — the
    # exactly-once primitive under test (a second commit is a bug
    # surfaced, not a write absorbed)
    tmp = path + ".tmp-%d" % os.getpid()
    with open(tmp, "w") as f:
        f.write(text)
    try:
        os.link(tmp, path)
    except FileExistsError:
        with open(dup, "a") as f:
            f.write(path + "\n")
    os.unlink(tmp)


deadline = time.time() + 60.0
if role == "prefill":
    crash = not os.path.exists(marker)
    while time.time() < deadline:
        todo = [r for r in range(n)
                if not os.path.exists(os.path.join(hand, str(r)))]
        if not todo:
            sys.exit(0)
        for r in sorted(todo):
            if crash and r == at:
                open(marker, "w").close()
                os._exit(1)       # pre-commit death: no handoff row
            payload = hashlib.sha256(b"block-%d" % r).hexdigest()
            commit(os.path.join(hand, str(r)), payload)
        time.sleep(0.002)
else:
    while time.time() < deadline:
        todo = [r for r in range(n)
                if not os.path.exists(os.path.join(done, str(r)))]
        if not todo:
            sys.exit(0)
        for r in todo:
            hp = os.path.join(hand, str(r))
            if not os.path.exists(hp):
                continue          # not committed yet: nothing to steal
            with open(hp) as f:
                payload = f.read()
            tok = hashlib.sha256(
                (payload + "|decode").encode()).hexdigest()
            commit(os.path.join(done, str(r)), tok)
        time.sleep(0.002)
os._exit(3)                       # deadline: report the stuck role
'''


def _run_stub_handoff_scenario(sc: Dict[str, Any], tmp: str,
                               log: Callable[[str], None]
                               ) -> Dict[str, Any]:
    m = _mods()
    res = m["res"]
    n = int(sc.get("rids", 6))
    at = int(sc.get("at", 3))

    spool = os.path.join(tmp, "spool")
    for d in ("handoff", "done"):
        os.makedirs(os.path.join(spool, d), exist_ok=True)
    script = os.path.join(tmp, "handoff_child.py")
    with open(script, "w") as f:
        f.write(_HANDOFF_CHILD)
    events_path = os.path.join(tmp, "supervisor-events.jsonl")

    def cmd(role):
        return [sys.executable, "-S", script, role, spool, str(n),
                str(at)]

    specs = [
        res.ChildSpec(name="w_pre", cmd=cmd("prefill"),
                      role="serve-prefill",
                      env={"NNPT_PROCESS_ID": "0"}, backoff=0.2),
        res.ChildSpec(name="w_dec", cmd=cmd("decode"),
                      role="serve-decode",
                      env={"NNPT_PROCESS_ID": "1"}, backoff=0.2),
    ]
    sup = res.GroupSupervisor(specs, log=lambda msg: None,
                              events_path=events_path)
    sup.start()
    deadline = time.time() + 120.0
    while sup.running() and time.time() < deadline:
        sup.poll()
        time.sleep(0.005)
    if sup.running():
        sup.terminate_all()
        raise AssertionError(f"{sc['name']}: children not done in 120s")
    rcs = {name: sup.done(name) for name in ("w_pre", "w_dec")}
    events = _read_events(events_path)

    def _rows(sub):
        out = {}
        d = os.path.join(spool, sub)
        for name in os.listdir(d):
            with open(os.path.join(d, name)) as f:
                out[int(name)] = f.read()
        return out

    committed, delivered = _rows("handoff"), _rows("done")
    dups = []
    for role in ("prefill", "decode"):
        p = os.path.join(spool, f"dup-{role}.count")
        if os.path.exists(p):
            with open(p) as f:
                dups += [ln for ln in f.read().splitlines() if ln]
    expected = {
        r: hashlib.sha256(
            (hashlib.sha256(b"block-%d" % r).hexdigest()
             + "|decode").encode()).hexdigest()
        for r in range(n)}
    tokens_digest = hashlib.sha256(json.dumps(
        {str(k): v for k, v in sorted(delivered.items())},
        sort_keys=True).encode()).hexdigest()

    inv = {
        # the pre-commit death happened and the supervisor recovered it
        "prefill_crashed_then_relaunched": any(
            e.get("event") == "relaunch" and e.get("child") == "w_pre"
            for e in events),
        # every request committed exactly once — no duplicate rows even
        # though the relaunched prefill re-scanned the whole spool
        "exactly_once_commit": (sorted(committed) == list(range(n))
                                and not dups),
        "exactly_once_delivery": sorted(delivered) == list(range(n)),
        # decode output byte-identical to the no-fault expectation
        "tokens_byte_identical": delivered == expected,
        "children_finished_ok": all(v == 0 for v in rcs.values()),
    }
    return {
        "name": sc["name"], "kind": "stub_handoff",
        "metrics": {
            "rids": n, "killed_before_rid": at,
            "committed": len(committed), "delivered": len(delivered),
            "duplicate_commit_attempts": len(dups),
            "tokens_digest": tokens_digest,
            "final_rcs": rcs,
        },
        "invariants": inv,
        "canonical": {
            "events": _canonical_events(events),
            "tokens_digest": tokens_digest,
            "final_rcs": rcs,
            "invariants": inv,
        },
    }


# ---------------------------------------------------------------------------
# stub wal scenario: the REAL write-ahead log, killed and replayed
# ---------------------------------------------------------------------------

# One supervised stdlib child models the durable router (serve/wal.py +
# serve/fleet.py recovery) against the REAL wal module
# (file-path loaded — the code under test, not a model of it): per
# request it journals ``accept``, computes deterministic tokens,
# journals ``complete`` (tokens ride the record), then link-commits the
# delivery row.  The fault: on its first life the child writes HALF of
# a ``complete`` record — flushed, fsynced, no newline — and SIGKILLs
# itself (``os._exit``): the torn-tail case.  The supervisor relaunches
# it; the second life's ``open()`` truncates the torn tail, replays the
# journal, re-delivers completed requests FROM THE JOURNAL (never
# recomputed — the idempotency-dedupe semantic), and re-executes only
# the unfinished ones.  Tiny segments force rotation, so the sealed-
# segment manifest path runs in the stdlib lane too.
_WAL_CHILD = r'''
import hashlib
import importlib.util
import json
import os
import sys


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


wal = _load("_nnpt_wal", sys.argv[1])
spool, n, at = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
done = os.path.join(spool, "done")
marker = os.path.join(spool, "crashed.marker")
dup = os.path.join(spool, "dup-router.count")


def commit(path, text):
    # link-commit: atomic publish that FAILS if the row exists — the
    # exactly-once delivery primitive (same discipline as the handoff
    # stub: a second commit is a bug surfaced, not a write absorbed)
    tmp = path + ".tmp-%d" % os.getpid()
    with open(tmp, "w") as f:
        f.write(text)
    try:
        os.link(tmp, path)
    except FileExistsError:
        with open(dup, "a") as f:
            f.write(path + "\n")
    os.unlink(tmp)


def toks(rid):
    return hashlib.sha256(b"req-%d" % rid).hexdigest()


crash = not os.path.exists(marker)
w = wal.WriteAheadLog(os.path.join(spool, "wal"), segment_records=4)
recs = w.open()
life = "life1" if crash else "life2"
with open(os.path.join(spool, "report-%s.json" % life), "w") as f:
    json.dump(w.report, f, sort_keys=True)
accepted, completed = set(), {}
for r in recs:
    if r["kind"] == "accept":
        accepted.add(r["rid"])
    elif r["kind"] == "complete":
        completed[r["rid"]] = r["tokens"]
# journaled completions deliver from the RECORD — the replayed tokens,
# not a recomputation (what the router's idempotency dedupe answers)
for rid, t in sorted(completed.items()):
    p = os.path.join(done, str(rid))
    if not os.path.exists(p):
        commit(p, t)
for rid in range(n):
    if rid in completed:
        continue
    if rid not in accepted:
        w.append("accept", rid=rid, idem="k%d" % rid)
    t = toks(rid)
    if crash and rid == at:
        open(marker, "w").close()
        # the torn write: half a complete record, fsynced, no newline
        line = wal.encode_record(
            {"seq": 10 ** 6, "kind": "complete", "rid": rid,
             "tokens": t})
        w._f.write(line[:len(line) // 2])
        w._f.flush()
        os.fsync(w._f.fileno())
        os._exit(1)
    w.append("complete", rid=rid, tokens=t)
    commit(os.path.join(done, str(rid)), t)
w.close()
with open(os.path.join(spool, "summary.json"), "w") as f:
    json.dump({"replayed_complete": len(completed),
               "accepted_seen": sorted(accepted)}, f, sort_keys=True)
sys.exit(0)
'''


def _run_stub_wal_scenario(sc: Dict[str, Any], tmp: str,
                           log: Callable[[str], None]) -> Dict[str, Any]:
    m = _mods()
    res = m["res"]
    n = int(sc.get("rids", 6))
    at = int(sc.get("at", 3))

    spool = os.path.join(tmp, "spool")
    os.makedirs(os.path.join(spool, "done"), exist_ok=True)
    script = os.path.join(tmp, "wal_child.py")
    with open(script, "w") as f:
        f.write(_WAL_CHILD)
    wal_py = os.path.join(_PKG, "serve", "wal.py")
    events_path = os.path.join(tmp, "supervisor-events.jsonl")

    specs = [
        res.ChildSpec(name="w_rt",
                      cmd=[sys.executable, "-S", script, wal_py, spool,
                           str(n), str(at)],
                      role="serve-router",
                      env={"NNPT_PROCESS_ID": "0"}, backoff=0.2),
    ]
    sup = res.GroupSupervisor(specs, log=lambda msg: None,
                              events_path=events_path)
    sup.start()
    deadline = time.time() + 120.0
    while sup.running() and time.time() < deadline:
        sup.poll()
        time.sleep(0.005)
    if sup.running():
        sup.terminate_all()
        raise AssertionError(f"{sc['name']}: child not done in 120s")
    rcs = {"w_rt": sup.done("w_rt")}
    events = _read_events(events_path)

    delivered = {}
    ddir = os.path.join(spool, "done")
    for name in os.listdir(ddir):
        with open(os.path.join(ddir, name)) as f:
            delivered[int(name)] = f.read()
    dups = []
    dp = os.path.join(spool, "dup-router.count")
    if os.path.exists(dp):
        with open(dp) as f:
            dups = [ln for ln in f.read().splitlines() if ln]

    def _json(name, default):
        p = os.path.join(spool, name)
        try:
            with open(p) as f:
                return json.load(f)
        except (OSError, ValueError):
            return default

    report2 = _json("report-life2.json", {})
    summary = _json("summary.json", {})
    expected = {r: hashlib.sha256(b"req-%d" % r).hexdigest()
                for r in range(n)}
    tokens_digest = hashlib.sha256(json.dumps(
        {str(k): v for k, v in sorted(delivered.items())},
        sort_keys=True).encode()).hexdigest()

    inv = {
        "router_crashed_then_relaunched": any(
            e.get("event") == "relaunch" and e.get("child") == "w_rt"
            for e in events),
        # the half-written record was truncated, not treated as fatal
        # and not replayed as data
        "torn_tail_truncated":
            bool(report2.get("torn_tail_truncated")),
        # rotation ran: the replayed journal spans sealed segments
        "segments_sealed": int(report2.get("segments", 0)) >= 1,
        "no_records_quarantined":
            int(report2.get("quarantined_records", 0)) == 0,
        # completed requests re-delivered from the journal, unfinished
        # ones re-executed — each delivery row committed exactly once
        "journal_deduped":
            int(summary.get("replayed_complete", 0)) >= 1,
        "exactly_once_delivery": (sorted(delivered) == list(range(n))
                                  and not dups),
        "tokens_byte_identical": delivered == expected,
        "children_finished_ok": all(v == 0 for v in rcs.values()),
    }
    return {
        "name": sc["name"], "kind": "stub_wal",
        "metrics": {
            "rids": n, "killed_at_rid": at,
            "delivered": len(delivered),
            "replayed_complete": summary.get("replayed_complete"),
            "duplicate_commit_attempts": len(dups),
            "wal_report_life2": report2,
            "tokens_digest": tokens_digest,
            "final_rcs": rcs,
        },
        "invariants": inv,
        "canonical": {
            "events": _canonical_events(events),
            "tokens_digest": tokens_digest,
            "final_rcs": rcs,
            "invariants": inv,
        },
    }


# ---------------------------------------------------------------------------
# fleet scenarios: subprocess replicas, the real router + autopilot
# ---------------------------------------------------------------------------

def _run_fleet_scenario(sc: Dict[str, Any], tmp: str, seed: int,
                        log: Callable[[str], None],
                        platform: str) -> Dict[str, Any]:
    """One failure against a real subprocess fleet (each worker its own
    process on ``platform``) under closed-loop load.  Needs torch; the
    stub scenarios are the stdlib path."""
    try:
        from ..serve.autopilot import Autopilot, AutopilotConfig
        from ..serve.fleet import launch_fleet
        from ..serve.loadgen import run_fleet_closed_loop
        from .platform import resolve_device
    except ImportError:
        # File-path loaded (tools/chaos_campaign.py): no parent
        # package, so import the installed package absolutely.
        if os.path.dirname(_PKG) not in sys.path:
            sys.path.insert(0, os.path.dirname(_PKG))
        _p = os.path.basename(_PKG)
        from importlib import import_module
        Autopilot = import_module(f"{_p}.serve.autopilot").Autopilot
        AutopilotConfig = import_module(
            f"{_p}.serve.autopilot").AutopilotConfig
        launch_fleet = import_module(f"{_p}.serve.fleet").launch_fleet
        run_fleet_closed_loop = import_module(
            f"{_p}.serve.loadgen").run_fleet_closed_loop
        resolve_device = import_module(f"{_p}.utils.platform").resolve_device

    # no card and platform "gpu": the no-CUDA error here, before any
    # worker starts
    resolve_device({"gpu": "cuda", "cpu": "cpu"}[platform])
    mode = sc["mode"]
    if mode == "disagg_handoff":
        return _run_fleet_disagg(sc, tmp, seed, launch_fleet,
                                 run_fleet_closed_loop, platform)
    if mode == "ctrlplane":
        return _run_fleet_ctrlplane(sc, tmp, seed, log, platform)
    n = int(sc.get("replicas", 2))
    clients = int(sc.get("clients", 8))
    rpc = int(sc.get("rpc", 5))
    model = dict(vocab=256, seq=128, layers=2, d_model=64, heads=4,
                 d_ff=128, init_seed=0)
    serve = dict(slots=4, block_size=16, prefill_chunk=32,
                 queue_depth=16, platform=platform)
    events_path = os.path.join(tmp, "supervisor-events.jsonl")

    fleet = launch_fleet(
        n - (1 if mode == "slow_evict" else 0), model=model,
        serve=serve, step_sleep_ms=15.0,
        router_kwargs=dict(queue_depth=128), prewarm=True,
        max_restarts=2, log=lambda msg: None)
    try:
        fleet.supervisor._events_path = events_path
        if mode == "slow_evict":
            # the degraded replica: slow-but-alive, +slow_ms of device
            # stall per tick once it has taken its first request
            fleet.add_replica(
                faults=f"slow@1-1000000?ms={float(sc['slow_ms'])}")
        fleet.wait_ready(600)
        victim = max(h.name for h in fleet.router.replicas)

        ap = None
        if mode == "slow_evict":
            ap = Autopilot(fleet, AutopilotConfig(
                min_replicas=n, max_replicas=n, interval_s=0.1,
                cooldown_s=1.0, health_eviction=True,
                evict_ttft_ratio=2.5, evict_itl_ratio=2.5,
                health_window_s=10.0, evict_hold_s=0.4,
                evict_min_samples=4, drain_timeout_s=60.0))
        elif mode == "notice" and sc.get("backfill"):
            # width pinned min=max=n: the preempt backfill still fires
            # (it counts non-noticed replicas against max), while the
            # load autoscaler stays out of the canonical ledger — a
            # post-drain idle scale_in would be a wall-clock race
            ap = Autopilot(fleet, AutopilotConfig(
                min_replicas=n, max_replicas=n, interval_s=0.1,
                cooldown_s=1.0))

        trigger = {"t": None, "down": False, "restored": None}
        after = int(sc.get("after_completed", 4))

        class _Shim:
            """Rides Fleet.pump: fires the planned failure once the
            router has demonstrably completed ``after`` requests (a
            deterministic trigger in request-space, not wall-clock),
            then watches for the victim's capacity to come back."""

            def tick(shim):
                now = time.monotonic()
                if trigger["t"] is None and \
                        fleet.router.completed >= after:
                    trigger["t"] = now
                    if mode == "kill":
                        fleet.force_kill(victim)
                    elif mode == "notice":
                        fleet.notify_preempt(
                            victim, grace_s=float(sc.get("grace_s",
                                                         30.0)))
                elif (trigger["t"] is not None
                      and trigger["restored"] is None
                      and mode == "kill"):
                    # MTTR needs the down transition observed first:
                    # right after the SIGKILL the handle still reads
                    # ready until the router notices the death
                    h = next((r for r in fleet.router.replicas
                              if r.name == victim), None)
                    accepting = h is not None and h.accepting()
                    if not trigger["down"]:
                        if not accepting:
                            trigger["down"] = True
                    elif accepting:
                        trigger["restored"] = now - trigger["t"]
                if ap is not None:
                    ap.tick()

        fleet.autopilot = _Shim()
        row = run_fleet_closed_loop(
            fleet, clients, rpc, vocab_size=model["vocab"],
            prompt_lens=(4, 24), max_new=(8, 24), seed=seed,
            classes=[{"name": "all", "slo_ms": None}])
        submitted = clients * rpc

        if mode in ("notice", "kill"):
            # settle: the closed loop returns the moment the last
            # request lands, which can race the victim's exit / the
            # backfill becoming ready — pump until the terminal events
            # the canonical ledger expects have all landed
            t_end = time.monotonic() + 150.0
            while time.monotonic() < t_end:
                fleet.pump()
                acts = {d["action"] for d in ap.decisions} \
                    if ap is not None else set()
                victim_exited = (mode == "kill") or any(
                    e.get("event") == "exit"
                    and e.get("child") == victim
                    for e in _read_events(events_path))
                need = set()
                if mode == "notice" and ap is not None:
                    need = {"preempt_drained"}
                    if sc.get("backfill"):
                        need.add("scale_out_ready")
                restoring = (mode == "kill"
                             and trigger["restored"] is None)
                if victim_exited and need <= acts and not restoring:
                    break
                time.sleep(0.02)

        row2 = None
        if mode == "slow_evict":
            # wait the eviction out (replacement ready -> victim
            # drained), then drive a second identical batch: the p99
            # recovery A/B is batch1 (degraded) vs batch2 (evicted)
            t_end = time.monotonic() + 150.0
            while time.monotonic() < t_end:
                fleet.pump()
                done = [d for d in ap.decisions
                        if d["action"] == "drained"
                        and d.get("kind") == "health_evict"]
                if done:
                    break
                time.sleep(0.02)
            row2 = run_fleet_closed_loop(
                fleet, clients, rpc, vocab_size=model["vocab"],
                prompt_lens=(4, 24), max_new=(8, 24), seed=seed + 1,
                classes=[{"name": "all", "slo_ms": None}])

        decisions = list(ap.decisions) if ap is not None else []
        events = _read_events(events_path)
        completed_total = fleet.router.completed
    finally:
        fleet.close()

    # the canonical decision ledger: CONTROL decisions as a sorted
    # (action, replica) multiset.  Timing-contingent escalations
    # (drain_stalled_kill, action_backoff) stay out of the digest —
    # they depend on wall-clock races, not on the plan — but remain in
    # the raw decisions/metrics for inspection.
    _escalations = ("action_backoff", "drain_stalled_kill")
    actions = sorted((d["action"], d.get("replica"))
                     for d in decisions
                     if d["action"] not in _escalations)
    inv: Dict[str, bool] = {
        # every submitted request delivered exactly once: the closed
        # loop observed all of them finish, and the router's completion
        # counter matches that count exactly (a duplicate delivery
        # would overshoot, a drop would hang the loop / undershoot)
        "ledger_exact": row["requests"] == submitted,
        "no_duplicate_deliveries":
            completed_total == row["requests"]
            + (row2["requests"] if row2 else 0),
    }
    if mode == "notice":
        inv["zero_requeue_on_notice"] = row["requeued"] == 0
        inv["victim_exited_47"] = any(
            e.get("event") == "exit" and e.get("child") == victim
            and e.get("rc") == 47 for e in events)
        inv["retired_stays_down"] = not _relaunched_after_exit(
            events, victim, rc=47)
        if sc.get("backfill"):
            inv["notice_in_ledger"] = any(
                a == "preempt_notice" for a, _ in actions)
            inv["backfill_decided"] = any(
                a == "preempt_backfill" for a, _ in actions)
    elif mode == "kill":
        inv["kill_requeued_inflight"] = row["requeued"] > 0
    elif mode == "slow_evict":
        inv["evicted"] = any(a == "health_evict" for a, _ in actions)
        inv["evict_drained"] = any(
            d["action"] == "drained"
            and d.get("kind") == "health_evict" for d in decisions)
        inv["retired_stays_down"] = not _relaunched_after_exit(
            events, victim, rc=47)
        if row2 is not None:
            p99_before = row["itl_ms_p99"]
            p99_after = row2["itl_ms_p99"]
            inv["p99_itl_recovered"] = (
                p99_before is not None and p99_after is not None
                and p99_after < p99_before * 0.8)

    metrics: Dict[str, Any] = {
        "submitted": submitted,
        "requests": row["requests"],
        "requeued": row["requeued"],
        "tokens_per_sec": row["tokens_per_sec"],
        "itl_ms_p99": row.get("itl_ms_p99"),
        "ttft_ms_p99": row.get("ttft_ms_p99"),
        "tokens_sha256": row["tokens_sha256"],
        "tokens_lost": (row["requeued"] if mode == "kill" else 0),
    }
    if mode == "kill":
        metrics["mttr_s"] = (round(trigger["restored"], 3)
                             if trigger["restored"] is not None
                             else None)
    if mode == "notice":
        notice_t = next((e["t"] for e in events
                         if e.get("event") == "preempt_notice"), None)
        exit_t = next((e["t"] for e in events
                       if e.get("event") == "exit"
                       and e.get("child") == victim), None)
        metrics["reaction_s"] = (round(exit_t - notice_t, 3)
                                 if notice_t is not None
                                 and exit_t is not None else None)
        metrics["mttr_s"] = metrics["reaction_s"]
    if mode == "slow_evict" and row2 is not None:
        evict_d = next((d for d in decisions
                        if d["action"] == "health_evict"), None)
        drain_d = next((d for d in decisions
                        if d["action"] == "drained"
                        and d.get("kind") == "health_evict"), None)
        metrics.update({
            "itl_ms_p99_after_evict": row2["itl_ms_p99"],
            "evict_verdict": {k: v for k, v in (evict_d or {}).items()
                              if k not in ("t",)},
            "evict_to_drained_s": (round(drain_d["t"] - evict_d["t"], 3)
                                   if evict_d and drain_d else None),
            "mttr_s": (round(drain_d["t"] - evict_d["t"], 3)
                       if evict_d and drain_d else None),
            "tokens_sha256_after": row2["tokens_sha256"],
        })

    return {
        "name": sc["name"], "kind": "fleet", "mode": mode,
        "metrics": metrics, "invariants": inv,
        "canonical": {
            "tokens_sha256": row["tokens_sha256"],
            "actions": actions,
            "invariants": inv,
        },
    }


def _run_fleet_disagg(sc: Dict[str, Any], tmp: str, seed: int,
                      launch_fleet, run_fleet_closed_loop, platform: str
                      ) -> Dict[str, Any]:
    """The disaggregated prefill/decode handoff under fire: a 1-prefill
    + 1-decode fleet whose prefill worker SIGKILLs
    itself just BEFORE its Nth handoff commit (``handoff_kill``), on
    EVERY life — so the pool crash-loops through the supervisor's
    relaunch budget and ends gone.  The claim checked: through
    pre-commit deaths, re-prefills, and the final degraded-unified
    window, every request is delivered exactly once and the tokens are
    byte-identical to a unified single-replica fleet serving the same
    plan."""
    clients = int(sc.get("clients", 6))
    rpc = int(sc.get("rpc", 4))
    kill_at = int(sc.get("kill_at_handoff", 2))
    model = dict(vocab=256, seq=128, layers=2, d_model=64, heads=4,
                 d_ff=128, init_seed=0)
    serve = dict(slots=4, block_size=16, prefill_chunk=32,
                 queue_depth=16, platform=platform)
    load = dict(vocab_size=model["vocab"], prompt_lens=(4, 24),
                max_new=(8, 24), seed=seed,
                classes=[{"name": "all", "slo_ms": None}])

    # the byte-identity reference: one unified replica, same plan
    base = launch_fleet(1, model=model, serve=serve, step_sleep_ms=15.0,
                        router_kwargs=dict(queue_depth=128),
                        prewarm=True, max_restarts=2,
                        log=lambda msg: None)
    try:
        base.wait_ready(600)
        row0 = run_fleet_closed_loop(base, clients, rpc, **load)
    finally:
        base.close()

    events_path = os.path.join(tmp, "supervisor-events.jsonl")
    fleet = launch_fleet(
        1, model=model, serve=serve, step_sleep_ms=15.0,
        router_kwargs=dict(queue_depth=128, handoff_timeout_s=60.0),
        prewarm=True, max_restarts=1, roles=["decode"],
        log=lambda msg: None)
    try:
        fleet.supervisor._events_path = events_path
        pre = fleet.add_replica(
            role="prefill",
            faults=f"handoff_kill@{kill_at}?proc=1&max=1")
        fleet.wait_ready(600)
        row = run_fleet_closed_loop(fleet, clients, rpc, **load)
        completed_total = fleet.router.completed
        hstats = fleet.router.handoff_stats()
        requeued = fleet.router.requeued
        events = _read_events(events_path)
    finally:
        fleet.close()

    submitted = clients * rpc
    pre_exits = [e for e in events
                 if e.get("event") == "exit"
                 and e.get("child") == pre.name]
    inv: Dict[str, bool] = {
        "ledger_exact": row["requests"] == submitted,
        "no_duplicate_deliveries": completed_total == row["requests"],
        # disagg + pre-commit kills + degraded fallback change
        # latency, never bytes
        "tokens_identical_to_unified":
            row["tokens_sha256"] == row0["tokens_sha256"],
        "handoffs_committed": hstats["handoffs"] >= 1,
        "prefill_killed_at_handoff": len(pre_exits) >= 1,
        "kill_requeued_inflight": requeued >= 1,
        "degraded_fallback_served": hstats["degraded_dispatches"] >= 1,
    }
    return {
        "name": sc["name"], "kind": "fleet", "mode": "disagg_handoff",
        "metrics": {
            "submitted": submitted,
            "requests": row["requests"],
            "requeued": requeued,
            "tokens_per_sec": row["tokens_per_sec"],
            "itl_ms_p99": row.get("itl_ms_p99"),
            "ttft_ms_p99": row.get("ttft_ms_p99"),
            "tokens_sha256": row["tokens_sha256"],
            "tokens_sha256_unified": row0["tokens_sha256"],
            "prefill_exits": len(pre_exits),
            **hstats,
        },
        "invariants": inv,
        "canonical": {
            "tokens_sha256": row["tokens_sha256"],
            "tokens_match": row["tokens_sha256"] == row0["tokens_sha256"],
            "invariants": inv,
        },
    }


def _run_fleet_ctrlplane(sc: Dict[str, Any], tmp: str, seed: int,
                         log: Callable[[str], None],
                         platform: str) -> Dict[str, Any]:
    """Control-plane death under load: the router +
    workers run in a killable driver subprocess
    (serve/ctrlplane_driver.py) with a write-ahead request ledger; the
    scenario SIGKILLs the driver pid mid-load (``router_kill`` — the
    workers orphan and drain via the notice channel) and, in a second
    arm, the whole process group (``fleet_kill`` — fired only while a
    committed handoff is still inflight, the hardest record class).
    Each arm relaunches on the same WAL dir; recovery must re-admit
    exactly once per journaled phase and finish with tokens
    byte-identical to the uncrashed baseline."""
    try:
        from ..serve import wal as wal_mod
        from .faults import FaultPlan
    except ImportError:
        if os.path.dirname(_PKG) not in sys.path:
            sys.path.insert(0, os.path.dirname(_PKG))
        from importlib import import_module
        _p = os.path.basename(_PKG)
        wal_mod = import_module(f"{_p}.serve.wal")
        FaultPlan = import_module(f"{_p}.utils.faults").FaultPlan

    clients = int(sc.get("clients", 4))
    rpc = int(sc.get("rpc", 3))
    kill_at = int(sc.get("kill_at_completed", 2))
    want = clients * rpc
    pkg = os.path.basename(_PKG)
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(_PKG) + os.pathsep
                         + env.get("PYTHONPATH", "")).rstrip(os.pathsep)

    def cmd(wal_dir: str, out: str) -> List[str]:
        return [sys.executable, "-m", f"{pkg}.serve.ctrlplane_driver",
                "--roles", "prefill,decode",
                "--clients", str(clients), "--rpc", str(rpc),
                "--seed", str(seed), "--mix", "long_prefill",
                "--step-sleep-ms", "15", "--platform", platform,
                "--wal-dir", wal_dir, "--out", out]

    def run_life(label: str, wal_dir: str) -> Dict[str, Any]:
        out = os.path.join(tmp, label + ".json")
        with open(os.path.join(tmp, label + ".stderr"), "w") as errf:
            subprocess.run(cmd(wal_dir, out), env=env, stderr=errf,
                           check=True, timeout=600)
        with open(out) as f:
            return json.load(f)

    def progress(wal_dir: str):
        recs, _ = wal_mod.replay(wal_dir, repair=False)
        done = {r.get("rid") for r in recs
                if r.get("kind") == "complete"}
        inflight = sum(1 for r in recs if r.get("kind") == "handoff"
                       and r.get("rid") not in done)
        return len(done), inflight

    def crash_arm(label: str, kind: str) -> Dict[str, Any]:
        wal_dir = os.path.join(tmp, "wal_" + label)
        # the window runs from kill_at to the last request: the 0.1 s
        # poll can see the completions jump past kill_at itself (JAX's
        # plan fires at kill_at only, which a fast fleet skips)
        plan = FaultPlan.parse(f"{kind}@{kill_at}-{want - 1}?max=1")
        fired, kd, ki = False, 0, 0
        with open(os.path.join(tmp, label + "_life1.stderr"),
                  "w") as errf:
            p = subprocess.Popen(
                cmd(wal_dir, os.path.join(tmp, label + "_life1.json")),
                env=env, stderr=errf, start_new_session=True)
            t0 = time.monotonic()
            while p.poll() is None and time.monotonic() - t0 < 300:
                done, inflight = progress(wal_dir)
                # fleet_kill waits for a committed handoff inflight
                # (late-fire fallback so a fast decode pool cannot
                # starve the arm); the gate runs BEFORE fire_if_due so
                # an unmet precondition does not consume the fire
                ok = (kind != "fleet_kill" or inflight > 0
                      or done >= want - 4)
                if ok and plan.fire_if_due(kind, done):
                    if kind == "fleet_kill":
                        os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                    else:
                        os.kill(p.pid, signal.SIGKILL)
                    fired, kd, ki = True, done, inflight
                    break
                time.sleep(0.1)
            p.wait(timeout=120)
        if kind == "router_kill":
            time.sleep(2.0)  # orphans hit EOF, drain, exit 47
        doc = run_life(label + "_life2", wal_dir)
        doc["fired"] = fired
        doc["kill_at_completed"] = kd
        doc["handoffs_inflight_at_kill"] = ki
        # the killed driver's session (start_new_session): its orphaned
        # or killed workers, still alive after the relaunched life
        doc["procs_left"] = len(_session_procs(p.pid))
        log(f"[chaos ctrlplane {label}] fired={fired} at={kd} "
            f"inflight={ki} recovery={doc['recovery']} "
            f"procs_left={doc['procs_left']}")
        return doc

    base = run_life("baseline", "")
    rk = crash_arm("router_kill", "router_kill")
    fk = crash_arm("fleet_kill", "fleet_kill")

    def _arm_inv(doc):
        return (doc["fired"] and doc["resumed"]
                and doc["row"]["tokens_sha256"]
                == base["row"]["tokens_sha256"]
                and doc["row"]["requests"] == want
                and doc["recovery"]["lost"] == 0
                and (doc["recovery"]["replayed"]
                     + doc["recovery"]["deduped"]) > 0)

    inv = {
        "baseline_completed": base["row"]["requests"] == want,
        # exactly-once across router death: journal replayed, completed
        # requests deduped, tokens byte-identical, nothing lost
        "router_kill_exactly_once": _arm_inv(rk),
        "fleet_kill_exactly_once": _arm_inv(fk),
        # the ledger never over-delivers: completed == accepted requests
        "no_duplicate_deliveries": (
            rk["completed"] == want and fk["completed"] == want),
    }
    canonical_inv = dict(inv)
    return {
        "name": sc["name"], "kind": "fleet", "mode": "ctrlplane",
        "metrics": {
            "submitted": want,
            "tokens_sha256": base["row"]["tokens_sha256"],
            "router_kill": {
                "kill_at_completed": rk["kill_at_completed"],
                "handoffs_inflight_at_kill":
                    rk["handoffs_inflight_at_kill"],
                "recovery": rk["recovery"],
                "recovery_wall_s": rk["ready_wall_s"],
                "tokens_sha256": rk["row"]["tokens_sha256"],
                "requests": rk["row"]["requests"],
                "procs_left": rk["procs_left"],
                "kernel_launches": rk.get("kernel_launches"),
            },
            "fleet_kill": {
                "kill_at_completed": fk["kill_at_completed"],
                "handoffs_inflight_at_kill":
                    fk["handoffs_inflight_at_kill"],
                "recovery": fk["recovery"],
                "recovery_wall_s": fk["ready_wall_s"],
                "tokens_sha256": fk["row"]["tokens_sha256"],
                "requests": fk["row"]["requests"],
                "procs_left": fk["procs_left"],
                "kernel_launches": fk.get("kernel_launches"),
            },
            # the workers' kernel launches of the baseline life (the
            # arms' relaunched lives report theirs above)
            "kernel_launches": base.get("kernel_launches"),
        },
        "invariants": inv,
        # kill timing (and with it every replay counter) is wall-clock
        # jitter: the digest pins only the token identity + verdicts
        "canonical": {
            "tokens_sha256": base["row"]["tokens_sha256"],
            "tokens_match": {
                "router_kill": rk["row"]["tokens_sha256"]
                == base["row"]["tokens_sha256"],
                "fleet_kill": fk["row"]["tokens_sha256"]
                == base["row"]["tokens_sha256"],
            },
            "invariants": canonical_inv,
        },
    }


def _session_procs(sid: int) -> List[int]:
    """Pids of the live (not zombie) processes of session ``sid``, read
    from ``/proc``."""
    out = []
    try:
        pids = [d for d in os.listdir("/proc") if d.isdigit()]
    except OSError:
        return out
    for d in pids:
        try:
            with open(f"/proc/{d}/stat") as f:
                st = f.read()
        except OSError:
            continue
        # after the ")" of the command name: state ppid pgrp session ...
        fields = st[st.rindex(")") + 2:].split()
        if int(fields[3]) == sid and fields[0] != "Z":
            out.append(int(d))
    return out


def _relaunched_after_exit(events: List[Dict[str, Any]], child: str,
                           rc: int) -> bool:
    """True if ``child`` was relaunched AFTER its rc==``rc`` exit — the
    retired-stays-down violation (a drained/noticed child coming back
    would undo the decommission and double-serve its traffic)."""
    seen_exit = False
    for e in events:
        if e.get("child") != child:
            continue
        if e.get("event") == "exit" and e.get("rc") == rc:
            seen_exit = True
        elif e.get("event") in ("launch", "relaunch") and seen_exit:
            return True
    return False


# ---------------------------------------------------------------------------
# campaign driver + invariant gate
# ---------------------------------------------------------------------------

def check_invariants(result: Dict[str, Any]) -> List[str]:
    """The machine gate: every False invariant becomes one problem
    string ``scenario: invariant_name``."""
    return [f"{result['name']}: {k}"
            for k, v in (result.get("invariants") or {}).items()
            if not v]


def canonical_digest(results: List[Dict[str, Any]]) -> str:
    """sha256 over the wall-clock-free canonical facts of every
    scenario (module docstring) — the bitwise-reproducibility pin."""
    doc = [{"name": r["name"], "canonical": r["canonical"]}
           for r in results]
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def run_scenario(sc: Dict[str, Any], seed: int = 0,
                 log: Optional[Callable[[str], None]] = None,
                 platform: str = "gpu") -> Dict[str, Any]:
    """One scenario in a fresh temporary directory; ``platform`` (``gpu``
    or ``cpu``) is where a fleet scenario's workers run."""
    import tempfile

    if platform not in ("gpu", "cpu"):
        raise ValueError(f"platform must be 'gpu' or 'cpu', not "
                         f"{platform!r}")
    log = log or (lambda msg: None)
    with tempfile.TemporaryDirectory(prefix="nnpt-chaos-") as tmp:
        t0 = time.monotonic()
        if sc.get("kind") == "fleet":
            out = _run_fleet_scenario(sc, tmp, seed, log, platform)
        elif sc.get("kind") == "stub":
            out = _run_stub_scenario(sc, tmp, log)
        elif sc.get("kind") == "stub_handoff":
            out = _run_stub_handoff_scenario(sc, tmp, log)
        elif sc.get("kind") == "stub_wal":
            out = _run_stub_wal_scenario(sc, tmp, log)
        else:
            raise ValueError(f"unknown scenario kind: {sc.get('kind')}")
        out["wall_s"] = round(time.monotonic() - t0, 3)
        problems = check_invariants(out)
        out["problems"] = problems
        log(f"[chaos] {sc['name']}: "
            + ("OK" if not problems else f"FAILED {problems}")
            + f" ({out['wall_s']}s)")
        return out


def run_campaign(plan: Dict[str, Any], repeat: int = 1,
                 log: Optional[Callable[[str], None]] = None,
                 platform: str = "gpu") -> Dict[str, Any]:
    """Run every scenario ``repeat`` times (>=2 checks determinism:
    identical canonical digests across passes), fleet scenarios' workers
    on ``platform``.  The campaign document is what
    ``tools/chaos_campaign.py`` gates its exit code on."""
    log = log or (lambda msg: None)
    seed = int(plan.get("seed", 0))
    passes: List[List[Dict[str, Any]]] = []
    for rep in range(max(1, int(repeat))):
        results = [run_scenario(sc, seed=seed, log=log,
                                platform=platform)
                   for sc in plan["scenarios"]]
        passes.append(results)
    digests = [canonical_digest(results) for results in passes]
    problems = [p for results in passes
                for r in results for p in r["problems"]]
    reproducible = len(set(digests)) == 1
    if not reproducible:
        problems.append("campaign: canonical digests differ across "
                        f"passes ({digests})")
    return {
        "plan": plan.get("name"), "seed": seed,
        "scenarios": passes[0],
        "determinism": {"passes": len(passes), "digests": digests,
                        "reproducible": reproducible},
        "problems": problems,
        "invariants_ok": not problems,
    }
