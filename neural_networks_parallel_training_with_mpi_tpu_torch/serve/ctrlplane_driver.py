"""Killable control-plane driver: the process a control-plane chaos run
SIGKILLs.  The port of the JAX package's ``serve/ctrlplane_driver.py``.

The router lives in the operator's process, so "kill the control plane"
cannot be modelled in-process: the experimenter would die with its
subject.  This module is the subject: it launches a fleet (router and
workers, WAL-backed through ``router_kwargs["wal_dir"]``), runs the
closed-loop load, and writes one JSON result row atomically (tmp +
``os.replace``) to ``--out``.  The parent (``utils/chaos.py``'s
``fleet_ctrlplane`` scenario) spawns it with ``start_new_session=True``
and then:

* **router_kill**: ``os.kill(driver_pid, SIGKILL)``.  The workers inherit
  the driver's process group and live on as orphans; their stdin hits EOF
  without an ``exit`` op, which arms the advance-notice drain with zero
  grace, so each orphan quiesces its allocator and exits 47
  (``EXIT_DECOMMISSION``).
* **fleet_kill**: ``os.killpg(driver_pgid, SIGKILL)``.  Everything dies
  mid-flight; durability rests on the fsynced WAL alone.

Relaunching the driver with the same ``--wal-dir`` is recovery: the
router replays the journal (completed requests dedupe by idempotency
key, committed handoffs re-inject, the rest requeue), and this module
wraps the resumed launch in a ``recovery`` trace span so the goodput
ledger prices the outage as ``recovery``, not idle.

The parent watches progress without IPC: it polls the WAL read-only
(``wal.replay(root, repair=False)``) and counts ``complete`` records.

``--platform`` picks the workers' device: ``gpu`` (the default) runs
them on the card or exits with the no-CUDA error, ``cpu`` runs them on
the plain PyTorch path.  The row has JAX's keys and one more,
``kernel_launches``: the workers' CUDA kernel launches, summed from their
last status reports.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict

from . import wal as wal_mod
from .fleet import launch_fleet
from .loadgen import run_fleet_closed_loop
from ..train import trace
from ..utils.platform import resolve_device


def _write_atomic(path: str, doc: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=2)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="WAL-backed fleet under closed-loop load; one JSON "
                    "row to --out (the process a control-plane chaos run "
                    "kills)")
    ap.add_argument("--wal-dir", default="",
                    help="WAL root ('' disables the WAL: baseline arm)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--roles", default="",
                    help="comma list, one per replica (e.g. "
                         "'prefill,decode'); overrides --replicas")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--rpc", type=int, default=4)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--mix", default="")
    ap.add_argument("--step-sleep-ms", type=float, default=15.0)
    ap.add_argument("--queue-depth", type=int, default=128)
    ap.add_argument("--handoff-timeout-s", type=float, default=60.0)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--max-wall-s", type=float, default=600.0)
    ap.add_argument("--trace-dir", default="")
    ap.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                    help="the workers' device: gpu (default) the card, or "
                         "the no-CUDA error; cpu the plain PyTorch path")
    args = ap.parse_args(argv)
    # no card and no --platform cpu: the no-CUDA error here, before any
    # worker starts
    resolve_device("cuda" if args.platform == "gpu" else "cpu")

    roles = ([r.strip() or None for r in args.roles.split(",")]
             if args.roles else None)
    n = len(roles) if roles else int(args.replicas)
    # the tiny model of JAX's driver: identity across arms comes from
    # greedy decode and init_seed, not from model size
    model = dict(vocab=256, seq=128, layers=2, d_model=64, heads=4,
                 d_ff=128, init_seed=0)
    serve_cfg = dict(slots=4, block_size=16, prefill_chunk=32,
                     queue_depth=16, platform=args.platform)
    wal_dir = args.wal_dir or None

    resuming = False
    if wal_dir:
        prior, _ = wal_mod.replay(wal_dir, repair=False)
        resuming = bool(prior)

    tracer = None
    if args.trace_dir:
        tracer = trace.start_run(args.trace_dir, ledger=False)

    t0 = time.perf_counter()

    def _launch():
        fl = launch_fleet(
            n, model=model, serve=serve_cfg,
            step_sleep_ms=float(args.step_sleep_ms),
            router_kwargs=dict(queue_depth=int(args.queue_depth),
                               handoff_timeout_s=float(
                                   args.handoff_timeout_s),
                               wal_dir=wal_dir),
            prewarm=True, max_restarts=int(args.max_restarts),
            roles=roles, log=lambda msg: None)
        fl.wait_ready(600)
        return fl

    # the recovery window: from relaunch to serving again.  Only a
    # resumed launch is recovery; a cold start is ordinary start-up.
    if resuming:
        with trace.span("recovery"):
            fleet = _launch()
    else:
        fleet = _launch()
    ready_wall_s = round(time.perf_counter() - t0, 6)

    try:
        row = run_fleet_closed_loop(
            fleet, int(args.clients), int(args.rpc),
            vocab_size=model["vocab"], prompt_lens=(4, 24),
            max_new=(8, 24), seed=int(args.seed),
            classes=[{"name": "all", "slo_ms": None}],
            mix=(args.mix or None), max_wall_s=float(args.max_wall_s))
        # one more status report from every worker (one each 0.25 s when
        # idle): the launch counts the load just made
        t_end = time.perf_counter() + 0.6
        while time.perf_counter() < t_end:
            fleet.pump()
            time.sleep(0.01)
        launches: Dict[str, int] = {}
        for h in fleet.handles:
            rep = (getattr(h, "report", None) or {}).get(
                "kernel_launches") or {}
            for k, v in rep.items():
                launches[k] = launches.get(k, 0) + int(v)
        router = fleet.router
        doc = {
            "row": row,
            "resumed": resuming,
            "ready_wall_s": ready_wall_s,
            "recovery": dict(router.recovery),
            "handoff_stats": router.handoff_stats(),
            "completed": int(router.completed),
            "wal": (dict(router._wal.report)
                    if router._wal is not None else None),
            "kernel_launches": launches,
        }
        _write_atomic(args.out, doc)
    finally:
        fleet.close()
        if tracer is not None:
            trace.stop_run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
