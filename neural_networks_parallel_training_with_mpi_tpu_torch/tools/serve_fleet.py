"""Serving-fleet launcher: N replica processes behind the SLO-aware
router.  The port's counterpart of the repository's
``tools/serve_fleet.py``.

Brings up a fleet of ``PagedDecodeServer`` replicas (each its own
process, one ``serve.Scheduler`` per replica, or a replica spanning a
local tensor group through ``generate_tp`` with ``--tp``) under the
process-group supervisor (``train.resilience.GroupSupervisor``: a dead
replica relaunches under its own budget while its siblings serve),
fronted by ``serve.fleet.FleetRouter`` in this process.  The closed-loop
load generator then drives the router and prints the measured row as
JSON.  The workers run on ``--platform``: ``gpu`` (the default) the card,
or the no-CUDA error; ``cpu`` the plain PyTorch path.

Telemetry: with ``--telemetry-dir`` every replica writes its own
``replica-K/`` dir and the router writes ``router/``; the repository's
``tools/obs_agg.py`` merges them::

    python tools/obs_agg.py RUN/replica-* RUN/router --json

Chaos: ``--kill-replica-after S`` SIGKILLs replica 0 that many seconds
into the load run: the router requeues its in-flight requests onto its
siblings (greedy decode gives the same tokens) and the supervisor
relaunches it.

Autopilot: ``--autopilot`` attaches ``serve.autopilot.Autopilot``:
occupancy- and queue-driven scale-out and scale-in between
``--min-replicas`` and ``--max-replicas``, ticked by the pump loop.
``--rollout-after S`` pushes a weight snapshot mid-load as a canary
generation; ``--rollout-mode`` picks the ending: ``good`` promotes,
``slow`` (a canary with 100 ms of emulated device latency a step) and
``corrupt`` (payload corrupted after the manifest is committed again, so
the worker fails its own verification and exits 44) both roll back with
the old generation undisturbed.

Example::

    python -m neural_networks_parallel_training_with_mpi_tpu_torch.tools.serve_fleet \
        --replicas 2 --clients 8 --requests-per-client 3 --slo-ms 2000 \
        --platform cpu --autopilot --rollout-after 2
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _prepare_snapshot(args, log):
    """Build the weights to push and commit them as a verified snapshot
    (``serve.autopilot.save_weight_snapshot``): the worker's seeded init
    on the host, as every worker of a seed draws it.  In ``corrupt`` mode
    the payload is flipped and the manifest committed again over it: the
    autopilot's pre-spawn verify passes, the canary worker's own load
    fails, and the rollback path runs end to end."""
    import tempfile

    from ..models.transformer import Transformer, TransformerConfig
    from ..serve import save_weight_snapshot
    from ..utils import ckpt_manifest, prng

    seed = (args.rollout_seed if args.rollout_seed is not None
            else args.init_seed)
    model = Transformer(TransformerConfig(
        vocab_size=args.vocab, max_seq_len=args.seq,
        n_layers=args.layers, d_model=args.d_model,
        n_heads=args.heads, d_ff=args.d_ff), device="cpu")
    params = model.init(prng.init_generator(seed))
    root = args.telemetry_dir or tempfile.mkdtemp(prefix="nnpt-snap-")
    snap = save_weight_snapshot(
        pathlib.Path(root) / "push", params, step=1,
        meta={"init_seed": seed})
    if args.rollout_mode == "corrupt":
        p = pathlib.Path(snap) / "weights.npz"
        raw = bytearray(p.read_bytes())
        # clobber the zip magic, not a payload byte: np.savez stores
        # uncompressed, so a mid-file flip would LOAD fine with silently
        # wrong values — the header flip fails np.load deterministically
        raw[0:4] = b"XXXX"
        p.write_bytes(bytes(raw))
        ckpt_manifest.commit(pathlib.Path(snap),
                             {"step": 1, "kind": "weights"})
        log(f"[fleet] chaos: corrupted snapshot payload at {snap}")
    log(f"[fleet] weight snapshot ready: {snap}")
    return snap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--roles", default=None,
                    help="comma list assigning a disagg role per "
                         "replica (e.g. 'prefill,decode'; an empty "
                         "item means unified).  Length must equal "
                         "--replicas")
    ap.add_argument("--wal-dir", default=None,
                    help="durable control plane: journal the router's "
                         "request ledger to this directory "
                         "(serve/wal.py) and replay it on relaunch — "
                         "rerunning with the same dir recovers "
                         "unfinished requests exactly once")
    ap.add_argument("--tp", type=int, default=0,
                    help="each replica spans a local tensor group of N "
                         "shards through generate_tp (0 = the paged "
                         "scheduler replica)")
    # model geometry (tiny default: every replica builds the same
    # params from --init-seed, which makes a requeued request's
    # re-execution give the same tokens)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=128)
    ap.add_argument("--init-seed", type=int, default=0)
    # per-replica serve geometry
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--replica-queue-depth", type=int, default=16)
    ap.add_argument("--attn-impl", default="fused",
                    choices=["gathered", "fused"],
                    help="fused: the CUDA paged-attention kernel on the "
                         "card (its plain version on the CPU), as the "
                         "worker's default")
    # router policy
    ap.add_argument("--queue-depth", type=int, default=128,
                    help="the ROUTER's bounded fleet wait queue "
                         "(overload rejects here, not at N replica "
                         "queues)")
    ap.add_argument("--replica-queue-cap", type=int, default=2,
                    help="requests the router parks at one replica "
                         "beyond its slots (shallow: waiting work "
                         "stays re-placeable at the router)")
    ap.add_argument("--reject-infeasible", action="store_true",
                    help="reject a deadline-carrying request up front "
                         "when no replica's TTFT rollup makes it "
                         "plausible")
    # load
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests-per-client", type=int, default=3)
    ap.add_argument("--prompt-lens", type=int, nargs=2,
                    default=(4, 24))
    ap.add_argument("--max-new", type=int, nargs=2, default=(8, 24))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="interactive-class deadline; half the clients "
                         "run it, half run the no-SLO bulk class")
    ap.add_argument("--step-sleep-ms", type=float, default=0.0,
                    help="emulated per-tick device latency in each "
                         "replica")
    ap.add_argument("--prewarm", action="store_true",
                    help="replicas pay every first call before reporting "
                         "ready: use with --autopilot so a canary's "
                         "first routed requests measure steady-state "
                         "TTFT, not start-up")
    # plumbing
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--backoff", type=float, default=0.5)
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0,
                    help="kill a replica whose telemetry heartbeat "
                         "goes stale this long (0 = off; needs "
                         "--telemetry-dir).  Pipe-EOF already catches "
                         "DEAD replicas instantly; the heartbeat is "
                         "for the LIVE-but-stuck ones (wedged device, "
                         "deadlocked loop) whose pipes stay open")
    ap.add_argument("--kill-replica-after", type=float, default=0.0,
                    help="chaos: SIGKILL replica 0 this many seconds "
                         "into the load run")
    # autopilot (the control loop that ACTS on the signals above)
    ap.add_argument("--autopilot", action="store_true",
                    help="attach serve.autopilot.Autopilot: "
                         "occupancy/queue-driven scale-out/in plus "
                         "rollout management, ticked by the pump loop")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--scale-out-hold", type=float, default=0.75,
                    help="seconds the high-load signal must HOLD "
                         "before a scale-out fires (hysteresis)")
    ap.add_argument("--rollout-after", type=float, default=0.0,
                    help="push a weight snapshot as a canary "
                         "generation this many seconds into the load "
                         "run (needs --autopilot)")
    ap.add_argument("--rollout-mode", default="good",
                    choices=["good", "slow", "corrupt"],
                    help="good = healthy canary, promotes; slow = "
                         "canary with 100ms emulated device latency, "
                         "rolls back on its SLO judgment; corrupt = "
                         "snapshot payload corrupted (manifest "
                         "re-committed so the autopilot's pre-spawn "
                         "verify passes), worker fails its own "
                         "verification and exits 44, rolls back")
    ap.add_argument("--rollout-seed", type=int, default=None,
                    help="init seed for the pushed weights (default: "
                         "--init-seed, i.e. a same-weights push whose "
                         "tokens stay byte-identical across "
                         "generations)")
    ap.add_argument("--canary-fraction", type=float, default=0.25)
    ap.add_argument("--canary-window", type=float, default=3.0)
    ap.add_argument("--json", action="store_true",
                    help="print ONLY the result row as JSON")
    ap.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                    help="the workers' device: gpu (default) the card, or "
                         "the no-CUDA error; cpu the plain PyTorch path")
    args = ap.parse_args(argv)

    from ..serve import launch_fleet, run_fleet_closed_loop
    from ..utils.platform import resolve_device

    # no card and no --platform cpu: the no-CUDA error before any worker
    resolve_device("cuda" if args.platform == "gpu" else "cpu")

    log = (lambda m: None) if args.json else (
        lambda m: print(m, file=sys.stderr, flush=True))
    roles = None
    if args.roles is not None:
        roles = [r.strip() or None for r in args.roles.split(",")]
        if len(roles) != args.replicas:
            ap.error(f"--roles lists {len(roles)} role(s) for "
                     f"--replicas {args.replicas}")
    model = dict(vocab=args.vocab, seq=args.seq, layers=args.layers,
                 d_model=args.d_model, heads=args.heads, d_ff=args.d_ff,
                 init_seed=args.init_seed)
    serve = dict(slots=args.slots, block_size=args.block_size,
                 prefill_chunk=args.prefill_chunk,
                 queue_depth=args.replica_queue_depth,
                 attn_impl=args.attn_impl, platform=args.platform)
    fleet = launch_fleet(
        args.replicas, model=model, serve=serve,
        telemetry_root=args.telemetry_dir,
        router_kwargs=dict(queue_depth=args.queue_depth,
                           replica_queue_cap=args.replica_queue_cap,
                           reject_infeasible=args.reject_infeasible,
                           wal_dir=args.wal_dir),
        step_sleep_ms=args.step_sleep_ms, tp=args.tp, roles=roles,
        max_restarts=args.max_restarts, backoff=args.backoff,
        heartbeat_timeout=args.heartbeat_timeout,
        prewarm=args.prewarm, log=log)
    try:
        fleet.wait_ready()
        log(f"[fleet] {args.replicas} replica(s) ready")
        ap_obj = None
        if args.autopilot:
            import time as time_lib

            import os

            from ..serve import Autopilot, AutopilotConfig

            ap_obj = Autopilot(fleet, AutopilotConfig(
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                scale_out_hold_s=args.scale_out_hold,
                canary_fraction=args.canary_fraction,
                canary_window_s=args.canary_window,
                events_path=(os.path.join(
                    args.telemetry_dir, "autopilot-decisions.jsonl")
                    if args.telemetry_dir else None)), log=log)
            fleet.autopilot = ap_obj
            if args.rollout_after > 0:
                snap = _prepare_snapshot(args, log)
                t0 = time_lib.monotonic()
                fired = []
                orig_tick = ap_obj.tick

                def tick():
                    # rollout trigger rides the pump thread too: no
                    # cross-thread mutation of router/supervisor state
                    if (not fired and time_lib.monotonic() - t0
                            >= args.rollout_after):
                        fired.append(True)
                        ap_obj.start_rollout(
                            snap,
                            step_sleep_ms=(100.0 if args.rollout_mode
                                           == "slow" else None))
                    return orig_tick()

                ap_obj.tick = tick
        if args.kill_replica_after > 0:
            import os
            import signal
            import threading
            import time as time_lib

            def killer():
                time_lib.sleep(args.kill_replica_after)
                proc = fleet.supervisor.proc("replica-0")
                if proc is not None and proc.poll() is None:
                    log(f"[fleet] chaos: SIGKILL replica-0 "
                        f"(pid {proc.pid})")
                    os.kill(proc.pid, signal.SIGKILL)

            threading.Thread(target=killer, daemon=True).start()
        classes = ([{"name": "interactive", "slo_ms": args.slo_ms},
                    {"name": "bulk", "slo_ms": None}]
                   if args.slo_ms is not None else None)
        row = run_fleet_closed_loop(
            fleet, args.clients, args.requests_per_client,
            vocab_size=args.vocab,
            prompt_lens=tuple(args.prompt_lens),
            max_new=tuple(args.max_new), seed=args.seed,
            classes=classes)
        row["replicas"] = args.replicas
        row["tp"] = args.tp
        row["supervisor_events"] = [
            {k: e[k] for k in ("event", "child", "incarnation")
             if k in e} for e in fleet.events]
        if ap_obj is not None:
            row["autopilot"] = ap_obj.summary()
            row["decisions"] = ap_obj.decisions
            row["per_generation_completed"] = \
                fleet.router.per_generation_completed()
        print(json.dumps(row, indent=None if args.json else 2))
        return 0
    finally:
        fleet.close()


if __name__ == "__main__":
    sys.exit(main())
