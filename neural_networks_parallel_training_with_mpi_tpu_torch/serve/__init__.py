"""Serving: paged KV cache + continuous batching, and the fleet over it.

* :mod:`serve.paged_kv` — block-allocated KV pools with per-stream block
  tables, chunked prefill, batched decode, prefix caching with
  copy-on-write, and the prefill -> decode block handoff; attention
  behind the ``attn_impl`` seam (``gathered``: plain PyTorch, ``fused``:
  the CUDA paged-attention kernel).
* :mod:`serve.scheduler` — bounded queue, per-tick admit/prefill/decode/
  retire, SLO-aware eviction, the prefill/decode roles, serving
  telemetry and tracing, and the fleet surface (load report, drain).
* :mod:`serve.loadgen` — closed-loop load generators (one scheduler, or
  a fleet router) measuring tokens/s and TTFT/ITL percentiles against
  offered load.
* :mod:`serve.fleet` — the router over in-process, tensor-parallel and
  subprocess replicas, its request and handoff ledgers, the worker
  process and ``launch_fleet`` under ``train.resilience.GroupSupervisor``;
  :mod:`serve.wal` its write-ahead ledger.
* :mod:`serve.autopilot` — the control loop over a fleet (autoscaling,
  rollouts with a canary judge, preemption backfill, health eviction),
  ticked from ``Fleet.pump``, and the weight snapshots a rollout pushes
  and a worker's ``--ckpt`` reads.
* :mod:`serve.ctrlplane_driver` — the killable process that runs a
  WAL-backed fleet under load (what ``router_kill``/``fleet_kill`` hit).
"""

from .loadgen import (
    MIXES,
    make_requests,
    prewarm,
    resolve_mix,
    run_closed_loop,
    run_fleet_closed_loop,
    sweep_loads,
)
from .paged_kv import (
    ATTN_IMPLS,
    BlockAllocator,
    BlockExhausted,
    PagedDecodeServer,
    PrefixIndex,
    init_paged_kv,
    prefill_bucket,
)
from .scheduler import Request, Scheduler, ServeConfig
from .fleet import (
    Fleet,
    FleetRequest,
    FleetRouter,
    InprocReplica,
    LoadSignal,
    ProcReplica,
    TPGenerateReplica,
    launch_fleet,
    role_kind,
)
from .autopilot import (
    Autopilot,
    AutopilotConfig,
    load_weight_snapshot,
    save_weight_snapshot,
)

__all__ = ["ATTN_IMPLS", "Autopilot", "AutopilotConfig", "BlockAllocator",
           "BlockExhausted", "Fleet",
           "FleetRequest", "FleetRouter", "InprocReplica", "LoadSignal",
           "MIXES", "PagedDecodeServer", "PrefixIndex", "ProcReplica",
           "Request", "Scheduler", "ServeConfig", "TPGenerateReplica",
           "init_paged_kv", "launch_fleet", "load_weight_snapshot",
           "make_requests", "prefill_bucket", "prewarm", "resolve_mix",
           "role_kind", "run_closed_loop", "run_fleet_closed_loop",
           "save_weight_snapshot", "sweep_loads"]
