"""Training telemetry: on-device step metrics, flight recorder, MFU
accounting, and the run-health heartbeat.

The port's own copy of the JAX package's ``train/telemetry.py``; its
records, files and names are JAX's, so ``tools/metrics_summary.py``,
``tools/obs_agg.py`` and the supervisor read the port's directories
unchanged.  Four pillars:

1. **On-device step metrics** — the train steps return a small metrics
   dict next to the loss (``parallel.data_parallel.make_train_step(...,
   with_metrics=True)``): global grad norm, param norm, update/param
   ratio, and the skip guard's CUMULATIVE rejection counter, all device
   tensors computed inside the step (under a CUDA graph, static output
   buffers written in place).  The grad norm is the guard's own norm
   (``Optimizer.update_with_norm``): one norm pass, not two.  The update
   norm is recorded by the update itself (its ``deltas`` list in
   ``ops.optim``), (new - old) taken where both are alive, and the update math is untouched, so params are
   bitwise equal with metrics on and off.  The host reads the
   metrics at lag 2: each dispatch's values are copied, without a sync,
   into a pinned host buffer behind a CUDA event, and that buffer is
   read only once the next dispatch is queued.
2. **Flight recorder** — a bounded ring of the last N step records and
   events (skips, rollbacks, faults), dumped as ``postmortem.json`` on
   crash (an unhandled exception or an injected ``crash`` fault),
   rollback, anomaly abort (exit 44), hang (the watchdog) and SIGTERM, so
   a relaunch log can point at WHAT the run was doing when it died
   (``train.resilience.supervise`` prints the pointer).
3. **MFU / FLOPs accounting** — analytic per-step matmul FLOPs from the
   model (``fwd_flops``: MLP, Transformer incl. attention and the LM
   head, GQA- and SwiGLU-aware) over the peak-FLOPs table below.  On the
   host the "peak" is a NOMINAL 100 GFLOP/s per device
   (``NNPT_PEAK_FLOPS`` overrides), so the metric stays a comparable
   time series everywhere.
4. **Run-health heartbeat** — a leader-written, atomically replaced
   ``heartbeat-<role>-p<P>.json`` (step, dispatch timestamp, steps/sec
   EMA, last metrics) refreshed per dispatch (throttled to
   ``_HEARTBEAT_MIN_INTERVAL_S``), watched by
   ``train.resilience.supervise`` (a wedged child is killed and retried
   as exit 42) and rendered by ``tools/metrics_summary.py``.

Layout under ``--telemetry_dir``::

    metrics.jsonl     per-step records (step, loss, grad_norm, param_norm,
                      update_ratio, skipped, step_time_ms, samples/sec, mfu)
                      plus kind="rollup" sketch snapshots (serialized
                      utils/sketches.py state on the --rollup_every
                      cadence, merged fleet-wide by tools/obs_agg.py)
                      and kind="alert" records (EMA z-score anomalies on
                      loss/grad_norm/samples-per-sec; observe-and-
                      annotate — nothing acts on them)
    heartbeat-<role>-p<P>.json
                      freshest run-health snapshot (atomic replace), one
                      file per role ("train"/"rl"/"serve") and process —
                      two programs sharing one dir can no longer blind
                      the staleness monitor by last-writer-winning over a
                      single heartbeat.json (readers fall back from the
                      legacy shared name to the freshest qualified file)
    postmortem.json   flight-recorder dump, written on abnormal events

Everything is zero-cost when ``telemetry_dir`` is unset, and file writes
are leader-only (rank 0).  ``kind="sdc"`` records (:meth:`Telemetry.on_sdc`,
the trainer's replica-consistency incidents; ``tools/sdc_report.py``) and
``kind="topology"`` records (:meth:`Telemetry.on_topology`, an elastic
resume onto another world; ``tools/metrics_summary.py``) share the stream.
Not ported yet: the serving scheduler's records with its telemetry.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.optim import GuardedState, Optimizer, global_norm
from ..utils import goodput as goodput_lib
from ..utils.logging import is_leader, log
from ..utils.sketches import EmaZScore, ErrorBudget, Gauge, QuantileSketch
from . import trace as trace_lib

Pytree = Any

# keys every on-device metrics dict carries (the step returns exactly
# these; consumers and tests key off this tuple)
METRIC_KEYS = ("loss", "grad_norm", "param_norm", "update_ratio", "skipped")

# heartbeat writes are throttled: a dispatch-bound micro-model can run
# thousands of dispatches/sec and the heartbeat must never become the
# bottleneck it is meant to watch
_HEARTBEAT_MIN_INTERVAL_S = 0.5

# ---------------------------------------------------------------------------
# Pillar 3: FLOPs / MFU accounting (single source for bench.py + trainer)
# ---------------------------------------------------------------------------

# Peak dense bf16 FLOPs/s per device by device-name substring: NVIDIA's
# H100 data sheet, dense BF16 tensor-core rates (H100 SXM5: 989 TFLOP/s;
# H100 PCIe: 756 TFLOP/s).  The PCIe row sits before the generic one.
PEAK_FLOPS = (
    ("h100 pcie", 756e12), ("h100", 989e12),
)

# Nominal per-device peak used for the CPU fallback so the telemetry
# stream's ``mfu`` stays a well-defined relative time-series on any
# backend.  Overridable for exotic hosts via the env var.
NOMINAL_CPU_PEAK_FLOPS = 1e11
PEAK_ENV_VAR = "NNPT_PEAK_FLOPS"


def peak_flops_per_chip(device_kind: str) -> Optional[float]:
    """Accelerator peak dense bf16 FLOPs/s by device-name substring, or
    None for kinds the table does not know (e.g. a CPU host)."""
    kind = (device_kind or "").lower()
    for key, val in PEAK_FLOPS:
        if key in kind:
            return val
    return None


def telemetry_peak_flops(device_kind: str, platform: str) -> float:
    """The MFU denominator for the telemetry stream: the real chip peak
    where known, else the documented nominal CPU peak (env-overridable) —
    never None, so ``mfu`` is always present in the metrics records."""
    env = os.environ.get(PEAK_ENV_VAR)
    if env:
        return float(env)
    if platform not in ("cpu",):
        peak = peak_flops_per_chip(device_kind)
        if peak is not None:
            return peak
    return NOMINAL_CPU_PEAK_FLOPS


def train_step_flops(model, batch_shape: Tuple[int, ...]) -> Optional[float]:
    """Analytic matmul FLOPs of ONE optimizer step on a batch of
    ``batch_shape``: forward + ~2x forward for the backward (the standard
    convention).  None for unaccounted architectures.  Accounting lives on
    the models themselves (``fwd_flops`` — the transformer counts qkv/
    out/FFN/attention scores+values and the LM head, honoring GQA's
    narrower qkv projection and SwiGLU's gate matmul; ``ce_chunk`` only
    changes peak memory, never the math)."""
    fwd_flops = getattr(model, "fwd_flops", None)
    fwd = None if fwd_flops is None else fwd_flops(tuple(batch_shape))
    return None if fwd is None else 3.0 * fwd


# ---------------------------------------------------------------------------
# Pillar 1: the on-device metrics (called INSIDE the train steps)
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_with_metrics(optimizer: Optimizer, grads: Pytree,
                        opt_state: Pytree, params: Pytree,
                        loss: torch.Tensor
                        ) -> Tuple[Pytree, Pytree, Dict[str, torch.Tensor],
                                   Optional[torch.Tensor]]:
    """Apply the update AND compute the metrics in one pass, PROVIDED
    ``grads`` are fully reduced (every rank holds the identical full
    gradient; the guard's precondition).  Returns (params, opt state,
    metrics, the guard's ``ok`` or None).

    The global grad norm is computed once here and handed to the guard
    via ``Optimizer.update_with_norm`` when the optimizer is guarded —
    the guard then skips its own reduction, so metrics + guard together
    cost ONE norm pass.  The update norm is recorded by the update itself
    (its ``deltas`` list), which writes the bits it writes unrecorded: params are bitwise equal with telemetry on and off."""
    gnorm = global_norm(grads)
    ok, deltas = None, []
    if optimizer.update_with_norm is not None:
        new_params, new_opt, ok = optimizer.update_with_norm(
            grads, opt_state, params, gnorm, deltas=deltas)
    else:
        new_params, new_opt = optimizer.update(grads, opt_state, params,
                                               deltas=deltas)
    return new_params, new_opt, metrics_vector(
        loss, gnorm, new_params, _norm_of(deltas), new_opt), ok


def _norm_of(norms) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(list(norms))).float()


def metrics_vector(loss: torch.Tensor, grad_norm: torch.Tensor,
                   new_params: Pytree, update_norm: torch.Tensor,
                   new_opt: Pytree) -> Dict[str, torch.Tensor]:
    """Assemble the ``METRIC_KEYS`` dict from an already-applied update —
    the single construction point shared by :func:`update_with_metrics`
    (the replicated path, whole-tree grad norm) and the sharded-update
    paths (``parallel.update_sharding``/zero1: the grad norm from the
    scattered shards' squares, and the update norm from the update's
    slices, summed over the data ranks).  ``new_params`` is the FULL
    tree (after the all-gather), so the param norm is local math,
    identical on every replica; ``update_norm`` is ||new - old||."""
    pnorm = global_norm(new_params)
    if isinstance(new_opt, GuardedState):
        # CUMULATIVE rejections, not a per-step delta: the host samples
        # the stream (metrics_every, and k>1 dispatches report only their
        # last step), and a sampled cumulative counter cannot lose fires
        # that happened between samples — the host differences it
        skipped = new_opt.skipped.float()
    else:
        skipped = torch.zeros((), dtype=torch.float32, device=pnorm.device)
    return {
        "loss": loss.float(),
        "grad_norm": grad_norm,
        "param_norm": pnorm,
        "update_ratio": update_norm / torch.clamp(pnorm, min=1e-12),
        "skipped": skipped,
    }


# ---------------------------------------------------------------------------
# Pillar 2: flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of the last N step records + events; dumps
    ``postmortem.json`` on abnormal events.  Recording is cheap (deque
    append of small dicts); dumping is leader-only."""

    def __init__(self, size: int, path: Optional[str]):
        self.size = int(size)
        self.path = path
        self.records: collections.deque = collections.deque(
            maxlen=max(1, self.size))
        self.enabled = bool(path) and self.size > 0
        self.dumps = 0
        self._pending_reason: Optional[str] = None

    def record(self, rec: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        self.records.append(rec)
        if self._pending_reason is not None and rec.get("kind") == "step":
            # a dump armed by an event (rollback) waits for one post-event
            # step record so the postmortem's tail STRADDLES the event
            reason, self._pending_reason = self._pending_reason, None
            self.dump(reason)

    def event(self, kind: str, step: int, **detail) -> None:
        self.record({"kind": "event", "event": kind, "step": int(step),
                     "t_unix": round(time.time(), 3), **detail})

    def arm_dump(self, reason: str) -> None:
        """Dump after the NEXT step record lands (straddling dump); if no
        further record ever lands, close()/abnormal-exit dumps instead."""
        self._pending_reason = reason

    def dump(self, reason: str) -> Optional[str]:
        if not (self.enabled and is_leader()):
            return None
        self._pending_reason = None
        doc = {
            "reason": reason,
            "written_unix": round(time.time(), 3),
            "written_iso": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
            "n_records": len(self.records),
            "records": list(self.records),
        }
        # per-device memory AT DEATH: the number an OOM/hang postmortem
        # is usually missing (best-effort — the runtime may be gone)
        mem = device_memory_summary(full=True)
        if mem:
            doc["device_memory"] = mem
        _atomic_write_json(self.path, doc)
        self.dumps += 1
        log(f"[telemetry] postmortem ({reason}) -> {self.path}")
        return self.path


# ---------------------------------------------------------------------------
# Pillar 4: heartbeat
# ---------------------------------------------------------------------------

def device_memory_summary(full: bool = False) -> Optional[Dict[str, Any]]:
    """Per-device memory snapshot for the heartbeat (compact: live +
    peak bytes) and the flight-recorder postmortem (``full=True``:
    everything the backend reports) — so an OOM/hang postmortem shows
    per-device memory at death.  None where no card is initialised (the
    host) or the runtime is already too broken to answer."""
    try:
        from ..utils.profiling import device_memory_stats

        stats = device_memory_stats()
    except Exception:
        return None
    if not stats:
        return None
    if full:
        return stats
    return {dev: {k: v for k, v in s.items()
                  if k in ("bytes_in_use", "peak_bytes_in_use")}
            for dev, s in stats.items()}


def _atomic_write_json(path: str, doc: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp, path)  # readers never observe a torn file


def heartbeat_filename(role: str, process_id: Optional[int] = None) -> str:
    """Per-role/per-process heartbeat file name:
    ``heartbeat-<role>-p<P>.json``.  Two programs sharing one
    ``--telemetry_dir`` (a trainer and a serving replica, or two
    serving replicas with distinct ``NNPT_PROCESS_ID``) used to
    last-writer-win over ONE ``heartbeat.json``, blinding the
    supervisor's staleness monitor to whichever wrote second; now each
    writer owns its file and generic readers (``read_heartbeat``,
    tools/metrics_summary.py, tools/obs_agg.py) fall back from the
    legacy shared name to the freshest qualified one — while the
    supervisor's hang monitor watches exactly its child's file.
    Delegates to the stdlib-only ``resilience.heartbeat_filename``
    (the naming's single source), with the process id resolved through
    ``trace.run_identity`` so the process-group rank fallback applies."""
    if process_id is None:
        process_id = trace_lib.run_identity()["process_id"]
    from .resilience import heartbeat_filename as _hb_name

    return _hb_name(role, process_id)


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    """Load a heartbeat document.  Back-compat: when ``path`` is the
    legacy shared ``heartbeat.json`` (or a telemetry dir) and only
    role-qualified files exist, the FRESHEST of those is returned —
    callers keyed to the old layout keep working against per-role
    writers."""
    from .resilience import find_heartbeats

    candidates = [path] if os.path.isfile(path) else (
        find_heartbeats(path if os.path.isdir(path)
                        else os.path.dirname(path) or "."))
    best: Optional[Dict[str, Any]] = None
    best_m = None
    for p in candidates:
        try:
            m = os.stat(p).st_mtime
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if best_m is None or m > best_m:
            best, best_m = doc, m
    return best


# staleness helper lives in resilience (stdlib-only, so the supervisor
# never imports this torch-importing module); canonical re-export
from .resilience import heartbeat_age_s  # noqa: E402


class Heartbeat:
    """Leader-written run-health snapshot, refreshed per dispatch
    (throttled) with NO device sync — everything in it is host state."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.enabled = bool(path) and is_leader()
        self._last_write = 0.0
        self._final = False
        self.last_step = 0  # newest step ever beaten (alive() reuses it)
        self.ema_steps_per_sec: Optional[float] = None

    def beat(self, step: Optional[int], last_metrics: Optional[Dict[str, Any]],
             force: bool = False, final: bool = False, **extra) -> None:
        """``step=None`` (the out-of-loop ``alive()`` beats) reuses the
        newest step already beaten — checkpoint/eval phases must never
        rewrite the step backwards.  Once the FINAL beat is written,
        later non-final beats only refresh the file's mtime (the
        staleness signal) and leave the final content intact."""
        if not self.enabled:
            return
        now = time.time()
        if not force and now - self._last_write < _HEARTBEAT_MIN_INTERVAL_S:
            return
        self._last_write = now
        if self._final and not final:
            try:
                os.utime(self.path)  # fresh, but the final record stands
            except OSError:
                pass
            return
        step = self.last_step if step is None else int(step)
        self.last_step = step  # plain assignment: a rollback rewinds it
        self._final = self._final or final
        doc = {
            "step": step,
            "t_unix": round(now, 3),
            "t_iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now)),
            "pid": os.getpid(),
            "steps_per_sec_ema": self.ema_steps_per_sec,
            "last_metrics": last_metrics,
            **extra,
        }
        # per-device live/peak memory where the backend reports it —
        # writes are already throttled, so this stays off the hot path
        mem = device_memory_summary()
        if mem:
            doc["device_memory"] = mem
        if final:
            doc["final"] = True
        _atomic_write_json(self.path, doc)

    def observe_rate(self, inst_steps_per_sec: float) -> None:
        e = self.ema_steps_per_sec
        self.ema_steps_per_sec = (inst_steps_per_sec if e is None
                                  else 0.9 * e + 0.1 * inst_steps_per_sec)


# ---------------------------------------------------------------------------
# The orchestrating object the Trainer drives
# ---------------------------------------------------------------------------

# process-global active telemetry, so out-of-band failure paths (the
# injected ``crash`` fault's pre-_exit hook, the hang watchdog's timeout
# callback) can dump the flight recorder without threading a reference
_ACTIVE: Optional["Telemetry"] = None


def emergency_dump(reason: str) -> Optional[str]:
    """Best-effort postmortem dump from wherever the process is dying
    (utils.faults' injected crash, the watchdog's hang handler).

    Deliberately does NOT drain the lag queue: on the hang path the queued
    copies are exactly what is stuck, and an event wait here would
    block the watchdog's exit forever.  The dump carries what was already
    fetched — which under the lag-2 discipline is everything up to ~2
    dispatches before the stall."""
    t = _ACTIVE
    if t is None or not t.enabled:
        return None
    try:
        t.recorder.event(
            "emergency", t._newest_step(),
            detail=reason, unfetched_dispatches=len(t._queue))
        return t.recorder.dump(reason)
    except Exception:
        return None


class Telemetry:
    """Per-run telemetry: owns the lag-2 fetch queue, the metrics
    JSONL, the heartbeat and the flight recorder.  All methods are no-ops
    when ``telemetry_dir`` is unset."""

    def __init__(self, cfg, model, feature_shape: Tuple[int, ...],
                 n_devices: int, device_kind: str, platform: str):
        """``device_kind`` is the card's name (``torch.cuda.
        get_device_name``) and ``platform`` the device type (``"cuda"``
        or ``"cpu"``).  Every metrics record is ``kind="step"`` and the
        heartbeat and rollups carry the role ``"train"``, as the JAX
        trainer's do."""
        global _ACTIVE

        self.enabled = bool(cfg.telemetry_dir)
        self.dir = cfg.telemetry_dir
        self.kind = "step"
        self.role = "train"
        self.metrics_every = max(0, int(cfg.metrics_every))
        self.rollup_every = max(0, int(getattr(cfg, "rollup_every", 0)))
        self.alerts_enabled = bool(getattr(cfg, "alerts", True))
        # (step, epoch, keys, host values, event, n_steps, rows, t, t)
        self._queue: List[tuple] = []
        self._pinned: List[torch.Tensor] = []   # host buffers, round robin
        self._n_copies = 0
        self._last_t: Optional[float] = None
        self.last_record: Optional[Dict[str, Any]] = None
        self.skipped_total = 0        # newest observed cumulative counter
        self._resync_skips = False    # set on rollback: counter rewound
        self.alerts_fired = 0
        self.rollups_written = 0
        # streaming SLO sketches (utils/sketches.py): cumulative per
        # incarnation, snapshotted into kind="rollup" records so
        # tools/obs_agg.py can merge fleet percentiles without raw
        # samples.  Detectors are the kind="alert" sources: loss /
        # grad-norm spikes (EMA z above) and throughput collapse (below)
        self._sketches = {k: QuantileSketch() for k in (
            "loss", "grad_norm", "step_time_ms", "samples_per_sec",
            "mfu")}
        self._gauges = {k: Gauge() for k in ("steps_per_sec", "mfu")}
        self._detectors = {
            "loss": EmaZScore("loss", direction="above"),
            "grad_norm": EmaZScore("grad_norm", direction="above"),
            "samples_per_sec": EmaZScore("samples_per_sec",
                                         direction="below"),
        }
        self._records_seen = 0
        self._last_rollup_step = 0
        if not self.enabled:
            self.recorder = FlightRecorder(0, None)
            self.heartbeat = Heartbeat(None)
            self._jsonl = None
            self.goodput_meter = None
            self._goodput_budget = None
            return
        if is_leader():
            os.makedirs(self.dir, exist_ok=True)
        self.metrics_path = os.path.join(self.dir, "metrics.jsonl")
        self.heartbeat_path = os.path.join(self.dir,
                                           heartbeat_filename(self.role))
        self.postmortem_path = os.path.join(self.dir, "postmortem.json")
        self.recorder = FlightRecorder(int(cfg.flight_recorder),
                                       self.postmortem_path)
        self.heartbeat = Heartbeat(self.heartbeat_path)
        self._jsonl = (open(self.metrics_path, "a")
                       if is_leader() else None)
        self._t0 = time.perf_counter()
        # per-ROW step FLOPs (every accounted model is linear in batch),
        # so per-dispatch FLOPs = rows * this
        self.flops_per_row = train_step_flops(model, (1,) + tuple(
            feature_shape))
        self.peak_total = (telemetry_peak_flops(device_kind, platform)
                           * max(1, n_devices))
        # goodput accounting (utils/goodput.py): an online meter riding
        # the trace span-listener seam, snapshotted as kind="goodput"
        # records on the rollup cadence, with per-step anatomy joined
        # from the compile ledger's capture flops.  --no-goodput
        # disables (the bench's A/B arm); no tracer installed = the
        # meter just never hears a span and reports idle.
        self.peak_bw_total = (goodput_lib.peak_bytes_per_s(
            device_kind, platform) * max(1, n_devices))
        self.goodput_meter: Optional[goodput_lib.GoodputMeter] = None
        self._goodput_budget: Optional[ErrorBudget] = None
        self._goodput_frac_min = float(getattr(cfg, "goodput_target", 0.5))
        self._goodput_prev: Optional[Tuple[int, Dict[str, Any]]] = None
        if bool(getattr(cfg, "goodput", True)):
            self.goodput_meter = goodput_lib.GoodputMeter()
            trace_lib.add_listener(self.goodput_meter.on_span)
            if self.alerts_enabled:
                # attainment SLO: >= 90% of rollup windows should meet
                # the goodput-fraction floor; sustained misses burn the
                # budget at >= 2x and fire goodput_burn_rate
                self._goodput_budget = ErrorBudget(
                    "goodput", target=0.9,
                    window=50, min_events=5, cooldown=10)
        _ACTIVE = self

    # ---- hot path --------------------------------------------------------

    def on_dispatch(self, step: int, epoch: int, before: int, out,
                    n_steps: int, rows: int) -> None:
        """Called once per dispatch, right after submission.  ``out`` is
        the dispatch's output: the on-device metrics dict when the step
        carries metrics, else the bare loss tensor.  Its values are
        stacked and copied without a sync into a pinned host buffer
        behind a CUDA event; the buffer is read at lag 2 (the monitor's
        discipline): the event waited on is always one whose successor
        dispatch is already queued, so one dispatch stays in flight."""
        if not self.enabled:
            return
        now = time.perf_counter()
        if self._last_t is not None and now > self._last_t:
            self.heartbeat.observe_rate(n_steps / (now - self._last_t))
        crossed = (self.metrics_every > 0 and
                   step // self.metrics_every > before // self.metrics_every)
        if crossed:
            keys, host, event = self._stage(out)
            self._queue.append((step, epoch, keys, host, event, n_steps,
                                rows, self._last_t, now))
            if len(self._queue) >= 2:
                # the popped entry's successor is already queued, so its
                # event wait never drains the card
                self._fetch(self._queue.pop(0))
        self._last_t = now
        self.heartbeat.beat(step, self.last_record,
                            skipped_total=self.skipped_total)

    def _stage(self, out):
        """(keys, host tensor, CUDA event or None): ``out``'s values as one
        f32 vector, copied to the host without a sync on the card."""
        if isinstance(out, dict):
            keys = tuple(out)
            vec = torch.stack([out[k].detach().float().reshape(())
                               for k in keys])
        else:
            keys = None
            vec = out.detach().float().reshape(1)
        if vec.device.type != "cuda":
            return keys, vec.clone(), None
        # three buffers: at most two entries wait in the queue, and the
        # third is the one being filled
        if not self._pinned or self._pinned[0].numel() != vec.numel():
            self._pinned = [torch.empty(vec.numel(), dtype=torch.float32,
                                        pin_memory=True) for _ in range(3)]
        host = self._pinned[self._n_copies % len(self._pinned)]
        self._n_copies += 1
        host.copy_(vec, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return keys, host, event

    def _fetch(self, entry) -> None:
        step, epoch, keys, host, event, n_steps, rows, t_prev, t_disp = entry
        with trace_lib.span("fetch", what="metrics", step=int(step)):
            if event is not None:
                event.synchronize()
            vals = host.tolist()
        if keys is not None:
            rec = dict(zip(keys, (float(v) for v in vals)))
        else:
            rec = {"loss": float(vals[0])}
        rec.update(step=int(step), epoch=int(epoch),
                   kind=self.kind,
                   t=round(time.perf_counter() - self._t0, 6))
        if t_prev is not None and t_disp > t_prev:
            dt = (t_disp - t_prev) / max(1, n_steps)  # dispatch-to-dispatch
            rec["step_time_ms"] = round(dt * 1e3, 4)
            rec["samples_per_sec"] = round(rows / (t_disp - t_prev), 2)
            if self.flops_per_row is not None:
                rows_per_step = rows / max(1, n_steps)
                rec["mfu"] = (self.flops_per_row * rows_per_step / dt
                              / self.peak_total)
        if "skipped" in rec:
            # 'skipped' is the guard's cumulative rejection counter;
            # difference it against the last observed value so fires
            # between sampled records (metrics_every > 1, mid-dispatch
            # steps of a k>1 dispatch) surface too.  A rollback restores
            # an OLDER counter — resync the watermark without an event.
            cum = int(rec["skipped"])
            if self._resync_skips or cum < self.skipped_total:
                self._resync_skips = False
            elif cum > self.skipped_total:
                self.recorder.event("skip", step,
                                    fires=cum - self.skipped_total,
                                    grad_norm=rec.get("grad_norm"))
            self.skipped_total = cum
        self.last_record = rec
        self.recorder.record(rec)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        self._observe(rec, step)

    # ---- streaming sketches, rollups, alerts -----------------------------

    def _observe(self, rec: Dict[str, Any], step: int) -> None:
        """Feed the fetched record into the sketch layer + anomaly
        detectors and emit rollup/alert records on their cadences.
        Host-side arithmetic on already-fetched floats — nothing here
        touches a device."""
        self._records_seen += 1
        for key, sketch in self._sketches.items():
            v = rec.get(key)
            if isinstance(v, (int, float)):
                sketch.add(v)
        ema = self.heartbeat.ema_steps_per_sec
        if ema is not None:
            self._gauges["steps_per_sec"].set(ema)
        if isinstance(rec.get("mfu"), (int, float)):
            self._gauges["mfu"].set(rec["mfu"])
        if self.alerts_enabled:
            for key, det in self._detectors.items():
                v = rec.get(key)
                if isinstance(v, (int, float)):
                    alert = det.observe(v, step=step)
                    if alert:
                        self._emit_alert(alert, step)
        if (self.rollup_every > 0
                and (step // self.rollup_every
                     > self._last_rollup_step // self.rollup_every)):
            self._last_rollup_step = step
            self._write_rollup(step)

    def _emit_alert(self, alert: Dict[str, Any], step: int) -> None:
        """One ``kind="alert"`` record into the metrics stream + a
        flight-recorder event.  Observe-and-annotate only: nothing here
        feeds back into training decisions — the supervisor logs these
        next to its relaunch reasoning, and the rollback/abort policy
        stays ``ResilienceMonitor``'s."""
        self.alerts_fired += 1
        rec = {"kind": "alert", "role": self.role, "step": int(step),
               "t": round(time.perf_counter() - self._t0, 6),
               "t_unix": round(time.time(), 3), **alert}
        self.recorder.event("alert", step, alert=alert.get("alert"),
                            value=alert.get("value"), z=alert.get("z"))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        log(f"[telemetry] ALERT {alert.get('alert')} at step {step} "
            f"(value {alert.get('value')})")

    def _write_rollup(self, step: int) -> None:
        """Snapshot the SERIALIZED sketch state (not point stats) as a
        ``kind="rollup"`` record, stamped with the (process, run,
        incarnation) identity so ``tools/obs_agg.py`` can pick the
        newest snapshot per writer and merge fleet percentiles.
        Sketches are cumulative over this incarnation — the aggregator
        takes the latest record per identity, never a sum of
        records."""
        if self._jsonl is None:
            return
        ident = trace_lib.run_identity()
        rec = {
            "kind": "rollup", "role": self.role, "step": int(step),
            "t": round(time.perf_counter() - self._t0, 6),
            "t_unix": round(time.time(), 3),
            "p": ident["process_id"], "run": ident["run_id"],
            "inc": ident["incarnation"],
            "sketches": {k: s.to_dict()
                         for k, s in self._sketches.items() if s.n},
            "counters": {"metrics_records": self._records_seen,
                         "skipped_total": int(self.skipped_total),
                         "alerts": self.alerts_fired},
            "gauges": {k: g.to_dict() for k, g in self._gauges.items()
                       if g.last is not None},
        }
        self.rollups_written += 1
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        self._write_goodput(step, ident)

    def _step_anatomy(self) -> Optional[Dict[str, Any]]:
        """Join the compile ledger's capture cost (analytic flops; the
        port records no bytes) with the measured step time
        and the meter's host-span seconds into a roofline position +
        MFU-gap breakdown.  None when any leg of the join is missing
        (no ledger, no captured program — an eager step records no
        cost — or no measured step yet)."""
        from ..utils import compile_ledger

        led = compile_ledger.active()
        last = self.last_record or {}
        step_ms = last.get("step_time_ms")
        if led is None or not isinstance(step_ms, (int, float)):
            return None
        flops = by = None
        for e in reversed(led.events):
            if e.get("flops"):
                flops, by = e.get("flops"), e.get("bytes_accessed")
                break
        if not flops:
            return None
        # host cost per step: the meter's dispatch/load/fetch span
        # seconds differenced over the steps since the last rollup
        host_s = 0.0
        if self.goodput_meter is not None and self._goodput_prev:
            prev_step, prev_host = self._goodput_prev
            cur = self.goodput_meter.snapshot()["host_seconds"]
            dsteps = max(1, self._last_rollup_step - prev_step)
            host_s = max(0.0, sum(cur.values())
                         - sum(prev_host.values())) / dsteps
        return goodput_lib.step_anatomy(
            flops=flops, bytes_accessed=by, step_s=float(step_ms) / 1e3,
            host_s=host_s, peak_flops=self.peak_total,
            peak_bw=self.peak_bw_total)

    def _write_goodput(self, step: int, ident: Dict[str, Any]) -> None:
        """One ``kind="goodput"`` record next to each rollup: cumulative
        per-category seconds (the aggregator takes the newest per
        identity, like the sketches), plus the step anatomy.  The burn
        alert reuses the sketches' ErrorBudget: each rollup whose goodput
        fraction is under ``--goodput_target`` consumes error budget."""
        if self.goodput_meter is None or self._jsonl is None:
            return
        snap = self.goodput_meter.snapshot()
        anatomy = self._step_anatomy()
        rec = goodput_lib.goodput_record(snap, role=self.role,
                                         step=step, ident=ident,
                                         anatomy=anatomy)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        self._goodput_prev = (int(step), snap["host_seconds"])
        # no spans heard = tracing is off: the meter sees only idle and
        # a burn alert would be noise, not signal
        if self._goodput_budget is not None and snap["spans"] > 0:
            frac = snap["goodput_fraction"] or 0.0
            alert = self._goodput_budget.observe(
                frac < self._goodput_frac_min)
            if alert:
                self._emit_alert(
                    {**alert, "goodput_fraction": frac,
                     "goodput_target": self._goodput_frac_min}, step)

    # ---- events ----------------------------------------------------------

    def on_rollback(self, step: int, rollbacks: int) -> None:
        """Flush in-flight records (they belong to the abandoned timeline
        but really executed), log the event, dump now AND arm a second
        dump after the next step record so the postmortem's tail straddles
        the rollback."""
        if not self.enabled:
            return
        self.flush(final=False)
        self.recorder.event("rollback", step, rollbacks=rollbacks)
        self.recorder.dump("rollback")
        self.recorder.arm_dump("rollback")
        self._last_t = None  # the restore stall is not a step time
        # the restored GuardedState carries an older cumulative skip
        # counter; resync the watermark at the next record, no event
        self._resync_skips = True
        # alive() beats between the rollback and the next dispatch must
        # report the restored step, not the abandoned timeline's
        self.heartbeat.last_step = int(step)

    def on_sdc(self, record: Dict[str, Any]) -> None:
        """A silent-data-corruption incident (the trainer's fingerprint
        check): the full record into the stream (``kind="sdc"``), an
        ``sdc`` flight-recorder event and a postmortem now, re-dumped
        after the next step record so its tail shows whether the run
        kept training past the incident."""
        if not self.enabled:
            return
        rec = {"kind": "sdc",
               "t": round(time.perf_counter() - self._t0, 6), **record}
        self.recorder.event(
            "sdc", int(record.get("step", -1)),
            verdict=record.get("verdict"), action=record.get("action"),
            leaves=record.get("leaves"), devices=record.get("devices"))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        self.recorder.dump("sdc")
        self.recorder.arm_dump("sdc")

    def on_topology(self, step: int, change: Dict[str, Any]) -> None:
        """An elastic resume onto another world than the snapshot's: not a
        failure (no postmortem), but the moment the batch or accumulation
        may have changed: a ``kind="topology"`` record and a flight-
        recorder event."""
        if not self.enabled:
            return
        rec = {"kind": "topology", "step": int(step),
               "t": round(time.perf_counter() - self._t0, 6), **change}
        self.recorder.event(
            "topology", int(step),
            from_devices=(change.get("from_world") or {}).get("n_devices"),
            to_devices=(change.get("to_world") or {}).get("n_devices"),
            policy=change.get("policy"),
            batch_size=change.get("batch_size"),
            accum_steps=change.get("accum_steps"))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def on_abnormal_exit(self, exc: BaseException) -> None:
        from .resilience import AnomalyAbort

        if not self.enabled:
            return
        reason = ("anomaly_abort" if isinstance(exc, AnomalyAbort)
                  else f"crash: {type(exc).__name__}: {exc}")
        self.recorder.event("abort" if isinstance(exc, AnomalyAbort)
                            else "crash", self._newest_step(), detail=str(exc))
        try:
            # device-side crashes poison the queued futures: draining
            # them re-raises.  This runs inside fit's finally, where a
            # second raise would MASK the original exception and skip the
            # dump — swallow it; the dump below carries what was fetched.
            self.flush(final=False)
        except Exception:
            pass
        self.recorder.dump(reason)

    def on_preempted(self, signum: int, step: int) -> None:
        if not self.enabled:
            return
        self.recorder.event("sigterm", step, signum=signum)
        self.recorder.dump(f"sigterm (signal {signum})")

    def _newest_step(self) -> int:
        if self._queue:
            return int(self._queue[-1][0])
        return int((self.last_record or {}).get("step", -1))

    def alive(self) -> None:
        """Refresh the heartbeat OUTSIDE the dispatch loop — long
        host-side phases (checkpoint writes, eval passes) emit no
        dispatches, and without these beats the supervisor's external
        stale-heartbeat monitor would kill a healthy run in its tail.
        Throttled like every beat; ``step=None`` keeps the newest step
        already beaten (never rewrites it backwards)."""
        if self.enabled:
            self.heartbeat.beat(None, self.last_record,
                                skipped_total=self.skipped_total)

    # ---- lifecycle -------------------------------------------------------

    def flush(self, final: bool = True, step: Optional[int] = None) -> None:
        """Drain the lag queue (safe: by the time flush runs, the futures
        are either complete or about to be blocked on anyway).  ``step``:
        the trainer's global step for the final heartbeat — needed in the
        heartbeat-only mode (``metrics_every=0``) where no record ever
        carries one."""
        if not self.enabled:
            return
        while self._queue:
            self._fetch(self._queue.pop(0))
        if final:
            if step is None:
                step = int((self.last_record or {}).get("step", 0))
            if self.rollup_every > 0 and self._records_seen:
                # terminal snapshot regardless of cadence: the
                # aggregator must see the run's complete sketches
                self._write_rollup(step)
            self.heartbeat.beat(step, self.last_record, force=True,
                                final=True,
                                skipped_total=self.skipped_total)

    def close(self) -> None:
        global _ACTIVE

        if _ACTIVE is self:
            _ACTIVE = None
        if self.goodput_meter is not None:
            trace_lib.remove_listener(self.goodput_meter.on_span)
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
