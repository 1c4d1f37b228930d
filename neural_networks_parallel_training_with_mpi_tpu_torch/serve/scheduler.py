"""Continuous-batching scheduler over the paged server: the port of the
JAX package's ``serve/scheduler.py`` service loop.

* **Bounded wait queue**: ``submit()`` enqueues FIFO up to
  ``queue_depth``; beyond that requests are rejected (counted, and the
  caller told).
* **Per-tick admit/retire**: every :meth:`Scheduler.tick` admits from the
  queue head while a slot, the prompt's blocks and the token budget
  allow, runs at most one chunked-prefill chunk, and advances all
  decoding streams one batched step.  Admission is head-of-line, so the
  queue head cannot be bypassed forever.
* **SLO-aware eviction**: every request carries a deadline
  (``t_submit + slo_ms``; none = +inf).  When the pool cannot supply a
  stream's next block, the latest-deadline stream is evicted and requeued
  at the front (arrival time and deadline kept); the earliest-deadline
  stream is never evicted while others exist, so the system drains.
* **Key counters**: attended / padded / kernel key positions per decode
  step (:meth:`snapshot`), the decode work the fused kernel skips.
* **Serving telemetry** (``telemetry_dir``): ``kind="serve"`` tick
  records and ``kind="serve_req"`` completions in ``metrics.jsonl``, the
  role-qualified heartbeat ``heartbeat-<role>-p<P>.json``; with
  ``rollup_every``, ``kind="rollup"`` quantile-sketch snapshots that
  ``tools/obs_agg.py`` merges across replicas, ``kind="goodput"`` records
  and SLO burn-rate ``kind="alert"`` records.  The records are the JAX
  package's, key for key.
* **Tracing** (``trace_dir``, or a tracer the process already runs):
  ``admit``/``prefill``/``decode``/``retire`` spans per tick, the
  ``queue_wait``/``sched_bubble`` gaps between ticks, and one flow per
  request threading admit -> prefill -> decode -> retire.
* **Roles** (``role``): ``unified`` prefills and decodes; ``prefill``
  exports each stream at the end of its prefill (:meth:`take_handoffs`
  drains the exports); ``decode`` admits exported streams through
  :meth:`inject`.  Either role serves a ``submit(..., unified=True)``
  end to end.
* **Fleet surface**: :meth:`load_report`, :meth:`tokens_at_risk`,
  :meth:`drain` and :meth:`quiesce` for a router and its workers.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional

from ..models.transformer import Transformer
from ..train import telemetry as telemetry_lib
from ..train import trace as trace_lib
from ..train.telemetry import Heartbeat
from ..utils import goodput as goodput_lib
from ..utils.platform import DeviceLike, resolve_device
from ..utils.sketches import ErrorBudget, Gauge, QuantileSketch
from .paged_kv import PagedDecodeServer

log = logging.getLogger(__name__)

ROLES = ("unified", "prefill", "decode")
# the counters a kind="serve" record carries into the rollups
_COUNTER_KEYS = ("admitted", "rejected", "evicted", "completed",
                 "tokens_out", "handed_off", "injected")


@dataclass
class ServeConfig:
    """Geometry + policy knobs of the serving runtime."""
    slots: int = 8                 # concurrent streams in the batched step
    num_blocks: int = 128          # KV pool blocks (block 0 is the sink)
    block_size: int = 16           # cache positions per block
    max_len: Optional[int] = None  # per-stream cap (default model max)
    queue_depth: int = 64          # bounded wait queue; beyond = rejected
    prefill_chunk: int = 32        # prompt positions prefilled per tick
    token_budget: int = 0          # max committed (prompt+max_new) tokens
    #                                in flight; 0 disables the gate
    default_slo_ms: Optional[float] = None  # deadline for SLO-less submits
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    kv_quant: bool = False
    attn_impl: str = "gathered"    # 'gathered' (plain PyTorch reference)
    #                                or 'fused' (the CUDA paged kernel)
    prefix_cache: bool = False     # share identical prompt-prefix blocks
    telemetry_dir: Optional[str] = None
    metrics_every: int = 25        # ticks between kind="serve" records
    # every N ticks a kind="rollup" record of serialized sketches and
    # cumulative counters; 0 = off (a final rollup still writes on close
    # when a cadence was set)
    rollup_every: int = 0
    # SLO burn-rate alerting over deadline misses (kind="alert" records;
    # observe and annotate).  Only requests with a deadline count.
    alerts: bool = True
    slo_target: float = 0.99       # SLO: fraction of deadlines met
    slo_burn_threshold: float = 2.0  # alert at >= this x budget burn
    # goodput accounting (utils/goodput.py) of the tick spans and the gap
    # spans into kind="goodput" records on the rollup cadence (needs
    # telemetry_dir)
    goodput: bool = True
    goodput_target: float = 0.5    # fraction floor for the burn alert
    # span tracing under this dir; None = ride a tracer the process
    # already runs (or off)
    trace_dir: Optional[str] = None
    completed_history: int = 1024  # completed Requests kept for stats()
    # fleet replica index: stamps rollup records and qualifies the
    # per-request flow ids, so replicas sharing a process identity never
    # collide on a merged timeline
    replica: Optional[int] = None
    # 'unified' prefills and decodes; 'prefill' exports each stream at
    # the end of its prefill (take_handoffs); 'decode' admits exports
    # (inject).  Telemetry roles: serve, serve-prefill, serve-decode.
    role: str = "unified"


@dataclass
class Request:
    """One request's lifecycle, kept after completion so load generators
    can read TTFT/ITL off it."""
    rid: int
    prompt: List[int]
    max_new: int
    t_submit: float
    deadline: float                       # t_submit + slo_ms, or +inf
    slo_ms: Optional[float] = None
    t_first: Optional[float] = None       # first output token sampled
    t_done: Optional[float] = None
    evictions: int = 0
    unified: bool = False                 # served end to end whatever the
    #                                       scheduler's role

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return (self.t_first - self.t_submit) * 1e3

    @property
    def itl_ms(self) -> Optional[float]:
        """Mean inter-token latency over the decode phase."""
        if self.t_done is None or self.t_first is None:
            return None
        return ((self.t_done - self.t_first)
                / max(1, self.max_new - 1)) * 1e3

    @property
    def deadline_missed(self) -> Optional[bool]:
        if self.t_done is None:
            return None
        return bool(math.isfinite(self.deadline)
                    and self.t_done > self.deadline)


class _ServeTelemetry:
    """``kind="serve"`` / ``"serve_req"`` records and the role-qualified
    heartbeat, plus ``kind="rollup"`` sketch snapshots, ``kind="goodput"``
    and ``kind="alert"`` records.  The sketches, counters and gauges are
    always kept (host arithmetic): :meth:`rollup_record` is the fleet
    router's load signal whether or not a ``telemetry_dir`` is set.  File
    and heartbeat IO need ``telemetry_dir``."""

    SKETCH_KEYS = ("ttft_ms", "itl_ms", "total_ms", "queue_depth",
                   "block_utilization", "tokens_per_sec")

    def __init__(self, cfg: ServeConfig):
        dirpath = cfg.telemetry_dir
        self.enabled = bool(dirpath)
        self.metrics_every = max(1, int(cfg.metrics_every))
        self.rollup_every = max(0, int(cfg.rollup_every))
        self.replica = cfg.replica
        self.role = "serve" if cfg.role == "unified" else f"serve-{cfg.role}"
        self._jsonl = None
        self.heartbeat = Heartbeat(None)
        self.alerts_fired = 0
        self.rollups_written = 0
        self._t0 = time.perf_counter()
        self._last_tokens = 0
        self._last_t = self._t0
        self._ident: Optional[Dict[str, Any]] = None
        self._sketches = {k: QuantileSketch() for k in self.SKETCH_KEYS}
        self._gauges = {k: Gauge() for k in ("tokens_per_sec",
                                             "queue_depth",
                                             "block_utilization")}
        self._counters: Dict[str, int] = {}
        self._budget = (ErrorBudget("slo", target=cfg.slo_target,
                                    burn_threshold=cfg.slo_burn_threshold)
                        if cfg.alerts else None)
        self.goodput_meter: Optional[goodput_lib.GoodputMeter] = None
        self._goodput_budget: Optional[ErrorBudget] = None
        self._goodput_frac_min = float(cfg.goodput_target)
        if not self.enabled:
            return
        if cfg.goodput:
            self.goodput_meter = goodput_lib.GoodputMeter()
            trace_lib.add_listener(self.goodput_meter.on_span)
            if cfg.alerts:
                self._goodput_budget = ErrorBudget(
                    "goodput", target=0.9, window=50, min_events=5,
                    cooldown=10)
        os.makedirs(dirpath, exist_ok=True)
        self.metrics_path = os.path.join(dirpath, "metrics.jsonl")
        self._jsonl = open(self.metrics_path, "a")
        self.heartbeat = Heartbeat(os.path.join(
            dirpath, telemetry_lib.heartbeat_filename(self.role)))

    def _write(self, rec: Dict[str, Any]) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def _ts(self) -> float:
        return round(time.perf_counter() - self._t0, 6)

    def _take_counters(self, snap: Dict[str, Any]) -> None:
        for key in _COUNTER_KEYS:
            if key in snap:
                self._counters[key] = int(snap[key])

    def on_tick(self, tick: int, snap: Dict[str, Any]) -> None:
        self._sketches["queue_depth"].add(snap["queue_depth"])
        self._sketches["block_utilization"].add(snap["block_utilization"])
        if tick % self.metrics_every:
            # the heartbeat still refreshes (throttled inside): the
            # supervisor's staleness monitor watches mtime, not records
            self.heartbeat.beat(tick, None)
            self._maybe_rollup(tick)
            return
        now = time.perf_counter()
        rec = {"kind": "serve", "step": int(tick),
               "t": round(now - self._t0, 6), **snap}
        dt = now - self._last_t
        if dt > 0:
            tps = round((snap["tokens_out"] - self._last_tokens) / dt, 2)
            rec["tokens_per_sec"] = tps
            self._sketches["tokens_per_sec"].add(tps)
            self._gauges["tokens_per_sec"].set(tps)
        self._gauges["queue_depth"].set(snap["queue_depth"])
        self._gauges["block_utilization"].set(snap["block_utilization"])
        self._take_counters(snap)
        self._last_tokens = snap["tokens_out"]
        self._last_t = now
        self._write(rec)
        self.heartbeat.beat(tick, rec)
        self._maybe_rollup(tick)

    def on_request_done(self, req: Request, n_generated: int) -> None:
        total_ms = round((req.t_done - req.t_submit) * 1e3, 3)
        ttft, itl = round(req.ttft_ms, 3), round(req.itl_ms, 3)
        self._write({
            "kind": "serve_req", "rid": req.rid, "t": self._ts(),
            "prompt_tokens": len(req.prompt),
            "new_tokens": int(n_generated),
            "ttft_ms": ttft,
            "itl_ms": itl,
            "total_ms": total_ms,
            "evictions": req.evictions,
            "deadline_missed": req.deadline_missed,
        })
        self._sketches["ttft_ms"].add(ttft)
        self._sketches["itl_ms"].add(itl)
        self._sketches["total_ms"].add(total_ms)
        self._counters["requests"] = self._counters.get("requests", 0) + 1
        if math.isfinite(req.deadline):
            # only SLO-carrying requests burn (or bank) the budget
            missed = bool(req.deadline_missed)
            self._counters["deadline_total"] = (
                self._counters.get("deadline_total", 0) + 1)
            if missed:
                self._counters["deadline_missed"] = (
                    self._counters.get("deadline_missed", 0) + 1)
            if self._budget is not None:
                alert = self._budget.observe(missed)
                if alert and self.enabled:
                    self._emit_alert(alert, rid=req.rid)

    def on_handoff(self, ttft_ms: float) -> None:
        """A prefill-role handoff: the first token was sampled here, so
        the TTFT lands in this replica's sketch; the decode side records
        only the decode phase of an injected stream."""
        self._sketches["ttft_ms"].add(round(ttft_ms, 3))

    def _emit_alert(self, alert: Dict[str, Any], **extra) -> None:
        self.alerts_fired += 1
        self._write({"kind": "alert", "role": self.role, "t": self._ts(),
                     "t_unix": round(time.time(), 3), **alert, **extra})
        log.warning("[serve] ALERT %s (burn rate %sx of the %s SLO budget)",
                    alert.get("alert"), alert.get("burn_rate"),
                    alert.get("target"))

    def rollup_record(self, tick: int,
                      snap: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        """The ``kind="rollup"`` record for this scheduler now: the
        document the file stream carries (``tools/obs_agg.py`` merges it)
        and the fleet router's load signal.  With ``snap`` (a live
        snapshot) the occupancy gauges refresh first and the record
        carries a ``now`` sub-dict of instantaneous queue/pool state."""
        if snap is not None:
            self._gauges["queue_depth"].set(snap["queue_depth"])
            self._gauges["block_utilization"].set(
                snap["block_utilization"])
        # the identity is cached: run_identity() makes up a fresh run id
        # when none is set, and one writer must not split into several
        if self._ident is None:
            self._ident = trace_lib.run_identity()
        ident = self._ident
        counters = dict(self._counters)
        counters["alerts"] = self.alerts_fired
        if self._budget is not None:
            counters["slo_events"] = self._budget.events
            counters["slo_misses"] = self._budget.misses
        rec = {
            "kind": "rollup", "role": self.role, "step": int(tick),
            "t": self._ts(), "t_unix": round(time.time(), 3),
            "p": ident["process_id"], "run": ident["run_id"],
            "inc": ident["incarnation"],
            "sketches": {k: s.to_dict()
                         for k, s in self._sketches.items() if s.n},
            "counters": counters,
            "gauges": {k: g.to_dict() for k, g in self._gauges.items()
                       if g.last is not None},
        }
        if self.replica is not None:
            rec["replica"] = int(self.replica)
        if snap is not None:
            rec["now"] = {k: snap[k] for k in
                          ("queue_depth", "live", "prefilling",
                           "free_blocks", "block_utilization",
                           "committed_tokens") if k in snap}
        return rec

    def _maybe_rollup(self, tick: int, final: bool = False) -> None:
        if self.rollup_every <= 0:
            return
        if not final and tick % self.rollup_every:
            return
        self.rollups_written += 1
        self._write(self.rollup_record(tick))
        self._write_goodput(tick)

    def _write_goodput(self, tick: int) -> None:
        """One ``kind="goodput"`` record beside each rollup (cumulative
        per incarnation); sustained goodput-fraction misses burn an error
        budget as the train role's do."""
        if self.goodput_meter is None:
            return
        snap = self.goodput_meter.snapshot()
        rec = goodput_lib.goodput_record(
            snap, role=self.role, step=tick,
            ident=self._ident or trace_lib.run_identity())
        if self.replica is not None:
            rec["replica"] = int(self.replica)
        self._write(rec)
        if self._goodput_budget is not None and snap["spans"] > 0:
            frac = snap["goodput_fraction"] or 0.0
            alert = self._goodput_budget.observe(
                frac < self._goodput_frac_min)
            if alert:
                self._emit_alert({**alert, "goodput_fraction": frac,
                                  "goodput_target":
                                      self._goodput_frac_min})

    def close(self, tick: int, snap: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        # the drain can end off the metrics_every cadence; the final
        # record carries the terminal counters regardless
        final_rec = {"kind": "serve", "step": int(tick), "t": self._ts(),
                     "final": True, **snap}
        self._write(final_rec)
        self._take_counters(snap)
        self._maybe_rollup(tick, final=True)
        self.heartbeat.beat(tick, final_rec, force=True, final=True)
        if self.goodput_meter is not None:
            trace_lib.remove_listener(self.goodput_meter.on_span)
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


class Scheduler:
    """The continuous-batching service loop (see the module docstring).

    ``now_fn`` injects the clock (tests drive a virtual one).  A caller
    timing a GPU run passes a clock that synchronises the device first,
    since the host runs ahead of the kernels it queues."""

    def __init__(self, model: Transformer, params,
                 cfg: Optional[ServeConfig] = None, now_fn=time.monotonic,
                 device: DeviceLike = None):
        self.cfg = cfg = ServeConfig() if cfg is None else cfg
        if cfg.role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got "
                             f"{cfg.role!r}")
        device = resolve_device(device)
        self.now = now_fn
        # an enclosing run's tracer is never displaced
        self._tracer = None
        if cfg.trace_dir and trace_lib.active() is None:
            self._tracer = trace_lib.start_run(cfg.trace_dir)
        try:
            self.server = PagedDecodeServer(
                model, params, slots=cfg.slots, num_blocks=cfg.num_blocks,
                block_size=cfg.block_size, max_len=cfg.max_len,
                temperature=cfg.temperature, top_k=cfg.top_k,
                top_p=cfg.top_p, seed=cfg.seed, kv_quant=cfg.kv_quant,
                attn_impl=cfg.attn_impl, prefix_cache=cfg.prefix_cache,
                device=device)
        except BaseException:
            self._stop_tracer()
            raise
        self.queue: Deque[Request] = collections.deque()
        self.reqs: Dict[int, Request] = {}      # every request ever seen
        self._srv_rid: Dict[int, int] = {}      # scheduler rid -> server
        self._sched_rid: Dict[int, int] = {}    # server rid -> scheduler
        self._prefilling: Deque[int] = collections.deque()
        self._results: Dict[int, List[int]] = {}
        self._done_order: Deque[int] = collections.deque()
        self._next_rid = 0
        self.tick_no = 0
        self.admitted = 0
        self.rejected = 0
        self.evicted = 0
        self.completed = 0
        self.tokens_out = 0
        # the handoff: exports a prefill-role tick produced, waiting for
        # take_handoffs(); counters of both directions
        self._handoffs: List[Dict[str, Any]] = []
        self.handed_off = 0
        self.injected = 0
        # decode-step key accounting (host arithmetic): attended = what
        # the math needs, padded = what the gathered path reduces over,
        # kernel = whole blocks the fused kernel walks
        self.attended_keys = 0
        self.padded_keys = 0
        self.kernel_keys = 0
        self.telemetry = _ServeTelemetry(cfg)
        # flow ids unique on a fleet's merged timeline: the process id,
        # and the replica index when set (scheduler rids restart at 0)
        rep = "" if cfg.replica is None else f"R{int(cfg.replica)}-"
        self._flow_prefix = (
            f"p{trace_lib.run_identity()['process_id']}-{rep}r")
        # inter-tick gap attribution: the next tick records the gap since
        # this one as queue_wait (requests queued, none live) or
        # sched_bubble (streams in flight)
        self._gap_wall: Optional[float] = None
        self._gap_state: Optional[str] = None

    # ---- client surface ------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               slo_ms: Optional[float] = None,
               unified: bool = False) -> Optional[int]:
        """Enqueue a request; returns its id, or None when the bounded
        queue is full (rejected).  Raises for requests the server could
        never hold (over ``max_len`` / pool capacity).  ``unified=True``
        serves the request end to end here whatever the role (the
        fallback a router uses when the peer pool is empty)."""
        prompt_ids = [int(t) for t in prompt_ids]
        self.server.check_request(len(prompt_ids), max_new_tokens)
        if len(self.queue) >= self.cfg.queue_depth:
            self.rejected += 1
            return None
        slo = self.cfg.default_slo_ms if slo_ms is None else slo_ms
        now = self.now()
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt_ids,
                      max_new=int(max_new_tokens), t_submit=now,
                      deadline=(now + slo / 1e3 if slo is not None
                                else math.inf),
                      slo_ms=slo, unified=bool(unified))
        self.reqs[rid] = req
        self.queue.append(req)
        return rid

    def done(self, rid: int) -> bool:
        if rid in self._results:
            return True
        if rid in self._srv_rid or any(r.rid == rid for r in self.queue):
            return False
        raise KeyError(f"request {rid}: unknown or already consumed")

    def result(self, rid: int) -> List[int]:
        """Prompt + generated ids (pops the tokens; timings stay readable
        through :meth:`stats`)."""
        return self._results.pop(rid)

    def stats(self, rid: int) -> Request:
        return self.reqs[rid]

    def in_flight(self) -> int:
        return len(self._srv_rid)

    def pending(self) -> int:
        return len(self.queue)

    # ---- the service loop ----------------------------------------------
    def tick(self) -> List[int]:
        """One tick: admit, one prefill chunk, one decode step, retire.
        Returns the rids completed during this tick."""
        self.tick_no += 1
        done_now: List[int] = []
        tracer = trace_lib.active()
        if tracer is not None and self._gap_state is not None:
            gap = time.time() - self._gap_wall
            if gap >= 1e-4:  # sub-100us gaps are loop overhead, not waits
                tracer.record_span(self._gap_state, self._gap_wall, gap,
                                   {"tick": self.tick_no})
        with trace_lib.span("admit", tick=self.tick_no):
            self._admit()
        with trace_lib.span("prefill", tick=self.tick_no):
            done_now += self._prefill_tick()
        if self.server.any_active():
            with trace_lib.span("decode", tick=self.tick_no):
                self._grow_or_evict()
                if trace_lib.active() is not None:
                    # one flow step per decoding stream links this tick's
                    # decode span into each request's path
                    for rid in self._srv_rid:
                        if rid not in self._prefilling:
                            trace_lib.flow(
                                "req", f"{self._flow_prefix}{rid}", "t",
                                rid=rid, stage="decode", tick=self.tick_no)
                acct = self.server.keys_accounting()
                self.attended_keys += acct["attended_keys"]
                self.padded_keys += acct["padded_keys"]
                self.kernel_keys += acct["kernel_keys"]
                finished = self.server.step()
            with trace_lib.span("retire", tick=self.tick_no):
                for srv_rid in finished:
                    done_now.append(self._retire(srv_rid))
        self.telemetry.on_tick(self.tick_no, self._snapshot())
        self._gap_wall = time.time()
        self._gap_state = ("sched_bubble" if self._srv_rid
                           else ("queue_wait" if self.queue else None))
        return done_now

    def run_until_drained(self, max_ticks: int = 100_000) -> List[int]:
        """Tick until queue and in-flight are empty; returns completion
        order.  ``max_ticks`` is a hard stop so a policy bug fails loudly
        instead of hanging."""
        order: List[int] = []
        for _ in range(max_ticks):
            if not (self.queue or self._srv_rid):
                return order
            order += self.tick()
        raise RuntimeError(
            f"not drained after {max_ticks} ticks: queue="
            f"{len(self.queue)} in_flight={len(self._srv_rid)}")

    def close(self) -> None:
        """Write the final records and heartbeat, and stop the tracer this
        scheduler started."""
        self.telemetry.close(self.tick_no, self._snapshot())
        self._stop_tracer()

    def _stop_tracer(self) -> None:
        if self._tracer is not None:
            trace_lib.stop_run(self._tracer)
            self._tracer = None

    # ---- fleet surface --------------------------------------------------
    def load_report(self) -> Dict[str, Any]:
        """This replica's live load signal for a router: the
        ``kind="rollup"`` record refreshed with a ``now`` sub-dict of
        instantaneous occupancy and admission capacity."""
        rec = self.telemetry.rollup_record(self.tick_no, self._snapshot())
        rec["now"]["free_slots"] = self.server.free_slots()
        rec["now"]["in_flight"] = len(self._srv_rid)
        rec["now"]["slots"] = self.cfg.slots
        rec["now"]["queue_cap"] = self.cfg.queue_depth
        rec["now"]["tokens_at_risk"] = self.tokens_at_risk()
        rec["now"]["role"] = self.cfg.role
        rec["now"]["handoffs_ready"] = len(self._handoffs)
        return rec

    def take_handoffs(self) -> List[Dict[str, Any]]:
        """The handoff exports a prefill-role scheduler produced since the
        last call: one ``{"rid", "payload", "slo_ms", "ttft_ms",
        "prompt_tokens"}`` descriptor per stream whose prefill completed."""
        out, self._handoffs = self._handoffs, []
        return out

    def inject(self, payload: Dict[str, Any],
               slo_ms: Optional[float] = None) -> Optional[int]:
        """Admit a handed-off stream directly into decode
        (:meth:`PagedDecodeServer.import_stream`): no queue, no prefill.
        Returns a request id, or None when a slot or the blocks are
        unavailable (nothing used; the caller retries).  ``t_first`` is
        stamped now: the real time to first token lives on the prefill
        side, and this side's numbers price the decode phase only."""
        srv_rid = self.server.import_stream(payload)
        if srv_rid is None:
            return None
        now = self.now()
        slo = self.cfg.default_slo_ms if slo_ms is None else slo_ms
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid,
                      prompt=[int(t) for t in payload["prompt"]],
                      max_new=int(payload["max_new"]), t_submit=now,
                      deadline=(now + slo / 1e3 if slo is not None
                                else math.inf),
                      slo_ms=slo, t_first=now)
        self.reqs[rid] = req
        self._srv_rid[rid] = srv_rid
        self._sched_rid[srv_rid] = rid
        self.injected += 1
        trace_lib.flow("req", f"{self._flow_prefix}{rid}", "t",
                       rid=rid, stage="inject", tick=self.tick_no)
        if self.server.done(srv_rid):
            # a single-token handoff is already complete
            self._retire(srv_rid)
        return rid

    def _consumed(self, rid: int, srv_rid: int):
        """(prefilled, generated) of an in-flight stream: position p holds
        the first sampled token once prefill completes, then one more per
        decode step (from the host's position counters)."""
        st = self.server._streams[srv_rid]
        slot = self.server._slot_of[srv_rid]
        prefilled, p = st.prefilled, len(self.reqs[rid].prompt)
        generated = (int(self.server._pos_host[slot]) - p + 1
                     if prefilled >= p else 0)
        return prefilled, max(0, generated)

    def tokens_at_risk(self) -> int:
        """Tokens of consumed work an unannounced kill would discard now:
        prefilled + generated over every in-flight stream (queued requests
        carry none)."""
        return sum(sum(self._consumed(rid, srv_rid))
                   for rid, srv_rid in self._srv_rid.items())

    @staticmethod
    def _descriptor(req: Request, prefilled: int = 0,
                    generated: int = 0) -> Dict[str, Any]:
        return {"rid": req.rid, "prompt": list(req.prompt),
                "max_new": req.max_new, "slo_ms": req.slo_ms,
                "prefilled": prefilled, "generated": generated,
                "t_submit": req.t_submit, "evictions": req.evictions}

    def drain(self) -> List[Dict[str, Any]]:
        """Stop serving and hand every unfinished request back: evicts all
        in-flight streams (the allocator drains), empties the wait queue
        and the untaken handoffs, and returns one descriptor per request
        in submission order: ``{"rid", "prompt", "max_new", "slo_ms",
        "prefilled", "generated", "t_submit", "evictions"}``.  The tokens
        are not carried: greedy re-admission with the same params
        reproduces them.  Completed results stay readable."""
        out: List[Dict[str, Any]] = []
        for rid in list(self._srv_rid):
            srv_rid = self._srv_rid[rid]
            prefilled, generated = self._consumed(rid, srv_rid)
            del self._srv_rid[rid]
            self._sched_rid.pop(srv_rid)
            self.server.evict(srv_rid)
            if rid in self._prefilling:
                self._prefilling.remove(rid)
            req = self.reqs[rid]
            req.t_first = None      # TTFT restarts on re-admission
            out.append(self._descriptor(req, prefilled, generated))
        # exported but never taken: the stream left the server, but the
        # request goes back as undone work (a full re-prefill elsewhere)
        for h in self._handoffs:
            req = self.reqs[h["rid"]]
            req.t_first = None
            out.append(self._descriptor(req))
        self._handoffs = []
        out += [self._descriptor(req) for req in self.queue]
        self.queue.clear()
        out.sort(key=lambda d: (d["t_submit"], d["rid"]))
        return out

    def quiesce(self) -> List[Dict[str, Any]]:
        """:meth:`drain`, then assert the allocator really is empty: the
        one call every worker shutdown path shares, so a clean exit means
        no leaked block."""
        out = self.drain()
        self.server.allocator.assert_drained()
        return out

    # ---- internals -----------------------------------------------------
    def _committed_tokens(self) -> int:
        """In-flight committed (prompt + max_new) tokens, discounting
        positions resident in shared blocks."""
        raw = sum(len(r.prompt) + r.max_new
                  for rid, r in self.reqs.items()
                  if rid in self._srv_rid)
        return max(0, raw - self.server.shared_token_discount())

    def _admit(self) -> None:
        while self.queue:
            req = self.queue[0]
            p = len(req.prompt)
            if self.server.free_slots() == 0:
                return
            # normal admission overcommits (blocks for prompt + first
            # token; growth is on demand).  A request evicted before waits
            # at the head until the pool covers its full need, or it would
            # thrash admit -> grow -> evict.
            need = self.server.admit_need(req.prompt, req.max_new,
                                          full_residency=bool(
                                              req.evictions))
            if self.server.free_blocks < need:
                return
            if (self.cfg.token_budget > 0
                    and self._committed_tokens() + p + req.max_new
                    > self.cfg.token_budget):
                return
            srv_rid = self.server.try_admit(req.prompt, req.max_new)
            if srv_rid is None:
                return
            self.queue.popleft()
            self._srv_rid[req.rid] = srv_rid
            self._sched_rid[srv_rid] = req.rid
            self._prefilling.append(req.rid)
            self.admitted += 1
            # flow start (or restart after an eviction's re-admission)
            trace_lib.flow("req", f"{self._flow_prefix}{req.rid}", "s",
                           rid=req.rid, stage="admit", prompt_tokens=p,
                           tick=self.tick_no)

    def _prefill_tick(self) -> List[int]:
        """At most one prefill chunk per tick, so decoding streams advance
        every tick regardless of admission work."""
        done_now: List[int] = []
        if not self._prefilling:
            return done_now
        rid = self._prefilling[0]
        srv_rid = self._srv_rid[rid]
        trace_lib.flow("req", f"{self._flow_prefix}{rid}", "t",
                       rid=rid, stage="prefill", tick=self.tick_no)
        if self.server.prefill_step(srv_rid, self.cfg.prefill_chunk):
            self._prefilling.popleft()
            req = self.reqs[rid]
            req.t_first = self.now()
            if self.server.done(srv_rid):   # single-token request
                done_now.append(self._retire(srv_rid))
            elif self.cfg.role == "prefill" and not req.unified:
                # the stream leaves at the prefill->decode boundary:
                # export first (read-only), then release; under
                # prefix_cache the registered prompt blocks then park
                # cached-free and stay resident for later prefix hits
                self._export_handoff(rid, srv_rid)
        return done_now

    def _export_handoff(self, rid: int, srv_rid: int) -> None:
        req = self.reqs[rid]
        payload = self.server.export_stream(srv_rid)
        self._srv_rid.pop(rid)
        self._sched_rid.pop(srv_rid)
        self.server.evict(srv_rid)
        ttft = round((req.t_first - req.t_submit) * 1e3, 3)
        self.handed_off += 1
        self.telemetry.on_handoff(ttft)
        self._handoffs.append({
            "rid": rid, "payload": payload, "slo_ms": req.slo_ms,
            "ttft_ms": ttft, "prompt_tokens": len(req.prompt)})
        trace_lib.flow("req", f"{self._flow_prefix}{rid}", "t",
                       rid=rid, stage="handoff", tick=self.tick_no)

    def _grow_or_evict(self) -> None:
        """Supply every decoding stream's next block, evicting
        latest-deadline streams under exhaustion."""
        while self.server.ensure_blocks():
            victim = self._pick_victim()
            if victim is None:
                # unreachable while submit()'s capacity guard holds
                raise RuntimeError("block exhaustion with no evictable "
                                   "stream (capacity guard violated)")
            self._evict(victim)

    def _pick_victim(self) -> Optional[int]:
        inflight = [self.reqs[rid] for rid in self._srv_rid]
        if len(inflight) <= 1:
            return None
        key = lambda r: (r.deadline, r.t_submit, r.rid)   # noqa: E731
        protected = min(inflight, key=key)
        victim = max(inflight, key=key)
        if victim.rid == protected.rid:
            return None
        return victim.rid

    def _evict(self, rid: int) -> None:
        srv_rid = self._srv_rid.pop(rid)
        self._sched_rid.pop(srv_rid)
        self.server.evict(srv_rid)
        if rid in self._prefilling:
            self._prefilling.remove(rid)
        req = self.reqs[rid]
        req.evictions += 1
        req.t_first = None          # TTFT restarts: tokens are recomputed
        self.queue.appendleft(req)  # front: original arrival order kept
        self.evicted += 1
        log.info("evicted rid=%d (deadline %s); requeued at front", rid,
                 "inf" if math.isinf(req.deadline)
                 else round(req.deadline, 3))

    def _retire(self, srv_rid: int) -> int:
        rid = self._sched_rid.pop(srv_rid)
        self._srv_rid.pop(rid)
        req = self.reqs[rid]
        req.t_done = self.now()
        trace_lib.flow("req", f"{self._flow_prefix}{rid}", "f",
                       rid=rid, stage="retire", tick=self.tick_no)
        if req.t_first is None:
            req.t_first = req.t_done
        toks = self.server.result(srv_rid)
        self._results[rid] = toks
        n_gen = len(toks) - len(req.prompt)
        self.completed += 1
        self.tokens_out += n_gen
        self.telemetry.on_request_done(req, n_gen)
        # bounded retention of completed requests and unconsumed results
        self._done_order.append(rid)
        while len(self._done_order) > max(1, self.cfg.completed_history):
            old = self._done_order.popleft()
            self.reqs.pop(old, None)
            self._results.pop(old, None)
        return rid

    def _snapshot(self) -> Dict[str, Any]:
        """Queue, pool and counter state (host arithmetic only): the key
        set of the JAX package's ``kind="serve"`` record."""
        prefix: Dict[str, Any] = {}
        if self.cfg.prefix_cache:
            ps = self.server.prefix_stats()
            prefix = dict(ps)
            prefix["prefix_hit_rate"] = (
                round(ps["prefix_hit_tokens"]
                      / ps["prompt_tokens_admitted"], 4)
                if ps["prompt_tokens_admitted"] else None)
        return {
            **prefix,
            "queue_depth": len(self.queue),
            "live": len(self._srv_rid),
            "prefilling": len(self._prefilling),
            "free_blocks": self.server.free_blocks,
            "block_utilization": round(self.server.block_utilization(), 4),
            "committed_tokens": self._committed_tokens(),
            "admitted": self.admitted,
            "rejected": self.rejected,
            "evicted": self.evicted,
            "completed": self.completed,
            "tokens_out": self.tokens_out,
            "handed_off": self.handed_off,
            "injected": self.injected,
            "attended_keys": self.attended_keys,
            "padded_keys": self.padded_keys,
            "kernel_keys": self.kernel_keys,
            "attended_ratio": (
                round(self.attended_keys / self.padded_keys, 4)
                if self.padded_keys else None),
        }

    def snapshot(self) -> Dict[str, object]:
        """:meth:`_snapshot` plus the server's forward-pass counts
        (``prefill_chunks``, ``decode_steps``: each runs paged attention
        once per layer)."""
        return {**self._snapshot(),
                "prefill_chunks": self.server.prefill_chunks,
                "decode_steps": self.server.decode_steps}
