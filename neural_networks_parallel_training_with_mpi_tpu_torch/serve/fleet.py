"""Serving fleet: N replicas behind one SLO-aware router, the port of the
JAX package's ``serve/fleet.py``: the router, the replica kinds, the
worker process and its supervision; ``serve/autopilot.py``'s control
loop rides :meth:`Fleet.pump`.

One ``Scheduler`` over one ``PagedDecodeServer`` is one replica.  A fleet
is N replica processes under ``train.resilience.GroupSupervisor`` with a
router load-balancing one bounded wait queue across them.

* **Replica handles**: the router speaks one interface
  (:class:`ReplicaHandle`) to three kinds: :class:`InprocReplica` (a
  ``serve.Scheduler`` in this process), :class:`ProcReplica` (a worker
  subprocess running :func:`worker_main`, newline JSON over stdio, so a
  crash takes out one replica's process) and :class:`TPGenerateReplica`
  (one replica over a tensor group through ``models.generate_tp``:
  batched greedy decode on ``tensor``-split params, token-identical to
  the single-device replica).
* **Placement**: least-loaded with deadline feasibility, fed by each
  replica's live load report, the ``kind="rollup"`` record of
  ``Scheduler.load_report`` (``utils/sketches.py`` TTFT/ITL state plus
  queue depth and block use), the document ``tools/obs_agg.py`` merges.
* **Admission**: overload is rejected at the router (one bounded queue);
  each replica keeps a shallow backlog (``replica_queue_cap``), so waiting
  work stays where it can be re-placed.  With ``reject_infeasible`` a
  request whose deadline no replica can plausibly meet (TTFT rollup x
  backlog over its slack) is rejected up front.
* **Replica death**: the router keeps the ledger of every dispatched
  request; when a replica dies its unfinished requests requeue at the
  front of the queue in submission order and re-place on siblings.
  Greedy decode is deterministic, so re-execution gives the same tokens.
  The supervisor relaunches the dead replica under its own budget, and
  the new process re-registers through its ``ready`` event.
* **Disaggregated handoff**: prefill-role replicas hand each stream to a
  decode-role replica through the router's handoff ledger (commit,
  re-inject after a decode death, timeout and retry, degraded unified
  service when a pool is empty), and with ``wal_dir`` every commit point
  is journaled first (``serve/wal.py``) and replayed by the next router.

``python -m neural_networks_parallel_training_with_mpi_tpu_torch.serve.\
_fleet_worker --worker ...`` is the worker process (:func:`worker_main`);
:func:`launch_fleet` assembles a subprocess fleet.
"""

from __future__ import annotations

import collections
import json
import math
import os
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..train import telemetry as telemetry_lib
from ..train import trace as trace_lib
from ..utils.logging import log
from ..utils.platform import DeviceLike, resolve_device
from ..utils.sketches import Gauge, QuantileSketch

Pytree = Any

# wire protocol (one JSON object per line):
#   parent -> worker : {"op": "submit", "rid", "prompt", "max_new",
#                       "slo_ms", "unified"?} | {"op": "drain"}
#                     | {"op": "inject", "rid", "payload", "slo_ms"}
#                     | {"op": "decommission"} | {"op": "exit"}
#   worker -> parent : {"ev": "ready", ...} | {"ev": "done", "rid",
#                       "tokens", "ttft_ms", "itl_ms", ...}
#                     | {"ev": "reject", "rid", "inject"?}
#                     | {"ev": "handoff", "rid", "payload", "ttft_ms"}
#                     | {"ev": "injected", "rid"}
#                     | {"ev": "status", "report": <load_report>}
#                       (the port's report also carries "kernel_launches":
#                        this process's CUDA kernel launch counts)
#                     | {"ev": "drained", "requests": [...]}
#                     | {"ev": "load_error", "error": ...}
# fleet rids ride the wire verbatim, so completions need no id
# translation on the way back.  "decommission" is "drain" followed by a
# terminal exit with train.resilience.EXIT_DECOMMISSION (47), the
# scale-in handshake (the supervisor must have retired the child first
# so the exit is final, not relaunched).
#
# Disaggregated handoff: a PREFILL-role worker answers
# a submit with "handoff" instead of "done" — the exported stream
# (serve/paged_kv.export_stream: block contents + first sampled token)
# rides the event, and emitting it is the COMMIT point: the router owns
# the record from that line on.  The router forwards it to a
# decode-role worker as an "inject" op, which acks "injected" (or
# rejects with "inject": true when a slot/blocks are unavailable) and
# later reports the normal "done".  "unified": true on a submit pins
# end-to-end service regardless of the worker's role — the degraded
# single-pool fallback.

# replica ids encode the WEIGHT GENERATION: a generation-g replica gets
# id g * GEN_STRIDE + k, so its flow-trace prefix (p{id}-R{id}-r...) and
# telemetry identity attribute every token it emits to its generation
# (id // GEN_STRIDE) without a side channel.
GEN_STRIDE = 1000


# ---------------------------------------------------------------------------
# load signal
# ---------------------------------------------------------------------------

@dataclass
class LoadSignal:
    """One replica's placement signal, parsed from its
    ``Scheduler.load_report()`` rollup record (serialized sketches +
    ``now`` occupancy) — NOT from private scheduler state, so a
    subprocess replica and an in-process one feed the router
    identically."""
    t_unix: float = 0.0
    queue_depth: int = 0
    in_flight: int = 0
    free_slots: int = 0
    slots: int = 1
    queue_cap: int = 0
    free_blocks: int = 0
    block_utilization: float = 0.0
    ttft_p50_ms: Optional[float] = None
    ttft_p99_ms: Optional[float] = None
    replica: Optional[int] = None
    role: str = "unified"              # scheduler serving role

    @classmethod
    def from_report(cls, rec: Dict[str, Any]) -> "LoadSignal":
        now = rec.get("now") or {}
        sig = cls(
            t_unix=float(rec.get("t_unix") or 0.0),
            queue_depth=int(now.get("queue_depth", 0)),
            in_flight=int(now.get("in_flight", now.get("live", 0))),
            free_slots=int(now.get("free_slots", 0)),
            slots=max(1, int(now.get("slots", 1))),
            queue_cap=int(now.get("queue_cap", 0)),
            free_blocks=int(now.get("free_blocks", 0)),
            block_utilization=float(now.get("block_utilization", 0.0)),
            replica=rec.get("replica"),
            role=str(now.get("role", "unified") or "unified"),
        )
        doc = (rec.get("sketches") or {}).get("ttft_ms")
        if doc:
            sk = QuantileSketch.from_dict(doc)
            sig.ttft_p50_ms = sk.quantile(0.5)
            sig.ttft_p99_ms = sk.quantile(0.99)
        return sig

    @property
    def occupancy(self) -> float:
        """Queued + running work, normalized by the replica's slot
        count — the least-loaded score (heterogeneous replicas compare
        by RELATIVE load, not absolute stream counts)."""
        return (self.in_flight + self.queue_depth) / self.slots


# ---------------------------------------------------------------------------
# the router's request ledger
# ---------------------------------------------------------------------------

@dataclass
class FleetRequest:
    """One request's fleet-level lifecycle.  The ROUTER owns this
    ledger — it is what makes replica death recoverable: a dead
    replica's uncompleted entries requeue from here, never from the
    dead process's memory."""
    rid: int
    prompt: List[int]
    max_new: int
    slo_ms: Optional[float]
    t_submit: float
    deadline: float
    replica: Optional[str] = None      # current / last placement
    t_dispatch: Optional[float] = None
    t_done: Optional[float] = None
    requeues: int = 0                  # times re-placed after a death
    ttft_ms: Optional[float] = None    # fleet-level: router wait included
    itl_ms: Optional[float] = None
    n_generated: Optional[int] = None
    generation: Optional[int] = None   # weight generation that COMPLETED
    #                                    this request (set at completion)
    # --- disaggregated-handoff ledger ---------------------------------
    # phase: queued -> prefilling -> handoff_inflight -> decoding.
    # ``handoff`` holds the COMMITTED export payload until completion:
    # it IS the decode-death recovery record (re-inject, no re-prefill).
    phase: str = "queued"
    unified: bool = False              # degraded end-to-end dispatch
    handoff: Optional[Dict[str, Any]] = None
    handoff_t: Optional[float] = None  # commit time (handoff received)
    handoff_ms: Optional[float] = None # commit -> injected ack latency
    handoff_retries: int = 0
    handoff_next_t: float = 0.0        # backoff: earliest re-dispatch
    prefill_replica: Optional[str] = None

    @property
    def deadline_missed(self) -> Optional[bool]:
        if self.t_done is None:
            return None
        return bool(math.isfinite(self.deadline)
                    and self.t_done > self.deadline)


# ---------------------------------------------------------------------------
# replica handles
# ---------------------------------------------------------------------------

def role_kind(handle_or_role) -> str:
    """Collapse a handle's role string to one of the three placement
    kinds: ``"prefill"`` / ``"decode"`` / ``"unified"``.  Legacy role
    strings ("replica", "serve", "serve-replica") are unified — a
    pre-disagg fleet routes exactly as before."""
    role = handle_or_role if isinstance(handle_or_role, str) else \
        getattr(handle_or_role, "role", "replica")
    role = str(role or "replica")
    if role.endswith("prefill"):
        return "prefill"
    if role.endswith("decode"):
        return "decode"
    return "unified"


class ReplicaHandle:
    """What the router needs from a replica, regardless of where it
    runs.  ``submit`` may refuse (False) — the request stays at the
    fleet queue head; ``pump`` advances the replica (in-process shapes)
    and returns completion dicts carrying the FLEET rid."""

    name: str = "replica"
    role: str = "replica"
    generation: int = 0     # weight generation this replica serves

    def alive(self) -> bool:
        raise NotImplementedError

    def accepting(self) -> bool:
        raise NotImplementedError

    def load(self) -> Optional[LoadSignal]:
        raise NotImplementedError

    def submit(self, req: FleetRequest) -> bool:
        raise NotImplementedError

    def can_inject(self) -> bool:
        """Whether this handle understands the ``inject`` op at all
        (batch engines don't)."""
        return False

    def inject(self, req: FleetRequest, payload: Dict[str, Any]) -> bool:
        """Dispatch a committed handoff record.  May refuse (False) —
        the record stays in the router's handoff queue."""
        return False

    def forget(self, rid: int) -> None:
        """Drop one rid from the assigned set WITHOUT completing it —
        the router's handoff-timeout path, which re-owns the record
        before re-dispatching it elsewhere."""

    def pump(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def assigned(self) -> List[int]:
        """Fleet rids dispatched here and not yet completed."""
        raise NotImplementedError

    def take_assigned(self) -> List[int]:
        """Drop and return the assigned set (the router requeues them
        after a death)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class InprocReplica(ReplicaHandle):
    """A ``serve.Scheduler`` in this process.  The core-lane test shape
    (no subprocesses inside the budgeted lane) and the mechanism
    baseline: everything the router does to a subprocess replica it
    does to this one, through the same load-report record."""

    def __init__(self, scheduler, name: str = "replica-0"):
        self.name = name
        self.sched = scheduler
        srole = str(getattr(scheduler.cfg, "role", "unified") or "unified")
        self.role = "replica" if srole == "unified" else srole
        self._local: Dict[int, int] = {}     # fleet rid -> scheduler rid
        self._events: List[Dict[str, Any]] = []   # pending injected acks
        self._dead = False

    def alive(self) -> bool:
        return not self._dead

    def accepting(self) -> bool:
        return (not self._dead
                and self.sched.pending() < self.sched.cfg.queue_depth)

    def load(self) -> Optional[LoadSignal]:
        if self._dead:
            return None
        return LoadSignal.from_report(self.sched.load_report())

    def submit(self, req: FleetRequest) -> bool:
        if self._dead:
            return False
        lrid = self.sched.submit(req.prompt, req.max_new,
                                 slo_ms=req.slo_ms, unified=req.unified)
        if lrid is None:
            return False
        self._local[req.rid] = lrid
        return True

    def can_inject(self) -> bool:
        return not self._dead

    def inject(self, req: FleetRequest, payload: Dict[str, Any]) -> bool:
        if self._dead:
            return False
        try:
            lrid = self.sched.inject(payload, slo_ms=req.slo_ms)
        except ValueError:
            return False
        if lrid is None:
            return False
        self._local[req.rid] = lrid
        # the ack rides the next pump so the router sees the same
        # event order a subprocess replica produces
        self._events.append({"ev": "injected", "rid": req.rid})
        return True

    def forget(self, rid: int) -> None:
        self._local.pop(rid, None)

    def pump(self) -> List[Dict[str, Any]]:
        if self._dead:
            return []
        out, self._events = self._events, []
        if self.sched.pending() or self.sched.in_flight():
            done_local = set(self.sched.tick())
        else:
            done_local = set()
        for rec in self.sched.take_handoffs():
            frid = next((f for f, l in self._local.items()
                         if l == rec["rid"]), None)
            if frid is None:
                continue
            del self._local[frid]
            out.append({"ev": "handoff", "rid": frid,
                        "payload": rec["payload"],
                        "ttft_ms": rec.get("ttft_ms")})
        for frid, lrid in list(self._local.items()):
            fin = lrid in done_local
            if not fin:
                # injected single-token streams retire inside inject()
                # and never appear in a tick's done list
                try:
                    fin = self.sched.done(lrid)
                except KeyError:
                    fin = False
            if not fin:
                continue
            st = self.sched.stats(lrid)
            out.append({"rid": frid,
                        "tokens": self.sched.result(lrid),
                        "ttft_ms": st.ttft_ms, "itl_ms": st.itl_ms,
                        "evictions": st.evictions})
            del self._local[frid]
        return out

    def assigned(self) -> List[int]:
        return list(self._local)

    def take_assigned(self) -> List[int]:
        rids = list(self._local)
        self._local.clear()
        return rids

    def fail(self) -> None:
        """Test hook: simulate this replica's death (the in-process
        analogue of SIGKILL — its scheduler state is unreachable)."""
        self._dead = True

    def drain(self) -> List[Dict[str, Any]]:
        return self.sched.drain()

    def close(self) -> None:
        if not self._dead:
            self.sched.close()


class TPGenerateReplica(ReplicaHandle):
    """One replica over a tensor group: batched ragged decode through
    ``models.generate_tp`` on ``tensor``-split params (qkv columns
    permuted by ``megatron.permute_qkv``).  A batch engine, not a
    continuous-batching scheduler: each :meth:`pump` takes up to ``batch``
    queued requests and decodes them in one ``generate_tp`` call over the
    group, so TTFT is batch-granular; what it buys is a replica whose model
    does not fit (or saturates) one card.  ``group``: a
    ``LocalTensorGroup(N)`` runs the N shards in this process (one card,
    or the CPU).  Prompt width, batch and total length pad to power-of-two
    buckets, as the JAX package's, whose mesh this group replaces; where
    the total bucket would pass ``max_seq_len``, it stops there.  Greedy
    tokens equal the single-device replica's: both decode as
    ``models.generate``."""

    def __init__(self, model, params_tp, group, *, batch: int = 4,
                 queue_cap: int = 64, name: str = "tp-replica",
                 pad_id: int = 0, now_fn=time.monotonic,
                 device: DeviceLike = None):
        self.name = name
        self.model = model
        self.params_tp = params_tp
        self.group = group
        self.device = resolve_device(device)
        self.batch = int(batch)
        self.queue_cap = int(queue_cap)
        self.pad_id = int(pad_id)
        self.now = now_fn
        self._queue: Deque[FleetRequest] = collections.deque()
        self._dead = False
        self._ttft = QuantileSketch()
        self._itl = QuantileSketch()
        self._q_gauge = Gauge()
        self._batches = 0

    @staticmethod
    def _bucket(n: int, lo: int = 8) -> int:
        b = lo
        while b < n:
            b *= 2
        return b

    def alive(self) -> bool:
        return not self._dead

    def accepting(self) -> bool:
        return not self._dead and len(self._queue) < self.queue_cap

    def load_report(self) -> Dict[str, Any]:
        """The record shape ``Scheduler.load_report`` emits, from this
        engine's own sketches: the router does not special-case kinds."""
        self._q_gauge.set(len(self._queue))
        return {
            "kind": "rollup", "role": "serve",
            "t_unix": round(time.time(), 3),
            "sketches": {k: s.to_dict()
                         for k, s in (("ttft_ms", self._ttft),
                                      ("itl_ms", self._itl)) if s.n},
            "counters": {"batches": self._batches},
            "gauges": {"queue_depth": self._q_gauge.to_dict()},
            "now": {"queue_depth": len(self._queue), "in_flight": 0,
                    "free_slots": self.batch, "slots": self.batch,
                    "queue_cap": self.queue_cap, "free_blocks": 1 << 20,
                    "block_utilization": 0.0},
        }

    def load(self) -> Optional[LoadSignal]:
        if self._dead:
            return None
        return LoadSignal.from_report(self.load_report())

    def submit(self, req: FleetRequest) -> bool:
        if not self.accepting():
            return False
        self._queue.append(req)
        return True

    def pump(self) -> List[Dict[str, Any]]:
        if self._dead or not self._queue:
            return []
        import numpy as np

        from ..models.generate_tp import generate_tp

        reqs = [self._queue.popleft()
                for _ in range(min(self.batch, len(self._queue)))]
        lens = [len(r.prompt) for r in reqs]
        need = max(l + r.max_new for l, r in zip(lens, reqs))
        p_pad = self._bucket(max(lens))
        total = self._bucket(need, lo=p_pad + 1)
        cap = self.model.cfg.max_seq_len
        if total > cap >= need:
            # the buckets stop at the model's length; the prompt bucket
            # gives way so that every row still decodes from its own
            # length (the longest prompt is < need <= cap).  A need past
            # cap reaches generate_tp, which raises, as in the JAX package
            total = cap
            p_pad = min(p_pad, cap - 1)
        b_pad = self._bucket(len(reqs), lo=1)
        prompts = np.full((b_pad, p_pad), self.pad_id, np.int64)
        plens = np.ones((b_pad,), np.int64)
        for i, r in enumerate(reqs):
            prompts[i, :lens[i]] = r.prompt
            plens[i] = lens[i]
        t0 = self.now()
        toks = generate_tp(self.model, self.params_tp, prompts, self.group,
                           max_new_tokens=total - p_pad,
                           prompt_lens=plens, pad_id=self.pad_id,
                           device=self.device).cpu().numpy()
        t1 = self.now()
        self._batches += 1
        out = []
        for i, r in enumerate(reqs):
            row = [int(t) for t in toks[i, :lens[i] + r.max_new]]
            ttft = (t1 - t0) * 1e3   # batch-granular: the first token
            #                          lands when the batch returns
            itl = 0.0 if r.max_new <= 1 else ttft / (r.max_new - 1)
            self._ttft.add(ttft)
            self._itl.add(itl)
            out.append({"rid": r.rid, "tokens": row,
                        "ttft_ms": ttft, "itl_ms": itl, "evictions": 0})
        return out

    def assigned(self) -> List[int]:
        return [r.rid for r in self._queue]

    def take_assigned(self) -> List[int]:
        rids = [r.rid for r in self._queue]
        self._queue.clear()
        return rids

    def fail(self) -> None:
        self._dead = True


class ProcReplica(ReplicaHandle):
    """A replica SUBPROCESS speaking the newline-JSON protocol (module
    header).  A dedicated reader thread drains the child's stdout into
    an event queue so the router's pump never blocks on a slow or dead
    pipe; writes detect a broken pipe and mark the replica down (the
    supervisor owns the relaunch, :meth:`attach` re-binds the fresh
    process and the ``ready`` event re-opens admission)."""

    def __init__(self, name: str, role: str = "replica",
                 generation: int = 0):
        self.name = name
        self.role = role
        self.generation = int(generation)
        self._proc = None
        self._stdin = None
        self._events: Deque[Dict[str, Any]] = collections.deque()
        self._lock = threading.Lock()
        self._reader: Optional[threading.Thread] = None
        self._assigned: Dict[int, FleetRequest] = {}
        self.ready = False
        self._signal: Optional[LoadSignal] = None
        self.report: Optional[Dict[str, Any]] = None   # last raw rollup
        self.drained: Optional[List[Dict[str, Any]]] = None
        self.incarnation = -1
        # seconds from the newest (re)launch to its ready event
        self.ready_s: Optional[float] = None
        self._t_attach: Optional[float] = None
        # advance-notice preemption: the worker announced it is going away
        # in ``notice_grace_s`` seconds; no new work lands here
        # (accepting() gates) while in-flight requests finish
        self.noticed = False
        self.notice_grace_s: Optional[float] = None

    # ---- supervisor wiring --------------------------------------------
    def attach(self, proc, incarnation: int = 0) -> None:
        """Bind to a freshly spawned worker process (GroupSupervisor's
        ``on_spawn`` callback lands here on every (re)launch)."""
        self._proc = proc
        self._stdin = proc.stdin
        self.ready = False
        self.ready_s = None
        self._t_attach = time.monotonic()
        self._signal = None
        self.noticed = False
        self.notice_grace_s = None
        self.incarnation = incarnation
        t = threading.Thread(target=self._read_loop,
                             args=(proc.stdout,), daemon=True)
        t.start()
        self._reader = t

    def _read_loop(self, stream) -> None:
        try:
            for line in stream:
                line = line.strip()
                if not line or not line.startswith("{"):
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "ev" in rec:
                    if rec["ev"] == "ready" and self._t_attach is not None:
                        # stamped on arrival, however late the owner pumps
                        self.ready_s = time.monotonic() - self._t_attach
                    with self._lock:
                        self._events.append(rec)
        except (OSError, ValueError):
            pass  # dead pipe: the supervisor reaps the exit

    # ---- handle interface ---------------------------------------------
    def alive(self) -> bool:
        return (self._proc is not None
                and self._proc.poll() is None)

    def accepting(self) -> bool:
        return self.alive() and self.ready and not self.noticed

    def load(self) -> Optional[LoadSignal]:
        return self._signal

    def _send(self, obj: Dict[str, Any]) -> bool:
        if self._stdin is None:
            return False
        try:
            self._stdin.write(json.dumps(obj) + "\n")
            self._stdin.flush()
            return True
        except (OSError, ValueError):
            return False

    def submit(self, req: FleetRequest) -> bool:
        if not self.accepting():
            return False
        op = {"op": "submit", "rid": req.rid, "prompt": req.prompt,
              "max_new": req.max_new, "slo_ms": req.slo_ms}
        if req.unified:
            op["unified"] = True
        if not self._send(op):
            return False
        self._assigned[req.rid] = req
        return True

    def can_inject(self) -> bool:
        return True

    def inject(self, req: FleetRequest, payload: Dict[str, Any]) -> bool:
        if not self.accepting():
            return False
        if not self._send({"op": "inject", "rid": req.rid,
                           "payload": payload, "slo_ms": req.slo_ms}):
            return False
        self._assigned[req.rid] = req
        return True

    def forget(self, rid: int) -> None:
        self._assigned.pop(rid, None)

    def request_drain(self) -> bool:
        return self._send({"op": "drain"})

    def request_decommission(self) -> bool:
        """Ask the worker to drain and exit
        :data:`train.resilience.EXIT_DECOMMISSION` — retire the child at
        the supervisor FIRST (``GroupSupervisor.retire``) so the exit is
        terminal even if the drain stalls and escalates to a kill."""
        return self._send({"op": "decommission"})

    def request_exit(self) -> bool:
        return self._send({"op": "exit"})

    def pump(self) -> List[Dict[str, Any]]:
        out = []
        while True:
            with self._lock:
                if not self._events:
                    break
                rec = self._events.popleft()
            ev = rec.get("ev")
            if ev == "ready":
                self.ready = True
            elif ev == "status":
                try:
                    self.report = rec.get("report") or {}
                    self._signal = LoadSignal.from_report(self.report)
                except (TypeError, ValueError, KeyError):
                    pass
            elif ev == "done":
                self._assigned.pop(int(rec["rid"]), None)
                out.append(rec)
            elif ev == "handoff":
                # the stream left this (prefill) worker: emitting the
                # event IS the commit — the router owns the record now
                self._assigned.pop(int(rec["rid"]), None)
                out.append(rec)
            elif ev == "injected":
                # inject ack: the stream is live on this (decode)
                # worker; it stays in the assigned set until done
                out.append(rec)
            elif ev == "reject":
                # the worker's local queue refused (should not happen
                # while the router respects its caps): back to the
                # fleet queue like a death-requeue of one request
                req = self._assigned.pop(int(rec["rid"]), None)
                if req is not None:
                    rec["requeue"] = req
                    out.append(rec)
            elif ev == "drained":
                self.drained = rec.get("requests") or []
            elif ev == "preempt_notice":
                # the worker is going away on purpose: close admission
                # now (in-flight work finishes inside the grace window)
                self.noticed = True
                try:
                    self.notice_grace_s = float(rec.get("grace_s"))
                except (TypeError, ValueError):
                    self.notice_grace_s = None
        return out

    def assigned(self) -> List[int]:
        return list(self._assigned)

    def take_assigned(self) -> List[int]:
        rids = list(self._assigned)
        self._assigned.clear()
        return rids

    def close(self) -> None:
        self.request_exit()


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class FleetRouter:
    """SLO-aware front-end over N :class:`ReplicaHandle`\\ s (module
    docstring).  ``pump()`` is the service loop step: collect
    completions (advancing in-process replicas), requeue any dead
    replica's ledger entries, place queued work.  Single-threaded by
    design — subprocess replicas compute concurrently; the router is
    pure host bookkeeping."""

    def __init__(self, replicas: Sequence[ReplicaHandle], *,
                 queue_depth: int = 256,
                 default_slo_ms: Optional[float] = None,
                 replica_queue_cap: int = 2,
                 reject_infeasible: bool = False,
                 feasibility_margin: float = 1.5,
                 telemetry_dir: Optional[str] = None,
                 rollup_every: int = 50,
                 handoff_timeout_s: float = 5.0,
                 handoff_max_retries: int = 8,
                 wal_dir: Optional[str] = None,
                 now_fn=time.monotonic):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [h.name for h in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.queue_depth = int(queue_depth)
        self.default_slo_ms = default_slo_ms
        self.replica_queue_cap = int(replica_queue_cap)
        self.reject_infeasible = bool(reject_infeasible)
        self.feasibility_margin = float(feasibility_margin)
        self.now = now_fn
        self.queue: Deque[FleetRequest] = collections.deque()
        self.reqs: Dict[int, FleetRequest] = {}
        self._results: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._pumps = 0
        # inter-pump queue-wait attribution (utils/goodput.py): when a
        # pump ends with requests still queued (no feasible placement),
        # the time to the next pump is router queue-wait — retro-emitted
        # as a queue_wait span so the fleet goodput ledger prices it
        self._gap_wall: Optional[float] = None
        # completions collected OUTSIDE pump() (on_replica_down drains
        # a dead handle's raced events); the next pump() surfaces them
        self._completed_backlog: List[int] = []
        # --- disaggregated-handoff ledger -----------------------------
        # rids whose committed handoff record awaits a decode replica;
        # _inflight_injects maps a dispatched-but-unacked inject to
        # (handle name, deadline) so a stall times out and retries
        self.handoff_timeout_s = float(handoff_timeout_s)
        self.handoff_max_retries = int(handoff_max_retries)
        self._handoff_queue: Deque[int] = collections.deque()
        self._inflight_injects: Dict[int, Tuple[str, float]] = {}
        self._handoff_ms = QuantileSketch()
        self.handoffs = 0            # records committed at the router
        self.handoff_retries = 0     # inject rejects + timeouts
        self.handoff_reprefills = 0  # records dropped -> full re-prefill
        self.redecodes = 0           # decode deaths recovered from record
        self.duplicates_suppressed = 0
        # degraded single-pool mode: a disagg fleet with an empty
        # prefill or decode pool serves unified until backfill
        self.degraded_dispatches = 0
        self.degraded_mode_s = 0.0
        self._degraded_since: Optional[float] = None
        # counters (the router's own rollup record reports these)
        self.routed = 0
        self.rejected = 0            # bounded-queue + infeasible rejects
        self.rejected_infeasible = 0
        self.requeued = 0
        self.completed = 0
        self.replica_deaths = 0
        self.deadline_misses = 0
        self._completed_by: Dict[str, int] = {h.name: 0
                                              for h in self.replicas}
        self._missed_by: Dict[str, int] = {h.name: 0
                                           for h in self.replicas}
        self._completed_by_gen: Dict[int, int] = {}
        # windowed per-completion samples (t, replica, generation,
        # ttft_ms, missed), bounded so a long-lived router cannot grow it
        self.recent: Deque[Dict[str, Any]] = collections.deque(
            maxlen=512)
        self._was_alive: Dict[str, bool] = {h.name: True
                                            for h in self.replicas}
        # generation-aware traffic policy (weight rollouts): placement
        # PREFERS the primary generation — or, for the
        # deterministic rid-modulo canary slice, the canary generation —
        # and falls back to any accepting replica when the preferred
        # generation has none (availability beats generation purity)
        self._primary_gen = 0
        self._canary: Optional[Tuple[int, float]] = None
        # router telemetry: same sketch/rollup shape as a replica, role
        # "router", so obs_agg renders router vs replica side by side
        self._ttft = QuantileSketch()
        self._q_gauge = Gauge()
        self.rollup_every = max(0, int(rollup_every))
        self._jsonl = None
        self._t0 = time.perf_counter()
        self._heartbeat = None
        if telemetry_dir:
            os.makedirs(telemetry_dir, exist_ok=True)
            self._jsonl = open(os.path.join(telemetry_dir,
                                            "metrics.jsonl"), "a")
            self._heartbeat = telemetry_lib.Heartbeat(os.path.join(
                telemetry_dir,
                telemetry_lib.heartbeat_filename("router")))
        # --- durable control plane (write-ahead request ledger) -------
        # with a wal_dir, every commit point (accept, assign,
        # handoff-commit, completion) is journaled BEFORE the router's
        # in-memory state moves, and construction replays whatever a
        # previous incarnation journaled — the recovery path mirrors
        # the live protocol exactly (queued work requeues, committed
        # handoff records re-inject or degrade to unified reprefills,
        # completed requests answer from the journal)
        self._wal = None
        self._idem: Dict[str, int] = {}
        self._replayed_rids: set = set()
        self.recovery: Dict[str, Any] = {
            "recovered": False, "replayed": 0, "deduped": 0,
            "converted": 0, "lost": 0, "wall_s": 0.0}
        if wal_dir:
            from .wal import WriteAheadLog

            t_wal = time.perf_counter()
            self._wal = WriteAheadLog(wal_dir)
            self._recover(self._wal.open())
            self.recovery["lost"] = (
                self._wal.report.get("quarantined_records", 0)
                + self._wal.report.get("quarantined_segments", 0))
            self.recovery["wall_s"] = round(
                time.perf_counter() - t_wal, 6)

    def _recover(self, records) -> None:
        """Rebuild the request + handoff ledgers from a replayed WAL.
        Unfinished requests re-admit exactly once IN THEIR RECORDED
        PHASE: accepted/assigned work requeues for a full re-prefill
        (its replica died with the old incarnation — the pre-commit
        recovery row), committed handoff records rejoin the handoff
        queue (re-inject, or degrade to unified reprefills when the
        decode pool never comes back — the existing recovery table),
        and completed requests restore their results so an
        idempotency-key resubmit is answered from the journal with the
        exact bytes the first incarnation delivered."""
        if not records:
            return
        now = self.now()
        order: List[int] = []
        for rec in records:
            kind = rec.get("kind")
            rid = rec.get("rid")
            if kind == "accept":
                rid = int(rid)
                req = FleetRequest(
                    rid=rid, prompt=[int(t) for t in rec["prompt"]],
                    max_new=int(rec["max_new"]),
                    slo_ms=rec.get("slo_ms"), t_submit=now,
                    deadline=(now + rec["slo_ms"] / 1e3
                              if rec.get("slo_ms") is not None
                              else math.inf))
                self.reqs[rid] = req
                order.append(rid)
                if rec.get("idem"):
                    self._idem[str(rec["idem"])] = rid
            elif kind == "handoff" and int(rid) in self.reqs:
                req = self.reqs[int(rid)]
                req.handoff = rec.get("payload")
                req.prefill_replica = rec.get("prefill")
                req.phase = "handoff_inflight"
                req.handoff_t = now
                if rec.get("ttft_ms") is not None:
                    req.ttft_ms = float(rec["ttft_ms"])
            elif kind == "complete" and int(rid) in self.reqs:
                req = self.reqs[int(rid)]
                req.t_done = now
                req.phase = "done"
                req.handoff = None
                req.ttft_ms = rec.get("ttft_ms")
                req.itl_ms = rec.get("itl_ms")
                req.generation = int(rec.get("generation", 0))
                toks = [int(t) for t in rec["tokens"]]
                self._results[req.rid] = toks
                req.n_generated = len(toks) - len(req.prompt)
                self.completed += 1
                self._completed_by_gen[req.generation] = (
                    self._completed_by_gen.get(req.generation, 0) + 1)
            # "assign" records carry no recovery action of their own:
            # the assigned replica died with the old incarnation, so an
            # assigned-but-uncommitted request recovers exactly like a
            # queued one (full re-prefill) — the same row of the table
            # a live prefill death takes
        self._next_rid = 1 + max(order, default=-1)
        for rid in order:
            req = self.reqs[rid]
            if req.t_done is not None:
                continue
            self.recovery["replayed"] += 1
            self._replayed_rids.add(rid)
            if req.handoff is not None:
                self._handoff_queue.append(rid)
            else:
                req.phase = "queued"
                req.replica = None
                self.queue.append(req)
        self.recovery["recovered"] = True
        log(f"router: recovered {len(order)} journaled requests "
            f"({self.recovery['replayed']} re-admitted, "
            f"{self.completed} already complete, "
            f"{len(self._handoff_queue)} committed handoffs)")

    # ---- client surface ------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               slo_ms: Optional[float] = None,
               idem: Optional[str] = None) -> Optional[int]:
        """Enqueue at the fleet; returns the fleet rid, or None when
        admission rejects (bounded queue full, or — with
        ``reject_infeasible`` — no replica can plausibly meet the
        deadline).  Validation mirrors ``Scheduler.submit``'s loud
        refusal for never-servable requests."""
        prompt_ids = [int(t) for t in prompt_ids]
        if not prompt_ids:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens {max_new_tokens} < 1")
        if idem is not None and idem in self._idem:
            # idempotency-key dedupe (durable control plane): the
            # journal already owns this request.  Completed -> answer
            # from the journal (the rid re-surfaces on the next pump
            # with the original bytes); still in flight -> re-attach
            # the client to the live rid, never a second execution.
            rid = self._idem[idem]
            req = self.reqs.get(rid)
            if req is not None:
                self.recovery["deduped"] += 1
                if req.t_done is not None:
                    self._completed_backlog.append(rid)
                return rid
        if len(self.queue) >= self.queue_depth:
            self.rejected += 1
            return None
        slo = self.default_slo_ms if slo_ms is None else slo_ms
        now = self.now()
        deadline = now + slo / 1e3 if slo is not None else math.inf
        if (self.reject_infeasible and math.isfinite(deadline)
                and not self._any_feasible(deadline, now)):
            self.rejected += 1
            self.rejected_infeasible += 1
            return None
        rid = self._next_rid
        self._next_rid += 1
        req = FleetRequest(rid=rid, prompt=prompt_ids,
                           max_new=int(max_new_tokens), slo_ms=slo,
                           t_submit=now, deadline=deadline)
        if self._wal is not None:
            # ACCEPT commit point: journal before the queue sees it —
            # an accepted request survives the very next SIGKILL
            self._wal.append("accept", rid=rid, prompt=prompt_ids,
                             max_new=int(max_new_tokens), slo_ms=slo,
                             idem=idem)
        if idem is not None:
            self._idem[idem] = rid
        self.reqs[rid] = req
        self.queue.append(req)
        return rid

    def done(self, rid: int) -> bool:
        if rid in self._results:
            return True
        if rid in self.reqs:
            return False
        raise KeyError(f"request {rid}: unknown or already consumed")

    def result(self, rid: int) -> List[int]:
        return self._results.pop(rid)

    def stats(self, rid: int) -> FleetRequest:
        return self.reqs[rid]

    def pending(self) -> int:
        return len(self.queue)

    def in_flight(self) -> int:
        # committed handoff records awaiting a decode replica are
        # in-flight work the fleet still owes, visible nowhere else
        return (sum(len(h.assigned()) for h in self.replicas)
                + len(self._handoff_queue))

    def per_replica_completed(self) -> Dict[str, int]:
        return dict(self._completed_by)

    def per_replica_missed(self) -> Dict[str, int]:
        """Completed-past-deadline counts per replica name — the canary
        judge's per-slice SLO-burn input."""
        return dict(self._missed_by)

    def per_generation_completed(self) -> Dict[int, int]:
        """Completions per weight generation — with the flow traces'
        ``R{id}`` prefix (``id // GEN_STRIDE`` = generation), the two
        views of rollout attribution that must agree."""
        return dict(self._completed_by_gen)

    # ---- fleet membership (the scale-out / rollout surface) ------------
    def add_replica(self, h: ReplicaHandle,
                    generation: Optional[int] = None) -> None:
        """Register a NEW replica at runtime (scale-out, or a rollout
        spawning the next weight generation).  It receives traffic as
        soon as it reports ready; the traffic policy (:meth:`set_traffic`)
        decides which requests PREFER it."""
        if any(r.name == h.name for r in self.replicas):
            raise ValueError(f"duplicate replica name: {h.name!r}")
        if generation is not None:
            h.generation = int(generation)
        self.replicas.append(h)
        self._completed_by.setdefault(h.name, 0)
        self._missed_by.setdefault(h.name, 0)
        self._was_alive[h.name] = h.alive()

    def remove_replica(self, name: str) -> None:
        """Deregister a replica (after a decommission completes or a
        canary rolls back).  The dead handle's raced completion events
        drain first and are HONORED; anything still assigned requeues
        exactly once through the ledger.  History counters persist, so
        what the replica served stays readable."""
        for i, h in enumerate(self.replicas):
            if h.name != name:
                continue
            self.on_replica_down(name)
            del self.replicas[i]
            self._was_alive.pop(name, None)
            return
        raise KeyError(f"unknown replica {name!r}")

    def set_traffic(self, primary_generation: int,
                    canary_generation: Optional[int] = None,
                    canary_fraction: float = 0.0) -> None:
        """Generation-aware traffic shift.  ``canary_fraction`` of rids
        (a deterministic rid-modulo slice, so the split is reproducible
        and survives requeues) prefer ``canary_generation``; everything
        else prefers ``primary_generation``.  Preference, not partition:
        when no replica of the desired generation is accepting,
        placement falls back to any accepting replica — a rollout must
        never become downtime."""
        self._primary_gen = int(primary_generation)
        if canary_generation is None or canary_fraction <= 0.0:
            self._canary = None
        else:
            self._canary = (int(canary_generation),
                            min(1.0, float(canary_fraction)))

    def _desired_gen(self, req: FleetRequest) -> int:
        if self._canary is not None:
            gen, frac = self._canary
            # Knuth multiplicative hash, NOT rid % 1000 directly:
            # rids issue sequentially, so an unhashed modulo slice is a
            # PREFIX of rid space — requests submitted before the
            # canary came up, i.e. zero canary traffic.  The hash
            # spreads the slice uniformly over arrival order while
            # staying deterministic per rid (a requeued request keeps
            # its generation preference).
            if ((req.rid * 2654435761) % 1000) < int(round(frac * 1000)):
                return gen
        return self._primary_gen

    # ---- placement -----------------------------------------------------
    def _est_wait_ms(self, h: ReplicaHandle,
                     sig: Optional[LoadSignal]) -> Optional[float]:
        """Predicted time-to-first-token on ``h`` from its rollup: the
        replica's observed TTFT p50 scaled by its relative backlog.
        None = no signal yet (cold replica) — treated as feasible, the
        optimistic default that lets a fresh fleet admit its first
        requests."""
        if sig is None or sig.ttft_p50_ms is None:
            return None
        # max(), not sum: the replica's reported occupancy already
        # CONTAINS the requests the router dispatched there — adding
        # h.assigned() on top would double the predicted wait and
        # reject genuinely feasible deadlines (the same discipline as
        # _place's occupancy)
        backlog = max(sig.in_flight + sig.queue_depth,
                      len(h.assigned())) / sig.slots
        return sig.ttft_p50_ms * max(1.0, backlog)

    def _any_feasible(self, deadline: float, now: float) -> bool:
        slack_ms = (deadline - now) * 1e3
        for h in self.replicas:
            if not h.accepting():
                continue
            est = self._est_wait_ms(h, h.load())
            if est is None or est * self.feasibility_margin <= slack_ms:
                return True
        return False

    def _place(self, req: FleetRequest,
               sigs: Optional[Dict[str, Optional[LoadSignal]]] = None,
               kinds: Optional[Tuple[str, ...]] = None
               ) -> Optional[ReplicaHandle]:
        """Least-loaded placement over the live load signals, deadline
        feasibility preferred: among accepting replicas whose router-
        side backlog is under ``slots + replica_queue_cap``, pick the
        lowest (occupancy, block_utilization) — the occupancy fed by
        the replica's own reported rollup combined with what the router
        knows it has dispatched there (robust to status staleness in
        both directions)."""
        best = None
        best_key = None
        desired_gen = self._desired_gen(req)
        for h in self.replicas:
            if not h.accepting():
                continue
            if kinds is not None and role_kind(h) not in kinds:
                continue
            sig = (sigs[h.name] if sigs is not None
                   and h.name in sigs else h.load())
            n_assigned = len(h.assigned())
            slots = sig.slots if sig is not None else 1
            if n_assigned >= slots + self.replica_queue_cap:
                continue
            if sig is None:
                occ, util = n_assigned, 0.0
            else:
                occ = max(sig.occupancy,
                          n_assigned / max(1, sig.slots))
                util = sig.block_utilization
            feasible = True
            if math.isfinite(req.deadline):
                est = self._est_wait_ms(h, sig)
                slack_ms = (req.deadline - self.now()) * 1e3
                feasible = (est is None
                            or est * self.feasibility_margin
                            <= slack_ms)
            # generation preference ranks BELOW feasibility (a rollout
            # must not turn deadlines into misses) and ABOVE load (the
            # canary slice really lands on the canary when it can)
            off_gen = getattr(h, "generation", 0) != desired_gen
            key = (not feasible, off_gen, occ, util, h.name)
            if best_key is None or key < best_key:
                best, best_key = h, key
        return best

    # ---- the service loop ----------------------------------------------
    def pump(self) -> List[int]:
        """One router pass; returns fleet rids completed during it."""
        self._pumps += 1
        tracer = trace_lib.active()
        if tracer is not None and self._gap_wall is not None:
            gap = time.time() - self._gap_wall
            if gap >= 1e-4:
                tracer.record_span("queue_wait", self._gap_wall, gap,
                                   {"pump": self._pumps, "router": True})
        done_now: List[int] = self._completed_backlog
        self._completed_backlog = []
        for h in self.replicas:
            # death detection BEFORE pumping: a dead handle's last
            # events still drain (completions that raced the death are
            # honored, not re-run)
            alive = h.alive()
            for rec in h.pump():
                ev = rec.get("ev")
                if ev == "reject":
                    if rec.get("inject"):
                        self._handoff_failed(int(rec["rid"]), h.name)
                    else:
                        self._requeue_one(int(rec["rid"]), h.name)
                    continue
                if ev == "handoff":
                    self._on_handoff(h, rec)
                    continue
                if ev == "injected":
                    self._on_injected(h, int(rec["rid"]))
                    continue
                prev = self.reqs.get(int(rec["rid"]))
                if prev is not None and prev.t_done is not None:
                    # a timed-out inject that was actually alive can
                    # complete AFTER its re-dispatch did: exactly-once
                    # delivery means the second result is dropped here
                    self.duplicates_suppressed += 1
                    continue
                done_now.append(self._complete(h, rec))
            if not alive and self._was_alive.get(h.name, True):
                self._on_death(h)
            self._was_alive[h.name] = alive
        self._check_handoff_timeouts()
        self._update_degraded()
        self._dispatch_handoffs()
        self._dispatch()
        if self._heartbeat is not None:
            self._heartbeat.beat(self._pumps, None)
        if (self._jsonl is not None and self.rollup_every
                and self._pumps % self.rollup_every == 0):
            self._write_rollup()
        # requests still queued after dispatch = the next inter-pump gap
        # is queue-wait, not idle (see __init__)
        self._gap_wall = time.time() if self.queue else None
        return done_now

    def _pool_health(self) -> Tuple[bool, bool, bool]:
        """(disagg, prefill_ok, decode_ok): whether the fleet has role
        pools at all, and whether each duty has an accepting replica
        (unified replicas count for both)."""
        disagg = any(role_kind(h) in ("prefill", "decode")
                     for h in self.replicas)
        prefill_ok = decode_ok = False
        for h in self.replicas:
            if not h.accepting():
                continue
            kind = role_kind(h)
            prefill_ok = prefill_ok or kind in ("unified", "prefill")
            decode_ok = decode_ok or kind in ("unified", "decode")
        return disagg, prefill_ok, decode_ok

    def _update_degraded(self) -> None:
        """Track wall-clock spent with a missing pool.  Degraded is a
        MODE, not an error: traffic keeps flowing unified until the
        empty pool is backfilled."""
        disagg, prefill_ok, decode_ok = self._pool_health()
        # XOR on purpose: one empty pool = degraded single-pool serving;
        # BOTH empty (the start-up window, total outage) is an
        # availability gap, not a serving mode
        degraded = disagg and (prefill_ok != decode_ok)
        if degraded and self._degraded_since is None:
            self._degraded_since = self.now()
            log(f"fleet: degraded single-pool mode "
                f"(prefill_ok={prefill_ok} decode_ok={decode_ok}) — "
                f"serving unified until backfill")
        elif not degraded and self._degraded_since is not None:
            self.degraded_mode_s += self.now() - self._degraded_since
            self._degraded_since = None
            log("fleet: both role pools healthy — degraded mode over")

    def _dispatch(self) -> None:
        # load signals fetched ONCE per pass: an InprocReplica's load()
        # serializes + re-parses its whole sketch state, and the signal
        # cannot change between consecutive placements within one pass
        # (the router-side assigned() count, which does, is read live)
        sigs = {h.name: h.load() for h in self.replicas
                if h.accepting()}
        disagg, prefill_ok, decode_ok = self._pool_health()
        while self.queue:
            req = self.queue[0]
            if not disagg:
                req.unified = False
                h = self._place(req, sigs)
            elif prefill_ok:
                # healthy prefill duty; unified pins end-to-end service
                # when there is no decode pool to hand off to
                req.unified = not decode_ok
                h = self._place(req, sigs, kinds=("unified", "prefill"))
            else:
                # no prefill-capable replica: the decode pool serves
                # end-to-end rather than stranding traffic
                req.unified = True
                h = self._place(req, sigs, kinds=("unified", "decode"))
            if h is None:
                return
            if not h.submit(req):
                # refused at the wire (filled up / died this instant):
                # try the next candidate on the next pump
                return
            self.queue.popleft()
            req.replica = h.name
            req.t_dispatch = self.now()
            req.phase = ("decoding" if req.unified or not disagg
                         or role_kind(h) != "prefill" else "prefilling")
            if self._wal is not None:
                # ASSIGN commit point: recovery treats assigned-but-
                # uncommitted exactly like queued (the replica dies
                # with the incarnation), so the record is provenance —
                # which replica owed this request when the lights went
                # out — not a distinct replay phase
                self._wal.append("assign", rid=req.rid, replica=h.name,
                                 phase=req.phase)
            if disagg and req.unified:
                self.degraded_dispatches += 1
            self.routed += 1

    # ---- the handoff ledger --------------------------------------------
    def _on_handoff(self, h: ReplicaHandle, rec: Dict[str, Any]) -> None:
        """COMMIT: the prefill replica exported the stream and the
        router received the record.  From here the payload — block
        contents, block table, first sampled token — lives in the
        ledger, so a decode death re-decodes from it without repaying
        prefill."""
        rid = int(rec["rid"])
        req = self.reqs.get(rid)
        if req is None or req.t_done is not None:
            return
        req.handoff = rec.get("payload")
        req.prefill_replica = h.name
        req.replica = None
        req.phase = "handoff_inflight"
        req.handoff_t = self.now()
        req.handoff_next_t = 0.0
        # fleet-level TTFT is owned by the PREFILL side (the first
        # token was sampled there); the decode side only prices ITL
        if rec.get("ttft_ms") is not None:
            wait_ms = ((req.t_dispatch or req.t_submit)
                       - req.t_submit) * 1e3
            req.ttft_ms = wait_ms + float(rec["ttft_ms"])
        if self._wal is not None:
            # HANDOFF-COMMIT point: the exported payload itself is
            # journaled — after a full-fleet SIGKILL the next
            # incarnation re-injects from the journal without repaying
            # prefill, the same row a live decode death takes
            self._wal.append("handoff", rid=rid, payload=req.handoff,
                             prefill=h.name, ttft_ms=req.ttft_ms)
        self.handoffs += 1
        self._handoff_queue.append(rid)

    def _on_injected(self, h: ReplicaHandle, rid: int) -> None:
        req = self.reqs.get(rid)
        if req is None:
            return
        self._inflight_injects.pop(rid, None)
        req.phase = "decoding"
        req.replica = h.name
        if req.handoff_t is not None and req.handoff_ms is None:
            req.handoff_ms = (self.now() - req.handoff_t) * 1e3
            self._handoff_ms.add(req.handoff_ms)

    def _handoff_failed(self, rid: int, from_name: str) -> None:
        """An inject was rejected, timed out, or its target died before
        acking: retry with deterministic jittered backoff; after
        ``handoff_max_retries`` the record is dropped and the request
        re-prefills from scratch (the one path that repays prefill)."""
        req = self.reqs.get(rid)
        if req is None or req.t_done is not None:
            return
        self._inflight_injects.pop(rid, None)
        req.replica = None
        req.handoff_retries += 1
        self.handoff_retries += 1
        if req.handoff is None or (req.handoff_retries
                                   > self.handoff_max_retries):
            req.handoff = None
            req.handoff_t = None
            req.phase = "queued"
            self.handoff_reprefills += 1
            self._requeue_one(rid, from_name)
            return
        # deterministic jitter (same discipline as the canary slice:
        # hash the rid, don't consult a clock-seeded RNG) so a faulted
        # run replays identically
        base = min(2.0, 0.05 * (2 ** (req.handoff_retries - 1)))
        jitter = ((rid * 2654435761 + req.handoff_retries * 40503)
                  % 1000) / 1000.0
        req.handoff_next_t = self.now() + base * (0.5 + jitter)
        req.phase = "handoff_inflight"
        if rid not in self._handoff_queue:
            self._handoff_queue.append(rid)

    def _check_handoff_timeouts(self) -> None:
        now = self.now()
        for rid, (name, deadline) in list(self._inflight_injects.items()):
            if now < deadline:
                continue
            # re-own the record BEFORE re-dispatch: the stalled worker
            # must not surface this rid as assigned work anymore (a
            # late completion is suppressed as a duplicate)
            for h in self.replicas:
                if h.name == name:
                    h.forget(rid)
                    break
            self._handoff_failed(rid, name)

    def _place_inject(self, req: FleetRequest) -> Optional[ReplicaHandle]:
        """Least-loaded inject placement: decode pool preferred,
        unified replicas as fallback, prefill replicas never (the whole
        point is taking decode work OFF them)."""
        best = None
        best_key = None
        for h in self.replicas:
            if not h.accepting() or not h.can_inject():
                continue
            kind = role_kind(h)
            if kind == "prefill":
                continue
            sig = h.load()
            n_assigned = len(h.assigned())
            slots = sig.slots if sig is not None else 1
            if n_assigned >= slots + self.replica_queue_cap:
                continue
            if sig is None:
                occ, util = float(n_assigned), 0.0
            else:
                occ = max(sig.occupancy, n_assigned / max(1, sig.slots))
                util = sig.block_utilization
            key = (kind != "decode", occ, util, h.name)
            if best_key is None or key < best_key:
                best, best_key = h, key
        return best

    def _dispatch_handoffs(self) -> None:
        now = self.now()
        disagg, prefill_ok, decode_ok = self._pool_health()
        if disagg and prefill_ok and not decode_ok:
            # the decode DUTY is gone (pool dead or drained, no unified
            # fallback): a committed record has no target and waiting
            # is a hang, not a recovery.  Degrade the records the same
            # way queued traffic degrades — drop to a unified requeue
            # (re-prefill, the one path that repays prefill) on the
            # surviving pool.  A transient relaunch window pays one
            # extra prefill per in-flight record; tokens are unchanged
            # (greedy re-execution), and the reprefill is COUNTED.
            for _ in range(len(self._handoff_queue)):
                rid = self._handoff_queue.popleft()
                req = self.reqs.get(rid)
                if (req is None or req.t_done is not None
                        or req.handoff is None):
                    continue
                req.handoff = None
                req.handoff_t = None
                req.phase = "queued"
                self.handoff_reprefills += 1
                if rid in self._replayed_rids:
                    # a journaled handoff record whose decode pool
                    # never came back: converted to a unified
                    # reprefill, the recovery table's last row
                    self.recovery["converted"] += 1
                    self._replayed_rids.discard(rid)
                self._requeue_one(rid, req.prefill_replica or "?")
            return
        for _ in range(len(self._handoff_queue)):
            rid = self._handoff_queue.popleft()
            req = self.reqs.get(rid)
            if req is None or req.t_done is not None or req.handoff is None:
                continue
            if now < req.handoff_next_t:
                self._handoff_queue.append(rid)
                continue
            h = self._place_inject(req)
            if h is None or not h.inject(req, req.handoff):
                # no decode-capable target right now: keep the record;
                # timeout/retry accounting only starts at dispatch
                self._handoff_queue.append(rid)
                continue
            req.replica = h.name
            self._inflight_injects[rid] = (
                h.name, now + self.handoff_timeout_s)

    def _complete(self, h: ReplicaHandle, rec: Dict[str, Any]) -> int:
        rid = int(rec["rid"])
        req = self.reqs[rid]
        req.t_done = self.now()
        if req.handoff is None and req.ttft_ms is None:
            # unified path: the serving replica owns TTFT.  Handed-off
            # requests already composed router wait + prefill TTFT at
            # commit; the decode side's "ttft_ms" is inject latency,
            # not a user-visible first token.
            wait_ms = ((req.t_dispatch or req.t_submit)
                       - req.t_submit) * 1e3
            req.ttft_ms = (wait_ms + float(rec["ttft_ms"])
                           if rec.get("ttft_ms") is not None else wait_ms)
        req.itl_ms = rec.get("itl_ms")
        req.handoff = None             # record retired: exactly-once
        req.phase = "done"
        self._inflight_injects.pop(rid, None)
        toks = [int(t) for t in rec["tokens"]]
        self._results[rid] = toks
        req.n_generated = len(toks) - len(req.prompt)
        req.generation = getattr(h, "generation", 0)
        if self._wal is not None:
            # COMPLETION commit point: tokens ride the record so a
            # post-restart idempotency-key resubmit is answered with
            # the exact bytes this delivery carried
            self._wal.append("complete", rid=rid, tokens=toks,
                             ttft_ms=req.ttft_ms, itl_ms=req.itl_ms,
                             generation=req.generation)
        self.completed += 1
        self._completed_by[h.name] = (
            self._completed_by.get(h.name, 0) + 1)
        self._completed_by_gen[req.generation] = (
            self._completed_by_gen.get(req.generation, 0) + 1)
        if req.deadline_missed:
            self.deadline_misses += 1
            self._missed_by[h.name] = self._missed_by.get(h.name, 0) + 1
        if req.ttft_ms is not None:
            self._ttft.add(req.ttft_ms)
        # bounded recent-completions window: windowed per-generation
        # latency, which a lifetime sketch cannot answer (a fresh
        # replica's first-call TTFTs would dominate its p50 forever)
        self.recent.append({
            "t": req.t_done, "replica": h.name,
            "generation": req.generation, "ttft_ms": req.ttft_ms,
            "missed": bool(req.deadline_missed)})
        return rid

    def _requeue_one(self, rid: int, from_name: str) -> None:
        req = self.reqs.get(rid)
        if req is None or rid in self._results:
            return
        req.requeues += 1
        req.replica = None
        req.t_dispatch = None
        self.requeued += 1
        # FRONT of the queue, original submission order among requeued
        # peers: the oldest obligation keeps its place — no starvation
        pos = 0
        while (pos < len(self.queue)
               and self.queue[pos].t_submit <= req.t_submit
               and self.queue[pos].requeues > 0):
            pos += 1
        self.queue.insert(pos, req)

    def _on_death(self, h: ReplicaHandle) -> None:
        self.replica_deaths += 1
        rids = h.take_assigned()
        # requeue in original submission order so insert-at-front
        # preserves it
        for rid in sorted(rids,
                          key=lambda r: (self.reqs[r].t_submit, r),
                          reverse=True):
            req = self.reqs.get(rid)
            if (req is not None and req.t_done is None
                    and req.handoff is not None):
                # decode death AFTER commit: the ledger still holds the
                # exported blocks + first token, so this is a re-decode,
                # not a re-prefill — prefill is not repaid
                self._inflight_injects.pop(rid, None)
                req.replica = None
                req.phase = "handoff_inflight"
                self.redecodes += 1
                if rid not in self._handoff_queue:
                    self._handoff_queue.appendleft(rid)
                continue
            self._requeue_one(rid, h.name)
        if getattr(h, "drained", None):
            # a gracefully drained replica reported its consumed-token
            # state; the ledger already holds these requests — the
            # report is observability, not a second source of truth
            h.drained = None

    def on_replica_down(self, name: str) -> None:
        """External death notice (the fleet supervisor's exit event) —
        idempotent with pump()'s own detection.  Drains the dead
        handle's pending events FIRST: a completion that raced the
        death must be honored (surfaced via the next pump()), never
        requeued into a duplicate execution."""
        for h in self.replicas:
            if h.name != name:
                continue
            for rec in h.pump():
                ev = rec.get("ev")
                if ev == "reject":
                    if rec.get("inject"):
                        self._handoff_failed(int(rec["rid"]), h.name)
                    else:
                        self._requeue_one(int(rec["rid"]), h.name)
                elif ev == "handoff":
                    # a commit that raced the death is a commit: the
                    # record reached the router, decode proceeds
                    self._on_handoff(h, rec)
                elif ev == "injected":
                    self._on_injected(h, int(rec["rid"]))
                else:
                    prev = self.reqs.get(int(rec["rid"]))
                    if prev is not None and prev.t_done is not None:
                        self.duplicates_suppressed += 1
                    else:
                        self._completed_backlog.append(
                            self._complete(h, rec))
            if h.assigned():
                self._on_death(h)
            self._was_alive[name] = False

    # ---- telemetry -----------------------------------------------------
    def load_report(self) -> Dict[str, Any]:
        """The router's own rollup record (role="router") — same
        serialized-sketch shape as a replica's, so the fleet aggregator
        renders router-observed TTFT next to replica-observed TTFT."""
        # cached: a fabricated per-call run id would split this router
        # into N aggregator "writers" whose cumulative counters then
        # double-count (see _ServeTelemetry.rollup_record)
        if not hasattr(self, "_ident"):
            self._ident = trace_lib.run_identity()
        ident = self._ident
        self._q_gauge.set(len(self.queue))
        return {
            "kind": "rollup", "role": "router", "step": self._pumps,
            "t": round(time.perf_counter() - self._t0, 6),
            "t_unix": round(time.time(), 3),
            "p": ident["process_id"], "run": ident["run_id"],
            "inc": ident["incarnation"],
            "sketches": {k: s.to_dict()
                         for k, s in (("ttft_ms", self._ttft),
                                      ("handoff_ms", self._handoff_ms))
                         if s.n},
            "counters": {"routed": self.routed,
                         "rejected": self.rejected,
                         "rejected_infeasible": self.rejected_infeasible,
                         "requeued": self.requeued,
                         "completed": self.completed,
                         "replica_deaths": self.replica_deaths,
                         "deadline_misses": self.deadline_misses,
                         "handoffs": self.handoffs,
                         "handoff_retries": self.handoff_retries,
                         "handoff_reprefills": self.handoff_reprefills,
                         "redecodes": self.redecodes,
                         "degraded_dispatches": self.degraded_dispatches,
                         "duplicates_suppressed":
                             self.duplicates_suppressed,
                         "recovery_replayed": self.recovery["replayed"],
                         "recovery_deduped": self.recovery["deduped"],
                         "recovery_converted":
                             self.recovery["converted"],
                         "recovery_lost": self.recovery["lost"]},
            "gauges": {"queue_depth": self._q_gauge.to_dict()},
            "now": {"queue_depth": len(self.queue),
                    "in_flight": self.in_flight(),
                    "handoff_queue": len(self._handoff_queue),
                    # rebuilt-from-journal state is DISCLOSED, not
                    # passed off as organic history: a controller and
                    # the aggregator can tell a post-recovery rollup
                    # from a first-life one
                    "post_recovery": bool(self.recovery["recovered"]),
                    "degraded": self._degraded_since is not None,
                    "degraded_mode_s": round(self.degraded_mode_s
                                             + ((self.now()
                                                 - self._degraded_since)
                                                if self._degraded_since
                                                is not None else 0.0), 6)},
        }

    def handoff_stats(self) -> Dict[str, Any]:
        """The handoff ledger in one call."""
        return {
            "handoffs": self.handoffs,
            "handoff_ms_p50": self._handoff_ms.quantile(0.5),
            "handoff_ms_p99": self._handoff_ms.quantile(0.99),
            "handoff_retries": self.handoff_retries,
            "handoff_reprefills": self.handoff_reprefills,
            "redecodes": self.redecodes,
            "degraded_dispatches": self.degraded_dispatches,
            "degraded_mode_s": round(self.degraded_mode_s, 6),
            "duplicates_suppressed": self.duplicates_suppressed,
            "recovery": dict(self.recovery),
        }

    def _write_rollup(self) -> None:
        try:
            self._jsonl.write(json.dumps(self.load_report()) + "\n")
            self._jsonl.flush()
        except (OSError, ValueError):
            pass

    def close(self) -> None:
        if self._degraded_since is not None:
            self.degraded_mode_s += self.now() - self._degraded_since
            self._degraded_since = None
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        if self._jsonl is not None:
            self._write_rollup()
            if self._heartbeat is not None:
                self._heartbeat.beat(self._pumps, None, force=True,
                                     final=True)
            self._jsonl.close()
            self._jsonl = None


# ---------------------------------------------------------------------------
# fleet assembly (subprocess replicas under the group supervisor)
# ---------------------------------------------------------------------------

def worker_cmd(python: str, *, replica: int, model: Dict[str, Any],
               serve: Dict[str, Any], telemetry_dir: Optional[str],
               status_every: int = 5, step_sleep_ms: float = 0.0,
               tp: int = 0, crash_at_request: int = 0,
               prewarm: bool = False, generation: int = 0,
               ckpt: Optional[str] = None,
               faults: Optional[str] = None) -> List[str]:
    """The replica worker command line (see :func:`worker_main`)."""
    cmd = [python, "-m",
           "neural_networks_parallel_training_with_mpi_tpu_torch.serve"
           "._fleet_worker",
           "--worker", "--replica", str(int(replica))]
    for k, v in model.items():
        cmd += [f"--{k.replace('_', '-')}", str(v)]
    for k, v in serve.items():
        if isinstance(v, bool):
            if v:
                cmd += [f"--{k.replace('_', '-')}"]
        elif v is not None:
            cmd += [f"--{k.replace('_', '-')}", str(v)]
    if telemetry_dir:
        cmd += ["--telemetry-dir", telemetry_dir]
    cmd += ["--status-every", str(int(status_every))]
    if step_sleep_ms:
        cmd += ["--step-sleep-ms", str(float(step_sleep_ms))]
    if tp:
        cmd += ["--tp", str(int(tp))]
    if crash_at_request:
        cmd += ["--crash-at-request", str(int(crash_at_request))]
    if prewarm:
        cmd += ["--prewarm"]
    if generation:
        cmd += ["--generation", str(int(generation))]
    if ckpt:
        cmd += ["--ckpt", str(ckpt)]
    if faults:
        cmd += ["--faults", str(faults)]
    return cmd


def _spawn_replica(cfg: Dict[str, Any], k: int, *, generation: int = 0,
                   ckpt: Optional[str] = None,
                   faults: Optional[str] = None,
                   step_sleep_ms: Optional[float] = None,
                   crash_at_request: int = 0,
                   role: Optional[str] = None):
    """Build one subprocess replica's (handle, ChildSpec, telemetry dir)
    from a fleet spawn config — the per-replica constructor shared by
    :func:`launch_fleet` and :meth:`Fleet.add_replica` (scale-out and
    rollouts).  Generation-g replicas get the strided id
    ``g * GEN_STRIDE + k`` (flow-trace/telemetry attribution, module
    header)."""
    import subprocess

    from ..train.resilience import (PREEMPT_NOTICE_ENV, ChildSpec,
                                    heartbeat_filename)

    rid = int(generation) * GEN_STRIDE + int(k)
    name = f"replica-{rid}"
    tdir = (os.path.join(cfg["telemetry_root"], name)
            if cfg["telemetry_root"] else None)
    serve = dict(cfg["serve"])
    if role is not None:
        serve["role"] = role
    srole = str(serve.get("role") or "unified")
    # the worker scheduler's telemetry role names its heartbeat file
    trole = "serve" if srole == "unified" else f"serve-{srole}"
    handle = ProcReplica(
        name=name,
        role=("replica" if srole == "unified" else srole),
        generation=generation)
    cmd = worker_cmd(
        cfg["python"], replica=rid, model=cfg["model"],
        serve=serve, telemetry_dir=tdir,
        status_every=cfg["status_every"],
        step_sleep_ms=(cfg["step_sleep_ms"] if step_sleep_ms is None
                       else step_sleep_ms),
        tp=cfg["tp"], crash_at_request=crash_at_request,
        prewarm=cfg["prewarm"], generation=generation, ckpt=ckpt,
        faults=faults)
    env = {"NNPT_PROCESS_ID": str(rid),
           "PYTHONPATH": cfg["repo_root"] + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    # the advance-notice file channel (train.resilience): both ends of
    # GroupSupervisor.notify_preempt agree on this path.  Without it the
    # signal still delivers but the grace window falls back to the 2 s
    # default, so a telemetry-less fleet gets a tempdir path instead.
    env[PREEMPT_NOTICE_ENV] = (
        os.path.join(tdir, "preempt-notice.json") if tdir
        else os.path.join(tempfile.gettempdir(),
                          f"nnpt-preempt-{os.getpid()}-{rid}.json"))

    def spawn(spec, env, _cmd=cmd):
        return subprocess.Popen(
            _cmd, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, bufsize=1)

    def on_spawn(spec, proc, inc, _h=handle):
        _h.attach(proc, inc)

    spec = ChildSpec(
        name=name, cmd=cmd,
        role=("serve-replica" if srole == "unified"
              else f"serve-{srole}"),
        env=env,
        max_restarts=cfg["max_restarts"], backoff=cfg["backoff"],
        backoff_cap=cfg["backoff_cap"],
        heartbeat_path=(os.path.join(tdir, heartbeat_filename(trole, rid))
                        if tdir else None),
        heartbeat_timeout=cfg["heartbeat_timeout"],
        spawn=spawn, on_spawn=on_spawn)
    return handle, spec, tdir


@dataclass
class Fleet:
    """A running fleet: the router, its subprocess replica handles, and
    the group supervisor babysitting them.  ``pump()`` is the whole
    service loop from the owner's side: supervisor events (exits →
    router requeue; relaunches re-attach through ``on_spawn``) then one
    router pass."""
    router: FleetRouter
    supervisor: Any
    handles: List[ProcReplica]
    telemetry_dirs: List[str] = field(default_factory=list)
    events: List[dict] = field(default_factory=list)
    spawn_cfg: Optional[Dict[str, Any]] = None   # launch_fleet's recipe,
    #   so add_replica can scale out / spawn generations at runtime
    autopilot: Any = None    # attached control loop, ticked from pump()
    _next_index: int = 0     # next per-generation replica index k

    def pump(self) -> List[int]:
        for e in self.supervisor.poll():
            self.events.append(e)
            if e["event"] in ("exit", "hang_kill"):
                self.router.on_replica_down(e["child"])
        done = self.router.pump()
        if self.autopilot is not None:
            # the control loop rides the service loop: no extra thread,
            # so its cost shows in the tokens/s the fleet reports
            self.autopilot.tick()
        return done

    # client surface: a Fleet IS a router whose replicas happen to be
    # supervised subprocesses — load drivers (serve.loadgen.
    # run_fleet_closed_loop) work on either unchanged
    def submit(self, prompt_ids, max_new_tokens: int,
               slo_ms: Optional[float] = None,
               idem: Optional[str] = None) -> Optional[int]:
        return self.router.submit(prompt_ids, max_new_tokens,
                                  slo_ms=slo_ms, idem=idem)

    def result(self, rid: int) -> List[int]:
        return self.router.result(rid)

    def stats(self, rid: int) -> FleetRequest:
        return self.router.stats(rid)

    def done(self, rid: int) -> bool:
        return self.router.done(rid)

    def per_replica_completed(self) -> Dict[str, int]:
        return self.router.per_replica_completed()

    @property
    def rejected(self) -> int:
        return self.router.rejected

    @property
    def requeued(self) -> int:
        return self.router.requeued

    # ---- runtime membership (the autopilot's actuation surface) --------
    def add_replica(self, *, generation: int = 0,
                    ckpt: Optional[str] = None,
                    faults: Optional[str] = None,
                    step_sleep_ms: Optional[float] = None,
                    role: Optional[str] = None
                    ) -> ProcReplica:
        """Spawn ONE new supervised replica at runtime from the stored
        launch recipe: scale-out (same generation) or a rollout spawning
        ``generation`` from a verified weight snapshot (``ckpt``).  The
        replica starts taking traffic when its ready event lands;
        ``faults`` injects the fleet fault kinds (utils/faults.py) into
        just this worker; ``role`` overrides the recipe's serving role
        (a dead prefill pool is backfilled with ``role="prefill"``,
        whatever the recipe says)."""
        if self.spawn_cfg is None:
            raise RuntimeError(
                "this Fleet was not built by launch_fleet (no spawn "
                "config to scale out from)")
        k = self._next_index
        self._next_index += 1
        handle, spec, tdir = _spawn_replica(
            self.spawn_cfg, k, generation=generation, ckpt=ckpt,
            faults=faults, step_sleep_ms=step_sleep_ms, role=role)
        self.handles.append(handle)
        if tdir:
            self.telemetry_dirs.append(tdir)
        self.supervisor.add_child(spec)    # launches immediately
        self.router.add_replica(handle, generation=generation)
        return handle

    def decommission(self, name: str) -> bool:
        """Begin intentional removal: retire the child at the supervisor
        (its next exit is terminal — no relaunch, no budget burn), then
        ask the worker to drain and exit 47.  Returns whether the
        decommission op reached the worker's pipe; the caller watches
        :meth:`replica_done` and escalates to :meth:`force_kill` if the
        drain stalls."""
        self.supervisor.retire(name)
        for h in self.handles:
            if h.name == name:
                return h.request_decommission()
        return False

    def notify_preempt(self, name: str, grace_s: float = 2.0) -> bool:
        """Deliver an advance preemption notice to one replica (the
        real-world seam: SIGUSR1 + the notice file, via
        ``GroupSupervisor.notify_preempt``).  The worker answers by
        closing admission, finishing in-flight work inside the grace
        window, and exiting 47, terminal at the supervisor without a
        retire (47 is in the no-retry contract)."""
        return self.supervisor.notify_preempt(name, grace_s=grace_s)

    def force_kill(self, name: str) -> None:
        """Stalled-drain escalation: SIGKILL the (already retired)
        child.  The router's ledger requeues its in-flight work exactly
        once; the retirement keeps the supervisor from relaunching it."""
        proc = self.supervisor.proc(name)
        if proc is not None and proc.poll() is None:
            proc.kill()

    def replica_done(self, name: str) -> Optional[int]:
        """Final exit code once the child will never run again (None
        while it is still alive or could relaunch)."""
        return self.supervisor.done(name)

    def remove_replica(self, name: str) -> None:
        """Forget a terminal replica: router deregistration (raced
        completions honored, leftovers requeued once) + supervisor
        bookkeeping cleanup + handle removal."""
        self.router.remove_replica(name)
        try:
            self.supervisor.remove_child(name)
        except (KeyError, ValueError):
            pass
        self.handles = [h for h in self.handles if h.name != name]

    def wait_ready(self, timeout_s: float = 180.0) -> None:
        """Block until every replica has started up + reported ready (or
        been given up on by the supervisor)."""
        t0 = time.time()
        while time.time() - t0 < timeout_s:
            self.pump()
            pending = [h.name for h in self.handles
                       if not h.ready
                       and self.supervisor.done(h.name) is None]
            if not pending:
                return
            time.sleep(0.05)
        raise TimeoutError(f"replicas never became ready: {pending}")

    def close(self) -> None:
        for h in self.handles:
            h.request_exit()
        deadline = time.time() + 5.0
        while time.time() < deadline and any(
                h.alive() for h in self.handles):
            self.supervisor.poll()
            time.sleep(0.05)
        self.supervisor.terminate_all()
        self.router.close()


def launch_fleet(n_replicas: int, *, model: Dict[str, Any],
                 serve: Dict[str, Any],
                 telemetry_root: Optional[str] = None,
                 router_kwargs: Optional[Dict[str, Any]] = None,
                 status_every: int = 5, step_sleep_ms: float = 0.0,
                 tp: int = 0, max_restarts: int = 2,
                 backoff: float = 0.5, backoff_cap: float = 10.0,
                 heartbeat_timeout: float = 0.0,
                 crash_at_request: int = 0,
                 prewarm: bool = False,
                 python: Optional[str] = None,
                 roles: Optional[Sequence[Optional[str]]] = None,
                 log=None) -> Fleet:
    """Assemble a subprocess fleet: N workers (each its own process and
    CUDA context) under a :class:`train.resilience.GroupSupervisor`, wired
    into a :class:`FleetRouter`.  ``model``/``serve`` are the worker's
    geometry flags (:func:`worker_cmd`); every replica gets its own
    telemetry dir under ``telemetry_root`` (``replica-K/``) and a
    distinct ``NNPT_PROCESS_ID`` so heartbeats, rollup identities and
    flow-trace ids never collide (tools/obs_agg.py merges the dirs).
    ``roles`` (optional, one entry per replica, e.g. ``["prefill",
    "decode", "decode"]``) builds a DISAGGREGATED fleet: each entry
    overrides the serve config's role for that replica; None entries
    keep the recipe's role."""
    from ..train.resilience import GroupSupervisor

    python = python or sys.executable
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = dict(python=python, model=dict(model), serve=dict(serve),
               telemetry_root=telemetry_root, status_every=status_every,
               step_sleep_ms=step_sleep_ms, tp=tp,
               max_restarts=max_restarts, backoff=backoff,
               backoff_cap=backoff_cap,
               heartbeat_timeout=heartbeat_timeout, prewarm=prewarm,
               repo_root=repo_root)
    handles: List[ProcReplica] = []
    specs = []
    tdirs: List[str] = []
    if roles is not None and len(roles) != int(n_replicas):
        raise ValueError(
            f"roles has {len(roles)} entries for {n_replicas} replicas")
    for k in range(int(n_replicas)):
        handle, spec, tdir = _spawn_replica(
            cfg, k, crash_at_request=(crash_at_request
                                      if k == 0 else 0),
            role=(roles[k] if roles is not None else None))
        handles.append(handle)
        specs.append(spec)
        tdirs.append(tdir)
    sup = GroupSupervisor(specs, log=log)
    router_tdir = (os.path.join(telemetry_root, "router")
                   if telemetry_root else None)
    router = FleetRouter(handles, telemetry_dir=router_tdir,
                         **(router_kwargs or {}))
    fleet = Fleet(router=router, supervisor=sup, handles=handles,
                  telemetry_dirs=[d for d in tdirs if d]
                  + ([router_tdir] if router_tdir else []),
                  spawn_cfg=cfg, _next_index=int(n_replicas))
    sup.start()
    return fleet


# ---------------------------------------------------------------------------
# the replica worker process
# ---------------------------------------------------------------------------

def _worker_argparser():
    import argparse

    ap = argparse.ArgumentParser(
        prog="serve._fleet_worker --worker",
        description="one serving replica speaking the fleet pipe "
                    "protocol on stdio")
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--replica", type=int, default=0)
    # model geometry (replicas must agree bit for bit: the same flags and
    # seed give the same params and the same greedy tokens anywhere)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=128)
    ap.add_argument("--init-seed", type=int, default=0)
    # serve geometry
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="0 = a non-starved pool for slots x max_len")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--queue-depth", type=int, default=64)
    ap.add_argument("--attn-impl", default="fused",
                    choices=("gathered", "fused"),
                    help="fused: the CUDA paged-attention kernel on the "
                         "card (its plain version on the CPU)")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--role", default="unified",
                    choices=("unified", "prefill", "decode"),
                    help="serving role: prefill replicas export streams "
                         "at the prefill -> decode boundary as handoff "
                         "events; decode replicas admit them through the "
                         "inject op; unified serves end to end")
    # fleet plumbing
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--status-every", type=int, default=5,
                    help="ticks between status (load-report) events")
    ap.add_argument("--step-sleep-ms", type=float, default=0.0,
                    help="latency added per busy engine pass (an emulated "
                         "device step)")
    ap.add_argument("--tp", type=int, default=0,
                    help="span this replica over a LocalTensorGroup of N "
                         "shards through generate_tp (0 = the paged "
                         "scheduler)")
    ap.add_argument("--crash-at-request", type=int, default=0,
                    help="fault injection: os._exit(17) when the Nth "
                         "submit arrives")
    ap.add_argument("--generation", type=int, default=0,
                    help="weight generation this replica serves "
                         "(stamped into ready/status events; the replica "
                         "id already encodes it as id // GEN_STRIDE)")
    ap.add_argument("--ckpt", default=None,
                    help="load params from this weight snapshot dir "
                         "(serve.autopilot.save_weight_snapshot, of either "
                         "package); manifest-verified before use, any "
                         "integrity, shape or dtype failure exits 44 "
                         "(EXIT_ANOMALY, no retry)")
    ap.add_argument("--faults", default=None,
                    help="utils/faults.py spec for the fleet kinds "
                         "(replica_kill@N, stall_drain@N-M, ...); the step "
                         "counter is this worker's submit (or inject, or "
                         "handoff) count, proc= matches --replica")
    ap.add_argument("--prewarm", action="store_true",
                    help="pay every prefill-bucket and decode first call "
                         "(serve.loadgen.prewarm) before reporting ready")
    ap.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                    help="gpu (default): the card, or exit with the "
                         "no-CUDA error; cpu: the plain PyTorch path")
    return ap


def _handoff_prewarm(model, params, cfg, device) -> None:
    """One export/import round trip through throwaway prefill and decode
    schedulers, so a decode replica's first real inject does not book the
    import's first call as its handoff time."""
    import dataclasses

    from .scheduler import Scheduler

    pre = Scheduler(model, params, dataclasses.replace(
        cfg, role="prefill", telemetry_dir=None, trace_dir=None),
        device=device)
    dec = Scheduler(model, params, dataclasses.replace(
        cfg, role="decode", telemetry_dir=None, trace_dir=None),
        device=device)
    try:
        if pre.submit([1, 2, 3, 4], 4) is None:
            raise RuntimeError("handoff prewarm rejected")
        for _ in range(64):
            pre.tick()
            hs = pre.take_handoffs()
            if hs:
                break
        else:
            raise RuntimeError("handoff prewarm never exported")
        r2 = dec.inject(hs[0]["payload"])
        if r2 is None:
            raise RuntimeError("handoff prewarm inject rejected")
        dec.run_until_drained()
        dec.result(r2)
    finally:
        pre.close()
        dec.close()


def worker_main(argv: Optional[Sequence[str]] = None) -> int:
    args = _worker_argparser().parse_args(argv)
    # protocol stream = the real stdout fd; everything else (log(), CUDA
    # and the kernel builds) goes to stderr, so a stray print never tears
    # a protocol line.  Before any CUDA call and any kernel load.
    caller_stdout = sys.stdout
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    try:
        # no card and no --platform cpu: resolve_device's error
        device = resolve_device("cuda" if args.platform == "gpu" else "cpu")
    except Exception:
        # nothing was served: the caller's stdout goes back as it was
        os.dup2(proto.fileno(), 1)
        proto.close()
        sys.stdout = caller_stdout
        raise

    import selectors

    import torch

    from ..models.transformer import Transformer, TransformerConfig
    from ..utils import prng
    from .scheduler import Scheduler, ServeConfig

    model = Transformer(TransformerConfig(
        vocab_size=args.vocab, max_seq_len=args.seq,
        n_layers=args.layers, d_model=args.d_model, n_heads=args.heads,
        d_ff=args.d_ff), device=device)
    # the seeded init on the host's generator, so every worker of a seed
    # agrees; under --ckpt only the tree's shapes matter, drawn on the
    # device (no host threads spent on values the snapshot replaces)
    params = model.init(torch.Generator(device=device).manual_seed(
        args.init_seed) if args.ckpt else prng.init_generator(args.init_seed))

    def emit(obj: Dict[str, Any]) -> None:
        try:
            proto.write(json.dumps(obj) + "\n")
            proto.flush()
        except BrokenPipeError:
            # the control plane died mid-write: the event has no reader.
            # The stdin-EOF orphan path owns the exit; a SIGPIPE-shaped
            # crash here would turn a clean orphan drain into a failure.
            pass

    if args.ckpt:
        # replace the seeded params with a verified weight snapshot.  A
        # failure is a deterministic no-retry exit: a relaunch would read
        # the same bad bytes
        try:
            from .autopilot import load_weight_snapshot

            params = load_weight_snapshot(args.ckpt, params)
            print(f"[worker {args.replica}] loaded weight snapshot "
                  f"{args.ckpt}", file=sys.stderr, flush=True)
        except Exception as exc:
            emit({"ev": "load_error", "error": str(exc)[:500]})
            print(f"[worker {args.replica}] checkpoint load failed: "
                  f"{exc}", file=sys.stderr, flush=True)
            from ..train.resilience import EXIT_ANOMALY

            return EXIT_ANOMALY

    from ..utils.faults import FaultPlan

    fault_plan = FaultPlan.from_config(args.faults or "")

    engine: ReplicaHandle
    sched: Optional[Scheduler] = None
    if args.tp and args.tp > 1:
        from ..parallel import megatron

        params_tp = dict(params)
        params_tp["blocks"] = megatron.permute_qkv(
            params["blocks"], model.cfg.d_model, model.cfg.n_heads,
            args.tp, kv_heads=model.cfg.kv_heads)
        engine = TPGenerateReplica(model, params_tp,
                                   megatron.LocalTensorGroup(args.tp),
                                   batch=args.slots,
                                   queue_cap=args.queue_depth,
                                   name=f"replica-{args.replica}",
                                   device=device)
    else:
        num_blocks = args.num_blocks or (
            1 + args.slots * (-(-args.seq // args.block_size)))
        sched = Scheduler(model, params, ServeConfig(
            slots=args.slots, num_blocks=num_blocks,
            block_size=args.block_size,
            prefill_chunk=args.prefill_chunk,
            queue_depth=args.queue_depth, attn_impl=args.attn_impl,
            prefix_cache=args.prefix_cache, kv_quant=args.kv_quant,
            temperature=args.temperature, role=args.role,
            telemetry_dir=args.telemetry_dir,
            rollup_every=max(1, args.status_every) * 5,
            replica=args.replica), device=device)
        if args.prewarm:
            import dataclasses

            from .loadgen import prewarm

            # a throwaway scheduler of the same geometry: the first calls
            # it pays (kernel loads, cuBLAS handles, allocator growth) are
            # this process's.  Always unified: a prefill-role throwaway
            # would hand its requests off instead of completing them
            prewarm(lambda: Scheduler(model, params, dataclasses.replace(
                sched.cfg, role="unified", telemetry_dir=None,
                trace_dir=None), device=device))
            if args.role == "decode":
                _handoff_prewarm(model, params, sched.cfg, device)
        engine = InprocReplica(sched, name=f"replica-{args.replica}")

    from ..ops.paged_attention import paged_attention as _paged

    def status() -> None:
        """One load report, with this process's kernel launches (the
        parent cannot read a worker's counters otherwise)."""
        report = (sched.load_report() if sched is not None
                  else engine.load_report())
        report["generation"] = args.generation
        report["kernel_launches"] = {"paged_attention": _paged.launches}
        emit({"ev": "status", "report": report})

    # raw non-blocking stdin: a burst of submit lines must all drain in
    # one pass (a buffered readline-per-select would admit one request
    # per idle timeout); selectors only provide the idle wait
    stdin_fd = sys.stdin.fileno()
    os.set_blocking(stdin_fd, False)
    sel = selectors.DefaultSelector()
    sel.register(stdin_fd, selectors.EVENT_READ)
    inbuf = b""

    def read_ops() -> Tuple[List[Dict[str, Any]], bool]:
        nonlocal inbuf
        eof = False
        while True:
            try:
                chunk = os.read(stdin_fd, 65536)
            except BlockingIOError:
                break
            except OSError:
                eof = True
                break
            if chunk == b"":
                eof = True
                break
            inbuf += chunk
        ops = []
        while b"\n" in inbuf:
            line, inbuf = inbuf.split(b"\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                op = json.loads(line)
            except ValueError:
                continue
            if isinstance(op, dict):
                ops.append(op)
        return ops, eof

    # advance-notice preemption (train.resilience channel): SIGUSR1 from
    # the supervisor/platform — or the injected twin, the ``preempt``
    # fault kind — sets a deadline; the worker keeps serving its
    # in-flight work, stops getting NEW work once the router pumps the
    # announcement (ProcReplica.accepting gates), and exits 47 as soon
    # as it is idle or the grace window closes, whichever comes first.
    import signal as signal_lib

    from ..train.resilience import (EXIT_DECOMMISSION, PREEMPT_GRACE_ENV,
                                    read_preempt_notice)

    notice: Dict[str, Any] = {"deadline": None, "grace_s": None,
                              "announced": None}

    def _notice_grace(spec_grace: Optional[float] = None) -> float:
        if spec_grace is not None:
            return float(spec_grace)
        rec = read_preempt_notice() or {}
        try:
            return float(rec.get("grace_s")
                         or os.environ.get(PREEMPT_GRACE_ENV) or 2.0)
        except (TypeError, ValueError):
            return 2.0

    def _on_notice_signal(signum, frame):
        if notice["deadline"] is not None:
            return   # idempotent: a repeated notice never escalates
        g = _notice_grace()
        notice["grace_s"] = g
        notice["deadline"] = time.monotonic() + g

    try:
        signal_lib.signal(signal_lib.SIGUSR1, _on_notice_signal)
    except ValueError:
        pass   # not the main thread (in-process tests): no signal seam

    emit({"ev": "ready", "replica": args.replica, "pid": os.getpid(),
          "tp": args.tp, "role": args.role,
          "generation": args.generation, "incarnation":
          os.environ.get("NNPT_INCARNATION", "0")})
    submits_seen = 0
    injects_seen = 0
    handoffs_seen = 0
    ticks = 0
    last_status = 0.0
    stop = False
    while not stop:
        # 1) drain control ops without blocking while work is pending
        busy = bool(engine.assigned()) or (
            sched is not None and (sched.pending()
                                   or sched.in_flight()))
        if not busy:
            sel.select(timeout=0.05)    # idle: park until ops arrive
        ops, eof = read_ops()
        if eof and not any(op.get("op") == "exit" for op in ops):
            # stdin EOF without the exit handshake: the control plane
            # died and this worker is ORPHANED.  Its in-flight work is
            # already owed by the next incarnation's journal replay, so
            # finishing it would deliver to nobody — drain through the
            # existing advance-notice channel (zero grace) and take the
            # same terminal exit 47 a noticed preemption takes.
            if notice["deadline"] is None:
                notice["grace_s"] = 0.0
                notice["deadline"] = time.monotonic()
        elif eof:
            stop = True    # parent hung up after exit: leave cleanly
        for op in ops:
            kind = op.get("op")
            if kind == "submit":
                submits_seen += 1
                if (args.crash_at_request
                        and submits_seen >= args.crash_at_request):
                    proto.flush()
                    os._exit(17)   # injected crash: SIGKILL-shaped
                if fault_plan is not None and fault_plan.fire_if_due(
                        "replica_kill", submits_seen,
                        proc=args.replica):
                    print(f"[faults] replica_kill at submit "
                          f"{submits_seen}: SIGKILL", file=sys.stderr,
                          flush=True)
                    proto.flush()
                    os.kill(os.getpid(), signal_lib.SIGKILL)
                if fault_plan is not None and notice["deadline"] is None:
                    spec = fault_plan.due_spec(
                        "preempt", submits_seen, proc=args.replica)
                    if spec is not None:
                        # injected twin of the SIGUSR1 notice: same
                        # deadline bookkeeping, same drain-and-exit-47
                        notice["grace_s"] = float(spec.grace)
                        notice["deadline"] = (time.monotonic()
                                              + float(spec.grace))
                        print(f"[faults] preempt notice at submit "
                              f"{submits_seen} (grace {spec.grace:.1f}s)",
                              file=sys.stderr, flush=True)
                req = FleetRequest(
                    rid=int(op["rid"]),
                    prompt=[int(t) for t in op["prompt"]],
                    max_new=int(op["max_new"]),
                    slo_ms=op.get("slo_ms"),
                    t_submit=time.monotonic(), deadline=math.inf,
                    unified=bool(op.get("unified")))
                if not engine.submit(req):
                    emit({"ev": "reject", "rid": req.rid})
            elif kind == "inject":
                # a committed handoff record arriving at a decode
                # replica; ack "injected" or reject with "inject": true
                injects_seen += 1
                if fault_plan is not None and fault_plan.fire_if_due(
                        "handoff_stall", injects_seen,
                        proc=args.replica):
                    # wedged-inject stand-in: swallow the op (no ack,
                    # no stream) — the router's handoff timeout must
                    # abort and retry elsewhere
                    print(f"[faults] handoff_stall: ignoring inject "
                          f"{injects_seen}", file=sys.stderr, flush=True)
                    continue
                req = FleetRequest(
                    rid=int(op["rid"]),
                    prompt=[int(t) for t in
                            (op.get("payload") or {}).get("prompt", [])],
                    max_new=int((op.get("payload") or {})
                                .get("max_new", 1)),
                    slo_ms=op.get("slo_ms"),
                    t_submit=time.monotonic(), deadline=math.inf)
                ok = False
                try:
                    ok = engine.inject(req, op.get("payload") or {})
                except ValueError as exc:
                    print(f"[worker {args.replica}] inject rejected: "
                          f"{exc}", file=sys.stderr, flush=True)
                if not ok:
                    emit({"ev": "reject", "rid": req.rid,
                          "inject": True})
            elif kind in ("drain", "decommission"):
                if fault_plan is not None and fault_plan.fire_if_due(
                        "stall_drain", submits_seen,
                        proc=args.replica):
                    # wedged-shutdown stand-in: the op is swallowed; the
                    # owner's drain timeout must escalate to a kill
                    print(f"[faults] stall_drain: ignoring {kind}",
                          file=sys.stderr, flush=True)
                    continue
                if sched is not None:
                    reqs = sched.quiesce()
                else:
                    reqs = [{"rid": r, "prefilled": 0, "generated": 0}
                            for r in engine.take_assigned()]
                status()      # the final counts, before the process ends
                emit({"ev": "drained", "requests": reqs})
                if kind == "decommission":
                    # intentional-decommission handshake: drained state
                    # reported, now exit the code the (already retired)
                    # supervisor treats as terminal without budget burn
                    proto.flush()
                    if sched is not None:
                        sched.close()
                    from ..train.resilience import EXIT_DECOMMISSION

                    return EXIT_DECOMMISSION
            elif kind == "exit":
                stop = True
        if stop:
            break
        # 1b) advance-notice drain: announce once (the router closes
        # admission when it pumps this), keep serving in-flight work,
        # and exit 47 at idle-after-settle or the grace deadline —
        # whichever comes first.  An idle exit reports an EMPTY drained
        # set: the zero-requeue preemption the crash path cannot give.
        if notice["deadline"] is not None:
            now_m = time.monotonic()
            if notice["announced"] is None:
                notice["announced"] = now_m
                print(f"[worker {args.replica}] preemption notice: "
                      f"draining within {notice['grace_s']:.1f}s, then "
                      f"exit {EXIT_DECOMMISSION}", file=sys.stderr,
                      flush=True)
                emit({"ev": "preempt_notice",
                      "grace_s": notice["grace_s"]})
            idle = not (engine.assigned()
                        or (sched is not None
                            and (sched.pending() or sched.in_flight())))
            if now_m >= notice["deadline"] or (
                    idle and now_m >= notice["announced"] + 0.25):
                # the decommission handshake, self-initiated: report
                # drained state (leftovers requeue exactly once through
                # the router's ledger), then the terminal no-retry exit
                if sched is not None:
                    reqs = sched.quiesce()
                else:
                    reqs = [{"rid": r, "prefilled": 0, "generated": 0}
                            for r in engine.take_assigned()]
                status()
                emit({"ev": "drained", "requests": reqs})
                proto.flush()
                if sched is not None:
                    sched.close()
                return EXIT_DECOMMISSION
        # 2) advance the engine one step; report completions, handoffs
        # and inject acks (the engine tags non-done events with "ev")
        for rec in engine.pump():
            rec.pop("requeue", None)
            ev = rec.pop("ev", "done")
            if ev == "handoff":
                handoffs_seen += 1
                if fault_plan is not None and fault_plan.fire_if_due(
                        "handoff_kill", handoffs_seen,
                        proc=args.replica):
                    # die BEFORE the commit line reaches the wire: the
                    # router never saw the record, so the request
                    # requeues for a full re-prefill elsewhere
                    print(f"[faults] handoff_kill at handoff "
                          f"{handoffs_seen}: SIGKILL pre-commit",
                          file=sys.stderr, flush=True)
                    proto.flush()
                    os.kill(os.getpid(), signal_lib.SIGKILL)
                emit({"ev": "handoff", **rec})
                if fault_plan is not None and fault_plan.fire_if_due(
                        "handoff_kill_post", handoffs_seen,
                        proc=args.replica):
                    # die AFTER the commit line: the router owns the
                    # record — decode proceeds, prefill is not repaid
                    print(f"[faults] handoff_kill_post at handoff "
                          f"{handoffs_seen}: SIGKILL post-commit",
                          file=sys.stderr, flush=True)
                    proto.flush()
                    os.kill(os.getpid(), signal_lib.SIGKILL)
                continue
            emit({"ev": ev, **rec})
            if ev == "injected" and fault_plan is not None \
                    and fault_plan.fire_if_due(
                        "decode_kill", injects_seen,
                        proc=args.replica):
                # decode death mid-stream, after the ack: the router
                # re-injects from its ledger record (re-decode only)
                print(f"[faults] decode_kill after inject "
                      f"{injects_seen}: SIGKILL", file=sys.stderr,
                      flush=True)
                proto.flush()
                os.kill(os.getpid(), signal_lib.SIGKILL)
        ticks += 1
        slow_ms = (fault_plan.slow_penalty_ms(submits_seen,
                                              proc=args.replica)
                   if fault_plan is not None and busy else 0.0)
        if (args.step_sleep_ms and busy) or slow_ms:
            time.sleep(((args.step_sleep_ms if busy else 0.0)
                        + slow_ms) / 1e3)
        # 3) status cadence: every N ticks while busy, ~4 Hz floor
        now = time.monotonic()
        if (ticks % max(1, args.status_every) == 0
                or now - last_status > 0.25):
            status()
            last_status = now
    if sched is not None:
        sched.close()
    return 0
