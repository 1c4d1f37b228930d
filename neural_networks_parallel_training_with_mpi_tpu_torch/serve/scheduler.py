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

Not ported yet, and refused by :class:`Scheduler`: the telemetry stream
(``telemetry_dir``), span tracing (``trace_dir``), fleet rollups
(``rollup_every``) and the disaggregated roles (``role``).
"""

from __future__ import annotations

import collections
import logging
import math
import time
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

from ..models.transformer import Transformer
from ..utils.platform import DeviceLike
from .paged_kv import PagedDecodeServer

log = logging.getLogger(__name__)


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
    completed_history: int = 1024  # completed Requests kept for stats()
    # not ported yet (see the module docstring); anything but the default
    # raises NotImplementedError
    telemetry_dir: Optional[str] = None
    trace_dir: Optional[str] = None
    rollup_every: int = 0
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


class Scheduler:
    """The continuous-batching service loop (see the module docstring).

    ``now_fn`` injects the clock (tests drive a virtual one).  A caller
    timing a GPU run passes a clock that synchronises the device first,
    since the host runs ahead of the kernels it queues."""

    def __init__(self, model: Transformer, params,
                 cfg: Optional[ServeConfig] = None, now_fn=time.monotonic,
                 device: DeviceLike = None):
        self.cfg = cfg = ServeConfig() if cfg is None else cfg
        if cfg.telemetry_dir or cfg.trace_dir or cfg.rollup_every > 0:
            raise NotImplementedError(
                "serving telemetry, tracing and rollups are not ported yet")
        if cfg.role != "unified":
            raise NotImplementedError(
                f"role={cfg.role!r}: disaggregated serving is not ported "
                "yet")
        self.now = now_fn
        self.server = PagedDecodeServer(
            model, params, slots=cfg.slots, num_blocks=cfg.num_blocks,
            block_size=cfg.block_size, max_len=cfg.max_len,
            temperature=cfg.temperature, top_k=cfg.top_k,
            top_p=cfg.top_p, seed=cfg.seed, kv_quant=cfg.kv_quant,
            attn_impl=cfg.attn_impl, prefix_cache=cfg.prefix_cache,
            device=device)
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
        # decode-step key accounting (host arithmetic): attended = what
        # the math needs, padded = what the gathered path reduces over,
        # kernel = whole blocks the fused kernel walks
        self.attended_keys = 0
        self.padded_keys = 0
        self.kernel_keys = 0

    # ---- client surface ------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               slo_ms: Optional[float] = None) -> Optional[int]:
        """Enqueue a request; returns its id, or None when the bounded
        queue is full (rejected).  Raises for requests the server could
        never hold (over ``max_len`` / pool capacity)."""
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
                      slo_ms=slo)
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

    # ---- the service loop ----------------------------------------------
    def tick(self) -> List[int]:
        """One tick: admit, one prefill chunk, one decode step, retire.
        Returns the rids completed during this tick."""
        self.tick_no += 1
        self._admit()
        done_now = self._prefill_tick()
        if self.server.any_active():
            self._grow_or_evict()
            acct = self.server.keys_accounting()
            self.attended_keys += acct["attended_keys"]
            self.padded_keys += acct["padded_keys"]
            self.kernel_keys += acct["kernel_keys"]
            for srv_rid in self.server.step():
                done_now.append(self._retire(srv_rid))
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

    def _prefill_tick(self) -> List[int]:
        """At most one prefill chunk per tick, so decoding streams advance
        every tick regardless of admission work."""
        done_now: List[int] = []
        if not self._prefilling:
            return done_now
        rid = self._prefilling[0]
        srv_rid = self._srv_rid[rid]
        if self.server.prefill_step(srv_rid, self.cfg.prefill_chunk):
            self._prefilling.popleft()
            self.reqs[rid].t_first = self.now()
            if self.server.done(srv_rid):   # single-token request
                done_now.append(self._retire(srv_rid))
        return done_now

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
        if req.t_first is None:
            req.t_first = req.t_done
        toks = self.server.result(srv_rid)
        self._results[rid] = toks
        self.completed += 1
        self.tokens_out += len(toks) - len(req.prompt)
        # bounded retention of completed requests and unconsumed results
        self._done_order.append(rid)
        while len(self._done_order) > max(1, self.cfg.completed_history):
            old = self._done_order.popleft()
            self.reqs.pop(old, None)
            self._results.pop(old, None)
        return rid

    def snapshot(self) -> Dict[str, object]:
        """Queue, pool and counter state (host arithmetic only)."""
        prefix: Dict[str, object] = {}
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
            "prefill_chunks": self.server.prefill_chunks,
            "decode_steps": self.server.decode_steps,
            "attended_keys": self.attended_keys,
            "padded_keys": self.padded_keys,
            "kernel_keys": self.kernel_keys,
            "attended_ratio": (
                round(self.attended_keys / self.padded_keys, 4)
                if self.padded_keys else None),
        }
