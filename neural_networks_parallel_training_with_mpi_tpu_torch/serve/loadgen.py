"""Closed-loop load generator and latency percentiles: the port of the
JAX package's ``serve/loadgen.py``, with its fleet driver
(:func:`run_fleet_closed_loop`, over a ``serve.fleet.FleetRouter`` or a
``Fleet``).

Closed-loop means each simulated client holds at most one outstanding
request and submits its next the moment the previous completes: offered
load is the number of concurrent clients, and the system is never driven
past saturation into an unbounded backlog.

Per request it records TTFT (submit -> first output token, queue wait
included) and mean ITL (decode span / (new_tokens - 1)); a row reports
p50/p99 of each across requests, plus generated tokens/s.  On the GPU the
scheduler's ``now_fn`` should synchronise the device before reading the
clock, since the host runs ahead of the kernels it queues.

**Shared-prefix mixes** (``shared_prefix_len`` / ``shared_fraction``): a
seeded fraction of requests prepend one fixed shared prefix to a random
suffix, the traffic the prefix cache serves.  The request stream is
generated up front per seed (client-major, independent of queue
dynamics), so two arms serve identical requests and the row's
``tokens_sha256`` pins greedy output equality across them.  The stream
is bitwise the JAX package's for the same arguments.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, Optional

import numpy as np


def _pct(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


def prewarm(make_scheduler, *, prompt_lens=(4, 24)) -> None:
    """Pay every first-call cost a load run can draw before any latency
    is measured: one prefill chunk at each power-of-two bucket width the
    prompt range can produce under the scheduler's ``prefill_chunk``
    (derived through ``paged_kv.prefill_bucket``, the function
    ``prefill_step`` pads with), plus the batched decode step, which
    under ``attn_impl='fused'`` builds and loads the paged-attention
    kernel.  Otherwise the first request at a cold shape books the
    kernel build, cuBLAS handle creation and allocator growth as a TTFT
    outlier.  Uses a throwaway scheduler from the same factory."""
    from .paged_kv import prefill_bucket

    sched = make_scheduler()
    try:
        chunk = max(1, int(sched.cfg.prefill_chunk))
        hi = min(int(prompt_lens[1]), sched.server.max_len - 2)
        w_max = max(1, min(chunk, hi))
        targets = {prefill_bucket(w) for w in range(1, w_max + 1)}
        # a prompt of min(bucket, w_max) tokens prefills in one chunk
        # drawing exactly that bucket (the top bucket via the partial
        # width w_max)
        lens = sorted(min(b, w_max) for b in targets)
        rids = [sched.submit(list(range(1, p + 1)), 2) for p in lens]
        if any(r is None for r in rids):
            raise RuntimeError("prewarm: the scheduler rejected a request")
        sched.run_until_drained()
        for r in rids:
            sched.result(r)
    finally:
        sched.close()


# Named traffic presets: one word pins the whole shape (prompt/decode
# ranges + shared-prefix mix), so two arms saying ``mix="long_prefill"``
# serve the same traffic.  The values are the JAX package's, sized for a
# max_seq_len of 128: the longest shared request is shared_prefix_len +
# prompt_lens[1] + max_new[1] = 124 tokens.
MIXES: Dict[str, Dict[str, Any]] = {
    # prefill-heavy: long prompts, decodes long enough that per-stream
    # cadence is a measurement, the traffic where prefill bursts stall a
    # unified pool's decode cadence; half the requests share one
    # 24-token prefix
    "long_prefill": dict(prompt_lens=(32, 72), max_new=(16, 28),
                         shared_prefix_len=24, shared_fraction=0.5),
}


def resolve_mix(mix: Optional[str], prompt_lens, max_new,
                shared_prefix_len: int, shared_fraction: float):
    """Apply a :data:`MIXES` preset: when ``mix`` is set its values
    replace the four traffic-shape arguments."""
    if mix is None:
        return prompt_lens, max_new, shared_prefix_len, shared_fraction
    if mix not in MIXES:
        raise ValueError(f"unknown mix {mix!r}; have {sorted(MIXES)}")
    m = MIXES[mix]
    return (m["prompt_lens"], m["max_new"], m["shared_prefix_len"],
            m["shared_fraction"])


def make_requests(clients: int, requests_per_client: int, *,
                  vocab_size: int, prompt_lens=(4, 24), max_new=(8, 32),
                  seed: int = 0, shared_prefix_len: int = 0,
                  shared_fraction: float = 0.0, stream: int = 0,
                  mix: Optional[str] = None
                  ) -> List[List[Dict[str, Any]]]:
    """Every client's request list, generated up front (client-major, one
    RNG pass), so the stream is a pure function of the arguments and two
    arms serve identical traffic.  With ``shared_prefix_len`` > 0, a
    ``shared_fraction`` of requests prepend one fixed shared prefix
    (drawn first from the same seed) to their random suffix.
    ``stream=k`` mixes ``k`` into the seed, so N generators driving N
    replicas from one seed do not replay one stream; ``stream=0`` draws
    from ``default_rng(seed)``."""
    (prompt_lens, max_new, shared_prefix_len,
     shared_fraction) = resolve_mix(mix, prompt_lens, max_new,
                                    shared_prefix_len, shared_fraction)
    rng = (np.random.default_rng(seed) if not stream
           else np.random.default_rng((int(seed), int(stream))))
    shared = (rng.integers(0, vocab_size, (shared_prefix_len,)).tolist()
              if shared_prefix_len > 0 else [])
    out: List[List[Dict[str, Any]]] = []
    for _ in range(int(clients)):
        reqs = []
        for _ in range(int(requests_per_client)):
            p = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
            n = int(rng.integers(max_new[0], max_new[1] + 1))
            is_shared = bool(shared
                             and rng.random() < float(shared_fraction))
            if not is_shared:
                p = max(1, p)     # a bare prompt needs >= 1 token; a
                #                   shared request's suffix may be empty
            suffix = rng.integers(0, vocab_size, (p,)).tolist()
            reqs.append({"prompt": shared + suffix if is_shared
                         else suffix,
                         "max_new": n, "shared": is_shared})
        out.append(reqs)
    return out


def run_closed_loop(scheduler, clients: int, requests_per_client: int,
                    *, vocab_size: int, prompt_lens=(4, 24),
                    max_new=(8, 32), seed: int = 0,
                    slo_ms: Optional[float] = None,
                    shared_prefix_len: int = 0,
                    shared_fraction: float = 0.0, stream: int = 0,
                    mix: Optional[str] = None,
                    max_ticks: int = 200_000) -> Dict[str, Any]:
    """Drive ``scheduler`` with ``clients`` closed-loop clients until
    each has completed ``requests_per_client`` requests; returns the
    measured row: tokens/s, TTFT/ITL percentiles (split by shared/unique
    class under a shared-prefix mix), blocks in use per tick, counters,
    and a sha256 of every request's output tokens in submission order.
    The requests come from :func:`make_requests`."""
    (prompt_lens, max_new, shared_prefix_len,
     shared_fraction) = resolve_mix(mix, prompt_lens, max_new,
                                    shared_prefix_len, shared_fraction)
    plan = make_requests(clients, requests_per_client,
                         vocab_size=vocab_size, prompt_lens=prompt_lens,
                         max_new=max_new, seed=seed,
                         shared_prefix_len=shared_prefix_len,
                         shared_fraction=shared_fraction, stream=stream)
    next_idx = [0] * int(clients)
    outstanding: List[Optional[int]] = [None] * int(clients)
    finished: List[int] = []
    shared_rids: set = set()
    results: Dict[int, tuple] = {}    # rid -> (client, idx, tokens)
    submit_retries = 0
    blocks_peak = 0
    blocks_sum = 0
    n_ticks = 0
    t0 = time.perf_counter()
    for _ in range(max_ticks):
        for ci in range(clients):
            if outstanding[ci] is not None or \
                    next_idx[ci] >= requests_per_client:
                continue
            req = plan[ci][next_idx[ci]]
            rid = scheduler.submit(req["prompt"], req["max_new"],
                                   slo_ms=slo_ms)
            if rid is None:           # bounded queue full: retry next tick
                submit_retries += 1
                continue
            if req["shared"]:
                shared_rids.add(rid)
            results[rid] = (ci, next_idx[ci], None)
            outstanding[ci] = rid
            next_idx[ci] += 1
        for rid in scheduler.tick():
            ci = outstanding.index(rid)
            outstanding[ci] = None
            finished.append(rid)
            c, i, _ = results[rid]
            results[rid] = (c, i, scheduler.result(rid))
        used = scheduler.server.allocator.used_blocks
        blocks_peak = max(blocks_peak, used)
        blocks_sum += used
        n_ticks += 1
        if all(i >= requests_per_client for i in next_idx) and \
                all(o is None for o in outstanding):
            break
    else:
        raise RuntimeError(f"load run not drained in {max_ticks} ticks")
    wall = time.perf_counter() - t0
    stats = [scheduler.stats(rid) for rid in finished]
    ttft = [s.ttft_ms for s in stats if s.ttft_ms is not None]
    itl = [s.itl_ms for s in stats if s.itl_ms is not None]
    # every request's tokens in submission order (client-major): two arms
    # serving the same plan hash equal iff every token matches; a
    # partitioned stream carries its tag in the preamble
    h = hashlib.sha256()
    if stream:
        h.update(repr(("stream", int(stream))).encode())
    for ci, i, toks in sorted(results.values()):
        h.update(repr((ci, i, toks)).encode())
    row = {
        "clients": int(clients),
        "requests": len(finished),
        "wall_s": round(wall, 3),
        "tokens_out": scheduler.tokens_out,
        "tokens_per_sec": round(scheduler.tokens_out / wall, 1),
        "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p99": _pct(ttft, 99),
        "itl_ms_p50": _pct(itl, 50), "itl_ms_p99": _pct(itl, 99),
        "ticks": scheduler.tick_no,
        "admitted": scheduler.admitted,
        "rejected": scheduler.rejected,
        "evicted": scheduler.evicted,
        "submit_retries": submit_retries,
        "deadline_missed": sum(1 for s in stats if s.deadline_missed),
        "blocks_in_use_peak": blocks_peak,
        "blocks_in_use_mean": round(blocks_sum / max(1, n_ticks), 2),
        "tokens_sha256": h.hexdigest(),
    }
    if mix is not None:
        row["mix"] = mix
    if shared_prefix_len > 0:
        row["shared_prefix_len"] = int(shared_prefix_len)
        row["shared_fraction"] = float(shared_fraction)
        row["shared_requests"] = len(shared_rids)
        for cls, rids in (("shared", shared_rids),
                          ("unique", set(finished) - shared_rids)):
            vals = [scheduler.stats(r).ttft_ms for r in rids
                    if scheduler.stats(r).ttft_ms is not None]
            row[f"ttft_ms_p50_{cls}"] = _pct(vals, 50)
            row[f"ttft_ms_p99_{cls}"] = _pct(vals, 99)
            # decode cadence per class: a prefix hit shortens TTFT, not
            # the steady-state ITL
            ivals = [scheduler.stats(r).itl_ms for r in rids
                     if scheduler.stats(r).itl_ms is not None]
            row[f"itl_ms_p50_{cls}"] = _pct(ivals, 50)
            row[f"itl_ms_p99_{cls}"] = _pct(ivals, 99)
    if getattr(scheduler.cfg, "prefix_cache", False):
        row["prefix_cache"] = scheduler.server.prefix_stats()
    return row


def sweep_loads(make_scheduler, loads: List[int],
                requests_per_client: int, *, vocab_size: int,
                prompt_lens=(4, 24), max_new=(8, 32), seed: int = 0,
                slo_ms: Optional[float] = None,
                shared_prefix_len: int = 0,
                shared_fraction: float = 0.0,
                warm: bool = True) -> List[Dict[str, Any]]:
    """One :func:`run_closed_loop` row per offered load (client count),
    on a fresh scheduler each (``make_scheduler()``), after
    :func:`prewarm` (``warm=False`` opts out, for a caller measuring the
    cold start itself)."""
    rows = []
    if warm and loads:
        prewarm(make_scheduler, prompt_lens=prompt_lens)
    for c in loads:
        sched = make_scheduler()
        try:
            rows.append(run_closed_loop(
                sched, c, requests_per_client, vocab_size=vocab_size,
                prompt_lens=prompt_lens, max_new=max_new, seed=seed,
                slo_ms=slo_ms, shared_prefix_len=shared_prefix_len,
                shared_fraction=shared_fraction))
        finally:
            sched.close()
    return rows


def run_fleet_closed_loop(router, clients: int,
                          requests_per_client: int, *, vocab_size: int,
                          prompt_lens=(4, 24), max_new=(8, 32),
                          seed: int = 0,
                          classes: Optional[List[Dict[str, Any]]] = None,
                          stream: int = 0,
                          mix: Optional[str] = None,
                          max_wall_s: float = 600.0) -> Dict[str, Any]:
    """The MULTI-REPLICA closed-loop driver: ``clients`` one-outstanding
    clients against a ``serve.fleet.FleetRouter`` instead of one
    scheduler.  Same pre-generated request plan as
    :func:`run_closed_loop` (pure function of seed/stream: fleets of
    different replica counts serve byte-identical traffic), plus
    per-CLASS SLOs: ``classes`` is a list of ``{"name", "slo_ms"}``
    dicts assigned client-major (client ``ci`` runs class ``ci % K`` —
    an interactive client and a bulk client are different CLIENTS, not
    different requests of one), and the row reports TTFT percentiles
    per class — the split the router's deadline-aware placement is
    judged on.  Rejections at the ROUTER (fleet queue full / SLO
    infeasible) surface as ``router_rejections`` with clients retrying,
    the closed-loop discipline."""
    classes = classes or [{"name": "all", "slo_ms": None}]
    (prompt_lens, max_new, shared_prefix_len,
     shared_fraction) = resolve_mix(mix, prompt_lens, max_new, 0, 0.0)
    plan = make_requests(clients, requests_per_client,
                         vocab_size=vocab_size, prompt_lens=prompt_lens,
                         max_new=max_new, seed=seed, stream=stream,
                         shared_prefix_len=shared_prefix_len,
                         shared_fraction=shared_fraction)
    cls_of = [classes[ci % len(classes)] for ci in range(int(clients))]
    next_idx = [0] * int(clients)
    outstanding: List[Optional[int]] = [None] * int(clients)
    finished: List[int] = []
    owner: Dict[int, int] = {}          # fleet rid -> client
    tokens_of: Dict[int, tuple] = {}    # fleet rid -> (ci, idx, tokens)
    shared_rids: set = set()
    submit_retries = 0
    t0 = time.perf_counter()
    while True:
        progressed = False
        for ci in range(int(clients)):
            if outstanding[ci] is not None or \
                    next_idx[ci] >= requests_per_client:
                continue
            req = plan[ci][next_idx[ci]]
            # client idempotency key: a pure function of the request's
            # coordinates in the plan (seed/stream/client/index), so a
            # relaunched driver resubmitting after a control-plane
            # death names each request IDENTICALLY and the router's
            # journal dedupes instead of re-executing (serve/wal.py)
            idem = f"{int(seed)}.{int(stream)}.{ci}.{next_idx[ci]}"
            rid = router.submit(req["prompt"], req["max_new"],
                                slo_ms=cls_of[ci]["slo_ms"], idem=idem)
            if rid is None:
                submit_retries += 1
                continue
            owner[rid] = ci
            if req.get("shared"):
                shared_rids.add(rid)
            tokens_of[rid] = (ci, next_idx[ci], None)
            outstanding[ci] = rid
            next_idx[ci] += 1
            progressed = True
        for rid in router.pump():
            ci = owner.get(rid)
            if ci is None:
                # a journal-replayed request can complete before its
                # client re-attaches (recovered router, fresh driver);
                # the idempotency-key resubmit re-announces it
                continue
            outstanding[ci] = None
            finished.append(rid)
            c, i, _ = tokens_of[rid]
            tokens_of[rid] = (c, i, router.result(rid))
            progressed = True
        if all(i >= requests_per_client for i in next_idx) and \
                all(o is None for o in outstanding):
            break
        if time.perf_counter() - t0 > max_wall_s:
            raise RuntimeError(
                f"fleet load run not drained in {max_wall_s}s: "
                f"{len(finished)}/{clients * requests_per_client} done, "
                f"outstanding={[o for o in outstanding if o is not None]}")
        if not progressed:
            # subprocess replicas own the compute; a busy-spinning
            # driver would steal their core
            time.sleep(0.002)
    wall = time.perf_counter() - t0
    stats = [router.stats(rid) for rid in finished]
    h = hashlib.sha256()
    if stream:
        h.update(repr(("stream", int(stream))).encode())
    for ci, i, toks in sorted(tokens_of.values()):
        h.update(repr((ci, i, toks)).encode())
    tokens_out = sum(s.n_generated or 0 for s in stats)
    row: Dict[str, Any] = {
        "clients": int(clients),
        "requests": len(finished),
        "wall_s": round(wall, 3),
        "tokens_out": tokens_out,
        "tokens_per_sec": round(tokens_out / wall, 1),
        "submit_retries": submit_retries,
        "router_rejections": router.rejected,
        "requeued": router.requeued,
        "tokens_sha256": h.hexdigest(),
    }
    ttft_all = [s.ttft_ms for s in stats if s.ttft_ms is not None]
    row["ttft_ms_p50"] = _pct(ttft_all, 50)
    row["ttft_ms_p99"] = _pct(ttft_all, 99)
    # fleet-wide decode cadence: the signal a slow-but-alive replica
    # degrades first
    itl_all = [s.itl_ms for s in stats if s.itl_ms is not None]
    row["itl_ms_p50"] = _pct(itl_all, 50)
    row["itl_ms_p99"] = _pct(itl_all, 99)
    if mix is not None:
        row["mix"] = mix
    if shared_prefix_len > 0:
        # shared/unique split under a prefix mix, TTFT and ITL both:
        # the shared class's TTFT prices prefix reuse, its ITL pins
        # that reuse never taxes decode cadence
        row["shared_prefix_len"] = int(shared_prefix_len)
        row["shared_fraction"] = float(shared_fraction)
        row["shared_requests"] = len(shared_rids)
        for cls, rids in (("shared", shared_rids),
                          ("unique", set(finished) - shared_rids)):
            tv = [s.ttft_ms for rid, s in zip(finished, stats)
                  if rid in rids and s.ttft_ms is not None]
            iv = [s.itl_ms for rid, s in zip(finished, stats)
                  if rid in rids and s.itl_ms is not None]
            row[f"ttft_ms_p50_{cls}"] = _pct(tv, 50)
            row[f"ttft_ms_p99_{cls}"] = _pct(tv, 99)
            row[f"itl_ms_p50_{cls}"] = _pct(iv, 50)
            row[f"itl_ms_p99_{cls}"] = _pct(iv, 99)
    for k in classes:
        vals = [s.ttft_ms for rid, s in zip(finished, stats)
                if cls_of[owner[rid]]["name"] == k["name"]
                and s.ttft_ms is not None]
        row[f"ttft_ms_p50_{k['name']}"] = _pct(vals, 50)
        row[f"ttft_ms_p99_{k['name']}"] = _pct(vals, 99)
        row[f"requests_{k['name']}"] = len(vals)
        if k["slo_ms"] is not None:
            row[f"deadline_missed_{k['name']}"] = sum(
                1 for rid, s in zip(finished, stats)
                if cls_of[owner[rid]]["name"] == k["name"]
                and s.ttft_ms is not None and s.deadline_missed)
    row["per_replica_completed"] = router.per_replica_completed()
    return row
