"""Goodput accounting: classify 100% of fleet wall-clock, every second.

The port's own copy of the JAX package's stdlib-only
``utils/goodput.py``: the same taxonomy, the same ledger and the same
records, so ``tools/goodput_report.py`` and ``tools/obs_agg.py`` read the
port's directories unchanged.  The raw observability events (trace
spans, sketch rollups, supervisor lifecycle records) do not answer the
question a training fleet is judged by: *where did the wall-clock go,
and how much of it was productive?*  This module is that layer, in two
halves:

1. an **offline ledger** (:func:`build_ledger`) that joins the
   per-process trace spans, the supervisor exit/relaunch event stream
   (``train/resilience.py`` ``events_path``), and the autopilot
   decision ledger into an exact interval-sweep account of each
   process's covered wall-clock — every second lands in exactly one
   category of a fixed, exhaustive taxonomy, gaps between spans are
   *attributed, never dropped*, and the categories provably sum to the
   covered interval (``sum_ok`` is asserted by tests and the bench);

2. an **online meter** (:class:`GoodputMeter`) that subscribes to the
   span stream via ``train.trace.add_listener`` and keeps the same
   taxonomy incrementally, cheap enough to ride every traced process,
   feeding ``kind="goodput"``
   rollup records through the existing telemetry channel so
   ``tools/obs_agg.py`` can merge a fleet-wide goodput fraction into
   fleet.json / Prometheus / the dashboard.

Taxonomy (fixed and exhaustive — the categories ROADMAP items 1 and 4
will be priced in):

==================  =====================================================
``step``            productive step compute: dispatch/fetch host cost
                    plus the async pipeline in flight between them, and
                    the serving tick phases (admit/prefill/decode/retire)
``compile``         ledger-observed compiles (``compile:<n>`` spans; in
                    the port, CUDA-graph captures)
``data_stall``      host batch assembly / loader waits (``load``)
``ckpt``            checkpoint save + the async writer's disk time
``rollback``        anomaly/SDC rollback *and the retrained window*: a
                    post-rollback dispatch revisiting an already-trained
                    step is repaid work, not new progress
``eval``            held-out evaluation passes
``relaunch_gap``    dead time between a crash and the supervisor's next
                    incarnation opening its trace
``drain``           decommission drain: the window between a process's
                    last span and its terminal exit-47 supervisor event
``serve_queue_wait`` serving inter-tick gaps with requests queued
``serve_bubble``    serving inter-tick gaps with streams mid-decode
                    (scheduler bubble: the loop, not the model, owned it)
``idle``            everything else — unattributable gaps, unknown spans
==================  =====================================================

Attribution rules (the exactness contract):

* overlapping spans (the async ckpt writer under an in-flight dispatch)
  are resolved by a fixed priority — productive work wins over
  background IO, so a checkpoint fully shadowed by compute costs zero;
* an intra-incarnation gap bracketed on BOTH sides by pipeline spans
  (``dispatch``/``load``/``fetch``) is ``step`` — the submitted program
  was executing while the host had nothing to record — or ``rollback``
  when the bracketing dispatches are retrained steps; any other gap is
  ``idle``;
* inter-incarnation gaps per (run, process) are ``relaunch_gap``;
* a terminal exit 47 (EXIT_DECOMMISSION) extends coverage from the last
  span to the exit event as ``drain``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

try:  # package context (bench, telemetry, tests)
    from . import jsonl as _jsonl
except Exception:  # standalone file-path load: tools inject utils/jsonl
    _jsonl = None  # type: ignore[assignment]

#: the fixed, exhaustive taxonomy — every accounted second lands in
#: exactly one of these, and consumers (obs_agg, the report tool, the
#: bench gates) iterate THIS tuple rather than discovering keys.
CATEGORIES = ("step", "compile", "data_stall", "ckpt", "rollback", "eval",
              "recovery", "relaunch_gap", "drain", "serve_queue_wait",
              "serve_bubble", "idle")

#: span-name -> category for the fixed trace vocabulary (train/trace.py)
SPAN_CATEGORY = {
    "dispatch": "step", "fetch": "step",
    "admit": "step", "prefill": "step", "decode": "step", "retire": "step",
    "load": "data_stall",
    "eval": "eval",
    "ckpt": "ckpt", "ckpt_write": "ckpt",
    "rollback": "rollback",
    "queue_wait": "serve_queue_wait",
    "sched_bubble": "serve_bubble",
    # control-plane crash recovery: the window between a relaunched
    # router opening its WAL and the fleet serving again (serve/wal.py)
    "recovery": "recovery",
}

#: spans whose presence on both sides of a gap means the async pipeline
#: was in flight: the gap is productive, not idle
PIPELINE_SPANS = ("dispatch", "load", "fetch")

#: overlap resolution, most-exclusive first: a category earlier in this
#: tuple owns any second where its span overlaps a later one's.
PRIORITY = ("rollback", "recovery", "compile", "eval", "step", "data_stall",
            "ckpt", "serve_queue_wait", "serve_bubble", "drain",
            "relaunch_gap", "idle")

_PRIO = {c: i for i, c in enumerate(PRIORITY)}

# exit code contract shared with train/resilience.py (kept literal here:
# this module must import nothing from the package at tool time)
EXIT_DECOMMISSION = 47

SUM_TOL = 1e-6  # float tolerance for the sum-to-covered invariant


def categorize(name: str) -> str:
    """Map a span name to its taxonomy category (unknown names are
    ``idle`` — 'idle/other' is the catch-all, never a dropped second)."""
    if name.startswith("compile:"):
        return "compile"
    return SPAN_CATEGORY.get(name, "idle")


def zero_categories() -> Dict[str, float]:
    return {c: 0.0 for c in CATEGORIES}


# ---------------------------------------------------------------------------
# offline exact ledger: interval sweep over one incarnation's spans
# ---------------------------------------------------------------------------

def _resolve_retrain(spans: List[Dict[str, Any]],
                     seed_max_step: Optional[int] = None,
                     ) -> Tuple[List[str], Optional[int]]:
    """Per-span resolved categories with the retrained-window override:
    after a ``rollback`` span — or a crash-relaunch, whose restore
    replays already-trained steps (``seed_max_step`` is the previous
    incarnations' high-water mark) — every ``dispatch`` whose ``step``
    attr is <= the maximum step already reached is repaid work and
    resolves to ``rollback`` until the step counter passes the
    high-water mark.  Returns (categories, incarnation max step)."""
    cats: List[str] = []
    max_step: Optional[int] = seed_max_step
    retrain_until: Optional[int] = seed_max_step
    for s in spans:
        name = str(s.get("name", ""))
        cat = categorize(name)
        step = s.get("step")
        if name == "rollback":
            retrain_until = max_step
        elif name == "dispatch" and isinstance(step, (int, float)):
            step = int(step)
            if retrain_until is not None:
                if step > retrain_until:
                    retrain_until = None
                else:
                    cat = "rollback"
            if max_step is None or step > max_step:
                max_step = step
        cats.append(cat)
    return cats, max_step


def _gap_category(prev_pipe: set, next_pipe: set) -> str:
    """Attribute an intra-incarnation gap from the resolved categories
    of the pipeline spans active on each side (empty set = no pipeline
    span adjacent on that side)."""
    if not prev_pipe or not next_pipe:
        return "idle"
    if "rollback" in (prev_pipe | next_pipe):
        return "rollback"
    return "step"


def _sweep(spans: List[Dict[str, Any]], cats: List[str],
           t_lo: float, t_hi: float) -> Dict[str, float]:
    """Exact one-incarnation sweep: clip spans to [t_lo, t_hi], resolve
    overlaps by PRIORITY, attribute gaps by the bracketing rule.  The
    returned seconds sum to (t_hi - t_lo) to float precision."""
    seconds = zero_categories()
    if t_hi <= t_lo:
        return seconds
    # (t, delta, cat, is_pipeline) boundary events
    events: List[Tuple[float, int, str, bool]] = []
    for s, cat in zip(spans, cats):
        a = float(s.get("t", 0.0))
        b = a + max(0.0, float(s.get("dur", 0.0)))
        a, b = max(a, t_lo), min(b, t_hi)
        if b <= a:
            continue
        pipe = str(s.get("name", "")) in PIPELINE_SPANS
        events.append((a, +1, cat, pipe))
        events.append((b, -1, cat, pipe))
    if not events:
        seconds["idle"] += t_hi - t_lo
        return seconds
    events.sort(key=lambda e: (e[0], -e[1]))  # starts before ends at a tie
    bounds = sorted({t_lo, t_hi, *(e[0] for e in events)})
    # walk elementary intervals maintaining active counts per category
    cat_count = {c: 0 for c in CATEGORIES}
    pipe_count = {c: 0 for c in CATEGORIES}  # pipeline spans per category
    ei = 0
    pending_gaps: List[Tuple[float, float, set]] = []
    last_pipe: set = set()
    for bi in range(len(bounds) - 1):
        a, b = bounds[bi], bounds[bi + 1]
        while ei < len(events) and events[ei][0] <= a:
            _, delta, cat, pipe = events[ei]
            cat_count[cat] += delta
            if pipe:
                pipe_count[cat] += delta
            ei += 1
        active = [c for c in PRIORITY if cat_count.get(c, 0) > 0]
        if active:
            seconds[active[0]] += b - a
            pipe_now = {c for c in CATEGORIES if pipe_count[c] > 0}
            if pipe_now:
                for ga, gb, prev_pipe in pending_gaps:
                    seconds[_gap_category(prev_pipe, pipe_now)] += gb - ga
                pending_gaps = []
                last_pipe = pipe_now
            else:
                # a non-pipeline span (e.g. a lone ckpt) breaks the
                # pipeline bracket: queued gaps can no longer be step
                for ga, gb, prev_pipe in pending_gaps:
                    seconds[_gap_category(prev_pipe, set())] += gb - ga
                pending_gaps = []
                last_pipe = set()
        else:
            pending_gaps.append((a, b, last_pipe))
    for ga, gb, prev_pipe in pending_gaps:  # trailing gap: nothing after
        seconds[_gap_category(prev_pipe, set())] += gb - ga
    return seconds


def _as_float(v, default: float = 0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def build_ledger(records: Iterable[Dict[str, Any]],
                 sup_events: Sequence[Dict[str, Any]] = (),
                 decisions: Sequence[Dict[str, Any]] = ()) -> Dict[str, Any]:
    """Build the exact goodput ledger from trace records.

    ``records`` is the mixed span/meta/instant/flow stream of one or
    more ``trace-p{P}-i{I}.jsonl`` files (other kinds are ignored);
    ``sup_events`` the supervisor lifecycle stream (``events_path``
    JSONL from ``supervise``/``GroupSupervisor``); ``decisions`` the
    autopilot decision ledger (annotation only — decisions are
    instants, they consume no time themselves).

    Returns ``{"processes": [...], "fleet": {...}}`` where every
    process entry carries per-category seconds that sum (``sum_ok``)
    to its covered wall-clock, incarnation relaunch gaps included.
    """
    # group spans + coverage bounds per (run, p, inc)
    groups: Dict[Tuple[str, int, int], Dict[str, Any]] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind not in ("span", "meta"):
            continue
        key = (str(rec.get("run", "")), int(rec.get("p", 0) or 0),
               int(rec.get("inc", 0) or 0))
        g = groups.setdefault(key, {"spans": [], "t_lo": None, "t_hi": None})
        t = _as_float(rec.get("t"))
        end = t + max(0.0, _as_float(rec.get("dur")))
        if g["t_lo"] is None or t < g["t_lo"]:
            g["t_lo"] = t
        if g["t_hi"] is None or end > g["t_hi"]:
            g["t_hi"] = end
        if kind == "span":
            g["spans"].append(rec)

    # index supervisor exits: (run, p, inc) -> newest exit event.  The
    # process id matters: a GroupSupervisor's children share ONE run id,
    # so without p a sibling's later rc-0 exit would overwrite a
    # drained child's rc-47 event and its drain tail would go unpriced.
    # Single-child supervise() events carry no "p" — the lookup falls
    # back to a p-less key for them.
    exits: Dict[Tuple[Optional[str], Optional[int], int],
                Dict[str, Any]] = {}
    relaunches = 0
    preempt_notices = 0
    for ev in sup_events:
        what = ev.get("event")
        if what == "relaunch":
            relaunches += 1
        if what == "preempt_notice":
            # advance-notice preemption: the child's tail past its last
            # span is priced as ``drain`` (its exit rc is 47), not as
            # rollback/relaunch_gap — the crash-vs-notice A/B keys on
            # this counter being nonzero in the notice arm
            preempt_notices += 1
        if what not in ("exit", "hang_kill", "gave_up"):
            continue
        try:
            ev_p: Optional[int] = int(ev["p"])
        except (KeyError, TypeError, ValueError):
            ev_p = None
        key = (ev.get("run") or None, ev_p,
               int(ev.get("inc", ev.get("incarnation", 0)) or 0))
        prev = exits.get(key)
        if prev is None or _as_float(ev.get("t")) >= _as_float(prev.get("t")):
            exits[key] = ev

    def _exit_for(run: str, p: int, inc: int) -> Optional[Dict[str, Any]]:
        for k in ((run, p, inc), (run, None, inc),
                  (None, p, inc), (None, None, inc)):
            if k in exits:
                return exits[k]
        return None

    # per (run, p): sweep each incarnation, then stitch the gaps
    by_proc: Dict[Tuple[str, int], List[Tuple[int, Dict[str, Any]]]] = {}
    for (run, p, inc), g in groups.items():
        by_proc.setdefault((run, p), []).append((inc, g))

    processes: List[Dict[str, Any]] = []
    fleet = zero_categories()
    fleet_covered = 0.0
    for (run, p), incs in sorted(by_proc.items()):
        incs.sort(key=lambda x: x[0])
        seconds = zero_categories()
        covered = 0.0
        inc_rows: List[Dict[str, Any]] = []
        prev_hi: Optional[float] = None
        prev_max_step: Optional[int] = None
        for inc, g in incs:
            spans = sorted(g["spans"], key=lambda s: _as_float(s.get("t")))
            t_lo = g["t_lo"] if g["t_lo"] is not None else 0.0
            t_hi = g["t_hi"] if g["t_hi"] is not None else t_lo
            ex = _exit_for(run, p, inc)
            drain_s = 0.0
            if ex is not None and int(ex.get("rc", -1)) == EXIT_DECOMMISSION:
                t_exit = _as_float(ex.get("t"))
                if t_exit > t_hi:
                    drain_s = t_exit - t_hi
                    t_hi_ext = t_exit
                else:
                    t_hi_ext = t_hi
            else:
                t_hi_ext = t_hi
            if prev_hi is not None and t_lo > prev_hi:
                gap = t_lo - prev_hi
                seconds["relaunch_gap"] += gap
                covered += gap
            cats, prev_max_step = _resolve_retrain(spans, prev_max_step)
            inc_sec = _sweep(spans, cats, t_lo, t_hi)
            inc_sec["drain"] += drain_s
            for c, v in inc_sec.items():
                seconds[c] += v
            inc_covered = max(0.0, t_hi_ext - t_lo)
            covered += inc_covered
            inc_rows.append({
                "inc": inc, "t_start": round(t_lo, 6),
                "t_end": round(t_hi_ext, 6),
                "covered_s": round(inc_covered, 6),
                "n_spans": len(spans),
                "exit_rc": None if ex is None else ex.get("rc"),
                "categories": {c: round(v, 6) for c, v in inc_sec.items()},
            })
            prev_hi = t_hi_ext
        total = sum(seconds.values())
        residual = covered - total
        row = {
            "run": run, "p": p,
            "incarnations": inc_rows,
            "covered_s": round(covered, 6),
            "categories": {c: round(v, 6) for c, v in seconds.items()},
            "goodput_fraction": (round(seconds["step"] / covered, 6)
                                 if covered > 0 else None),
            "sum_ok": abs(residual) < max(SUM_TOL, 1e-9 * max(covered, 1.0)),
            "sum_residual_s": round(residual, 9),
        }
        processes.append(row)
        for c, v in seconds.items():
            fleet[c] += v
        fleet_covered += covered

    fleet_total = sum(fleet.values())
    ledger = {
        "processes": processes,
        "fleet": {
            "n_processes": len(processes),
            "covered_s": round(fleet_covered, 6),
            "categories": {c: round(v, 6) for c, v in fleet.items()},
            "goodput_fraction": (round(fleet["step"] / fleet_covered, 6)
                                 if fleet_covered > 0 else None),
            "sum_ok": abs(fleet_covered - fleet_total) < max(
                SUM_TOL * max(1, len(processes)),
                1e-9 * max(fleet_covered, 1.0)),
            "relaunches": relaunches,
            "preempt_notices": preempt_notices,
            "decisions": len(list(decisions)),
        },
    }
    return ledger


def collect_dir(dirpath: str) -> Dict[str, Any]:
    """Gather one trace directory's goodput inputs: trace records,
    supervisor events (``supervisor-events*.jsonl``), autopilot
    decisions (``autopilot*.jsonl``), compile-ledger records — plus the
    torn-line skip count from the shared tolerant reader.  Package
    context uses the relative ``utils.jsonl`` import; standalone tools
    (``goodput_report``) inject the module before calling."""
    if _jsonl is None:
        raise RuntimeError(
            "utils.jsonl not available: standalone loaders must set "
            "goodput._jsonl to the file-path-loaded jsonl module")
    import glob

    out: Dict[str, Any] = {"records": [], "sup_events": [],
                           "decisions": [], "compiles": [], "skipped": 0}
    for pat, key in (("trace-*.jsonl", "records"),
                     ("supervisor-events*.jsonl", "sup_events"),
                     ("autopilot*.jsonl", "decisions"),
                     ("compiles-*.jsonl", "compiles")):
        recs, skip = _jsonl.read_many(
            sorted(glob.glob(os.path.join(dirpath, pat))))
        out[key].extend(recs)
        out["skipped"] += skip
    return out


def ledger_from_dir(dirpath: str) -> Dict[str, Any]:
    """``collect_dir`` + :func:`build_ledger`, with the skip count
    surfaced in the fleet block."""
    inputs = collect_dir(dirpath)
    ledger = build_ledger(inputs["records"], inputs["sup_events"],
                          inputs["decisions"])
    ledger["fleet"]["lines_skipped"] = inputs["skipped"]
    return ledger


# ---------------------------------------------------------------------------
# online meter: the in-process approximation riding the span listener
# ---------------------------------------------------------------------------

class GoodputMeter:
    """Incremental taxonomy accounting from the live span stream.

    Subscribes via ``train.trace.add_listener(meter.on_span)``; per span
    the cost is one dict update.  It
    is an *online approximation* of the exact offline sweep: spans
    arrive at END time, so overlaps are resolved by a frontier rule
    (only time beyond the furthest end yet seen is newly accounted, so
    an async checkpoint fully shadowed by compute costs zero — same
    outcome as the offline priority rule), and a gap before a pipeline
    span whose predecessor at the frontier was also a pipeline span is
    ``step``.  By construction the categories sum exactly to
    ``now - t_start`` at snapshot time.
    """

    def __init__(self, now_fn=time.time):
        self._now = now_fn
        self._lock = threading.Lock()
        self.t_start = float(now_fn())
        self.seconds = zero_categories()
        self.host_seconds = {n: 0.0 for n in PIPELINE_SPANS}
        self.spans = 0
        self._frontier = self.t_start
        self._frontier_pipeline = False

    def on_span(self, name: str, t_unix: float, dur_s: float,
                attrs: Optional[Dict[str, Any]] = None) -> None:
        cat = categorize(name)
        pipe = name in PIPELINE_SPANS
        end = t_unix + max(0.0, dur_s)
        with self._lock:
            self.spans += 1
            if pipe:
                self.host_seconds[name] += max(0.0, dur_s)
            gap = t_unix - self._frontier
            if gap > 0.0:
                gcat = ("step" if (pipe and self._frontier_pipeline)
                        else "idle")
                self.seconds[gcat] += gap
                self._frontier = t_unix
            eff = end - self._frontier
            if eff > 0.0:
                self.seconds[cat] += eff
                self._frontier = end
                self._frontier_pipeline = pipe
            # a span fully shadowed by an earlier end (async overlap)
            # adds nothing and leaves the frontier untouched

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Cumulative account since meter creation; the unobserved tail
        (after the last span end) is ``idle`` until proven productive,
        so categories sum to ``covered_s`` exactly."""
        with self._lock:
            now_t = float(now if now is not None else self._now())
            secs = dict(self.seconds)
            host = dict(self.host_seconds)
            spans = self.spans
            frontier = self._frontier
        tail = now_t - frontier
        if tail > 0.0:
            secs["idle"] += tail
        covered = max(0.0, sum(secs.values()))
        return {
            "t_start": round(self.t_start, 6),
            "covered_s": round(covered, 6),
            "categories": {c: round(v, 6) for c, v in secs.items()},
            "goodput_fraction": (round(secs["step"] / covered, 6)
                                 if covered > 0 else None),
            "host_seconds": {k: round(v, 6) for k, v in host.items()},
            "spans": spans,
        }


# ---------------------------------------------------------------------------
# step anatomy: compile-ledger cost analysis x measured dispatch time
# ---------------------------------------------------------------------------

# nominal memory bandwidth per device by device-kind substring (bytes/s);
# same convention as telemetry's peak-FLOPs table: env var wins, then
# substring match, then the disclosed CPU nominal so artifacts stay
# comparable across hosts.  The H100 rows are NVIDIA's data-sheet HBM
# rates (SXM5 80 GB HBM3: 3.35 TB/s; PCIe 80 GB HBM2e: 2.0 TB/s); the
# PCIe row sits before the generic one.
PEAK_BW_BY_KIND = (
    ("h100 pcie", 2.0e12), ("h100", 3.35e12),
    ("v6e", 1.64e12), ("v6", 1.64e12),
    ("v5p", 2.765e12), ("v5e", 8.19e11), ("v5", 8.19e11),
    ("v4", 1.228e12), ("v3", 9.0e11), ("v2", 7.0e11),
)
NOMINAL_CPU_BW = 5.0e10
BW_ENV_VAR = "NNPT_PEAK_BW"


def peak_bytes_per_s(device_kind: str = "", platform: str = "cpu") -> float:
    """Per-device nominal memory bandwidth (``NNPT_PEAK_BW`` overrides);
    the CPU nominal on the host and for kinds the table does not know."""
    env = os.environ.get(BW_ENV_VAR)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    kind = (device_kind or "").lower()
    if platform != "cpu":
        for sub, bw in PEAK_BW_BY_KIND:
            if sub in kind:
                return bw
    return NOMINAL_CPU_BW


def step_anatomy(flops: Optional[float], bytes_accessed: Optional[float],
                 step_s: float, host_s: float,
                 peak_flops: float, peak_bw: float) -> Optional[Dict[str, Any]]:
    """Join one layout's cost (the compile ledger's flops and bytes) with
    its measured step time.

    Returns the roofline position (arithmetic intensity vs the machine
    ridge) and the MFU-gap breakdown: of the measured step, how much is
    the roofline-bound floor (``compute``), how much is measured host
    work (``host`` — dispatch/load/fetch span time per step), and how
    much is unexplained ``stall``.  ``None`` when the cost analysis is
    unavailable (backend didn't report) or the step is unmeasured."""
    if not flops or not step_s or step_s <= 0 or peak_flops <= 0 \
            or peak_bw <= 0:
        return None
    flops = float(flops)
    by = float(bytes_accessed) if bytes_accessed else 0.0
    compute_s = flops / peak_flops
    memory_s = by / peak_bw if by else 0.0
    bound_s = max(compute_s, memory_s)
    intensity = (flops / by) if by else None
    ridge = peak_flops / peak_bw
    if intensity is None:
        bound = "compute"
    else:
        bound = "compute" if intensity >= ridge else "memory"
    host_s = max(0.0, float(host_s))
    stall_s = max(0.0, step_s - bound_s - host_s)
    mfu = compute_s / step_s
    return {
        "flops": flops, "bytes_accessed": by,
        "arithmetic_intensity": (round(intensity, 3)
                                 if intensity is not None else None),
        "ridge_intensity": round(ridge, 3),
        "roofline_bound": bound,
        "step_s": round(step_s, 6),
        "compute_s": round(compute_s, 6),
        "memory_s": round(memory_s, 6),
        "host_s": round(host_s, 6),
        "stall_s": round(stall_s, 6),
        "mfu": round(mfu, 4),
        "mfu_gap": {
            "compute_frac": round(min(1.0, bound_s / step_s), 4),
            "host_frac": round(min(1.0, host_s / step_s), 4),
            "stall_frac": round(stall_s / step_s, 4),
        },
    }


def goodput_record(snapshot: Dict[str, Any], role: str, step: int,
                   ident: Dict[str, Any],
                   anatomy: Optional[Dict[str, Any]] = None,
                   t_unix: Optional[float] = None) -> Dict[str, Any]:
    """Build one ``kind="goodput"`` telemetry record from a meter
    snapshot.  Cumulative per incarnation, like the sketch rollups —
    the aggregator takes the latest per (role, run, p, inc) and sums
    across identities."""
    rec = {
        "kind": "goodput", "role": role, "step": int(step),
        "t_unix": round(t_unix if t_unix is not None else time.time(), 3),
        "p": ident.get("process_id", ident.get("p", 0)),
        "run": ident.get("run_id", ident.get("run", "")),
        "inc": ident.get("incarnation", ident.get("inc", 0)),
        "covered_s": snapshot["covered_s"],
        "categories": snapshot["categories"],
        "goodput_fraction": snapshot["goodput_fraction"],
        "spans": snapshot["spans"],
    }
    if anatomy is not None:
        rec["anatomy"] = anatomy
    return rec
