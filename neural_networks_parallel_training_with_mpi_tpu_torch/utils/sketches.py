"""Streaming SLO sketches: mergeable quantiles, counters, gauges, alerts.

The port's own copy of the JAX package's ``utils/sketches.py``: the
serialized dicts are the same for the same inputs, because
``tools/obs_agg.py`` merges the rollups of both packages.

The fleet observability plane (DESIGN.md §7) needs percentiles that
COMPOSE: a p99 TTFT over a serving fleet cannot be computed from
per-process p99s, and shipping raw samples off every process scales with
traffic.  This module gives every telemetry writer a bounded summary
whose MERGE is exact enough to be quoted:

* :class:`QuantileSketch` — a Greenwald–Khanna ε-summary: a sorted list
  of ``(value, g, delta)`` tuples where ``g`` counts collapsed samples
  and ``delta`` bounds the rank uncertainty.  ``add`` is O(log k),
  memory is O(1/ε), and ``quantile(q)`` answers within ``ε·n`` ranks of
  the exact answer.  ``merge_many`` concatenates any number of shards'
  tuple lists in ONE pass and re-compresses; cross-shard interleaving
  adds hidden rank uncertainty bounded by the shards' own bands, so
  each merge LEVEL adds ε to the stated bound (``rank_error_bound`` =
  ε fresh, 2ε after the aggregator's single K-way fleet merge — the
  number tests/test_sketches.py asserts against exact numpy
  percentiles over K-shard merges).  Min/max/sum/count ride exactly,
  so ``quantile(0)``/``quantile(1)`` and the mean are not sketched at
  all.
* :class:`Gauge` — the windowed scalar companion: (last value,
  timestamp, min/max envelope), serialized into rollups next to plain
  cumulative counter numbers; the aggregator merges counters by SUM
  across every incarnation and gauges by sum-or-mean over each
  process's latest incarnation (tools/obs_agg.py owns those fleet
  semantics).
* :class:`EmaZScore` — streaming anomaly detection: EMA mean + EMA
  variance per series, alerting when a value lands ``z_threshold``
  deviations out (after ``warmup`` observations, throttled by
  ``cooldown``); non-finite values alert immediately.
* :class:`ErrorBudget` — SLO burn-rate tracking over a sliding window
  of success/miss events: with an SLO target of ``target`` the error
  budget is ``1 - target``, and the alert fires when the windowed miss
  rate burns the budget at ``burn_threshold`` x or faster (the
  SRE-workbook multiwindow discipline collapsed to one window — the
  aggregator's fleet view re-derives longer horizons from counters).

Everything here is STDLIB-ONLY and imported nowhere at package-init
time: ``tools/obs_agg.py`` loads this file by path (the ckpt_fsck
convention) and runs under ``python -S``, and ``train/telemetry.py``
imports it as a module.
Serialized form (``to_dict``/``from_dict``) is plain JSON — the
``kind="rollup"`` records in metrics.jsonl carry it verbatim.
"""

from __future__ import annotations

import bisect
import math
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

# ---------------------------------------------------------------------------
# quantile sketch (GK)
# ---------------------------------------------------------------------------

DEFAULT_EPS = 0.005  # per-sketch rank error; 2x after cross-shard merges


class QuantileSketch:
    """Greenwald–Khanna ε-approximate quantile summary (see module
    docstring).  Tuples are ``[v, g, delta]`` sorted by ``v``; the rank
    of ``v_i`` lies in ``[rmin_i, rmin_i + delta_i]`` where ``rmin_i =
    sum(g_1..g_i)``, and the compression invariant keeps every band
    ``g_i + delta_i <= 2*eps*n``."""

    __slots__ = ("eps", "n", "total", "vmin", "vmax", "depth",
                 "_tuples", "_vals", "_since_compress")

    def __init__(self, eps: float = DEFAULT_EPS):
        if not (0.0 < eps < 0.5):
            raise ValueError(f"eps must be in (0, 0.5), got {eps}")
        self.eps = float(eps)
        self.n = 0
        self.total = 0.0           # exact running sum (mean = total/n)
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        # merge-tree depth: 0 fresh, 1 after one (K-way) merge level.
        # Each level's interleaving hides <= eps*n ranks of uncertainty
        # beyond the recorded deltas, so the stated bound grows with
        # depth — which is why the fleet aggregator merges K shards in
        # ONE K-way pass (depth 1, bound 2*eps) instead of a pairwise
        # chain (depth K-1, bound honestly reported but useless)
        self.depth = 0
        self._tuples: List[List[float]] = []   # [v, g, delta]
        self._vals: List[float] = []           # bisect key mirror
        self._since_compress = 0

    @property
    def merged(self) -> bool:
        return self.depth > 0

    # ---- ingest ----------------------------------------------------------

    def add(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            return  # non-finite values are the ALERT layer's job
        self.n += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        pos = bisect.bisect_right(self._vals, v)
        if pos == 0 or pos == len(self._tuples):
            delta = 0.0  # a new extreme carries no rank uncertainty
        else:
            delta = max(0.0, math.floor(self.eps * self.n) - 1)
        self._tuples.insert(pos, [v, 1.0, delta])
        self._vals.insert(pos, v)
        self._since_compress += 1
        if self._since_compress >= max(1, int(1.0 / (2.0 * self.eps))):
            self._compress()

    def _compress(self) -> None:
        # bands are kept to eps*n — HALF the classic GK 2*eps*n budget —
        # so the stated bounds (eps fresh, 2*eps merged) hold with margin
        # after the hidden uncertainty cross-shard interleaving adds;
        # memory stays O(1/eps), just with a ~2x smaller constant traded
        # for quotable fleet numbers
        self._since_compress = 0
        if len(self._tuples) < 3:
            return
        # a merged sketch compresses at HALF the band budget again:
        # repeated merge->compress cycles fold tuples whose recorded
        # deltas understate the interleaving uncertainty, and the extra
        # headroom keeps the stated 2*eps bound honest deep into a
        # many-shard merge tree
        threshold = math.floor(self.eps * self.n
                               * (0.5 if self.merged else 1.0))
        out = [self._tuples[0]]
        for t in self._tuples[1:]:
            prev = out[-1]
            # merging prev INTO t keeps t's value; legal while the
            # combined band respects the invariant.  The first/last
            # tuples never disappear (min/max anchor the summary).
            if (prev[1] + t[1] + t[2] <= threshold
                    and len(out) > 1):
                t[1] += prev[1]
                out[-1] = t
            else:
                out.append(t)
        self._tuples = out
        self._vals = [t[0] for t in out]

    # ---- query -----------------------------------------------------------

    @property
    def rank_error_bound(self) -> float:
        """The stated rank-error of :meth:`quantile` answers as a
        fraction of ``n``: ε for a pure-insert sketch, plus ε per merge
        LEVEL (each level's cross-shard interleaving hides rank
        uncertainty the recorded deltas cannot see, bounded by the
        donors' own ε·n_donor bands which sum to ≤ ε·n per level).  The
        fleet path (:func:`merge_sketch_dicts` / :meth:`merge_many`)
        merges any number of shards in one level, so its bound is 2ε."""
        return self.eps * (1.0 + self.depth)

    def quantile(self, q: float) -> Optional[float]:
        if self.n == 0:
            return None
        if q <= 0.0:
            return self.vmin
        if q >= 1.0:
            return self.vmax
        target = max(1, min(self.n, math.ceil(q * self.n)))
        # closest-interval rule: each tuple's true rank lies in
        # [rmin, rmin + delta]; answer with the value whose interval is
        # nearest the target rank (an interval containing it is exact up
        # to the recorded uncertainty)
        best_v = self._tuples[0][0]
        best_d: Optional[float] = None
        rmin = 0.0
        for v, g, delta in self._tuples:
            rmin += g
            if rmin > target:
                dist = rmin - target
            elif rmin + delta < target:
                dist = target - (rmin + delta)
            else:
                dist = 0.0
            if best_d is None or dist < best_d:
                best_d, best_v = dist, v
            if rmin > target and dist >= (best_d or 0.0):
                break  # rmin only grows: no later tuple can be closer
        return best_v

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.n if self.n else None

    # ---- merge -----------------------------------------------------------

    def merge_many(self, others: Sequence["QuantileSketch"]
                   ) -> "QuantileSketch":
        """Absorb every sketch in ``others`` (left unchanged) in ONE
        merge level and return self: all tuple lists are merge-sorted
        with (g, delta) intact, then compressed ONCE against the
        combined n.  One K-way pass costs one level of hidden
        interleaving uncertainty total — a pairwise chain would cost
        K-1 (see :attr:`rank_error_bound`), which is why the fleet
        aggregator always lands here."""
        others = [o for o in others if o.n > 0]
        if not others:
            return self
        if self.n == 0 and len(others) == 1 and self.depth == 0:
            # adopting a lone shard verbatim keeps ITS bound
            o = others[0]
            self.eps = max(self.eps, o.eps)
            self.n, self.total = o.n, o.total
            self.vmin, self.vmax = o.vmin, o.vmax
            self.depth = o.depth
            self._tuples = [list(t) for t in o._tuples]
            self._vals = list(o._vals)
            return self
        sources = ([self] if self.n else []) + list(others)
        merged: List[List[float]] = sorted(
            (list(t) for s in sources for t in s._tuples),
            key=lambda t: t[0])
        self.eps = max(s.eps for s in sources)
        self.n = sum(s.n for s in sources)
        self.total = sum(s.total for s in sources)
        self.vmin = min(s.vmin for s in sources)
        self.vmax = max(s.vmax for s in sources)
        self.depth = max(s.depth for s in sources) + 1
        self._tuples = merged
        self._vals = [t[0] for t in merged]
        self._compress()
        return self

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Pairwise convenience over :meth:`merge_many` — each call is
        its own merge level, so prefer one ``merge_many`` for fan-in."""
        return self.merge_many([other])

    # ---- serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"eps": self.eps, "n": self.n, "sum": self.total,
                "min": self.vmin, "max": self.vmax,
                "depth": self.depth,
                "tuples": [[t[0], t[1], t[2]] for t in self._tuples]}

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "QuantileSketch":
        s = cls(eps=float(doc.get("eps", DEFAULT_EPS)))
        s.n = int(doc.get("n", 0))
        s.total = float(doc.get("sum", 0.0))
        s.vmin = doc.get("min")
        s.vmax = doc.get("max")
        s.depth = int(doc.get("depth", 0))
        s._tuples = [[float(v), float(g), float(d)]
                     for v, g, d in doc.get("tuples", [])]
        s._vals = [t[0] for t in s._tuples]
        return s

    def summary(self, quantiles: Sequence[float] = (0.5, 0.9, 0.99)
                ) -> Dict[str, Any]:
        """The quoted form: count/mean/min/max plus the requested
        percentiles and the bound they are good to."""
        out: Dict[str, Any] = {"n": self.n, "mean": self.mean,
                               "min": self.vmin, "max": self.vmax,
                               "rank_error_bound": self.rank_error_bound}
        for q in quantiles:
            v = self.quantile(q)
            out[f"p{round(q * 100) if q < 1 else 100}"] = v
        return out


def merge_sketch_dicts(docs: Sequence[Dict[str, Any]]) -> QuantileSketch:
    """Fleet merge of serialized sketch states (the aggregator's path):
    ONE K-way merge level, so the result's bound is 2ε no matter how
    many shards the fleet contributes."""
    return QuantileSketch().merge_many(
        [QuantileSketch.from_dict(doc) for doc in docs])


# ---------------------------------------------------------------------------
# gauges (counters need no class: writers keep plain cumulative numbers
# in the rollup's ``counters`` dict and the aggregator merges by SUM)
# ---------------------------------------------------------------------------

class Gauge:
    """Last-write scalar with a retained min/max envelope.  Writers
    ``set()`` and serialize via ``to_dict``; the aggregator parses the
    serialized form back (``from_dict``) and applies its own fleet
    semantics — sum for additive gauges (tokens/s, queue depth), mean
    for intensive ones (MFU, utilization) — over each process's LATEST
    incarnation, so there is deliberately no pairwise merge here."""

    __slots__ = ("last", "t", "vmin", "vmax")

    def __init__(self):
        self.last: Optional[float] = None
        self.t: Optional[float] = None
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def set(self, value: float, t_unix: Optional[float] = None) -> None:
        v = float(value)
        if not math.isfinite(v):
            return
        self.last = v
        self.t = time.time() if t_unix is None else float(t_unix)
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def to_dict(self) -> Dict[str, Any]:
        return {"last": self.last, "t": self.t,
                "min": self.vmin, "max": self.vmax}

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "Gauge":
        g = cls()
        last = doc.get("last")
        g.last = float(last) if isinstance(last, (int, float)) else None
        g.t = doc.get("t")
        g.vmin = doc.get("min")
        g.vmax = doc.get("max")
        return g


# ---------------------------------------------------------------------------
# alerting: EMA z-score anomaly detection + SLO error-budget burn rate
# ---------------------------------------------------------------------------

class EmaZScore:
    """Streaming per-series anomaly detector (see module docstring).

    ``direction``: ``"above"`` alerts only on values above the EMA mean
    (loss/grad-norm spikes), ``"below"`` only below (throughput
    collapse), ``"both"`` on either side.  Returns an alert dict or
    None per observation; non-finite values alert immediately
    (``reason="nonfinite"``) and do not perturb the EMA."""

    def __init__(self, series: str, z_threshold: float = 8.0,
                 beta: float = 0.98, warmup: int = 25,
                 cooldown: int = 25, direction: str = "above"):
        if direction not in ("above", "below", "both"):
            raise ValueError(f"direction {direction!r}")
        self.series = series
        self.z_threshold = float(z_threshold)
        self.beta = float(beta)
        self.warmup = int(warmup)
        self.cooldown = int(cooldown)
        self.direction = direction
        self.mean: Optional[float] = None
        self.var = 0.0
        self.count = 0
        self._since_alert = 10 ** 9
        self.fired = 0

    def observe(self, value: float, step: Optional[int] = None
                ) -> Optional[Dict[str, Any]]:
        self._since_alert += 1
        v = float(value)
        if not math.isfinite(v):
            return self._fire("nonfinite", v, None, step)
        self.count += 1
        if self.mean is None:
            self.mean = v
            return None
        # variance against the PRE-update mean (the standard EW form)
        dev = v - self.mean
        z = None
        if self.count > self.warmup:
            std = math.sqrt(self.var)
            floor = max(abs(self.mean) * 1e-3, 1e-12)
            z = dev / max(std, floor)
        self.var = self.beta * self.var + (1.0 - self.beta) * dev * dev
        self.mean = self.beta * self.mean + (1.0 - self.beta) * v
        if z is None:
            return None
        breach = ((self.direction in ("above", "both") and
                   z > self.z_threshold)
                  or (self.direction in ("below", "both") and
                      z < -self.z_threshold))
        if breach:
            return self._fire("zscore", v, z, step)
        return None

    def _fire(self, reason: str, value: float, z: Optional[float],
              step: Optional[int]) -> Optional[Dict[str, Any]]:
        if self._since_alert <= self.cooldown:
            return None  # throttled: one alert per cooldown window
        self._since_alert = 0
        self.fired += 1
        # non-finite values (the nonfinite alert's whole subject) are
        # stringified: json.dumps would otherwise emit the bare NaN/
        # Infinity extension tokens, and one alert record would make
        # metrics.jsonl — and every fleet.json/HTTP document obs_agg
        # copies the record into — unparseable to strict JSON consumers
        # exactly when the alert matters most
        out = {"alert": f"{self.series}_{reason}", "series": self.series,
               "reason": reason,
               "value": value if math.isfinite(value) else str(value),
               "mean": self.mean, "std": math.sqrt(self.var)}
        if z is not None:
            out["z"] = round(z, 3)
        if step is not None:
            out["step"] = int(step)
        return out


class ErrorBudget:
    """Sliding-window SLO burn-rate tracker (see module docstring).
    ``observe(missed)`` returns an alert dict when the windowed miss
    rate consumes the error budget at ``burn_threshold`` x or faster."""

    def __init__(self, name: str = "slo", target: float = 0.99,
                 window: int = 200, burn_threshold: float = 2.0,
                 min_events: int = 20, cooldown: int = 50):
        if not (0.0 < target < 1.0):
            raise ValueError(f"slo target must be in (0, 1), got {target}")
        self.name = name
        self.target = float(target)
        self.window = int(window)
        self.burn_threshold = float(burn_threshold)
        self.min_events = int(min_events)
        self.cooldown = int(cooldown)
        self._events: deque = deque(maxlen=self.window)
        self.events = 0
        self.misses = 0
        self.fired = 0
        self._since_alert = 10 ** 9

    @property
    def burn_rate(self) -> Optional[float]:
        if not self._events:
            return None
        miss_rate = sum(self._events) / len(self._events)
        return miss_rate / (1.0 - self.target)

    def observe(self, missed: bool) -> Optional[Dict[str, Any]]:
        self._since_alert += 1
        self.events += 1
        self.misses += int(bool(missed))
        self._events.append(1 if missed else 0)
        if len(self._events) < self.min_events:
            return None
        rate = self.burn_rate
        if rate is None or rate < self.burn_threshold:
            return None
        if self._since_alert <= self.cooldown:
            return None
        self._since_alert = 0
        self.fired += 1
        return {"alert": f"{self.name}_burn_rate", "reason": "burn_rate",
                "burn_rate": round(rate, 3), "target": self.target,
                "window": len(self._events),
                "window_misses": int(sum(self._events)),
                "misses_total": self.misses, "events_total": self.events}
