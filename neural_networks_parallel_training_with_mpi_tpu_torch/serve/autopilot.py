"""Fleet autopilot: the control loop that acts on the fleet's signals,
and the weight snapshots its rollouts push.  The port of the JAX
package's ``serve/autopilot.py``.

:class:`Autopilot` rides the owner's service loop (``Fleet.pump`` ticks
it when attached; no thread of its own) and makes these decisions, each
guarded so that a noisy signal cannot flap the fleet:

* **Autoscaling**: scale out when mean replica occupancy or the router's
  queue depth crosses its high-water mark and holds there
  (``scale_out_hold_s``); scale in when occupancy sits under the
  low-water mark with an empty queue for ``scale_in_hold_s``.  Scale-in
  drops no work: the victim is retired at the supervisor, asked to drain
  (the worker's ``decommission`` op) and exits 47
  (``EXIT_DECOMMISSION``); its in-flight requests requeue once through
  the router's ledger.  A drain that stalls past ``drain_timeout_s`` is
  escalated to SIGKILL, safe because the child is already retired.
* **Rollouts**: :meth:`Autopilot.start_rollout` verifies a weight
  snapshot's manifest before anything spawns; verified, it spawns canary
  replicas of the next generation (replica ids ``gen * GEN_STRIDE + k``),
  shifts a deterministic rid-modulo slice of traffic onto them and
  judges them over a window: canary p50 TTFT over
  ``canary_max_p50_ratio`` x the stable generation's, a deadline-miss
  fraction over ``canary_max_miss_frac``, or a canary that dies
  terminally rolls back; a healthy window promotes, and the old
  generation drains out through the same decommission path.
* **Preemption backfill** (a replica's advance notice is priced as lost
  capacity at once) and **health eviction** (``health_eviction``: a
  slow-but-alive replica is replaced, then drained).

A failed action arms a bounded exponential backoff; a successful scaling
action arms ``cooldown_s``.  With ``events_path`` every decision is
appended as one ``kind="autopilot"`` JSON line.

A snapshot is ``ckpt-<step>/weights.npz``, one array per leaf keyed as
``jax.tree_util.keystr`` keys the same tree (``"['blocks'][0]['qkv']['w']"``),
committed through ``utils.ckpt_manifest`` (payload fsynced, the manifest
with a size and sha256 per file written last).  Either package writes a
snapshot the other loads.  numpy has no bfloat16: a bf16 leaf is stored as
2-byte void (``|V2``, what numpy reads back from the JAX package's bf16
leaves) and named ``bfloat16`` in the checks.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils import ckpt_manifest
from ..utils.sketches import QuantileSketch
from .fleet import GEN_STRIDE  # noqa: F401  (the id <-> generation stride
#   is part of this module's attribution contract, as in JAX's)
from .fleet import role_kind

WEIGHTS = "weights.npz"


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) in JAX's flatten order: dict keys sorted, list and
    tuple items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(tree, leaves: Iterator):
    if isinstance(tree, dict):
        vals = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}     # the template's key order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _dtype_name(dtype) -> str:
    """A dtype named as numpy names it; a 2-byte void is bfloat16."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    dtype = np.dtype(dtype)
    if dtype.kind == "V" and dtype.itemsize == 2:
        return "bfloat16"
    return dtype.name


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(like.device)
    return torch.from_numpy(np.array(a)).to(like.device)


def save_weight_snapshot(ckpt_dir, params, step: int = 0,
                         meta: Optional[dict] = None) -> str:
    """Write ``ckpt-<step>/weights.npz`` (keystr -> array) and commit it
    through ``utils.ckpt_manifest``, so :func:`load_weight_snapshot` can
    prove it whole before reading a byte.  Returns the snapshot's path."""
    snap = Path(ckpt_dir) / f"{ckpt_manifest.CKPT_PREFIX}{int(step)}"
    snap.mkdir(parents=True, exist_ok=True)
    arrs = {key: _to_numpy(leaf) for key, leaf in _leaves(params)}
    with open(snap / WEIGHTS, "wb") as f:
        np.savez(f, **arrs)
        f.flush()
        os.fsync(f.fileno())
    ckpt_manifest.commit(
        snap, {"step": int(step), "kind": "weights", **(meta or {})})
    return str(snap)


def load_weight_snapshot(snap_dir, template):
    """Verify, then load a :func:`save_weight_snapshot` directory into the
    structure, dtypes and device of ``template`` (the worker's seeded
    params, which fix the tree).  Raises ``ValueError`` on a failed
    manifest, a missing or extra leaf, or a shape or dtype mismatch; the
    fleet worker exits 44 on it (no retry)."""
    snap_dir = Path(snap_dir)
    problems = ckpt_manifest.verify(snap_dir)
    if problems:
        raise ValueError(
            f"weight snapshot {snap_dir} failed verification: "
            f"{'; '.join(problems[:3])}")
    with np.load(snap_dir / WEIGHTS) as z:
        arrs = {k: z[k] for k in z.files}
    out: List[torch.Tensor] = []
    for key, leaf in _leaves(template):
        if key not in arrs:
            raise ValueError(f"snapshot missing leaf {key}")
        a = arrs.pop(key)
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"snapshot leaf {key}: shape {a.shape}, "
                             f"model expects {tuple(leaf.shape)}")
        if _dtype_name(a.dtype) != _dtype_name(leaf.dtype):
            raise ValueError(f"snapshot leaf {key}: dtype "
                             f"{_dtype_name(a.dtype)}, model expects "
                             f"{_dtype_name(leaf.dtype)}")
        out.append(_to_tensor(a, leaf))
    if arrs:
        raise ValueError(f"snapshot has leaves the model does not: "
                         f"{sorted(arrs)[:5]}")
    return _rebuild(template, iter(out))


# ---------------------------------------------------------------------------
# the control loop
# ---------------------------------------------------------------------------

@dataclass
class AutopilotConfig:
    """Guard rails for the three decision kinds (module docstring).
    Defaults suit the tiny CPU-emulated fleets of the examples/bench;
    real deployments scale the holds and windows with their traffic's
    noise floor."""
    # fleet width
    min_replicas: int = 1
    max_replicas: int = 4
    # per-role floor for DISAGGREGATED fleets (prefill/decode roles,
    # DESIGN.md §11): a role pool that has ever served is kept at this
    # many replicas — scale-in refuses victims that would breach it,
    # and an EMPTIED pool (crash-then-retire, eviction) is backfilled
    # with the same role so degraded unified serving is a transient,
    # not a steady state.  Unified fleets never hit either path.
    min_per_role: int = 1
    # decision cadence: tick() is called every Fleet.pump but only
    # evaluates this often (the steady-state overhead knob)
    interval_s: float = 0.2
    # autoscaling signal + hysteresis
    high_occupancy: float = 1.25   # mean (in_flight+queued)/slots
    high_queue: int = 8            # router fleet-queue high water
    low_occupancy: float = 0.25
    scale_out_hold_s: float = 0.75
    scale_in_hold_s: float = 3.0
    cooldown_s: float = 5.0        # between successful scaling actions
    # bounded backoff after a FAILED/rolled-back action
    action_backoff_s: float = 1.0
    action_backoff_cap_s: float = 30.0
    # decommission / spawn liveness bounds
    drain_timeout_s: float = 10.0
    ready_timeout_s: float = 120.0
    # canary policy
    canary_replicas: int = 1
    canary_fraction: float = 0.25
    canary_window_s: float = 5.0
    canary_min_completed: int = 5
    canary_max_extensions: int = 3
    canary_max_p50_ratio: float = 3.0
    canary_max_miss_frac: float = 0.25
    # degraded-replica eviction (off by default: an A/B bench or an
    # operator turns it on).  A replica whose WINDOWED TTFT median — or
    # lifetime-rollup ITL p50 — sits ``evict_*_ratio`` x beyond the
    # median of its peers for ``evict_hold_s`` is replaced-then-drained:
    # the replacement spawns first, the victim decommissions only once
    # the replacement accepts, so the fleet never dips below
    # ``min_replicas`` (transiently +1 wide, like a rollout).
    health_eviction: bool = False
    evict_ttft_ratio: float = 3.0
    evict_itl_ratio: float = 3.0
    health_window_s: float = 6.0
    evict_hold_s: float = 1.0
    evict_min_samples: int = 8
    # decision-ledger persistence: when set, every decision is appended
    # as one ``kind="autopilot"`` JSON line (the control loop's flight
    # recorder — rendered by ``metrics_summary --autopilot`` and drawn
    # as instant events by ``trace_report``, joined into the goodput
    # ledger by ``goodput_report``)
    events_path: Optional[str] = None


class Autopilot:
    """The supervisor-side control loop over a running fleet.  The
    ``fleet`` object provides the actuation surface (``Fleet`` has all
    of it; tests drive an in-process stand-in): ``router``,
    ``add_replica``, ``decommission``, ``force_kill``, ``replica_done``,
    ``remove_replica``.  All state is host-side bookkeeping;
    :meth:`tick` is cheap enough to ride every service-loop pass."""

    def __init__(self, fleet, cfg: Optional[AutopilotConfig] = None,
                 log: Optional[Callable[[str], None]] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.fleet = fleet
        self.cfg = cfg or AutopilotConfig()
        self.log = log or (lambda m: None)
        self._now = now_fn
        self._t0 = now_fn()
        self.decisions: List[Dict[str, Any]] = []
        self._last_eval = -math.inf
        # hysteresis + flap guards
        self._high_since: Optional[float] = None
        self._low_since: Optional[float] = None
        self._cooldown_until = -math.inf
        self._backoff_until = -math.inf
        self._failures = 0
        # in-flight actions
        self._pending_out: Optional[Dict[str, Any]] = None
        self._draining: Dict[str, Dict[str, Any]] = {}
        self._rollout: Optional[Dict[str, Any]] = None
        # preemption notices + health-eviction hysteresis
        self._noticed_seen: set = set()
        self._backfill_due: List[Tuple[str, Optional[str]]] = []
        self._unhealthy_since: Dict[str, float] = {}
        # disagg role memory: pools this fleet has served with.  A pool
        # that empties (all members dead AND removed) leaves no handle
        # to read the role from, so remember it here — _watch_pools
        # backfills from this set.
        self._roles_seen: set = set()
        # one-shot WAL-recovery disclosure (first tick after a router
        # relaunch): everything this loop observes — rollups, rates,
        # per-replica history — was REBUILT from the journal, not
        # carried across the crash
        self._recovery_disclosed = False

    # ---- bookkeeping ---------------------------------------------------
    def _decide(self, action: str, **extra) -> Dict[str, Any]:
        d = {"t": round(self._now() - self._t0, 3), "action": action,
             **extra}
        self.decisions.append(d)
        self.log(f"[autopilot] {action}: "
                 + ", ".join(f"{k}={v}" for k, v in extra.items()))
        if self.cfg.events_path:
            # append-only flight recorder; t_unix puts decisions on the
            # same wall-clock axis as the trace spans, so trace_report
            # can draw them as instants over the tick timeline
            import json

            try:
                rec = {"kind": "autopilot",
                       "t_unix": round(time.time(), 3),
                       "run": os.environ.get("NNPT_RUN_ID", ""),
                       "p": int(os.environ.get("NNPT_PROCESS_ID", "0")
                                or 0),
                       "inc": int(os.environ.get("NNPT_INCARNATION",
                                                 "0") or 0),
                       **d}
                with open(self.cfg.events_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
            except (OSError, TypeError, ValueError):
                pass  # the ledger must never take the control loop down
        return d

    def _action_failed(self, now: float, action: str,
                       why: str) -> None:
        self._failures += 1
        delay = min(self.cfg.action_backoff_s
                    * (2.0 ** (self._failures - 1)),
                    self.cfg.action_backoff_cap_s)
        self._backoff_until = now + delay
        self._decide("action_backoff", failed=action, why=why,
                     backoff_s=round(delay, 2))

    def _primary_gen(self) -> int:
        return self.fleet.router._primary_gen

    def _active(self) -> List[Any]:
        """Replicas the autopilot counts as serving capacity: registered
        at the router and not already being drained out."""
        return [h for h in self.fleet.router.replicas
                if h.name not in self._draining]

    def _spawn(self, role: Optional[str] = None, **kw):
        """``fleet.add_replica`` with the role passed ONLY when set, so
        unified fleets (and the in-process stand-ins tests drive) keep
        their pre-disagg call shape."""
        if role is not None and role != "unified":
            return self.fleet.add_replica(role=role, **kw)
        return self.fleet.add_replica(**kw)

    def _pool_counts(self) -> Dict[str, int]:
        """LIVE replicas per role kind (prefill / decode / unified),
        and the role-memory update: any disagg role seen here is
        remembered for empty-pool backfill.  Membership is ``alive``,
        not ``accepting`` — a replica still compiling occupies its
        pool (else the startup window would read as an empty pool and
        trigger a spurious backfill)."""
        by: Dict[str, int] = {}
        for h in self._active():
            kind = role_kind(h)
            if kind in ("prefill", "decode"):
                self._roles_seen.add(kind)
            alive = getattr(h, "alive", None)
            live = alive() if callable(alive) else h.accepting()
            if live and not getattr(h, "noticed", False):
                by[kind] = by.get(kind, 0) + 1
        return by

    def summary(self) -> Dict[str, Any]:
        """Decision counts per action (bench/test assertion surface)."""
        by: Dict[str, int] = {}
        for d in self.decisions:
            by[d["action"]] = by.get(d["action"], 0) + 1
        return {"decisions": len(self.decisions), "by_action": by,
                "draining": sorted(self._draining),
                "rollout": (self._rollout or {}).get("phase")}

    # ---- the judge's input ---------------------------------------------
    def breakdown(self) -> List[Dict[str, Any]]:
        """One row per replica in ``tools/obs_agg.py``'s per-writer
        breakdown shape, built from each replica's latest RAW
        ``kind="rollup"`` load report (the identical document obs_agg
        merges from the telemetry dirs — same sketches, same ``now``
        gauges), plus the generation tag the judge slices on."""
        rows = []
        for h in self.fleet.router.replicas:
            rec = getattr(h, "report", None)
            if rec is None and hasattr(h, "sched"):
                rec = h.sched.load_report()     # InprocReplica
            if not rec:
                continue
            row: Dict[str, Any] = {
                "name": h.name, "role": rec.get("role", "serve"),
                "replica": rec.get("replica"),
                "generation": getattr(h, "generation", 0),
                "step": rec.get("step"),
            }
            for metric in ("ttft_ms", "itl_ms"):
                doc = (rec.get("sketches") or {}).get(metric)
                if doc:
                    sk = QuantileSketch.from_dict(doc)
                    row[f"{metric}_p50"] = sk.quantile(0.5)
                    row[f"{metric}_p99"] = sk.quantile(0.99)
            now_d = rec.get("now") or {}
            for k in ("queue_depth", "in_flight", "block_utilization"):
                if k in now_d:
                    row[k] = now_d[k]
            rows.append(row)
        return rows

    # ---- the loop ------------------------------------------------------
    def tick(self) -> List[Dict[str, Any]]:
        """One control evaluation (rate-limited to ``interval_s``);
        returns the decisions made during this call."""
        now = self._now()
        if now - self._last_eval < self.cfg.interval_s:
            return []
        self._last_eval = now
        before = len(self.decisions)
        rec = getattr(self.fleet.router, "recovery", None)
        if not self._recovery_disclosed and rec and rec.get("recovered"):
            # disclose ONCE that this incarnation's state is journal-
            # rebuilt (serve/wal.py): consumers of the decision ledger
            # must not read pre-crash trends into post-crash rollups
            self._recovery_disclosed = True
            self._decide("post_recovery",
                         replayed=rec.get("replayed", 0),
                         deduped=rec.get("deduped", 0),
                         converted=rec.get("converted", 0),
                         lost=rec.get("lost", 0),
                         wall_s=rec.get("wall_s", 0.0))
        self._watch_pending_out(now)
        self._watch_notices(now)
        self._watch_draining(now)
        if self._rollout is not None:
            self._advance_rollout(now)
        else:
            self._watch_pools(now)
            self._autoscale(now)
            self._health_evict(now)
        return self.decisions[before:]

    # ---- disagg pool floors (DESIGN.md §11) ----------------------------
    def _watch_pools(self, now: float) -> None:
        """Backfill an EMPTIED disagg role pool.  While a pool is empty
        the router serves degraded-unified (correct but unpriced:
        prefill and decode interfere again), so this reacts like the
        preemption backfill — not gated on cooldown, only on the
        one-action gate and failure backoff.  Roles come from
        ``_roles_seen``: an empty pool leaves no handle to read."""
        counts = self._pool_counts()
        if (len(self._roles_seen) < 2       # never was a disagg fleet
                or self._rollout is not None
                or self._pending_out is not None
                or now < self._backoff_until):
            return
        missing = sorted(r for r in self._roles_seen
                         if counts.get(r, 0) < self.cfg.min_per_role)
        if not missing:
            return
        role = missing[0]
        try:
            h = self._spawn(role=role, generation=self._primary_gen())
        except Exception as exc:
            self._action_failed(now, "pool_backfill", str(exc)[:200])
            return
        self._pending_out = {"name": h.name, "t": now,
                             "deadline": now + self.cfg.ready_timeout_s}
        self._decide("pool_backfill", replica=h.name, role=role,
                     pool_size=counts.get(role, 0))

    # ---- autoscaling ---------------------------------------------------
    def _observe(self):
        router = self.fleet.router
        occs = []
        by_role: Dict[str, List[float]] = {}
        for h in self._active():
            if not h.accepting():
                continue
            sig = h.load()
            occ = sig.occupancy if sig is not None else 0.0
            occs.append(occ)
            by_role.setdefault(role_kind(h), []).append(occ)
        queue = len(router.queue)
        mean_occ = (sum(occs) / len(occs)) if occs else math.inf
        occ_by_role = {k: sum(v) / len(v) for k, v in by_role.items()}
        return mean_occ, queue, occ_by_role

    def _autoscale(self, now: float) -> None:
        cfg = self.cfg
        mean_occ, queue, occ_by_role = self._observe()
        # disagg fleets watch each pool: one hot role is a capacity
        # problem even when the other pool idles the fleet-wide mean
        # below the threshold (a long-prompt wave saturates prefill
        # while decode coasts)
        hot_roles = {k: v for k, v in occ_by_role.items()
                     if k in ("prefill", "decode")
                     and v >= cfg.high_occupancy}
        high = (mean_occ >= cfg.high_occupancy
                or queue >= cfg.high_queue or bool(hot_roles))
        low = mean_occ <= cfg.low_occupancy and queue == 0
        # hysteresis: the signal must HOLD before anything moves
        if high:
            self._low_since = None
            if self._high_since is None:
                self._high_since = now
        elif low:
            self._high_since = None
            if self._low_since is None:
                self._low_since = now
        else:
            self._high_since = self._low_since = None
        if (now < self._cooldown_until or now < self._backoff_until
                or self._pending_out is not None or self._draining):
            return                      # one action in flight at a time
        n = len(self._active())
        if (self._high_since is not None
                and now - self._high_since >= cfg.scale_out_hold_s
                and n < cfg.max_replicas):
            # disagg fleets scale the PRESSURED pool: the role with the
            # highest mean occupancy gets the new replica, so a
            # long-prompt wave widens prefill without over-building the
            # decode pool (and vice versa).  Unified fleets pass None.
            role = None
            disagg = [(v, k) for k, v in
                      (hot_roles or occ_by_role).items()
                      if k in ("prefill", "decode")]
            if disagg:
                role = max(disagg)[1]
            self._scale_out(now, reason={
                "mean_occupancy": round(mean_occ, 3)
                if math.isfinite(mean_occ) else None,
                "queue_depth": queue}, role=role)
        elif (self._low_since is not None
                and now - self._low_since >= cfg.scale_in_hold_s
                and n > cfg.min_replicas):
            self._scale_in(now, reason={
                "mean_occupancy": round(mean_occ, 3)
                if math.isfinite(mean_occ) else None})

    def _scale_out(self, now: float, reason,
                   role: Optional[str] = None) -> None:
        try:
            h = self._spawn(role=role, generation=self._primary_gen())
        except Exception as exc:          # spawn refusal = failed action
            self._action_failed(now, "scale_out", str(exc)[:200])
            return
        self._pending_out = {"name": h.name, "t": now,
                             "deadline": now + self.cfg.ready_timeout_s}
        self._high_since = None
        self._cooldown_until = now + self.cfg.cooldown_s
        if role is not None:
            reason = {**reason, "role": role}
        self._decide("scale_out", replica=h.name, **reason)

    def _watch_pending_out(self, now: float) -> None:
        p = self._pending_out
        if p is None:
            return
        h = next((r for r in self.fleet.router.replicas
                  if r.name == p["name"]), None)
        if h is not None and h.accepting():
            self._pending_out = None
            self._failures = 0
            self._decide("scale_out_ready", replica=p["name"],
                         reaction_s=round(now - p["t"], 3))
            # replace-then-drain: the eviction victim leaves only once
            # its replacement accepts, so capacity never dips
            victim = p.get("then_evict")
            if victim is not None and victim not in self._draining \
                    and any(r.name == victim
                            for r in self.fleet.router.replicas):
                self._begin_decommission(now, victim,
                                         kind="health_evict")
            return
        rc = self.fleet.replica_done(p["name"])
        if rc is not None:
            # the supervisor gave up on (or terminally stopped) the new
            # child before it ever served — undo the registration
            self._pending_out = None
            self.fleet.remove_replica(p["name"])
            self._action_failed(now, "scale_out",
                                f"{p['name']} never ready (rc {rc})")
            return
        if now >= p["deadline"]:
            self._pending_out = None
            try:
                self.fleet.supervisor.retire(p["name"])
            except (KeyError, AttributeError):
                pass
            self.fleet.force_kill(p["name"])
            self.fleet.remove_replica(p["name"])
            self._action_failed(now, "scale_out",
                                f"{p['name']} ready timeout")

    def _scale_in(self, now: float, reason) -> None:
        gen = self._primary_gen()
        victims = [h for h in self._active()
                   if getattr(h, "generation", 0) == gen]
        if len(victims) <= self.cfg.min_replicas:
            return
        # per-role floor: in a disagg fleet, removing a replica must not
        # drop its role pool below min_per_role — an emptied pool means
        # degraded unified serving, which scale-in must never cause.
        pool = {}
        for h in victims:
            pool[role_kind(h)] = pool.get(role_kind(h), 0) + 1
        victims = [h for h in victims
                   if role_kind(h) == "unified"
                   or pool[role_kind(h)] > self.cfg.min_per_role]
        if not victims:
            return
        victim = max(victims, key=lambda h: h.name)  # newest out first
        self._begin_decommission(now, victim.name, kind="scale_in")
        self._low_since = None
        self._cooldown_until = now + self.cfg.cooldown_s
        self._decide("scale_in", replica=victim.name, **reason)

    # ---- decommission (the no-drop removal primitive) ------------------
    def _begin_decommission(self, now: float, name: str,
                            kind: str) -> None:
        sent = self.fleet.decommission(name)
        self._draining[name] = {
            "t": now, "deadline": now + self.cfg.drain_timeout_s,
            "forced": False, "kind": kind, "op_sent": sent,
            "base_requeued": self.fleet.router.requeued}

    def _watch_draining(self, now: float) -> None:
        for name, st in list(self._draining.items()):
            rc = self.fleet.replica_done(name)
            if rc is not None:
                self.fleet.remove_replica(name)
                del self._draining[name]
                self._decide(
                    "drained", replica=name, rc=rc, kind=st["kind"],
                    forced=st["forced"],
                    wall_s=round(now - st["t"], 3),
                    requeued=self.fleet.router.requeued
                    - st["base_requeued"])
                if self._rollout is not None:
                    self._check_promote_done(now)
                continue
            if now >= st["deadline"] and not st["forced"]:
                # stalled drain: the child is already retired, so the
                # kill is terminal — no relaunch, ledger requeues once
                st["forced"] = True
                self.fleet.force_kill(name)
                self._decide("drain_stalled_kill", replica=name,
                             kind=st["kind"],
                             after_s=round(now - st["t"], 3))

    # ---- preemption notices (advance-notice drain + backfill) ----------
    def _watch_notices(self, now: float) -> None:
        """A replica that announced a preemption notice
        (``preempt_notice`` on the wire) stops accepting new work on
        its own — the router's admission closes the moment the pump
        lands the event — and exits 47 when idle or at its grace
        deadline.  The autopilot's job is attribution and backfill:
        record the notice ONCE in the decision ledger, reap the
        self-initiated exit (it never enters ``_draining``), and spawn
        a replacement while the victim is still finishing its
        in-flight work, so capacity is restored before the death."""
        for h in list(self.fleet.router.replicas):
            if not getattr(h, "noticed", False):
                continue
            if h.name not in self._noticed_seen:
                self._noticed_seen.add(h.name)
                # record the role AT NOTICE TIME: the handle may be
                # gone by the time the backfill slot frees up
                self._backfill_due.append((h.name, role_kind(h)))
                g = getattr(h, "notice_grace_s", None)
                self._decide("preempt_notice", replica=h.name,
                             grace_s=(round(float(g), 3)
                                      if g is not None else None))
            if h.name in self._draining:
                continue            # an explicit drain already owns it
            rc = self.fleet.replica_done(h.name)
            if rc is not None:
                self.fleet.remove_replica(h.name)
                self._decide("preempt_drained", replica=h.name, rc=rc,
                             requeued=0 if rc == 47 else None)
        # backfill one replacement per notice.  Deliberately NOT gated
        # on cooldown: the capacity loss is involuntary, reacting to it
        # is not flapping.  The one-action gate and failure backoff
        # still apply, and a rollout owns spawning while active.
        if (not self._backfill_due or self._rollout is not None
                or self._pending_out is not None
                or now < self._backoff_until):
            return
        width = len([h for h in self._active()
                     if not getattr(h, "noticed", False)])
        if width >= self.cfg.max_replicas:
            self._backfill_due.clear()
            return
        victim, vrole = self._backfill_due.pop(0)
        try:
            # the replacement inherits the victim's role, so a preempted
            # prefill replica is backfilled INTO the prefill pool
            h = self._spawn(role=vrole,
                            generation=self._primary_gen())
        except Exception as exc:
            self._backfill_due.insert(0, (victim, vrole))
            self._action_failed(now, "preempt_backfill",
                                str(exc)[:200])
            return
        self._pending_out = {"name": h.name, "t": now,
                             "deadline": now + self.cfg.ready_timeout_s}
        self._decide("preempt_backfill", replica=h.name,
                     replaces=victim)

    # ---- degraded-replica eviction -------------------------------------
    def _health_windowed(self, now: float) -> Dict[str, Any]:
        """Per-replica windowed TTFT medians from the router's
        completion samples (``FleetRouter.recent``) — the same windowed
        signal the canary judge reads, so a degraded replica cannot
        hide behind a healthy lifetime sketch."""
        t_cut = now - self.cfg.health_window_s
        by: Dict[str, List[float]] = {}
        for s in self.fleet.router.recent:
            if s["t"] < t_cut or s["ttft_ms"] is None:
                continue
            by.setdefault(s["replica"], []).append(s["ttft_ms"])
        return {n: (sorted(v)[len(v) // 2], len(v))
                for n, v in by.items()}

    def _health_evict(self, now: float) -> None:
        """Force-drain a slow-but-alive replica: windowed TTFT median
        (or lifetime-rollup ITL p50) ``evict_*_ratio`` x beyond the
        median of its PEERS, held for ``evict_hold_s``.  Shares the
        one-action-in-flight gate, cooldown and backoff with the
        autoscaler, and goes replace-then-drain through
        ``_pending_out["then_evict"]`` so the fleet never dips below
        ``min_replicas`` — even when the victim IS the floor."""
        cfg = self.cfg
        if not cfg.health_eviction:
            return
        if (now < self._cooldown_until or now < self._backoff_until
                or self._pending_out is not None or self._draining):
            return                  # one action in flight at a time
        candidates = [h for h in self._active()
                      if h.accepting()
                      and not getattr(h, "noticed", False)]
        if len(candidates) < 2:
            self._unhealthy_since.clear()
            return                  # no peers to compare against
        names = {h.name for h in candidates}
        windowed = {n: v for n, v
                    in self._health_windowed(now).items()
                    if n in names and v[1] >= cfg.evict_min_samples}
        itl = {r["name"]: r.get("itl_ms_p50")
               for r in self.breakdown() if r["name"] in names}
        worst = None                # (name, verdict-extras)
        for n in sorted(names):
            vs: Dict[str, Any] = {}
            if n in windowed and len(windowed) >= 2:
                peers = sorted(m for k, (m, _) in windowed.items()
                               if k != n)
                base = peers[len(peers) // 2]
                if base > 0 and windowed[n][0] / base \
                        >= cfg.evict_ttft_ratio:
                    vs["ttft_p50_ms"] = round(windowed[n][0], 1)
                    vs["ttft_ratio"] = round(windowed[n][0] / base, 2)
            mine = itl.get(n)
            peers_i = sorted(v for k, v in itl.items()
                             if k != n and v is not None)
            if mine is not None and peers_i:
                base_i = peers_i[len(peers_i) // 2]
                if base_i > 0 and mine / base_i >= cfg.evict_itl_ratio:
                    vs["itl_p50_ms"] = round(mine, 1)
                    vs["itl_ratio"] = round(mine / base_i, 2)
            if vs and (worst is None
                       or vs.get("ttft_ratio", 0)
                       > worst[1].get("ttft_ratio", 0)):
                worst = (n, vs)
        # hysteresis: the verdict must HOLD before anything moves
        for n in list(self._unhealthy_since):
            if worst is None or n != worst[0]:
                del self._unhealthy_since[n]
        if worst is None:
            return
        name, verdict = worst
        since = self._unhealthy_since.setdefault(name, now)
        if now - since < cfg.evict_hold_s:
            return
        del self._unhealthy_since[name]
        # replace-then-drain: spawn the replacement first (same role as
        # the victim, so an evicted prefill replica is replaced in the
        # prefill pool); the victim decommissions in _watch_pending_out
        # once it accepts
        vrole = next((role_kind(h) for h in candidates
                      if h.name == name), None)
        try:
            h = self._spawn(role=vrole,
                            generation=self._primary_gen())
        except Exception as exc:
            self._action_failed(now, "health_evict", str(exc)[:200])
            return
        self._pending_out = {"name": h.name, "t": now,
                             "deadline": now + cfg.ready_timeout_s,
                             "then_evict": name}
        self._cooldown_until = now + cfg.cooldown_s
        self._decide("health_evict", replica=name,
                     replacement=h.name, **verdict)

    # ---- rollout / canary ----------------------------------------------
    def start_rollout(self, snapshot_dir,
                      canary_replicas: Optional[int] = None,
                      canary_fraction: Optional[float] = None,
                      step_sleep_ms: Optional[float] = None) -> bool:
        """Begin a zero-downtime weight rollout from a snapshot dir
        (:func:`save_weight_snapshot` layout).  Verification happens
        HERE, before any process spawns: a bad snapshot returns False
        with the serving generation untouched (decision
        ``rollout_rejected``).  ``step_sleep_ms`` overrides the canary
        workers' emulated device latency (chaos/testing knob: a slow
        canary must roll back on its SLO judgment)."""
        if self._rollout is not None:
            raise RuntimeError("a rollout is already in progress")
        now = self._now()
        problems = ckpt_manifest.verify(Path(snapshot_dir))
        if problems:
            self._decide("rollout_rejected",
                         snapshot=str(snapshot_dir),
                         problems=problems[:3])
            self._action_failed(now, "rollout", "snapshot unverified")
            return False
        gen = self._primary_gen() + 1
        k = canary_replicas or self.cfg.canary_replicas
        names = []
        try:
            for _ in range(k):
                h = self.fleet.add_replica(
                    generation=gen, ckpt=str(snapshot_dir),
                    step_sleep_ms=step_sleep_ms)
                names.append(h.name)
        except Exception as exc:
            for n in names:
                self.fleet.force_kill(n)
                self.fleet.remove_replica(n)
            self._action_failed(now, "rollout", str(exc)[:200])
            return False
        self._rollout = {
            "phase": "wait_ready", "gen": gen,
            "snapshot": str(snapshot_dir), "canary": names,
            "step_sleep_ms": step_sleep_ms, "t0": now,
            "fraction": (canary_fraction
                         if canary_fraction is not None
                         else self.cfg.canary_fraction),
            "deadline": now + self.cfg.ready_timeout_s,
            "extensions": 0,
        }
        self._decide("canary_spawn", generation=gen,
                     replicas=list(names),  # copy: _promote grows it
                     snapshot=str(snapshot_dir))
        return True

    def _canary_handles(self) -> List[Any]:
        names = set(self._rollout["canary"])
        return [h for h in self.fleet.router.replicas
                if h.name in names]

    def _advance_rollout(self, now: float) -> None:
        ro = self._rollout
        phase = ro["phase"]
        if phase == "promote_drain":
            self._check_promote_done(now)
            return
        # a canary child that terminally died (bad checkpoint -> exit
        # 44; supervisor gave up) fails the rollout in ANY phase
        for name in list(ro["canary"]):
            rc = self.fleet.replica_done(name)
            if rc is not None and name not in self._draining:
                self._rollback(now, f"canary {name} died (rc {rc})")
                return
        if phase == "wait_ready":
            if all(h.accepting() for h in self._canary_handles()) \
                    and self._canary_handles():
                router = self.fleet.router
                router.set_traffic(self._primary_gen(),
                                   canary_generation=ro["gen"],
                                   canary_fraction=ro["fraction"])
                ro["phase"] = "judge"
                ro["window_end"] = now + self.cfg.canary_window_s
                ro["base_completed"] = router.per_replica_completed()
                ro["base_missed"] = router.per_replica_missed()
                self._decide("canary_traffic",
                             fraction=ro["fraction"],
                             generation=ro["gen"])
            elif now >= ro["deadline"]:
                self._rollback(now, "canary never became ready")
            return
        if phase == "judge" and now >= ro["window_end"]:
            self._judge(now)

    def _judge(self, now: float) -> None:
        ro = self._rollout
        cfg = self.cfg
        router = self.fleet.router
        canary = set(ro["canary"])
        comp = router.per_replica_completed()
        miss = router.per_replica_missed()
        done = sum(comp.get(n, 0) - ro["base_completed"].get(n, 0)
                   for n in canary)
        missed = sum(miss.get(n, 0) - ro["base_missed"].get(n, 0)
                     for n in canary)
        if done < cfg.canary_min_completed:
            if ro["extensions"] < cfg.canary_max_extensions:
                ro["extensions"] += 1
                ro["window_end"] = now + cfg.canary_window_s
                self._decide("canary_window_extended",
                             completed=done,
                             extension=ro["extensions"])
                return
            self._rollback(now, f"insufficient canary traffic "
                                f"({done} completed)")
            return
        miss_frac = missed / done
        # latency verdict from the router's WINDOWED completion samples
        # (FleetRouter.recent), not the replicas' lifetime sketches: a
        # fresh canary's first-compile TTFTs would dominate a lifetime
        # p50 forever and roll back every healthy push.  Samples before
        # the traffic shift (minus the judge window, for the stable
        # side's sample size) are out of scope.
        t_cut = now - self.cfg.canary_window_s * (
            1 + ro["extensions"] + 1)
        canary_ts, stable_ts = [], []
        for s in router.recent:
            if s["t"] < t_cut or s["ttft_ms"] is None:
                continue
            if s["generation"] == ro["gen"]:
                canary_ts.append(s["ttft_ms"])
            elif s["generation"] == self._primary_gen():
                stable_ts.append(s["ttft_ms"])
        ratio = None
        if canary_ts and stable_ts:
            c_p50 = sorted(canary_ts)[len(canary_ts) // 2]
            s_p50 = sorted(stable_ts)[len(stable_ts) // 2]
            if s_p50 > 0:
                ratio = c_p50 / s_p50
        verdict = {"completed": done, "missed": missed,
                   "miss_frac": round(miss_frac, 3),
                   "p50_ratio": (round(ratio, 2)
                                 if ratio is not None else None)}
        if miss_frac > cfg.canary_max_miss_frac:
            self._rollback(now, f"canary SLO burn {miss_frac:.0%}",
                           **verdict)
            return
        if ratio is not None and ratio > cfg.canary_max_p50_ratio:
            self._rollback(now, f"canary p50 {ratio:.1f}x stable",
                           **verdict)
            return
        self._promote(now, verdict)

    def _promote(self, now: float, verdict: Dict[str, Any]) -> None:
        ro = self._rollout
        router = self.fleet.router
        old_gen = self._primary_gen()
        old = [h for h in self._active()
               if getattr(h, "generation", 0) == old_gen]
        # grow the new generation to the old serving width, then shift
        # all traffic; old-gen replicas stay accepting until their drain
        # lands (generation preference, not partition — zero downtime
        # while the extras compile)
        grow = max(0, len(old) - len(ro["canary"]))
        try:
            for _ in range(grow):
                h = self.fleet.add_replica(
                    generation=ro["gen"], ckpt=ro["snapshot"],
                    step_sleep_ms=ro["step_sleep_ms"])
                ro["canary"].append(h.name)
        except Exception as exc:
            self._rollback(now, f"promote spawn failed: {exc}")
            return
        router.set_traffic(ro["gen"])
        for h in old:
            self._begin_decommission(now, h.name, kind="rollout_old")
        ro["phase"] = "promote_drain"
        ro["old"] = [h.name for h in old]
        self._decide("canary_promote", generation=ro["gen"],
                     draining=[h.name for h in old], **verdict)

    def _check_promote_done(self, now: float) -> None:
        ro = self._rollout
        if ro is None or ro["phase"] != "promote_drain":
            return
        if any(n in self._draining for n in ro["old"]):
            return
        self._failures = 0
        self._decide("rollout_complete", generation=ro["gen"],
                     wall_s=round(now - ro["t0"], 3))
        self._rollout = None

    def _rollback(self, now: float, reason: str, **extra) -> None:
        ro = self._rollout
        router = self.fleet.router
        # restore traffic FIRST: the old generation takes everything
        # again before the canaries disappear
        router.set_traffic(self._primary_gen())
        for name in ro["canary"]:
            if name in self._draining:
                continue
            if self.fleet.replica_done(name) is not None:
                self.fleet.remove_replica(name)
            else:
                self._begin_decommission(now, name, kind="rollback")
        self._decide("canary_rollback", generation=ro["gen"],
                     reason=reason, **extra)
        self._rollout = None
        self._action_failed(now, "rollout", reason)
