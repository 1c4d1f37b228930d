"""Deterministic fault injection for resilience testing, the port's own
copy of the JAX package's ``utils/faults.py`` for its training kinds.

Spec grammar (``--faults`` / the ``NNPT_FAULTS`` environment variable),
comma-separated, as in the JAX package::

    kind@start[-end][?opt[&opt...]]

Training kinds, fired by :meth:`FaultPlan.apply` at the global step about
to run (every step of a ``--steps_per_dispatch`` group is visited, before
the group is dispatched):

    ``nan``          multiply that step's ``mask`` by NaN (every float leaf
                     when there is none), so its loss and gradient are NaN:
                     the bad batch the guarded update must reject.  Inside
                     a k-group only the faulted step's rows are poisoned.
    ``crash``        ``os._exit(1)``: the crash the supervisor relaunches
                     (after the flight recorder's postmortem).
    ``sigterm``      SIGTERM to this process: the preemption the graceful
                     shutdown absorbs (final snapshot, exit 0).
    ``preempt``      SIGUSR1 with a notice file of ``grace=S`` seconds
                     (default 2): the advance notice (snapshot, exit 47).
    ``slow``         sleep ``ms=M`` milliseconds (default 50) per step.
    ``torn_ckpt``    the next snapshot write publishes its payload without
                     the manifest and the process dies by SIGKILL.
    ``corrupt_ckpt`` XOR 8 bytes in the middle of the newest committed
                     snapshot's largest payload file (rank 0 only).
    ``ckpt_ioerr``   the next snapshot write raises OSError.
    ``peer_kill``    SIGKILL this process: the dead host its peers must
                     turn into exit 43 within ``--collective_timeout``.
    ``peer_hang``    wedge this process in a host sleep: the frozen host
                     (its own watchdog exits 42; its peers' collectives
                     time out, exit 43).
    ``device_loss``  report a lost local device: exit 43.

Silent-data-corruption kinds, fired by :meth:`FaultPlan.apply_state` on
the train state about to run that step (in place, so a CUDA graph captured
on it stays valid), on the rank whose data-rank index is ``shard`` only:

    ``bitflip``      flip bit ``bit=B`` (default 12) of the middle element
                     of one replicated float param leaf (``param=SUBSTR``,
                     else candidate ``start % n``); shard ``shard=K``
                     (default 1): the cosmic ray the fingerprint must
                     detect, localize, triage as transient and heal.
    ``desync``       add ``eps=V`` (default 1e-3) to one replicated float
                     OPTIMIZER-state leaf of that shard: a garbled update,
                     transient like ``bitflip``.  With ``det`` it moves
                     into the step function (:func:`wrap_step_with_desync`):
                     every data rank but the first drifts from optimizer
                     step ``start`` on, the replay reproduces it, and the
                     run aborts with exit 45.

Options: ``max=N`` (fire at most N times in this process), ``once=PATH``
(at most once while the marker file exists: survives a relaunch),
``proc=K`` (fire on rank K only), ``grace=S`` (preempt), ``ms=M`` (slow),
``param=``/``shard=``/``bit=``/``eps=``/``det`` (the SDC kinds).

Parsed, with the JAX package's grammar and errors, but refused when the
plan is built into a run: the serving-fleet, handoff and control-plane
kinds (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ENV_VAR = "NNPT_FAULTS"
KINDS = ("nan", "crash", "sigterm", "torn_ckpt", "corrupt_ckpt",
         "ckpt_ioerr", "bitflip", "desync", "peer_kill", "peer_hang",
         "device_loss", "replica_kill", "stall_drain", "preempt", "slow",
         "handoff_kill", "handoff_kill_post", "decode_kill",
         "handoff_stall", "router_kill", "fleet_kill")
# the kinds that corrupt the train state (apply_state), not the batch
STATE_KINDS = ("bitflip", "desync")
# kinds parsed for the grammar's sake whose paths are not ported, with the
# ROADMAP Queue A item that ports them
UNPORTED_KINDS = {
    **{k: "the serving fleet (Queue A item 6)" for k in (
        "replica_kill", "stall_drain", "handoff_kill", "handoff_kill_post",
        "decode_kill", "handoff_stall", "router_kill", "fleet_kill")},
}


def _process_index() -> int:
    """This process's world rank (0 without a process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _say(msg: str) -> None:
    print(f"[faults] {msg}", file=sys.stderr, flush=True)


def _emergency_dump(reason: str) -> None:
    """The flight recorder's postmortem before an injected death
    (``train.telemetry``; a no-op with telemetry off)."""
    try:
        from ..train import telemetry

        telemetry.emergency_dump(reason)
    except Exception:
        pass


@dataclasses.dataclass
class _Fault:
    kind: str
    start: int
    end: int                      # inclusive
    max_fires: Optional[int] = None
    once_marker: Optional[str] = None
    param: Optional[str] = None   # bitflip/desync: leaf substring
    shard: int = 1
    bit: int = 12
    eps: float = 1e-3
    det: bool = False
    proc: Optional[int] = None    # fire only on this rank
    grace: float = 2.0            # preempt: notice-to-deadline seconds
    ms: float = 50.0              # slow: injected latency per step
    fires: int = 0

    def should_fire(self, step: int) -> bool:
        if not (self.start <= step <= self.end):
            return False
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.once_marker and Path(self.once_marker).exists():
            return False
        return True

    def mark_fired(self) -> None:
        self.fires += 1
        if self.once_marker:
            p = Path(self.once_marker)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text("fired\n")


def _parse_one(item: str) -> _Fault:
    head, _, opts = item.partition("?")
    kind, _, window = head.partition("@")
    kind = kind.strip()
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r} in {item!r} "
                         f"(choices: {', '.join(KINDS)})")
    if not window:
        raise ValueError(f"fault {item!r} lacks '@step' (e.g. 'nan@5-8')")
    lo, _, hi = window.partition("-")
    start = int(lo)
    end = int(hi) if hi else start
    if end < start:
        raise ValueError(f"fault window {window!r} ends before it starts")
    fault = _Fault(kind, start, end)
    if kind == "preempt":
        fault.max_fires = 1     # a notice is an edge, not a level
    for opt in filter(None, opts.split("&")):
        key, _, val = opt.partition("=")
        if key == "max":
            fault.max_fires = int(val)
        elif key == "once":
            if not val:
                raise ValueError(f"once= needs a marker path in {item!r}")
            fault.once_marker = val
        elif key == "param":
            fault.param = val
        elif key == "shard":
            fault.shard = int(val)
        elif key == "bit":
            fault.bit = int(val)
        elif key == "eps":
            fault.eps = float(val)
        elif key == "det":
            fault.det = True
        elif key == "proc":
            fault.proc = int(val)
        elif key == "grace":
            fault.grace = float(val)
            if fault.grace < 0:
                raise ValueError(f"grace= must be >= 0 in {item!r}")
            if kind != "preempt":
                raise ValueError(
                    f"option 'grace' only applies to preempt, not {kind!r}")
        elif key == "ms":
            fault.ms = float(val)
            if fault.ms < 0:
                raise ValueError(f"ms= must be >= 0 in {item!r}")
            if kind != "slow":
                raise ValueError(
                    f"option 'ms' only applies to slow, not {kind!r}")
        else:
            raise ValueError(f"unknown fault option {key!r} in {item!r}")
    if fault.det and kind != "desync":
        raise ValueError(f"option 'det' only applies to desync, not {kind!r}")
    return fault


def _corrupt_newest(ckpt_dir: Optional[str], step: int) -> None:
    """``corrupt_ckpt``: XOR 8 bytes in the middle of the newest committed
    snapshot's largest payload file (rank 0 only: on a shared filesystem
    two ranks would flip the same bytes back)."""
    from . import checkpoint as ckpt_lib
    from . import ckpt_manifest

    if _process_index() != 0:
        return
    snaps = (ckpt_lib._snapshot_dirs(Path(ckpt_dir), committed=True)
             if ckpt_dir else [])
    if not snaps:
        _say(f"corrupt_ckpt at step {step}: no committed snapshot "
             f"{'yet' if ckpt_dir else '(no checkpoint_dir)'}, nothing to "
             "corrupt")
        return
    _, snap = snaps[-1]
    victim = max(ckpt_manifest.payload_files(snap),
                 key=lambda p: p.stat().st_size)
    size = victim.stat().st_size
    with open(victim, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(8)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))
    _say(f"injected corruption at step {step}: flipped {len(chunk)} bytes "
         f"in {snap.name}/{victim.name}")


def _replicated_float_leaves(tree):
    """(name, tensor) of the float leaves of ``tree`` in the JAX package's
    flatten order: the candidate victims of the SDC kinds."""
    from .consistency import replicated_leaves

    if tree is None:
        return
    for name, leaf in replicated_leaves(tree):
        if leaf.is_floating_point():
            yield name, leaf


def flip_bit_in_shard(leaf, shard_idx: int, bit: int,
                      elem: Optional[int] = None, replica: int = 0,
                      n_replicas: int = 1):
    """Flip bit ``bit`` of element ``elem`` (default: the middle of the
    flat tensor) of ``leaf`` in place, on the replica whose data-rank index
    is ``shard_idx`` (mod ``n_replicas``) only: physically diverged
    replicas of a leaf every rank claims to hold identically, which is
    what a hardware SDC looks like.  Returns ``leaf``."""
    import numpy as np
    import torch

    if shard_idx % max(n_replicas, 1) != replica:
        return leaf
    width = leaf.element_size() * 8
    ints = {8: torch.uint8, 16: torch.int16, 32: torch.int32,
            64: torch.int64}[width]
    flat = leaf.detach().view(-1).view(ints)
    elem = flat.numel() // 2 if elem is None else elem % flat.numel()
    word = flat[elem:elem + 1].cpu().numpy().copy()
    u = word.view(f"uint{width}")
    u ^= np.asarray(1 << (bit % width), u.dtype)
    with torch.no_grad():
        flat[elem:elem + 1].copy_(torch.from_numpy(word))
    return leaf


def perturb_shard(leaf, shard_idx: int, eps: float, replica: int = 0,
                  n_replicas: int = 1):
    """Add ``eps`` to every element of ``leaf`` in place on the replica
    whose data-rank index is ``shard_idx`` only (the ``desync`` kind's
    garbled update).  Returns ``leaf``."""
    import torch

    if shard_idx % max(n_replicas, 1) == replica:
        with torch.no_grad():
            leaf.add_(torch.tensor(eps, dtype=leaf.dtype,
                                   device=leaf.device))
    return leaf


def wrap_step_with_desync(step_fn, start: int, eps: float, replica: int):
    """The DETERMINISTIC desync (``desync@N?det``): after each step, from
    optimizer step ``start`` on, every data rank but the first adds ``eps
    * replica`` to the first float param leaf, inside the step function —
    the stand-in for an update that is not the same on every rank.  The
    condition is read from the optimizer's count on the device, so the
    wrapped step can be captured as a CUDA graph.  The SDC replay
    reproduces it and must return the deterministic verdict (exit 45)."""
    import numpy as np
    import torch

    from .consistency import replicated_leaves

    delta = float(np.float32(eps) * np.float32(replica))

    def wrapped(state, batch):
        state, out = step_fn(state, batch)
        if replica:
            leaf = next(t for _, t in replicated_leaves(state.params)
                        if t.is_floating_point())
            count = getattr(state.opt_state, "count", None)
            with torch.no_grad():
                if isinstance(count, torch.Tensor):
                    leaf.add_((count >= start).to(leaf.dtype) * delta)
                elif state.step >= start:
                    leaf.add_(delta)
        return state, out

    return wrapped


def _poison(batch: Dict) -> Dict:
    """NaN into ``mask`` (multiplied into every loss term and the count),
    or into every float leaf when there is no mask."""
    batch = dict(batch)
    if "mask" in batch:
        batch["mask"] = batch["mask"] * float("nan")
    else:
        batch = {k: (v * float("nan") if v.is_floating_point() else v)
                 for k, v in batch.items()}
    return batch


class FaultPlan:
    """A parsed fault schedule.  The Trainer calls :meth:`apply` for every
    step about to run, with that step's batch, and trains on what it
    returns."""

    def __init__(self, faults: List[_Fault]):
        self.faults = faults

    @staticmethod
    def parse(spec: str) -> Optional["FaultPlan"]:
        spec = (spec or "").strip()
        if not spec:
            return None
        return FaultPlan([_parse_one(s.strip())
                          for s in spec.split(",") if s.strip()])

    @staticmethod
    def from_config(cfg_spec: str = "") -> Optional["FaultPlan"]:
        """The config spec, else ``NNPT_FAULTS`` (what a supervised child
        inherits)."""
        return FaultPlan.parse(cfg_spec or os.environ.get(ENV_VAR, ""))

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` naming the first kind whose path
        the port lacks."""
        for f in self.faults:
            if f.kind in UNPORTED_KINDS:
                raise NotImplementedError(
                    f"fault kind {f.kind!r} needs "
                    f"{UNPORTED_KINDS[f.kind]}, not ported to the "
                    "PyTorch/CUDA package yet")

    def det_desync(self) -> Optional[_Fault]:
        """The deterministic in-step desync, if any (the Trainer wraps its
        step with it; :meth:`apply_state` never fires it)."""
        for f in self.faults:
            if f.kind == "desync" and f.det:
                return f
        return None

    def apply_state(self, step: int, state, replica: int = 0,
                    n_replicas: int = 1, sharded_opt: bool = False,
                    what: str = "train state"):
        """Fire the due ``bitflip``/``desync`` faults on ``state`` in place
        and return it.  ``replica``/``n_replicas``: this rank's data-rank
        index and the data-rank count (the candidates are the replicated
        float leaves: none with one replica, and no optimizer leaf under
        ``sharded_opt``).  Every rank calls it at the same step; only the
        rank whose index is ``shard`` (mod ``n_replicas``) is corrupted."""
        for f in self.faults:
            if (f.kind not in STATE_KINDS or f.det
                    or (f.proc is not None and _process_index() != f.proc)
                    or not f.should_fire(step)):
                continue
            target = (state.params if f.kind == "bitflip"
                      else None if sharded_opt else state.opt_state)
            cands = (list(_replicated_float_leaves(target))
                     if n_replicas >= 2 else [])
            if not cands:
                _say(f"{f.kind} at step {step}: no replicated float leaves "
                     f"in {what} to corrupt")
                continue
            f.mark_fired()
            if f.param:
                named = [c for c in cands if f.param in c[0]]
                if not named:
                    raise ValueError(
                        f"{f.kind} param={f.param!r} matches no replicated "
                        f"float leaf (candidates: {[n for n, _ in cands]})")
                name, leaf = named[0]
            else:
                name, leaf = cands[f.start % len(cands)]
            shard = f.shard % n_replicas
            if shard != replica:
                continue
            if f.kind == "bitflip":
                flip_bit_in_shard(leaf, shard, f.bit, replica=replica,
                                  n_replicas=n_replicas)
                detail = f"bit {f.bit}"
            else:
                perturb_shard(leaf, shard, f.eps, replica=replica,
                              n_replicas=n_replicas)
                detail = f"eps {f.eps}"
            _say(f"injected {f.kind} at step {step}: {detail} in shard "
                 f"{shard} of {name}")
        return state

    def apply(self, step: int, batch: Dict,
              ckpt_dir: Optional[str] = None) -> Dict:
        for f in self.faults:
            if f.kind in UNPORTED_KINDS or f.kind in STATE_KINDS:
                continue
            if f.proc is not None and _process_index() != f.proc:
                continue
            if not f.should_fire(step):
                continue
            f.mark_fired()
            if f.kind == "peer_kill":
                _say(f"injected peer_kill at step {step}: SIGKILL "
                     "(dead-host stand-in)")
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "peer_hang":
                _say(f"injected peer_hang at step {step}: wedging this "
                     "process (frozen-host stand-in)")
                while True:
                    time.sleep(3600)
            elif f.kind == "device_loss":
                _say(f"injected device_loss at step {step}: reporting a "
                     "lost local device, exiting 43")
                _emergency_dump(f"device_loss@{step} (injected)")
                os._exit(43)
            elif f.kind in ("torn_ckpt", "ckpt_ioerr"):
                from . import checkpoint as ckpt_lib

                _say(f"armed {f.kind} for the next checkpoint write "
                     f"(step {step})")
                ckpt_lib.inject_io_fault(f.kind)
            elif f.kind == "corrupt_ckpt":
                _corrupt_newest(ckpt_dir, step)
            elif f.kind == "crash":
                _say(f"injected crash at step {step}")
                sys.stdout.flush()
                # a real segfault could not, but the stand-in dies WITH a
                # postmortem for the supervisor's relaunch log
                _emergency_dump(f"crash@{step} (injected)")
                os._exit(1)
            elif f.kind == "sigterm":
                _say(f"injected SIGTERM at step {step}")
                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind == "preempt":
                from ..train import resilience as res_lib

                _say(f"injected preemption notice at step {step} (grace "
                     f"{f.grace:.1f}s)")
                res_lib.write_preempt_notice(grace_s=f.grace)
                os.kill(os.getpid(), res_lib.PREEMPT_SIGNAL)
            elif f.kind == "slow":
                time.sleep(f.ms / 1e3)
            else:       # nan
                _say(f"injected NaN batch at step {step}")
                batch = _poison(batch)
        return batch
