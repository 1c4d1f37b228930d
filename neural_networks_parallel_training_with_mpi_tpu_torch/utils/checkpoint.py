"""Checkpoint/resume: the port of the JAX package's ``utils/checkpoint.py``
for its npz layout.

Layout: ``<dir>/ckpt-<step>/`` per snapshot, newest-VERIFIED-wins restore,
retention of the last K snapshots.  A snapshot holds

* ``state.npz``: ``leaf_i`` in JAX's flatten order (NamedTuple fields in
  order, dict keys sorted, lists in order), so leaf 0 is ``step`` and
  leaves ``1..n_params`` are the params whatever the optimizer.  The fp8
  calibration state comes last (``qstate/amax/<role>``, roles sorted);
  every other format's ``qstate=()`` has no leaves, so its snapshots are
  leaf for leaf those written before ``TrainState`` had the field, and
  restore either way.  ``step`` and the optimizer counts are 0-d int32
  arrays.  ``__leaf_dtypes__`` records the
  true dtypes: a bf16 leaf is stored as ``|V2`` bytes marked
  ``"bfloat16"``, as numpy writes the JAX package's bf16 arrays;
* ``leaves.json``: the leaf paths (``params/blocks/0/qkv/w``, ...).  The
  JAX package writes ``treedef.pkl`` instead, a pickled ``PyTreeDef``
  whose unpickling imports JAX: the port never reads it, and a restore
  maps leaves by the template's order;
* ``meta.json`` (step, format, the saving world, the data order salt,
  consumed samples) and ``manifest.json`` (``utils.ckpt_manifest``),
  written last, after fsync of the payload: a directory without a valid
  manifest is an uncommitted snapshot, never a crash.

So the JAX package restores the port's snapshots (given its
``treedef.pkl``) and the port restores the JAX package's.

``restore()`` verifies the manifest before reading anything; a corrupt or
torn generation is quarantined (renamed ``corrupt-ckpt-<step>``) and the
next-newest verified snapshot is restored instead.  Pruning never deletes
the last verified snapshot.  A restore checks every leaf's shape and dtype
against the caller's template and raises on a mismatch.

Rank 0 writes; every rank restores.  Params are replicated (data and
sequence parallelism); under update sharding the Trainer hands ``save``
the gathered global padded opt-state arrays (the JAX package's zero1 and
``sharded`` snapshot layout) and slices what ``restore`` returns.  A
snapshot whose padding or layout differs from the template's is refused,
naming the elastic reshard, unless ``restore(..., elastic=True)``: then an
OPTIMIZER-state leaf (the template's ``opt_state`` field, by field order)
whose one differing dimension is padding for another data-rank count is
re-padded (:func:`_repad_axis`: zeros only move, a nonzero tail raises),
which also converts sharded <-> replicated layouts of one optimizer; a
param of another length still refuses.  Replicated state restores on any
world as it is.

I/O fault injection (``utils.faults``: ``torn_ckpt``, ``ckpt_ioerr``):
:func:`inject_io_fault` arms the next write to publish its payload
without a manifest and die by SIGKILL, or to raise ``OSError`` (through
the async error channel for an async save).  Not ported: the orbax
layout.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import sys
import threading
from pathlib import Path
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..train.state import TrainState
from . import ckpt_manifest
from .logging import log

_CKPT_PREFIX = ckpt_manifest.CKPT_PREFIX
_TMP_PREFIX = ".tmp-" + _CKPT_PREFIX
LEAVES = "leaves.json"
# async writer bookkeeping: one write at a time (_write_lock), joinable
# threads (wait_pending), failures drained under _err_lock and re-raised on
# the caller's thread
_write_lock = threading.Lock()
_err_lock = threading.Lock()
_pending: List[threading.Thread] = []
_async_errors: List[BaseException] = []

# (path, host array as stored, true dtype name) per leaf, in JAX order
HostLeaves = List[Tuple[str, np.ndarray, str]]
# armed I/O faults (utils.faults: torn_ckpt / ckpt_ioerr), consumed by the
# next writes in order
_io_fault: List[str] = []


def inject_io_fault(kind: str) -> None:
    """Arm a writer fault (``torn_ckpt`` | ``ckpt_ioerr``) for the next
    snapshot write."""
    if kind not in ("torn_ckpt", "ckpt_ioerr"):
        raise ValueError(f"unknown checkpoint I/O fault {kind!r}")
    _io_fault.append(kind)


def _die_torn(d: Path, tmp: Path, target: Path, step: int) -> None:
    """The injected torn write: publish the payload WITHOUT a manifest
    (what a non-atomic writer leaves when the machine dies between the
    payload and the commit marker), then die by SIGKILL.  A restore
    treats the dir as uncommitted and falls back past it."""
    if target.exists():
        shutil.rmtree(target)
    tmp.rename(target)
    ckpt_manifest.fsync_path(d)
    print(f"[faults] injected torn checkpoint write at step {step}: "
          f"published {target.name} without a manifest, dying (SIGKILL)",
          file=sys.stderr, flush=True)
    _emergency_dump(f"torn_ckpt@{step} (injected)")
    os.kill(os.getpid(), signal.SIGKILL)


def _emergency_dump(reason: str) -> None:
    """The injected deaths die WITH a postmortem for the supervisor's
    relaunch log to point at (``train.telemetry``; a no-op when off)."""
    try:
        from ..train import telemetry

        telemetry.emergency_dump(reason)
    except Exception:
        pass


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in JAX's flatten order.  Leaves are tensors,
    numpy arrays and host ints (the port's ``step`` and counts)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def _rebuild(template: Any, it: Iterator) -> Any:
    """``template`` with its leaves replaced from ``it`` (consumed in JAX
    order); dicts keep the template's key order."""
    if isinstance(template, dict):
        vals = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(v, it) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, it) for v in template)
    if template is None:
        return None
    return next(it)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, (int, np.integer)):
        return "int32"
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """One leaf as the array ``state.npz`` stores: host ints as 0-d int32,
    bf16 as ``|V2`` bytes.  The tensor is copied synchronously (a host
    tensor too), so the array owns this moment's values whatever the next
    step updates in place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.to("cpu", copy=True).numpy()
        return a.view(np.dtype("V2")) if leaf.dtype == torch.bfloat16 else a
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def host_state(state: Any) -> HostLeaves:
    """Every leaf copied to the host, in JAX order."""
    return [(path, _to_host(leaf), _dtype_name(leaf))
            for path, leaf in flatten(state)]


def _drain_errors() -> List[BaseException]:
    with _err_lock:
        err = _async_errors[:]
        _async_errors.clear()
    return err


def _snapshot_dirs(d: Path, committed: bool = False):
    """[(step, path)] ascending; with ``committed`` only dirs carrying a
    manifest count (torn or uncommitted writes are invisible to
    latest_step, read_meta and pruning)."""
    return [(s, p) for s, p in ckpt_manifest.snapshot_steps(d)
            if not committed or (p / ckpt_manifest.MANIFEST).exists()]


def _sweep_tmp(d: Path) -> None:
    """Remove stale ``.tmp-ckpt-*`` staging dirs a crash mid-write left."""
    if not d.exists():
        return
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith(_TMP_PREFIX):
            shutil.rmtree(p, ignore_errors=True)


def _prune(d: Path, keep: int, trusted: Optional[Path] = None) -> None:
    """Drop committed snapshots beyond the newest ``keep``, but only once
    some retained snapshot is known good: a run whose recent generations
    all rotted never deletes the only restorable state left.  ``trusted``
    is a generation this process just committed from checksums it
    computed itself (counted verified without re-hashing)."""
    if not keep:
        return
    committed = _snapshot_dirs(d, committed=True)
    doomed, kept = committed[:-keep], committed[-keep:]
    if not doomed:
        return
    if not any(p == trusted or not ckpt_manifest.verify(p)
               for _, p in reversed(kept)):
        log(f"checkpoint: NOT pruning {len(doomed)} old snapshot(s) — no "
            f"retained snapshot in {d} verifies; run tools/ckpt_fsck.py")
        return
    for _, old in doomed:
        shutil.rmtree(old, ignore_errors=True)


def current_world() -> dict:
    """The saving topology recorded in ``meta.json`` and the manifest: one
    process per card, so devices = processes."""
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    return {"n_devices": n, "n_processes": n, "local_devices": 1}


def _with_world(extra_meta: Optional[dict]) -> dict:
    extra = dict(extra_meta or {})
    extra["saved_world"] = {**current_world(),
                            **(extra.get("saved_world") or {})}
    return extra


def save(directory: str, state: TrainState, keep: int = 3,
         extra_meta: Optional[dict] = None) -> Path:
    """Write ``<directory>/ckpt-<step>/`` from rank 0 and prune to the
    newest ``keep``.  ``extra_meta`` is merged into ``meta.json``; the
    saving world (``saved_world``) is always recorded.  Every rank may
    call it; ranks other than 0 write nothing."""
    step = int(state.step)
    d = Path(directory)
    if _rank() == 0:
        _write_npz(d, step, host_state(state), keep, _with_world(extra_meta))
    return d / f"{_CKPT_PREFIX}{step}"


def _write_npz(d: Path, step: int, host: HostLeaves, keep: int,
               extra_meta: dict) -> None:
    """Serialized (lock-held) atomic snapshot write + pruning, on the
    caller's thread (save) or the writer thread (save_async): the payload
    goes to ``.tmp-ckpt-<step>``, the manifest's checksums come from the
    read-back, everything is fsync'd, the manifest is written last, and
    one rename publishes the snapshot."""
    with _write_lock:
        fault = _io_fault.pop(0) if _io_fault else None
        if fault == "ckpt_ioerr":
            raise OSError(f"injected ckpt_ioerr fault (step {step})")
        target = d / f"{_CKPT_PREFIX}{step}"
        tmp = d / f"{_TMP_PREFIX}{step}"
        d.mkdir(parents=True, exist_ok=True)
        _sweep_tmp(d)
        tmp.mkdir(parents=True)
        np.savez(tmp / "state.npz",
                 __leaf_dtypes__=np.array([dt for _, _, dt in host]),
                 **{f"leaf_{i}": a for i, (_, a, _) in enumerate(host)})
        (tmp / LEAVES).write_text(json.dumps([p for p, _, _ in host]))
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "format": "npz", **extra_meta}))
        if fault == "torn_ckpt":
            _die_torn(d, tmp, target, step)
        ckpt_manifest.commit(
            tmp, {"step": step, "format": "npz", "leaves": len(host),
                  "saved_world": extra_meta.get("saved_world")})
        if target.exists():
            shutil.rmtree(target)
        tmp.rename(target)
        ckpt_manifest.fsync_path(d)
        _prune(d, keep, trusted=target)


def save_async(directory: str, state: TrainState, keep: int = 3,
               extra_meta: Optional[dict] = None) -> None:
    """Copy the state to the host now (synchronously: the optimizer
    updates params and its state in place, so a copy still in flight
    would race the next step), then write the snapshot on a background
    thread while training goes on.  A writer's error is raised on the
    caller's thread by the next ``save_async`` or ``wait_pending``."""
    err = _drain_errors()
    if err:
        raise RuntimeError("previous async checkpoint write failed") \
            from err[0]
    if _rank() != 0:
        return
    step = int(state.step)
    host = host_state(state)
    extra = _with_world(extra_meta)

    def work():
        from ..train import trace as trace_lib

        try:
            # span "ckpt_write": the writer's disk time on the timeline
            with trace_lib.span("ckpt_write", step=step):
                _write_npz(Path(directory), step, host, keep, extra)
        except Exception as e:  # noqa: BLE001 — raised by wait_pending
            with _err_lock:
                _async_errors.append(e)

    t = threading.Thread(target=work, name=f"ckpt-writer-{step}")
    t.start()
    _pending.append(t)
    _pending[:] = [p for p in _pending if p.is_alive()]


def _join_pending() -> None:
    """Join in-flight writers without draining their errors, so a restore
    never races a writer's pruning of the snapshot it reads."""
    for t in list(_pending):
        t.join()
    _pending.clear()


def wait_pending() -> None:
    """Join every in-flight async write; re-raise their errors."""
    _join_pending()
    err = _drain_errors()
    if err:
        raise RuntimeError("async checkpoint write failed") from err[0]


def latest_step(directory: str) -> Optional[int]:
    """Newest COMMITTED snapshot step (uncommitted dirs don't count)."""
    snaps = _snapshot_dirs(Path(directory), committed=True)
    return snaps[-1][0] if snaps else None


def read_meta(directory: str, step: Optional[int] = None) -> Optional[dict]:
    """meta.json of the newest committed (or a given) snapshot; None when
    there is none or it has no readable metadata."""
    snaps = _snapshot_dirs(Path(directory), committed=True)
    if step is not None:
        snaps = [(s, p) for s, p in snaps if s == step]
    if not snaps:
        return None
    try:
        return json.loads((snaps[-1][1] / "meta.json").read_text())
    except (OSError, json.JSONDecodeError):
        return None


def newest_verified_step(directory: str) -> Optional[int]:
    """Step of the generation :func:`restore` will land on: the newest
    committed snapshot whose checksums all verify; None when none does."""
    for s, p in reversed(_snapshot_dirs(Path(directory), committed=True)):
        if not ckpt_manifest.verify(p):
            return s
    return None


def block_stack(directory: str, params: Any,
                step: Optional[int] = None) -> tuple:
    """The leading stack dims of a transformer snapshot's blocks, read
    from the header of its first ``params/blocks/.../qkv/w`` leaf (2-d per
    layer) in the newest verified (or a given) generation, in either
    package's snapshots: ``()`` for per-layer blocks or no blocks, ``(L,)``
    for a ``scan_layers`` stack, ``(S, per)`` or ``(v, S, per)`` for a
    pipeline's.  The leaf is found by its path in the snapshot's
    ``leaves.json``; the JAX package's snapshots have none, and there by
    its path in ``params`` (a template of the same model, in any blocks
    layout: each keeps one block's key order, so the leaf has the same
    index in all).  Nothing but the header is read."""
    import zipfile

    step = newest_verified_step(directory) if step is None else step
    snaps = [p for s, p in _snapshot_dirs(Path(directory)) if s == step]
    if not snaps:
        return ()
    saved = snaps[0] / LEAVES
    paths = (json.loads(saved.read_text()) if saved.exists()
             else [p for p, _ in flatten(TrainState(0, params, None))])
    qkv = next((i for i, p in enumerate(paths)
                if p.startswith("params/blocks/") and p.endswith("qkv/w")),
               None)
    if qkv is None:
        return ()
    with zipfile.ZipFile(snaps[0] / "state.npz") as z:
        with z.open(f"leaf_{qkv}.npy") as f:
            version = np.lib.format.read_magic(f)
            shape = (np.lib.format.read_array_header_1_0(f) if version[0] == 1
                     else np.lib.format.read_array_header_2_0(f))[0]
    return tuple(shape[:-2])


def verify(directory: str, step: Optional[int] = None) -> bool:
    """With ``step``: that generation has a valid manifest and every file
    matches it.  Without: ANY generation does (the chain restore walks)."""
    snaps = _snapshot_dirs(Path(directory))
    if step is not None:
        snaps = [(s, p) for s, p in snaps if s == step]
    return any(not ckpt_manifest.verify(p) for _, p in reversed(snaps))


def _quarantine(path: Path, problems: List[str]) -> None:
    """Rank 0 renames a failed generation out of the restore namespace;
    the other ranks see the same failure and skip it alike."""
    log(f"checkpoint: snapshot {path.name} FAILED verification "
        f"({problems[0]}{' ...' if len(problems) > 1 else ''})")
    if _rank() != 0:
        return
    try:
        q = ckpt_manifest.quarantine(path)
        log(f"checkpoint: quarantined {path.name} -> {q.name}; falling "
            "back to the next-newest verified snapshot")
    except OSError as e:
        log(f"checkpoint: could not quarantine {path.name}: {e}")


def restore(directory: str, template: TrainState,
            step: Optional[int] = None,
            elastic: bool = False) -> Optional[TrainState]:
    """Load the newest VERIFIED (or a given) snapshot into the structure of
    ``template`` (the freshly initialised state): every leaf's shape and
    dtype must match, and each tensor lands on its template leaf's device
    (with its ``requires_grad``).

    Every candidate's manifest is checked before anything is read; a
    generation that fails is quarantined and the chain falls back to the
    next-newest one, returning None only when none is left.  An explicit
    ``step=`` raises instead of substituting another generation.
    ``elastic`` arms the cross-world reshard of the sharded-update
    optimizer state (see the module docstring)."""
    return _restore_chain(directory, template, step, prefix=False,
                          elastic=elastic)


def restore_params(directory: str, params: Any,
                   step: Optional[int] = None) -> Optional[Tuple[int, Any]]:
    """``(step, params)`` from the newest verified (or a given) snapshot,
    whatever optimizer state it also holds: leaf 0 is ``step`` and leaves
    ``1..n_params`` are the params in both packages' layouts.  ``params``
    is a template built from the model config alone."""
    got = _restore_chain(directory, TrainState(0, params, None), step,
                         prefix=True)
    return None if got is None else (got.step, got.params)


def _restore_chain(directory: str, template: Any, step: Optional[int],
                   prefix: bool, elastic: bool = False) -> Optional[Any]:
    _join_pending()  # never race an in-flight writer's pruning
    d = Path(directory)
    if _rank() == 0:
        _sweep_tmp(d)
    snaps = _snapshot_dirs(d)
    if not snaps:
        return None
    if step is not None:
        match = [p for s, p in snaps if s == step]
        if not match:
            raise ValueError(f"no checkpoint for step {step} in {directory}; "
                             f"have {[s for s, _ in snaps]}")
        problems = ckpt_manifest.verify(match[0])
        if problems:
            raise ValueError(
                f"checkpoint {match[0].name} fails verification: "
                f"{'; '.join(problems)} — run tools/ckpt_fsck.py, or drop "
                "step= to fall back to the newest verified snapshot")
        return _load(match[0], template, prefix, elastic)
    # a manifest-less dir NEWER than the newest committed generation is
    # torn-writer debris (quarantined); one OLDER, or in a directory with
    # no committed generation at all, may be a pre-manifest snapshot: left
    # untouched, and if nothing else restores the restore refuses
    committed = [s for s, p in snaps
                 if (p / ckpt_manifest.MANIFEST).exists()]
    newest_committed = max(committed) if committed else None
    maybe_legacy: List[str] = []
    for s, path in reversed(snaps):
        problems = ckpt_manifest.verify(path)
        if not problems:
            if maybe_legacy:
                log(f"checkpoint: left {len(maybe_legacy)} manifest-less "
                    f"snapshot(s) untouched ({', '.join(maybe_legacy)}); "
                    "tools/ckpt_fsck.py --adopt makes them restorable")
            return _load(path, template, prefix, elastic)
        if (not (path / ckpt_manifest.MANIFEST).exists()
                and (path / "meta.json").exists()
                and (newest_committed is None or s < newest_committed)):
            maybe_legacy.append(path.name)
            continue
        _quarantine(path, problems)
    if maybe_legacy:
        raise RuntimeError(
            f"{directory} holds {len(maybe_legacy)} snapshot(s) with "
            "meta.json but no manifest and nothing newer verifies: "
            "refusing to quarantine them and silently restart from step "
            "0.  Run `tools/ckpt_fsck.py --adopt` to trust them, or "
            "remove the directory to start fresh")
    log(f"checkpoint: no verified snapshot left in {directory}")
    return None


def _from_host(a: np.ndarray, dtype_name: str, like) -> Any:
    """A stored array as its template leaf's kind: a host int, or a tensor
    on the template's device."""
    if not isinstance(like, torch.Tensor):
        return int(a)
    # ascontiguousarray makes a 0-d array 1-d: reshape back
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.reshape(a.shape).to(like.device).requires_grad_(
        like.requires_grad)


def _repad_axis(saved: np.ndarray, want_shape: tuple, leaf_idx: int
                ) -> np.ndarray:
    """Re-pad a sharded-update optimizer-state leaf whose padded dimension
    was sized for another data-rank count: zero1's flat buffer is
    ``ceil(P/N)*N`` long, the ``sharded`` layout pads one dimension of each
    leaf the same way, and a replicated snapshot is the padding-free case,
    so N -> M, sharded -> replicated and back are one move: grow or shrink
    the ONE differing dimension, where only zeros may move.  A nonzero
    tail is not padding and would drop optimizer state: raise."""
    cur = np.asarray(saved)
    diff = [d for d in range(cur.ndim) if cur.shape[d] != want_shape[d]]
    assert len(diff) == 1, (cur.shape, want_shape)  # caller-checked
    axis = diff[0]
    new_len = want_shape[axis]
    if new_len < cur.shape[axis]:
        tail = np.take(cur, range(new_len, cur.shape[axis]), axis=axis)
        if np.any(tail != 0):
            raise ValueError(
                f"cannot reshard checkpoint leaf {leaf_idx}: truncating "
                f"dim {axis} {cur.shape[axis]} -> {new_len} would drop "
                f"{int(np.count_nonzero(tail))} nonzero entries — not "
                "update-sharding padding; wrong model/optimizer config?")
        return np.ascontiguousarray(np.take(cur, range(new_len), axis=axis))
    widths = [(0, 0)] * cur.ndim
    widths[axis] = (0, new_len - cur.shape[axis])
    return np.pad(cur, widths)


def _opt_range(template: Any) -> Tuple[int, int]:
    """[start, end) of the template's ``opt_state`` leaves in flatten
    order, from its field order (the only leaves an elastic restore may
    re-pad); empty without an ``opt_state`` field."""
    n = len(flatten(template))
    if not (_is_namedtuple(template) and "opt_state" in template._fields):
        return n, n
    fields = list(template._fields)
    start = sum(len(flatten(getattr(template, f)))
                for f in fields[:fields.index("opt_state")])
    return start, start + len(flatten(template.opt_state))


def _load(path: Path, template: Any, prefix: bool,
          elastic: bool = False) -> Any:
    """Read ``state.npz`` into ``template``'s structure.  ``prefix``: the
    template covers the first leaves only (the params-only restore).  The
    leaves come back as they were saved: a seq x tensor snapshot
    (``qkv_tp`` > 1 in its meta) holds its qkv columns permuted, which the
    caller reconciles (the trainer's resume, ``--generate``).
    ``elastic``: see :func:`restore`."""
    meta = json.loads((path / "meta.json").read_text()) \
        if (path / "meta.json").exists() else {}
    saved_world = meta.get("saved_world") or {}
    n_now = current_world()["n_devices"]
    if elastic and saved_world and saved_world.get("n_devices") != n_now:
        log(f"checkpoint: elastic restore of a "
            f"{saved_world.get('n_devices')}-device snapshot onto "
            f"{n_now} device(s) ({path.name})")
    opt_start, opt_end = _opt_range(template)
    resharded: List[int] = []
    want = flatten(template)
    with np.load(path / "state.npz") as data:
        n_saved = sum(1 for k in data.files if k.startswith("leaf_"))
        recorded = ([str(s) for s in data["__leaf_dtypes__"]]
                    if "__leaf_dtypes__" in data.files else None)
        saved_paths = None
        if (path / LEAVES).exists():
            saved_paths = json.loads((path / LEAVES).read_text())
        if (n_saved < len(want) if prefix else n_saved != len(want)) or (
                saved_paths is not None
                and saved_paths[:len(want)] != [p for p, _ in want]):
            raise ValueError(
                f"checkpoint structure mismatch: {path.name} holds "
                f"{n_saved} leaves, the template {len(want)}"
                + ("" if saved_paths is None else
                   f" (first differing path: "
                   f"{_first_diff(saved_paths, [p for p, _ in want])})")
                + " — wrong model/optimizer config?")
        out = []
        for i, (p, like) in enumerate(want):
            a = data[f"leaf_{i}"]
            w_dtype = _dtype_name(like)
            dt = recorded[i] if recorded is not None else (
                w_dtype if a.dtype.kind == "V" else str(a.dtype))
            w_shape = tuple(like.shape) if isinstance(like, torch.Tensor) \
                else ()
            if tuple(a.shape) != w_shape:
                if (elastic and opt_start <= i < opt_end
                        and a.ndim == len(w_shape) and dt == w_dtype
                        and sum(a.shape[d] != w_shape[d]
                                for d in range(a.ndim)) == 1):
                    a = _repad_axis(a, w_shape, i)
                    resharded.append(i)
                else:
                    raise ValueError(
                        f"checkpoint leaf {i} ({p}) shape {tuple(a.shape)}"
                        f" != expected {w_shape} — wrong model config?"
                        + ("" if elastic else
                           " (a sharded-update snapshot from a different "
                           "world size — or a sharded<->replicated layout "
                           "change — needs the elastic reshard path: "
                           "--elastic)"))
            if dt != w_dtype:
                raise ValueError(
                    f"checkpoint leaf {i} ({p}) dtype {dt} != expected "
                    f"{w_dtype} — wrong precision/optimizer config?")
            out.append(_from_host(a, dt, like))
    if resharded:
        log(f"checkpoint: resharded {len(resharded)} sharded-update "
            f"opt-state leaf/leaves for the new data-axis size (leaf "
            f"{resharded[:4]}{'...' if len(resharded) > 4 else ''})")
    return _rebuild(template, iter(out))


def _first_diff(a: List[str], b: List[str]) -> str:
    for x, y in zip(a, b):
        if x != y:
            return f"saved {x!r}, template {y!r}"
    return "none in the common prefix"
