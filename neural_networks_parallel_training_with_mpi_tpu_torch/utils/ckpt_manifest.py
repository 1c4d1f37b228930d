"""Checkpoint manifest: the commit/verify protocol of the port's
``utils.checkpoint``, the port's own copy of the JAX package's
stdlib-only ``utils/ckpt_manifest.py`` (same manifest format, so
``tools/ckpt_fsck.py`` audits the port's snapshots and each package
verifies the other's), less that module's audit-report helpers, which
only ``tools/`` calls.

A snapshot directory is COMMITTED iff it contains a valid ``manifest.json``
— written last, after every payload file (and the file itself) has been
``os.fsync``'d, so the manifest can never land on disk before the bytes it
vouches for.  The manifest records a sha256 + byte size per payload file
plus the layout facts restore needs before reading anything (step,
format, leaf count).  Consequences:

* a crash mid-write leaves a directory WITHOUT a manifest — an uncommitted
  snapshot, silently skipped by restore, never an error;
* bit rot / truncation flips a checksum — restore quarantines the
  generation (rename to ``corrupt-<name>``) and falls back to the
  next-newest verified one.

Stdlib-only and free of intra-package imports.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

MANIFEST = "manifest.json"
MANIFEST_VERSION = 1
CKPT_PREFIX = "ckpt-"
QUARANTINE_PREFIX = "corrupt-"
_CHUNK = 1 << 20


def snapshot_steps(directory: Path):
    """[(step, path)] ascending for ``ckpt-<int>`` dirs — the one
    prefix-parse shared by the checkpoint writer/restore, the
    supervisor's relaunch report, and fsck; tolerates foreign entries."""
    out = []
    d = Path(directory)
    if not d.is_dir():
        return out
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith(CKPT_PREFIX):
            try:
                out.append((int(p.name[len(CKPT_PREFIX):]), p))
            except ValueError:
                continue
    return sorted(out)


def file_sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def fsync_path(path: Path) -> None:
    """fsync a file OR a directory (directory fsync makes the rename/entry
    durable, not just the inode contents)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def payload_files(snap_dir: Path) -> List[Path]:
    """Every regular file under the snapshot except the manifest itself
    (recursive: the orbax layout nests its shard tree under ``orbax/``)."""
    return sorted(p for p in Path(snap_dir).rglob("*")
                  if p.is_file() and p.name != MANIFEST)


def build(snap_dir: Path, meta: Optional[dict] = None) -> dict:
    """Manifest dict for the files currently in ``snap_dir``, hashed from
    the (page-cached) read-back — which doubles as the cheapest
    end-to-end check that what landed is what the writer meant."""
    snap_dir = Path(snap_dir)
    files: Dict[str, dict] = {}
    for p in payload_files(snap_dir):
        rel = p.relative_to(snap_dir).as_posix()
        files[rel] = {"sha256": file_sha256(p), "bytes": p.stat().st_size}
    return {"version": MANIFEST_VERSION, "files": files, **(meta or {})}


def commit(snap_dir: Path, meta: Optional[dict] = None) -> dict:
    """The commit point: fsync every payload file AND every directory in
    the payload tree (a file's dirent lives in its parent — without the
    directory fsync a nested orbax shard can vanish on power loss even
    though its bytes were synced), then write + fsync the manifest, then
    fsync the snapshot dir.  Until the manifest is durably in place the
    snapshot does not exist as far as restore is concerned."""
    snap_dir = Path(snap_dir)
    man = build(snap_dir, meta)
    dirs = set()
    for rel in man["files"]:
        p = snap_dir / rel
        fsync_path(p)
        d = p.parent
        while d != snap_dir:
            dirs.add(d)
            d = d.parent
    for d in sorted(dirs, key=lambda p: len(p.parts), reverse=True):
        fsync_path(d)  # deepest first, so parents see final children
    man_path = snap_dir / MANIFEST
    man_path.write_text(json.dumps(man, sort_keys=True))
    fsync_path(man_path)
    fsync_path(snap_dir)
    return man


def read(snap_dir: Path) -> Optional[dict]:
    """The manifest dict, or None when absent/unparsable (uncommitted)."""
    try:
        man = json.loads((Path(snap_dir) / MANIFEST).read_text())
    except (OSError, ValueError):
        return None
    return man if isinstance(man, dict) else None


def verify(snap_dir: Path) -> List[str]:
    """Problems with the snapshot; an empty list means VERIFIED.  Size is
    checked before sha256 so a truncated file reports cheaply."""
    snap_dir = Path(snap_dir)
    if not (snap_dir / MANIFEST).exists():
        return ["missing manifest.json (uncommitted, torn, or pre-manifest "
                "snapshot — see ckpt_fsck --adopt for trusted legacy dirs)"]
    man = read(snap_dir)
    if man is None:
        return ["unreadable manifest.json"]
    files = man.get("files")
    if not isinstance(files, dict) or not files:
        return ["manifest lists no payload files"]
    problems = []
    for rel in sorted(files):
        info = files[rel]
        p = snap_dir / rel
        try:
            size = p.stat().st_size
            if size != info.get("bytes"):
                problems.append(f"{rel}: {size} bytes, manifest says "
                                f"{info.get('bytes')}")
                continue
            digest = file_sha256(p)
        except OSError as e:
            # a concurrent quarantine (the leader renaming the dir while a
            # non-leader is mid-verify) must read as "this generation fails
            # verification", never as a crash
            problems.append(f"{rel}: unreadable ({e})")
            continue
        if digest != info.get("sha256"):
            problems.append(f"{rel}: sha256 mismatch")
    return problems


def quarantine(snap_dir: Path) -> Path:
    """Rename a failed snapshot out of the restore namespace
    (``ckpt-8`` -> ``corrupt-ckpt-8``, ``.1``/``.2``... on collision) so
    the evidence survives for fsck/postmortem without ever being restored
    or counted again."""
    snap_dir = Path(snap_dir)
    base = snap_dir.parent / f"{QUARANTINE_PREFIX}{snap_dir.name}"
    target, n = base, 0
    while target.exists():
        n += 1
        target = base.with_name(f"{base.name}.{n}")
    snap_dir.rename(target)
    return target
