"""Write-ahead log of the fleet router's request ledger: the port of the
JAX package's ``serve/wal.py``, byte for byte the same format, so a
ledger written by either package replays in the other.

With a ``wal_dir`` the router journals each commit point (accept,
assign, handoff commit, completion) before its memory moves, and a new
router on the same directory replays it (``FleetRouter._recover``).

* **Append-only, fsynced, checksummed per record.**  A record is one line
  ``<sha16> <canonical-json>\n``: ``sha16`` is the first 16 hex chars of
  the sha256 of the json body (``sort_keys``, tight separators).
  ``append`` returns after write, flush and fsync, so an acknowledged
  record survives the next SIGKILL.
* **A torn tail is truncated, never fatal.**  A crash mid-append leaves a
  partial last line (no newline, bad json or checksum, nothing valid
  after it); ``replay(repair=True)`` truncates the active file at the
  last valid record.
* **Corrupt records are quarantined.**  A mid-file record failing its
  checksum (valid records follow it) moves to
  ``quarantined-records.jsonl`` with its provenance and is counted;
  replay goes on.  A lost record costs a re-execution of its request,
  never wrong bytes or a second delivery.
* **Segments rotate through the checkpoint manifest.**  Every
  ``segment_records`` appends the active file is sealed into
  ``walseg-<k>/records.jsonl`` and committed with
  :func:`utils.ckpt_manifest.commit` (payload fsynced first, manifest
  last); a segment failing ``verify`` is quarantined
  (``corrupt-walseg-<k>``) and its intact records salvaged.

Stdlib-only.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

try:
    from ..utils import ckpt_manifest as _manifest
except ImportError:      # file-path loaded (utils/chaos.py's stdlib children)
    import importlib.util as _ilu
    import sys as _sys

    _p = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "utils", "ckpt_manifest.py")
    _spec = _ilu.spec_from_file_location("_wal_ckpt_manifest", _p)
    _manifest = _ilu.module_from_spec(_spec)
    _sys.modules["_wal_ckpt_manifest"] = _manifest
    _spec.loader.exec_module(_manifest)

SEG_PREFIX = "walseg-"
ACTIVE = "wal-active.jsonl"
QUARANTINE_FILE = "quarantined-records.jsonl"


def _body(rec: Dict[str, Any]) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def _sha16(body: str) -> str:
    return hashlib.sha256(body.encode()).hexdigest()[:16]


def encode_record(rec: Dict[str, Any]) -> str:
    body = _body(rec)
    return f"{_sha16(body)} {body}\n"


def decode_line(line: str) -> Optional[Dict[str, Any]]:
    """The record, or None when the line is torn/corrupt (wrong
    checksum, unparsable json, missing separator)."""
    if not line.endswith("\n"):
        return None                      # torn: the newline IS the seal
    try:
        sha, body = line[:-1].split(" ", 1)
    except ValueError:
        return None
    if _sha16(body) != sha:
        return None
    try:
        rec = json.loads(body)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


def _scan_lines(data: str) -> Tuple[List[Tuple[int, str]], int]:
    """[(byte_offset, line)] including a torn final fragment, plus the
    total byte length scanned."""
    out: List[Tuple[int, str]] = []
    off = 0
    while off < len(data):
        nl = data.find("\n", off)
        if nl < 0:
            out.append((off, data[off:]))
            off = len(data)
        else:
            out.append((off, data[off:nl + 1]))
            off = nl + 1
    return out, off


def _segments(root: str) -> List[Tuple[int, str]]:
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        p = os.path.join(root, name)
        if os.path.isdir(p) and name.startswith(SEG_PREFIX):
            try:
                out.append((int(name[len(SEG_PREFIX):]), p))
            except ValueError:
                continue
    return sorted(out)


def replay(root: str, *, repair: bool = False
           ) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Replay every surviving record in commit order: sealed segments
    (manifest-verified; a failed segment is quarantined and its intact
    lines salvaged from the quarantine location) then the active file
    (mid-file corrupt lines quarantined, torn tail truncated).

    ``repair=False`` is a read-only scan — safe against a LIVE wal
    (a driver may poll a live ledger's progress this way); ``repair=True``
    additionally truncates the torn tail and moves corrupt records to
    ``quarantined-records.jsonl`` (what :meth:`WriteAheadLog.open`
    does before reopening for append)."""
    records: List[Dict[str, Any]] = []
    report: Dict[str, Any] = {
        "segments": 0, "quarantined_segments": 0,
        "records": 0, "quarantined_records": 0,
        "torn_tail_bytes": 0, "torn_tail_truncated": False,
    }
    if not os.path.isdir(root):
        return records, report
    quarantined_lines: List[Dict[str, Any]] = []

    def _parse_file(path: str, origin: str, tail_is_torn: bool) -> int:
        """Parse one record file; returns the byte offset of the end of
        the last VALID prefix (for tail truncation)."""
        try:
            with open(path, "r") as f:
                data = f.read()
        except OSError:
            return 0
        lines, _ = _scan_lines(data)
        valid_end = 0
        bad: List[Tuple[int, str]] = []
        for off, line in lines:
            rec = decode_line(line)
            if rec is None:
                bad.append((off, line))
                continue
            # a bad line FOLLOWED by a valid one is corruption, not a
            # torn tail: quarantine the bad line, keep going
            for boff, bline in bad:
                quarantined_lines.append(
                    {"origin": origin, "offset": boff,
                     "line": bline.rstrip("\n")})
                report["quarantined_records"] += 1
            bad = []
            records.append(rec)
            report["records"] += 1
            valid_end = off + len(line)
        if bad:
            if tail_is_torn:
                report["torn_tail_bytes"] += sum(
                    len(line) for _, line in bad)
            else:
                for boff, bline in bad:
                    quarantined_lines.append(
                        {"origin": origin, "offset": boff,
                         "line": bline.rstrip("\n")})
                    report["quarantined_records"] += 1
        return valid_end

    for idx, seg in _segments(root):
        report["segments"] += 1
        rec_path = os.path.join(seg, "records.jsonl")
        problems = _manifest.verify(seg)
        if problems:
            report["quarantined_segments"] += 1
            if repair:
                seg = str(_manifest.quarantine(seg))
                rec_path = os.path.join(seg, "records.jsonl")
            # salvage: intact lines inside a failed segment still
            # replay; the broken ones are quarantined per record
            _parse_file(rec_path, f"{SEG_PREFIX}{idx}",
                        tail_is_torn=False)
        else:
            _parse_file(rec_path, f"{SEG_PREFIX}{idx}",
                        tail_is_torn=False)

    active = os.path.join(root, ACTIVE)
    if os.path.exists(active):
        valid_end = _parse_file(active, ACTIVE, tail_is_torn=True)
        if report["torn_tail_bytes"] and repair:
            with open(active, "r+") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())
            report["torn_tail_truncated"] = True

    if quarantined_lines and repair:
        qpath = os.path.join(root, QUARANTINE_FILE)
        with open(qpath, "a") as f:
            for row in quarantined_lines:
                f.write(json.dumps(row, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
    return records, report


class WriteAheadLog:
    """Append/rotate/replay for one wal directory.

    ``open()`` replays (with repair), remembers the report, and reopens
    the active file for append; ``append(kind, **fields)`` stamps a
    monotonically increasing ``seq``, checksums, writes, fsyncs;
    ``rotate()`` seals the active file into a manifest-committed
    segment.  ``fsync=False`` exists only so tests can model a torn
    write; production callers keep the default."""

    def __init__(self, root: str, *, segment_records: int = 4096,
                 fsync: bool = True):
        self.root = str(root)
        self.segment_records = int(segment_records)
        self.fsync = bool(fsync)
        self._f = None
        self._seq = 0
        self._n_active = 0
        self.report: Dict[str, Any] = {}
        os.makedirs(self.root, exist_ok=True)

    # -- lifecycle ----------------------------------------------------
    def open(self) -> List[Dict[str, Any]]:
        records, self.report = replay(self.root, repair=True)
        self._seq = 1 + max((int(r.get("seq", -1)) for r in records),
                            default=-1)
        active = os.path.join(self.root, ACTIVE)
        self._n_active = 0
        if os.path.exists(active):
            with open(active, "r") as f:
                self._n_active = sum(1 for _ in f)
        self._f = open(active, "a")
        return records

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()
            self._f = None

    # -- append path --------------------------------------------------
    def append(self, kind: str, **fields: Any) -> Dict[str, Any]:
        assert self._f is not None, "append before open()"
        rec = {"seq": self._seq, "kind": str(kind), **fields}
        self._f.write(encode_record(rec))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._seq += 1
        self._n_active += 1
        if self._n_active >= self.segment_records:
            self.rotate()
        return rec

    def rotate(self) -> Optional[str]:
        """Seal the active file into the next ``walseg-<k>`` and commit
        it (payload fsynced, manifest last).  No-op when empty."""
        if self._n_active == 0:
            return None
        assert self._f is not None
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        idx = 1 + max((i for i, _ in _segments(self.root)), default=-1)
        seg = os.path.join(self.root, f"{SEG_PREFIX}{idx}")
        os.makedirs(seg, exist_ok=True)
        os.replace(os.path.join(self.root, ACTIVE),
                   os.path.join(seg, "records.jsonl"))
        _manifest.commit(seg, meta={"kind": "walseg",
                                    "records": self._n_active,
                                    "seq_hi": self._seq - 1})
        _manifest.fsync_path(self.root)
        self._f = open(os.path.join(self.root, ACTIVE), "a")
        self._n_active = 0
        return seg
