"""Weight snapshots for the serving fleet: the port of the JAX package's
``serve/autopilot.py`` :func:`save_weight_snapshot` /
:func:`load_weight_snapshot` pair, which a fleet worker's ``--ckpt``
reads.  The control loop of that module (``Autopilot``: autoscaling,
rollouts, the canary judge) is ROADMAP Queue A item 6b.

A snapshot is ``ckpt-<step>/weights.npz``, one array per leaf keyed as
``jax.tree_util.keystr`` keys the same tree (``"['blocks'][0]['qkv']['w']"``),
committed through ``utils.ckpt_manifest`` (payload fsynced, the manifest
with a size and sha256 per file written last).  Either package writes a
snapshot the other loads.  numpy has no bfloat16: a bf16 leaf is stored as
2-byte void (``|V2``, what numpy reads back from the JAX package's bf16
leaves) and named ``bfloat16`` in the checks.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils import ckpt_manifest

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
