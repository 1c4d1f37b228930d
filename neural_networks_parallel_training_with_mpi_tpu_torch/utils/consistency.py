"""Silent-data-corruption defense: the port of the JAX package's
``utils/consistency.py``.

Every rank holds an identical replica of the replicated training state
only because every rank applies the same averaged gradient; nothing in the
reference notices when they drift.  Here the invariant is checked, cheaply,
and survived when it breaks.  Three tiers:

1. **Fingerprint** (:class:`Fingerprinter`, fast path): one launch of the
   ``ops.fingerprint`` kernel folds every replicated leaf of a rank's state
   into a uint32 digest (a bit-exact positional fold: any flipped bit, any
   NaN, changes it) and an advisory f32 magnitude.  ``compute`` is
   asynchronous (the two values are copied to a pinned host buffer behind
   a CUDA event); ``fetch`` reads them at the trainer's lag-2 discipline,
   so routine checking never drains the card.  The ranks gather their
   digests into a ``(nodes, LOCAL_WORLD_SIZE)`` matrix
   (``parallel.distributed``) and :func:`digest_report` gives the verdict.
2. **Localization** (slow path, on a mismatch only): :func:`localize`, a
   pure function from the per-leaf digest matrix of N replicas, elects the
   MAJORITY group of each leaf (a corrupt replica 0 is no oracle) and
   fetches only the diverged leaves for their magnitudes.
   :func:`divergence_report` runs it on replicas held in this process (a
   list of trees) or on the ranks of the world; :func:`replica_divergence`,
   :func:`check_replicas` and :func:`assert_replicated` are the simple
   replica-0-referenced debug API.
3. **Heal** (:func:`heal_replication`): each diverged leaf is copied, in
   place, from its majority replica (so a CUDA graph captured on the state
   stays valid).  The trainer heals over ranks by a broadcast in each
   node's group; a divergence BETWEEN nodes rolls back instead.

Replicated leaves are the tensors of the state in the JAX package's
flatten order (``.params['w']``, ...; dict keys sorted), skipping the
host step counter and, under the sharded updates (zero1, ``sharded``),
the optimizer state, whose slices differ by rank by design.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fingerprint as fingerprint_op
from ..ops.fingerprint import fingerprint

Tree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _leaf_paths(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``jax.tree_util.keystr``-style name, leaf) in JAX's flatten order:
    NamedTuple fields ``.f``, dict keys sorted ``['k']``, sequences
    ``[i]``; None holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            key = f"'{k}'" if isinstance(k, str) else str(k)
            yield from _leaf_paths(tree[k], f"{prefix}[{key}]")
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from _leaf_paths(v, f"{prefix}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def replicated_leaves(tree: Tree, sharded_opt: bool = False
                      ) -> List[Tuple[str, torch.Tensor]]:
    """The tensor leaves every replica holds identically, named; the
    optimizer state is left out when ``sharded_opt`` (its slices are
    per-rank)."""
    out = []
    for name, leaf in _leaf_paths(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        if sharded_opt and name.startswith(".opt_state"):
            continue
        out.append((name, leaf))
    return out


# ---------------------------------------------------------------------------
# Tier 2: localization
# ---------------------------------------------------------------------------

def _magnitudes(datas: Sequence[torch.Tensor], ref: int,
                bad: Sequence[int]) -> Tuple[float, int]:
    """(max |bad - ref|, differing elements) over the bad replicas, in
    float64; positions where both sides hold NaN are in lockstep, a NaN on
    one side is an infinite difference."""
    r = datas[ref]
    max_diff, n_bad = 0.0, 0
    for i in bad:
        a = datas[i].to(r.device)
        if a.dtype != r.dtype or a.shape != r.shape:
            max_diff = float("inf")
            n_bad = int(max(a.numel(), r.numel()))
            continue
        if r.is_floating_point():
            a64, r64 = a.double(), r.double()
            both_nan = torch.isnan(a64) & torch.isnan(r64)
            diff = torch.where(both_nan, torch.zeros_like(a64),
                               (a64 - r64).abs())
            m = float(diff.max()) if diff.numel() else 0.0
            max_diff = max(max_diff, float("inf") if np.isnan(m) else m)
            n_bad += int((~((a64 == r64) | both_nan)).sum())
        else:
            n_bad += int((a != r).sum())
            max_diff = float("inf")
    return max_diff, n_bad


def localize(names: Sequence[str], digests: np.ndarray,
             fetch: Callable[[int], Sequence[torch.Tensor]],
             devices: Sequence[str]) -> Dict[str, Dict[str, Any]]:
    """The localization core, pure: ``digests`` is the ``(replicas,
    leaves)`` matrix of per-leaf digests, ``fetch(j)`` the replicas' copies
    of leaf ``j`` (called for diverged leaves only), ``devices`` a name per
    replica.  For each leaf whose digests disagree, the majority group is
    the reference (ties break toward the group holding the lowest replica
    index); returns ``{leaf: {shards, devices, reference_shard,
    max_abs_diff, n_bad_elements}}``, empty when every leaf agrees."""
    mat = np.asarray(digests, dtype=np.uint32)
    out: Dict[str, Dict[str, Any]] = {}
    for j, name in enumerate(names):
        groups: Dict[int, List[int]] = {}
        for i, v in enumerate(mat[:, j].tolist()):
            groups.setdefault(int(v), []).append(i)
        if len(groups) == 1:
            continue
        majority = max(groups.values(), key=lambda g: (len(g), -min(g)))
        ref = majority[0]
        bad = sorted(i for i in range(mat.shape[0]) if i not in majority)
        max_diff, n_bad = _magnitudes(fetch(j), ref, bad)
        out[name] = {"shards": bad, "devices": [devices[i] for i in bad],
                     "reference_shard": ref, "max_abs_diff": max_diff,
                     "n_bad_elements": n_bad}
    return out


def leaf_digest_array(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    """Per-leaf digests of ``tensors`` as a host uint32 array (one kernel
    launch on the card, then a sync: slow path only)."""
    if not tensors:
        return np.zeros(0, np.uint32)
    return fingerprint(tensors)[0][:-1].cpu().numpy().astype(np.uint32)


def leaf_digests(tree: Tree, sharded_opt: bool = False
                 ) -> Dict[str, np.ndarray]:
    """``{leaf: (1,) uint32 digest}`` of this rank's replicated leaves: the
    small host pytree the cross-node sweep
    (``parallel.distributed.cross_host_report``) gathers to name WHICH leaf
    and node diverged."""
    named = replicated_leaves(tree, sharded_opt)
    d = leaf_digest_array([t for _, t in named])
    return {n: d[i:i + 1].copy() for i, (n, _) in enumerate(named)}


def _replica_sets(replicas: Any, sharded_opt: bool = False
                  ) -> Tuple[List[str], List[List[torch.Tensor]], List[str]]:
    """(names, per-replica leaf lists, replica names).  ``replicas`` is a
    list of replica trees held in this process, or one tree, whose
    replicas are then the ranks of the world: each replicated leaf is
    all-gathered (debug path: O(state) traffic).  ``sharded_opt``: the
    optimizer state is per-rank slices, not compared."""
    if isinstance(replicas, list):
        named = [replicated_leaves(r, sharded_opt) for r in replicas]
        names = [n for n, _ in named[0]] if named else []
        return (names, [[t for _, t in nl] for nl in named],
                [f"replica{i}" for i in range(len(replicas))])
    named = replicated_leaves(replicas, sharded_opt)
    names = [n for n, _ in named]
    size = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)
    per: List[List[torch.Tensor]] = [[] for _ in range(size)]
    for _, t in named:
        if size == 1:
            per[0].append(t)
            continue
        got = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(got, t.detach().contiguous())
        for r in range(size):
            per[r].append(got[r])
    return names, per, [f"rank{r}" for r in range(size)]


def divergence_report(replicas: Any, sharded_opt: bool = False
                      ) -> Dict[str, Dict[str, Any]]:
    """Localize divergence among ``replicas`` (see :func:`_replica_sets`)
    by a byte-exact vote of per-leaf digests: :func:`localize`."""
    names, per, devices = _replica_sets(replicas, sharded_opt)
    if len(per) < 2:
        return {}
    mat = np.stack([leaf_digest_array(leaves) for leaves in per])
    return localize(names, mat, lambda j: [p[j] for p in per], devices)


def replica_divergence(replicas: Any, sharded_opt: bool = False
                       ) -> Dict[str, float]:
    """Max |replica - replica 0| per replicated leaf (all zeros is the
    healthy state); a NaN on one side is ``inf``, both-NaN positions are
    in lockstep, an integer leaf that differs is ``inf``."""
    names, per, _ = _replica_sets(replicas, sharded_opt)
    out: Dict[str, float] = {}
    if len(per) < 2:
        return out
    for j, name in enumerate(names):
        datas = [p[j] for p in per]
        out[name] = _magnitudes(datas, 0, range(1, len(datas)))[0] \
            if any(not torch.equal(d.to(datas[0].device), datas[0])
                   for d in datas[1:]) else 0.0
    return out


def check_replicas(replicas: Any, atol: float = 0.0,
                   sharded_opt: bool = False) -> Dict[str, float]:
    """Only the diverged leaves (> atol).  Empty dict == healthy."""
    return {k: v for k, v in replica_divergence(replicas,
                                                sharded_opt).items()
            if v > atol}


def assert_replicated(replicas: Any, atol: float = 0.0,
                      what: str = "state", sharded_opt: bool = False
                      ) -> None:
    """Raise if any replicated leaf differs across the replicas."""
    bad = check_replicas(replicas, atol, sharded_opt)
    if bad:
        worst = sorted(bad.items(), key=lambda kv: -kv[1])[:5]
        raise AssertionError(
            f"replica divergence in {what}: {len(bad)} replicated leaves "
            f"differ across replicas (worst: {worst}); an update that is "
            "not the same on every rank, or flaky hardware")


# ---------------------------------------------------------------------------
# Tier 3: heal
# ---------------------------------------------------------------------------

@torch.no_grad()
def heal_replication(replicas: List[Tree],
                     report: Optional[Dict[str, Dict[str, Any]]] = None
                     ) -> Tuple[List[Tree], Dict[str, Dict[str, Any]]]:
    """Copy every diverged leaf of the replicas held in this process from
    its majority replica, in place (healthy leaves are untouched).
    Returns ``(replicas, report)``."""
    if report is None:
        report = divergence_report(replicas)
    if not report:
        return replicas, report
    names, per, _ = _replica_sets(replicas)
    index = {n: j for j, n in enumerate(names)}
    for name, r in report.items():
        j = index[name]
        src = per[r["reference_shard"]][j]
        for i in r["shards"]:
            per[i][j].copy_(src)
    return replicas, report


# ---------------------------------------------------------------------------
# Tier 1: the fingerprint
# ---------------------------------------------------------------------------

class Fingerprinter:
    """The replicated leaves of a state folded into one ``(digest, fold)``
    pair per rank by one ``ops.fingerprint`` launch.

    Built once per run from the state's structure (stable across steps,
    rollbacks and heals, which all write in place), so the kernel's
    launch table is built once too, and again only for a tree whose
    leaves live elsewhere (a replay's copy).  ``compute`` is
    asynchronous: the chained digest and the summed fold are copied into
    a pinned host buffer behind a CUDA event; ``fetch`` waits on that
    event and reads them (this rank's entries: the caller gathers)."""

    _RING = 4   # pinned buffers: two wait in the lag queue, one fills

    def __init__(self, tree: Tree, sharded_opt: bool = False):
        self.sharded_opt = sharded_opt
        self.paths = [n for n, _ in replicated_leaves(tree, sharded_opt)]
        self.n_leaves = len(self.paths)
        self._pinned: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._n = 0
        self._table: Optional[fingerprint_op.Table] = None

    def leaves(self, tree: Tree) -> List[torch.Tensor]:
        by_name = dict(replicated_leaves(tree, self.sharded_opt))
        return [by_name[p] for p in self.paths]

    def compute(self, tree: Tree) -> Optional[tuple]:
        """Launch the digest of ``tree``; no host sync."""
        if not self.n_leaves:
            return None
        leaves = self.leaves(tree)
        if leaves[0].device.type != "cuda":
            digests, folds = fingerprint(leaves)
            return digests[-1:].clone(), folds[-1:].clone(), None
        if (self._table is None
                or self._table.key != fingerprint_op.table_key(leaves)):
            self._table = fingerprint_op.launch_table(leaves)
        digests, folds = fingerprint(leaves, self._table)
        d, f = digests[-1:], folds[-1:]
        if not self._pinned:
            self._pinned = [
                (torch.empty(1, dtype=torch.int64, pin_memory=True),
                 torch.empty(1, dtype=torch.float32, pin_memory=True))
                for _ in range(self._RING)]
        hd, hf = self._pinned[self._n % self._RING]
        self._n += 1
        hd.copy_(d, non_blocking=True)
        hf.copy_(f, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return hd, hf, event

    @staticmethod
    def fetch(fp: tuple) -> Tuple[np.ndarray, np.ndarray]:
        """This rank's ``(digests, folds)``, each of shape (1,)."""
        hd, hf, event = fp
        if event is not None:
            event.synchronize()
        return (hd.numpy().astype(np.uint32).copy(),
                hf.numpy().astype(np.float32).copy())

    def leaf_digests(self, tree: Tree) -> np.ndarray:
        """Per-leaf digests of ``tree`` (host uint32, ``paths`` order)."""
        return leaf_digest_array(self.leaves(tree))


def digests_differ(digests: np.ndarray) -> bool:
    """True when the given digests are not all identical."""
    return bool(digests.size > 1 and np.any(digests != digests.flat[0]))


def digest_report(all_digests: np.ndarray) -> Dict[str, Any]:
    """Global fingerprint verdict from the gathered ``(nodes,
    LOCAL_WORLD_SIZE)`` digest matrix (the JAX package's ``(processes,
    local devices)``) — pure host math, identical on every rank that holds
    the same gathered input.

    Returns ``{}`` when healthy, else ``{"local": [nodes whose own ranks
    disagree], "cross": [nodes whose (internally consistent) digest
    differs from the majority], "majority": digest}``."""
    mat = np.asarray(all_digests, dtype=np.uint32)
    if mat.ndim == 1:
        mat = mat[None, :]
    local_bad = [p for p in range(mat.shape[0])
                 if np.any(mat[p] != mat[p, 0])]
    firsts = [int(v) for v in mat[:, 0]]
    counts: Dict[int, int] = {}
    first_seen: Dict[int, int] = {}
    for p, v in enumerate(firsts):
        counts[v] = counts.get(v, 0) + 1
        first_seen.setdefault(v, p)
    # majority over the nodes' digests; a tie convicts the HIGHER node
    # index (breaks toward the digest seen first)
    majority = max(counts, key=lambda v: (counts[v], -first_seen[v]))
    cross_bad = [p for p in range(mat.shape[0])
                 if p not in local_bad and firsts[p] != majority]
    if not local_bad and not cross_bad:
        return {}
    return {"local": local_bad, "cross": cross_bad, "majority": majority}
