"""Megatron tensor parallelism for transformer blocks, the port of the JAX
package's ``parallel/megatron.py``.

Where the JAX package runs these functions inside ``shard_map`` with a
``tensor`` mesh axis bound, the port passes an explicit *tensor group*,
as ``parallel.sequence`` passes a sequence group:

* ``ProcessTensorGroup(pg)``: one shard per rank of a
  ``torch.distributed`` process group (NCCL on cards, gloo on the CPU).
* ``LocalTensorGroup(tp)``: all ``tp`` shards in one process, on one
  card, with no collective: a sum over the group is a sum over the list
  of shards.

Every function here takes the shards this process holds as a list, one
entry per rank of ``group.ranks`` (all ``tp`` of them under a local group,
this rank's under a process group), and returns what the JAX function
returns on each rank, which is the same on every rank of the group.

* **f / g** (Megatron's conjugate pair, :func:`make_megatron_ops`): ``f``
  is identity forward and all-reduce backward (a column-parallel layer's
  input), ``g`` all-reduce forward and identity backward (a row-parallel
  layer's output), as ``autograd.Function``s over a process group.  Under
  a local group ``f`` is the identity (every shard reads the one input
  tensor, so autograd sums their input gradients) and ``g`` the sum of
  the list.
* **qkv column permutation** (:func:`qkv_tp_permutation`): the order in
  which the fused ``[q | k | v]`` columns give shard r whole heads,
  ``[q_r | k_r | v_r]`` (GQA: rank r's query heads and the K/V heads they
  read).
* :func:`tp_block_apply`: one pre-LN block with column-parallel qkv /
  ff_in / ff_gate, local attention over ``n_heads / tp`` heads and
  row-parallel attn_out / ff_out.
* Vocab parallelism: the embedding table row-sharded and the LM head
  column-sharded on the vocab dim, with the cross-entropy and argmax over
  the sharded logits, so the full (B, T, V) logits never exist.

:func:`shard_layer` cuts one layer's dense (or permuted) leaves into the
per-shard trees :func:`tp_block_apply` reads, as views (``torch.chunk``)
whose backward writes each shard's gradient into the dense leaf (a local
group's whole state); under a process group each rank holds its own
slices already (``parallel.tensor_parallel.StateLayout``).  Under
``--matmul_dtype int8|fp8`` the block's products run through
``ops.qmm.qdot_col`` / ``qdot_row``, whose scales span the split dims.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.core import ACTIVATIONS, LayerNorm
from ..ops.losses import reduce_example_hits, reduce_token_nll
from .sequence import attention_reference

Tree = Any


# ---------------------------------------------------------------------------
# tensor groups
# ---------------------------------------------------------------------------

class LocalTensorGroup:
    """All ``size`` tensor shards in this process."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"tensor group size must be >= 1, got {size}")
        self.size = size
        self.rank = 0
        self.ranks = tuple(range(size))

    def f(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def g(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return functools.reduce(torch.add, parts)

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return functools.reduce(torch.maximum, [p.detach() for p in parts])

    def min(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return functools.reduce(torch.minimum, [p.detach() for p in parts])

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(list(parts), dim=dim)


class _F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pg, x):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.pg)
        return None, grad


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pg, x):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=pg)
        return y

    @staticmethod
    def backward(ctx, grad):
        return None, grad


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` in rank order; the backward keeps this
    rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.rank, ctx.dim, ctx.n = group.rank, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(group.size)]
        dist.all_gather(parts, x.contiguous(), group=group.pg)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return None, None, grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n)


class ProcessTensorGroup:
    """One tensor shard per rank of the process group ``pg``."""

    def __init__(self, pg):
        self.pg = pg
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.ranks = (self.rank,)

    def f(self, x: torch.Tensor) -> torch.Tensor:
        return _F.apply(self.pg, x)

    def g(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        (part,) = parts
        return _G.apply(self.pg, part)

    def _reduce(self, parts, op) -> torch.Tensor:
        (part,) = parts
        out = part.detach().clone()
        dist.all_reduce(out, op=op, group=self.pg)
        return out

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return self._reduce(parts, dist.ReduceOp.MAX)

    def min(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return self._reduce(parts, dist.ReduceOp.MIN)

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        (part,) = parts
        return _Gather.apply(self, dim, part)


def make_megatron_ops(group) -> Tuple[Callable, Callable]:
    """The (f, g) conjugate pair over ``group``: ``f`` identity forward,
    all-reduce backward; ``g`` all-reduce (of the list of shards) forward,
    identity backward."""
    return group.f, group.g


# ---------------------------------------------------------------------------
# the qkv column permutation and the checks
# ---------------------------------------------------------------------------

def qkv_tp_permutation(d_model: int, n_heads: int, tp: int,
                       kv_heads: int = 0) -> np.ndarray:
    """Column order mapping the fused ``[q | k | v]`` qkv weight to a
    layout whose contiguous slice r of ``tp`` is ``[q_heads_r | k_heads_r
    | v_heads_r]``: rank r's ``n_heads/tp`` query heads and, under GQA,
    its ``kv_heads/tp`` K/V heads, onto which exactly its query heads
    group.  ``kv_heads=0`` (or ``n_heads``) is multi-head attention."""
    kv = kv_heads or n_heads
    if n_heads % tp:
        raise ValueError(f"n_heads={n_heads} not divisible by tp={tp}")
    if kv % tp:
        raise ValueError(f"n_kv_heads={kv} not divisible by tp={tp}")
    head_dim = d_model // n_heads
    per_q = (n_heads // tp) * head_dim
    per_kv = (kv // tp) * head_dim
    kvw = kv * head_dim
    cols = []
    for r in range(tp):
        for base, per in ((0, per_q), (d_model, per_kv),
                          (d_model + kvw, per_kv)):   # q, k, v
            b0 = base + r * per
            cols.extend(range(b0, b0 + per))
    return np.asarray(cols, dtype=np.int64)


def path_names(path) -> Tuple[str, ...]:
    """A key path (dict keys / list indices) as a tuple of strings."""
    return tuple(str(p) for p in path)


def map_with_path(fn, tree, path=()):
    """``fn(path names, leaf)`` over every leaf of a tree of dicts, lists
    and tuples (``jax.tree_util.tree_map_with_path``'s counterpart)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path_names(path), tree)


def leaf_paths(tree, path=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path names, leaf) of every tensor leaf, in ``utils.tree.leaves``
    order."""
    if isinstance(tree, torch.Tensor):
        return [(path_names(path), tree)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaf_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaf_paths(v, path + (i,))]
    return []


def permute_qkv(blocks: Tree, d_model: int, n_heads: int, tp: int,
                inverse: bool = False, kv_heads: int = 0) -> Tree:
    """Apply (or invert) the qkv column permutation on a blocks tree, per
    layer or stacked (``scan_layers``): the permuted dim is the last.
    Returns new tensors (a gather), bitwise the same values."""
    perm = qkv_tp_permutation(d_model, n_heads, tp, kv_heads)
    if inverse:
        perm = np.argsort(perm)

    def fix(names, leaf):
        if "qkv" in names and isinstance(leaf, torch.Tensor):
            idx = torch.as_tensor(perm, device=leaf.device)
            return leaf.detach().index_select(-1, idx).requires_grad_(
                leaf.requires_grad)
        return leaf

    return map_with_path(fix, blocks)


def validate_tp(cfg, tp: int) -> None:
    """The divisibility the head-aligned layout needs, with the JAX
    package's messages and exception type."""
    kv = cfg.kv_heads
    if kv % tp:
        raise ValueError(
            f"GQA under Megatron TP shards the K/V heads over the tensor "
            f"axis, which needs n_kv_heads % tp == 0; got n_kv_heads={kv} "
            f"with tp={tp}.  Use a kv-head count divisible by tp, the "
            f"GSPMD TP path, or n_kv_heads=n_heads")
    for name, dim in (("d_model", cfg.d_model), ("n_heads", cfg.n_heads),
                      ("d_ff", cfg.d_ff)):
        if dim % tp:
            raise ValueError(f"{name}={dim} not divisible by tensor axis "
                             f"size {tp}")


def tensor_sharded_block_paths() -> Tuple[Tuple[str, str], ...]:
    """(submodule, leaf) pairs of block params SHARDED over the tensor
    group; everything else in a block (ln1/ln2, attn_out.b, ff_out.b) is
    replicated, with the same gradient on every rank (f's backward)."""
    return (("qkv", "w"), ("qkv", "b"), ("ff_in", "w"), ("ff_in", "b"),
            ("ff_gate", "w"), ("ff_gate", "b"),   # SwiGLU: col like ff_in
            ("attn_out", "w"), ("ff_out", "w"))


def is_tensor_sharded(names: Tuple[str, ...]) -> bool:
    """Whether a block leaf (by its path names) is sharded over the tensor
    group: the single consult point for the layout."""
    return any(sub in names and names[-1] == leaf
               for sub, leaf in tensor_sharded_block_paths())


def shard_layer(layer: Dict[str, Any], tp: int,
                qkv_index: Optional[torch.Tensor] = None
                ) -> List[Dict[str, Any]]:
    """One layer's params -> the ``tp`` per-shard trees of
    :func:`tp_block_apply`: column leaves (qkv, ff_in, ff_gate) split on
    their last dim, row weights (attn_out, ff_out) on their input dim,
    replicated leaves shared.  The qkv columns are taken in the order
    ``qkv_index`` gives (``qkv_tp_permutation`` for a dense-order layer),
    or as they are (a layer already permuted).  Views and one gather: the
    backward writes each shard's gradient into the layer's own leaves."""
    shards: List[Dict[str, Any]] = [{} for _ in range(tp)]
    for sub, leaves_ in layer.items():
        for r in range(tp):
            shards[r][sub] = {}
        for name, leaf in leaves_.items():
            if not is_tensor_sharded((sub, name)):
                parts = [leaf] * tp
            else:
                if sub == "qkv" and qkv_index is not None:
                    leaf = leaf.index_select(-1, qkv_index)
                row = sub in ("attn_out", "ff_out")
                parts = leaf.chunk(tp, dim=-2 if row else -1)
            for r in range(tp):
                shards[r][sub][name] = parts[r]
    return shards


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _col(fmt: str, role: str, h: torch.Tensor, lps, name: str, group,
         cdt, qscales, qobs, batch=None) -> List[torch.Tensor]:
    """A column-parallel Linear of every shard held here: ``h`` (whole,
    after ``f``) times each shard's columns, plus its bias, in ``cdt``;
    under int8/fp8 through ``ops.qmm.qdot_col``."""
    ws = [lp[name]["w"] for lp in lps]
    if fmt == "bf16":
        ys = [h.to(cdt) @ w.to(cdt) for w in ws]
    else:
        from ..ops import qmm

        if qobs is not None and fmt == "fp8":
            qobs[role] = qmm.tensor_amax(h)
        a = None if qscales is None or fmt != "fp8" else qscales.get(role)
        ys = [y.to(cdt) for y in qmm.qdot_col(h.to(cdt), ws, fmt=fmt,
                                              group=group, scales=a,
                                              batch=batch)]
    return [y + lp[name]["b"].to(cdt) for y, lp in zip(ys, lps)]


def _row(fmt: str, role: str, xs: List[torch.Tensor], lps, name: str,
         group, cdt, qscales, qobs, batch=None) -> List[torch.Tensor]:
    """A row-parallel Linear's partial products (no bias), for ``g`` to
    sum; under int8/fp8 through ``ops.qmm.qdot_row``, whose scales span
    the whole contraction (a max over the group)."""
    ws = [lp[name]["w"] for lp in lps]
    if fmt == "bf16":
        return [x.to(cdt) @ w.to(cdt) for x, w in zip(xs, ws)]
    from ..ops import qmm

    if qobs is not None and fmt == "fp8":
        # the shards held here; the step maxes it over the ranks
        qobs[role] = functools.reduce(torch.maximum,
                                      [qmm.tensor_amax(x) for x in xs])
    a = None if qscales is None or fmt != "fp8" else qscales.get(role)
    return [y.to(cdt) for y in qmm.qdot_row([x.to(cdt) for x in xs], ws,
                                            fmt=fmt, group=group, scales=a,
                                            batch=batch)]


def tp_block_apply(cfg, layer_shards: List[Dict[str, Any]], x: torch.Tensor,
                   group, attention_fn: Optional[Callable] = None,
                   qscales=None, qobs=None,
                   mm: Optional[Callable[[str], str]] = None,
                   batch=None, ffn_fn: Optional[Callable] = None):
    """One transformer block with the tensor dimension split over
    ``group``: ``layer_shards`` are the per-shard trees of the shards this
    process holds (:func:`shard_layer`), qkv / ff_in / ff_gate holding
    their output columns, attn_out / ff_out their input rows.  Pre-LN,
    residual adds in the input's dtype, products in ``cfg.compute_dtype``,
    as the dense block.

    ``attention_fn(q, k, v)`` (each (B, T, H/tp, hd)) overrides the
    attention: the TP x SP composition point (a sequence-sharded impl,
    which rotates RoPE by global positions itself).  Default: dense causal
    attention over the whole local sequence, RoPE at positions 0..T-1.

    ``mm(role)``: the matmul format of a projection role (the model's
    ``_mm``; default the config's ``matmul_dtype``).  Under int8/fp8 the
    products run through ``ops.qmm``'s tensor-parallel seam; fp8 reads
    ``qscales`` and writes each role's observed amax into ``qobs``;
    ``batch``: the batch ranks' group of the global-view scales
    (``parallel.distributed.BatchGroup``).

    ``ffn_fn(layer_shards, h) -> (ff, aux)`` replaces the column / row
    FFN: the TP x EP composition point (``parallel.expert.moe_ffn_fn``,
    which owns its f / g placement; ``h`` is handed over whole).  The
    block then returns ``(x, aux)``."""
    f, g = make_megatron_ops(group)
    cdt = cfg.compute_dtype
    tp = group.size
    heads_local = cfg.n_heads // tp
    kv_local = cfg.kv_heads // tp
    hd = cfg.head_dim
    ln = LayerNorm(cfg.d_model, param_dtype=cfg.param_dtype)
    if mm is None:
        def mm(role):
            return cfg.matmul_dtype
    if attention_fn is None:
        if cfg.pos_encoding == "rope":
            from ..ops.rope import rope_rotate

            def attention_fn(q, k, v):
                pos = torch.arange(q.shape[1], device=q.device)
                return attention_reference(
                    rope_rotate(q, pos, cfg.rope_theta),
                    rope_rotate(k, pos, cfg.rope_theta), v, causal=True)
        else:
            def attention_fn(q, k, v):
                return attention_reference(q, k, v, causal=True)
    rep = layer_shards[0]       # the replicated leaves, shared by every shard
    q8 = (qscales, qobs, batch)

    # attention: column-parallel qkv, local heads, row-parallel out
    h = f(ln.apply(rep["ln1"], x))
    outs = []
    for qkv in _col(mm("qkv"), "qkv", h, layer_shards, "qkv", group, cdt,
                    *q8):
        b, t, _ = qkv.shape
        q_w, kv_w = heads_local * hd, kv_local * hd
        q = qkv[..., :q_w].reshape(b, t, heads_local, hd)
        k = qkv[..., q_w:q_w + kv_w].reshape(b, t, kv_local, hd)
        v = qkv[..., q_w + kv_w:].reshape(b, t, kv_local, hd)
        if kv_local != heads_local:
            groups = heads_local // kv_local
            k = torch.repeat_interleave(k, groups, dim=2)
            v = torch.repeat_interleave(v, groups, dim=2)
        outs.append(attention_fn(q, k, v).reshape(b, t, q_w))
    attn = (g(_row(mm("attn_out"), "attn_out", outs, layer_shards,
                   "attn_out", group, cdt, *q8))
            + rep["attn_out"]["b"].to(cdt))
    x = x + attn.to(x.dtype)

    if ffn_fn is not None:
        ff, aux = ffn_fn(layer_shards, ln.apply(rep["ln2"], x))
        return x + ff.to(x.dtype), aux
    # FFN: column-parallel in, row-parallel out
    h = f(ln.apply(rep["ln2"], x))
    hid = _col(mm("ff_in"), "ff_in", h, layer_shards, "ff_in", group, cdt,
               *q8)
    if cfg.activation == "swiglu":
        gates = _col(mm("ff_gate"), "ff_gate", h, layer_shards, "ff_gate",
                     group, cdt, *q8)
        hid = [F.silu(gt) * hh for gt, hh in zip(gates, hid)]
    else:
        hid = [ACTIVATIONS[cfg.activation](hh) for hh in hid]
    ff = (g(_row(mm("ff_out"), "ff_out", hid, layer_shards, "ff_out", group,
                 cdt, *q8))
          + rep["ff_out"]["b"].to(cdt))
    return x + ff.to(x.dtype)


# ---------------------------------------------------------------------------
# vocab parallelism: embedding table + LM head sharded on the vocab dim
# ---------------------------------------------------------------------------

def _offsets(group, v_local: int):
    return [r * v_local for r in group.ranks]


def vocab_parallel_embed(tables_local: List[torch.Tensor], ids: torch.Tensor,
                         group) -> torch.Tensor:
    """Embedding lookup with the (V, D) table row-sharded over ``group``
    (shard r: rows r*V/tp ..): each shard contributes the rows it owns,
    zeros elsewhere, and ``g`` sums them; its identity backward scatters
    the cotangent into the owning shard's rows."""
    v_local = tables_local[0].shape[0]
    rows = []
    for table, off in zip(tables_local, _offsets(group, v_local)):
        local = ids - off
        in_shard = (local >= 0) & (local < v_local)
        r = table[torch.clamp(local, 0, v_local - 1)]
        rows.append(torch.where(in_shard[..., None], r,
                                torch.zeros((), dtype=r.dtype,
                                            device=r.device)))
    return group.g(rows)


def vocab_parallel_logits(x: torch.Tensor, head_w_local: List[torch.Tensor],
                          group, compute_dtype: Optional[torch.dtype] = None
                          ) -> List[torch.Tensor]:
    """(..., D) @ (D, V/tp) -> the LOCAL f32 logits shards (..., V/tp),
    one per shard held here; ``f`` makes the backward sum of x's partial
    cotangents explicit."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    x = group.f(x)
    return [(x @ (w if compute_dtype is None else w.to(compute_dtype)))
            .float() for w in head_w_local]


def vocab_parallel_cross_entropy(logits_local: List[torch.Tensor],
                                 targets: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 group=None):
    """Softmax cross-entropy over vocab-sharded logits without gathering
    them: the stable max by an all-reduce MAX (no gradient: softmax is
    shift-invariant), the denominator and the target logit each one ``g``
    over the group, all in f32.  ``(loss_sum, count)`` as
    ``ops.losses.softmax_cross_entropy``, the same on every rank."""
    v_local = logits_local[0].shape[-1]
    m = group.max([lg.detach().amax(-1) for lg in logits_local])
    denom = group.g([torch.exp(lg - m[..., None]).sum(-1)
                     for lg in logits_local])
    tgts = []
    for lg, off in zip(logits_local, _offsets(group, v_local)):
        local_t = targets.long() - off
        in_shard = (local_t >= 0) & (local_t < v_local)
        idx = torch.clamp(local_t, 0, v_local - 1)
        t_local = torch.gather(lg, -1, idx[..., None])[..., 0]
        tgts.append(torch.where(in_shard, t_local,
                                torch.zeros((), dtype=t_local.dtype,
                                            device=t_local.device)))
    nll = m + torch.log(denom) - group.g(tgts)
    return reduce_token_nll(nll, mask)


def vocab_parallel_accuracy(logits_local: List[torch.Tensor],
                            targets: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            group=None):
    """Argmax over the sharded vocab: the global max by an all-reduce MAX,
    then the smallest global index attaining it by an all-reduce MIN
    (``argmax``'s first-occurrence rule).  ``(correct_sum, count)`` per
    example, as ``ops.losses.accuracy``; no gradient."""
    v_local = logits_local[0].shape[-1]
    local_max = [lg.detach().amax(-1) for lg in logits_local]
    global_max = group.max(local_max)
    big = torch.iinfo(torch.int64).max
    cands = []
    for lg, lm, off in zip(logits_local, local_max,
                           _offsets(group, v_local)):
        arg = lg.detach().argmax(-1) + off
        cands.append(torch.where(lm >= global_max, arg,
                                 torch.full_like(arg, big)))
    pred = group.min(cands)
    hit = (pred == targets.long()).float()
    return reduce_example_hits(hit, mask)
