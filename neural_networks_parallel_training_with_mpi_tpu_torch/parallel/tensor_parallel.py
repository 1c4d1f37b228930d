"""Tensor parallelism and fsdp: the partition rules, the sliced training
state and the split forward, the port of the JAX package's
``parallel/tensor_parallel.py`` and of what XLA's partitioner does with
its specs on the GSPMD path.

In the JAX package a rule maps each parameter's path to a
``PartitionSpec`` over the mesh's ``tensor`` and ``fsdp`` axes.  In the
port a rule gives a :class:`LeafSpec`: the dim of the leaf split over the
tensor group and the dim split over the fsdp group, each None when the
leaf stays whole on that axis (every dim that does not divide, as JAX's
``_divisible``).  The rules are JAX's, leaf for leaf:

* transformer (Megatron): ``qkv`` / ``ff_in`` / ``ff_gate`` weights
  column-parallel (tensor on the output dim, fsdp on the input dim),
  their biases tensor-split; ``attn_out`` / ``ff_out`` weights
  row-parallel (tensor on the input dim, fsdp on the output dim); the LM
  head's weight tensor-split on its vocab dim (fsdp on its input dim);
  any other 2-d weight fsdp on its input dim; the embedding tables fsdp
  on their vocab / position dim; LayerNorms and row biases whole;
* MLP: Megatron's alternating column / row Linears (``mlp_rules``);
* anything else: fsdp on the leading dim of every leaf of 2 dims or
  more (``generic_rules``).

:class:`StateLayout` is where each leaf's bytes live.  Under process
groups (``ProcessTensorGroup``, ``parallel.fsdp.ProcessFsdpGroup``) each
rank holds only its slice of every leaf the rules split: the params and
every optimizer slot that mirrors them (momentum, mu, nu, the master
copy).  The qkv columns of a dense-order layout are held head-aligned:
tensor rank r holds columns ``megatron.qkv_tp_permutation[r]``'s slice,
the heads it computes, and a snapshot gathers them back into the dense
order.  Under a local tensor group (``LocalTensorGroup``) every slice
stays in this process, each leaf whole; under a local fsdp group
(``parallel.fsdp.LocalFsdpGroup``, one card) the F fsdp slices of a leaf
are held stacked, side by side.  The numbers are the same.

:class:`TensorParallelModel` is the model's forward with that split: the
counterpart of the JAX GSPMD step's global-view forward (``--tp`` /
``--fsdp``) and of ``parallel/spmd.py``'s ``sp_tp`` forward (``--sp`` x
``--tp``, qkv columns stored permuted, optionally the vocab-parallel
embedding and head).  A leaf split over fsdp is all-gathered where it is
used (one block at a time; ``parallel.fsdp.gather``, whose backward
reduce-scatters its gradient).  The train and eval steps of
``parallel.data_parallel`` run it as they run the model, and reduce each
gradient over the ranks that hold the same slice
(``World.replica_pg``, after the fsdp group for a leaf fsdp keeps
whole), so each tensor rank counts a whole leaf once.  The clip, the
skip guard and the telemetry take JAX's global-view norms through
:meth:`StateLayout.combine`: each rank sums the squares of the slices it
owns (a whole leaf on tensor and fsdp rank 0 only), summed over the
tensor and fsdp groups.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.core import Activation, Linear
from ..models.mlp import MLP
from ..models.transformer import Transformer, layer_params
from ..ops import qmm
from ..ops.optim import combine_norms, leaf_norms
from ..utils.tree import leaves, tree_map, unflatten
from . import fsdp as fsdp_lib
from . import megatron
from .sequence import global_positions, sequence_sharded_attention
from .update_sharding import LeafPlan

Tree = Any


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """The dim of a leaf split over the tensor group, the one split over
    the fsdp group, the stage dim split over the pipe group and the
    expert dim split over the expert group (None: whole on that axis)."""

    tensor: Optional[int] = None
    fsdp: Optional[int] = None
    pipe: Optional[int] = None
    expert: Optional[int] = None


WHOLE = LeafSpec()
Rule = Callable[[Tuple[str, ...], Any], LeafSpec]


def _divisible(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def _fs(dim: int, fsdp: int, at: int) -> Optional[int]:
    return at if _divisible(dim, fsdp) else None


def transformer_rules(tp: int, fsdp: int = 1) -> Rule:
    """Megatron rules keyed on the transformer's param paths."""

    def rule(path: Tuple[str, ...], leaf) -> LeafSpec:
        shape = tuple(leaf.shape)
        col = "qkv" in path or "ff_in" in path or "ff_gate" in path
        row = "attn_out" in path or "ff_out" in path
        if path[-1] == "w" and len(shape) == 2:
            in_dim, out_dim = shape
            if col and _divisible(out_dim, tp):
                return LeafSpec(1, _fs(in_dim, fsdp, 0))
            if row and _divisible(in_dim, tp):
                return LeafSpec(0, _fs(out_dim, fsdp, 1))
            if path[0] == "head" and _divisible(out_dim, tp):
                return LeafSpec(1, _fs(in_dim, fsdp, 0))
            return LeafSpec(None, _fs(in_dim, fsdp, 0))
        if path[-1] == "b" and col and _divisible(shape[0], tp):
            return LeafSpec(0, None)
        if path[-1] == "table" and len(shape) == 2:
            return LeafSpec(None, _fs(shape[0], fsdp, 0))
        return WHOLE

    return rule


def mlp_rules(tp: int, fsdp: int = 1) -> Rule:
    """Alternating column / row parallelism for the MLP (a Sequential of
    [Linear, Activation]*depth + Linear, Linears at even indices): the
    1st, 3rd, ... Linear column-parallel, the 2nd, 4th, ... row-parallel;
    a dim that does not divide falls back to fsdp or whole."""

    def rule(path: Tuple[str, ...], leaf) -> LeafSpec:
        shape = tuple(leaf.shape)
        try:
            ordinal = int(path[-2]) // 2
        except (ValueError, IndexError):
            ordinal = 0
        col = ordinal % 2 == 0
        if path[-1] == "w" and len(shape) == 2:
            in_dim, out_dim = shape
            if col and _divisible(out_dim, tp):
                return LeafSpec(1, _fs(in_dim, fsdp, 0))
            if not col and _divisible(in_dim, tp):
                return LeafSpec(0, _fs(out_dim, fsdp, 1))
            return LeafSpec(None, _fs(in_dim, fsdp, 0))
        if (path[-1] == "b" and col and len(shape) == 1
                and _divisible(shape[0], tp)):
            return LeafSpec(0, None)
        return WHOLE

    return rule


def generic_rules(tp: int, fsdp: int = 1) -> Rule:
    """Models with no tensor structure: fsdp on the leading dim of every
    leaf of 2 dims or more, the rest whole."""

    def rule(path: Tuple[str, ...], leaf) -> LeafSpec:
        if leaf.dim() >= 2 and _divisible(leaf.shape[0], fsdp):
            return LeafSpec(None, 0)
        return WHOLE

    return rule


def rules_for(model, tp: int, fsdp: int = 1) -> Rule:
    if isinstance(model, Transformer):
        return transformer_rules(tp, fsdp)
    if isinstance(model, MLP):
        return mlp_rules(tp, fsdp)
    return generic_rules(tp, fsdp)


def param_specs(model, params: Tree, tp: int, fsdp: int = 1) -> Tree:
    """The :class:`LeafSpec` of every leaf of ``params`` (global shapes)."""
    rule = rules_for(model, tp, fsdp)
    return megatron.map_with_path(rule, params)


def _group_size(group) -> int:
    return 1 if group is None else group.size


class StateLayout:
    """Where the training state's bytes live under a tensor group and an
    optional fsdp group (see the module docstring).

    ``spec_tree``: the :class:`LeafSpec` of every param leaf, over the
    params' GLOBAL shapes ``shapes`` (in ``leaves`` order).  A leaf's
    tensor slice is held here when ``group`` is a process group (a local
    group keeps it whole), its fsdp slice when ``fsdp_group`` is given
    (every slice, stacked, under a local one), its pipeline stage's slice
    when ``pipe_group`` is a process group (``parallel.pipeline``; a
    local one keeps every stage), its experts when ``expert_group`` is a
    process group (``parallel.expert``; a local one keeps every expert).
    ``qkv_dense``: the params keep the dense qkv column order (the GSPMD
    layout), so a held tensor slice of a qkv leaf is its head-aligned
    columns."""

    def __init__(self, spec_tree: Tree, shapes: List[Tuple[int, ...]],
                 names: List[Tuple[str, ...]], group, fsdp_group=None,
                 qkv_dense: bool = False, head_dims=None, pipe_group=None,
                 expert_group=None):
        self.spec_tree = spec_tree
        self.specs: List[LeafSpec] = [
            s for _, s in _spec_items(spec_tree)]
        self.shapes, self.names = shapes, names
        self.group, self.fsdp_group = group, fsdp_group
        self.tp, self.fsdp = group.size, _group_size(fsdp_group)
        self.tensor_sliced = hasattr(group, "pg") and self.tp > 1
        self.pipe_group = pipe_group
        self.pp = _group_size(pipe_group)
        # the pipe process group; None: no pipe, or every stage held here
        self.pipe_pg = (pipe_group.pg if hasattr(pipe_group, "pg")
                        and self.pp > 1 else None)
        self.expert_group = expert_group
        self.ep = _group_size(expert_group)
        # the expert process group; None: no expert split, or every expert
        # held here
        self.expert_pg = (expert_group.pg if hasattr(expert_group, "pg")
                          and self.ep > 1 else None)
        self.sliced = (self.tensor_sliced or fsdp_group is not None
                       or self.pipe_pg is not None
                       or self.expert_pg is not None)
        # the fsdp process group; None: no fsdp, or every slice held here
        self.fsdp_pg = getattr(fsdp_group, "pg", None)
        self._qkv_perm = None
        if qkv_dense and self.tensor_sliced and head_dims is not None:
            self._qkv_perm = megatron.qkv_tp_permutation(
                head_dims[0], head_dims[1], self.tp, head_dims[2])
        self.stored = [self._stored(s) for s in self.specs]
        t_rank = group.rank if self.tensor_sliced else 0
        f_rank = fsdp_group.rank if self.fsdp_pg is not None else 0
        p_rank = pipe_group.rank if self.pipe_pg is not None else 0
        e_rank = expert_group.rank if self.expert_pg is not None else 0
        self.owner = [(st.tensor is not None or t_rank == 0)
                      and (st.fsdp is not None or f_rank == 0)
                      and (st.pipe is not None or p_rank == 0)
                      and (st.expert is not None or e_rank == 0)
                      for st in self.stored]

    def _stored(self, spec: LeafSpec) -> LeafSpec:
        return LeafSpec(spec.tensor if self.tensor_sliced else None,
                        spec.fsdp if self.fsdp_group is not None else None,
                        spec.pipe if self.pipe_pg is not None else None,
                        spec.expert if self.expert_pg is not None else None)

    # ---- the optimizer slots mirror the params ----
    def mirror(self, tree: Tree) -> List[int]:
        """Per tensor leaf of ``tree`` (an optimizer state), the param leaf
        it mirrors, or -1 for a 0-d leaf (a count): slot leaf ``i`` of
        dimension > 0 mirrors param leaf ``i % n_params``."""
        out, i, n = [], 0, len(self.specs)
        for x in leaves(tree):
            if x.dim():
                out.append(i % n)
                i += 1
            else:
                out.append(-1)
        if i % n:
            raise ValueError(f"{i} optimizer leaves do not mirror {n} "
                             "params")
        return out

    def _spec_of(self, j: int) -> Tuple[LeafSpec, bool]:
        if j < 0:
            return WHOLE, False
        return self.stored[j], self._is_qkv(j)

    def _is_qkv(self, j: int) -> bool:
        return (self._qkv_perm is not None and "qkv" in self.names[j]
                and self.stored[j].tensor is not None)

    # ---- slicing and gathering ----
    def _slice(self, x: torch.Tensor, spec: LeafSpec, qkv: bool
               ) -> torch.Tensor:
        if spec.tensor is not None:
            if qkv:
                x = x.index_select(-1, torch.as_tensor(self._qkv_perm,
                                                       device=x.device))
            x = x.chunk(self.tp, spec.tensor)[self.group.rank]
        if spec.fsdp is not None:
            x = self.fsdp_group.slice(x, spec.fsdp)
        if spec.pipe is not None:
            x = x.chunk(self.pp, spec.pipe)[self.pipe_group.rank]
        if spec.expert is not None:
            x = x.chunk(self.ep, spec.expert)[self.expert_group.rank]
        return x.clone()

    def conform(self, params: Tree) -> Tree:
        """``params`` with their dicts' keys in the model's order (a tree
        carried from JAX has them sorted), so its leaves line up with the
        specs."""
        return _conform(params, self.spec_tree)

    def local(self, tree: Tree, mirrors: bool = False) -> Tree:
        """This rank's slices of ``tree``, the params' global (dense)
        leaves in the model's key order, or with ``mirrors`` an optimizer
        state's."""
        if not self.sliced:
            return tree
        js = (self.mirror(tree) if mirrors
              else list(range(len(self.specs))))
        return unflatten(tree, [self._slice(x, *self._spec_of(j))
                                for x, j in zip(leaves(tree), js)])

    def gather_leaf(self, x: torch.Tensor, j: int) -> torch.Tensor:
        """One leaf whole from every rank's slice (collective over the
        expert, pipe, fsdp and tensor groups), qkv columns back in the
        dense order."""
        spec, qkv = self._spec_of(j)
        x = x.detach()
        if spec.expert is not None:
            x = fsdp_lib.all_gather_dim(x, spec.expert, self.expert_pg,
                                        self.ep)
        if spec.pipe is not None:
            x = fsdp_lib.all_gather_dim(x, spec.pipe, self.pipe_pg, self.pp)
        if spec.fsdp is not None:
            x = self.fsdp_group.whole(x, spec.fsdp)
        if spec.tensor is not None:
            x = self._dense_qkv(fsdp_lib.all_gather_dim(
                x, spec.tensor, self.group.pg, self.tp), qkv)
        return x

    def join_leaf(self, parts: List[torch.Tensor], j: int) -> torch.Tensor:
        """:meth:`gather_leaf`'s tensor gather from the tensor ranks'
        slices ``parts`` (in rank order) held in this process: the same
        join without a collective (no fsdp split)."""
        spec, qkv = self._spec_of(j)
        if spec.tensor is None:
            return parts[0]
        return self._dense_qkv(torch.cat(parts, spec.tensor), qkv)

    def _dense_qkv(self, x: torch.Tensor, qkv: bool) -> torch.Tensor:
        """A gathered qkv leaf's columns back in the dense order."""
        if not qkv:
            return x
        inv = np.argsort(self._qkv_perm)
        return x.index_select(-1, torch.as_tensor(inv, device=x.device))

    def _stacked(self, spec: LeafSpec) -> bool:
        """The leaf is held as a local fsdp group's stacked slices."""
        return spec.fsdp is not None and self.fsdp_pg is None

    def global_shape(self, x: torch.Tensor, j: int) -> List[int]:
        spec, _ = self._spec_of(j)
        shape = list(x.shape[1:] if self._stacked(spec) else x.shape)
        if spec.tensor is not None:
            shape[spec.tensor] *= self.tp
        if spec.fsdp is not None:
            shape[spec.fsdp] *= self.fsdp
        if spec.pipe is not None:
            shape[spec.pipe] *= self.pp
        if spec.expert is not None:
            shape[spec.expert] *= self.ep
        return shape

    # ---- the forward's gathers ----
    def gather_fsdp(self, params: Tree, specs: Tree) -> Tree:
        """``params`` (a subtree) with every fsdp-split leaf whole, its
        gradient reduce-scattered back (``parallel.fsdp.gather``)."""
        if self.fsdp_group is None:
            return params
        return tree_map(lambda p, s: p if s.fsdp is None else
                        self.fsdp_group.gather(p, s.fsdp),
                        params, specs)

    # ---- global-view norms ----
    def combine(self, norms: List[torch.Tensor]) -> torch.Tensor:
        """The global norm from per-leaf norms of this rank's slices (in
        param order): the owned leaves' squares summed over the tensor,
        fsdp, pipe and expert groups (no process group: every slice is
        here)."""
        if not (self.tensor_sliced or self.fsdp_pg is not None
                or self.pipe_pg is not None or self.expert_pg is not None):
            return combine_norms(norms)
        sq = torch.stack([n.float().square() for n, o
                          in zip(norms, self.owner) if o]
                         or [norms[0].float() * 0]).sum()
        return torch.sqrt(self.sum_over_model(sq))

    def global_norm(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return self.combine(leaf_norms([x.float() for x in xs]))

    def sum_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the tensor, fsdp, pipe and expert groups (in
        place)."""
        if self.tensor_sliced:
            dist.all_reduce(x, group=self.group.pg)
        if self.fsdp_pg is not None:
            dist.all_reduce(x, group=self.fsdp_pg)
        if self.pipe_pg is not None:
            dist.all_reduce(x, group=self.pipe_pg)
        if self.expert_pg is not None:
            dist.all_reduce(x, group=self.expert_pg)
        return x

    # ---- the sharded update over the data ranks ----
    def update_plans(self, n: int, min_shard_elems: int = 1024):
        """JAX's ``update_sharding.gspmd_opt_specs`` as per-leaf plans: each
        leaf's largest dim not consumed by tensor or fsdp that the data
        ranks divide, unpadded (its held size is its global size; one
        dim on under stacked slices); none, or a leaf under
        ``min_shard_elems``, keeps the replicated update."""
        plans = []
        for shape, spec, st in zip(self.shapes, self.specs, self.stored):
            size = int(np.prod(shape)) if shape else 1
            cands = [d for d in range(len(shape))
                     if d not in (spec.tensor, spec.fsdp)
                     and shape[d] % n == 0 and shape[d] >= n]
            if n <= 1 or not shape or size < min_shard_elems or not cands:
                plans.append(LeafPlan(None))
                continue
            d = max(cands, key=lambda i: shape[i])
            plans.append(LeafPlan(d + self._stacked(st), shape[d],
                                  shape[d] // n))
        return plans


def _conform(tree, like):
    if isinstance(like, dict):
        return {k: _conform(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)) and not isinstance(like, LeafSpec):
        return type(tree)(_conform(t, v) for t, v in zip(tree, like))
    return tree


def _spec_items(tree, path=()):
    if isinstance(tree, LeafSpec):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _spec_items(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _spec_items(v, path + (i,))]
    return []


def state_layout(model, params: Tree, group, fsdp_group=None,
                 qkv_order: str = "dense",
                 vocab_parallel: bool = False, pipe_group=None,
                 interleave: int = 1) -> StateLayout:
    """The :class:`StateLayout` of ``model``'s global ``params`` (the
    dense init, or under ``qkv_order="permuted"`` the ``sp_tp`` one; with
    ``pipe_group``, the stage-stacked pipeline params of
    ``parallel.pipeline``, whose qkv columns are permuted for the tensor
    group)."""
    if pipe_group is not None:
        from .pipeline import pipeline_param_specs

        spec_tree = pipeline_param_specs(params, group.size, interleave)
    elif qkv_order == "permuted":
        from .spmd import sp_tp_param_specs

        spec_tree = megatron.map_with_path(
            lambda n, d: LeafSpec(d, None),
            sp_tp_param_specs(params, vocab_parallel))
    else:
        spec_tree = param_specs(model, params, group.size,
                                _group_size(fsdp_group))
    head_dims = None
    if isinstance(model, Transformer):
        c = model.cfg
        head_dims = (c.d_model, c.n_heads, c.kv_heads)
    paths = megatron.leaf_paths(params)
    return StateLayout(spec_tree, [tuple(x.shape) for _, x in paths],
                       [n for n, _ in paths], group, fsdp_group,
                       qkv_dense=qkv_order == "dense" and pipe_group is None,
                       head_dims=head_dims, pipe_group=pipe_group)


class TensorParallelModel:
    """``model``'s forward with its tensor dim split over ``group`` and, with
    a ``layout`` over an fsdp group, its fsdp-split leaves gathered where
    they are used.

    ``qkv_order``: ``"dense"`` (the params keep the dense model's qkv
    columns; each shard takes its heads' columns by
    ``megatron.qkv_tp_permutation``, or holds them so under a process
    group) or ``"permuted"`` (the params hold the permuted order,
    ``sp_tp``'s).  ``seq_group``: the sequence group of a
    sequence-sharded attention.  ``vocab_parallel``: the embedding table
    row-split and the head column-split, the loss the vocab-parallel
    cross-entropy (``fused_loss_sum``), never the full logits; otherwise
    :meth:`apply` returns the full f32 logits, gathered when the head is
    split.  ``layout``: the :class:`StateLayout` of the params this model
    is given; by default, on the first call, every leaf whole (a local
    group's).  ``batch_group``: the ranks holding the batch's other rows
    (``parallel.distributed.BatchGroup``), over which the quantized
    products' row-spanning scales are taken (JAX's global view).  An MoE
    model's blocks run ``parallel.expert.moe_ffn_fn`` in place of the
    Megatron FFN: its experts split over ``expert_group`` and their hidden
    dim over ``group`` (JAX's EP x TP), and :meth:`apply` with
    ``return_aux`` returns the aux beside the logits."""

    def __init__(self, model, group, qkv_order: str = "dense",
                 seq_group=None, vocab_parallel: bool = False,
                 layout: Optional[StateLayout] = None, batch_group=None,
                 expert_group=None):
        if qkv_order not in ("dense", "permuted"):
            raise ValueError(f"unknown qkv_order {qkv_order!r}")
        if layout is None and hasattr(group, "pg") and group.size > 1:
            raise ValueError("a process tensor group holds sliced params: "
                             "pass their StateLayout")
        self.model, self.group, self.seq_group = model, group, seq_group
        self.qkv_order, self.vocab_parallel = qkv_order, vocab_parallel
        self.layout, self.batch_group = layout, batch_group
        self.tp = group.size
        self.transformer = isinstance(model, Transformer)
        self._ffn_fn = None
        if self.transformer:
            megatron.validate_tp(model.cfg, self.tp)
            if model.cfg.moe_experts > 0:
                from .expert import moe_ffn_fn

                self._ffn_fn = moe_ffn_fn(
                    model.cfg, expert_group, group,
                    len(seq_group.ranks) if seq_group is not None else 1)
        self._qkv_index = {}

    @property
    def cfg(self):
        return getattr(self.model, "cfg", None)

    def _layout(self, params: Tree) -> StateLayout:
        if self.layout is None:
            self.layout = state_layout(
                self.model, params, self.group, qkv_order=self.qkv_order,
                vocab_parallel=self.vocab_parallel)
        return self.layout

    def _specs(self, params: Tree) -> Tree:
        return self._layout(params).spec_tree

    def _full(self, params: Tree, key) -> Tree:
        """``params[key]`` with its fsdp-split leaves gathered."""
        lay = self._layout(params)
        return lay.gather_fsdp(params[key], lay.spec_tree[key])

    # ---- the transformer ----
    def _head_split(self, params: Tree) -> bool:
        if self.vocab_parallel:
            return True
        if self.qkv_order == "permuted":    # sp_tp: the head stays whole
            return False
        return self._specs(params)["head"]["w"].tensor == 1

    def _qkv(self, device) -> Optional[torch.Tensor]:
        if self.qkv_order == "permuted" or self.layout.tensor_sliced:
            return None     # held head-aligned already
        idx = self._qkv_index.get(device)
        if idx is None:
            c = self.model.cfg
            idx = torch.as_tensor(megatron.qkv_tp_permutation(
                c.d_model, c.n_heads, self.tp, c.kv_heads), device=device)
            self._qkv_index[device] = idx
        return idx

    def _chunks(self, leaf: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """The tensor shards of ``leaf`` this process computes: its own
        slice as held under a process group, else the ``tp`` chunks of
        the whole leaf."""
        if self.layout.tensor_sliced:
            return [leaf]
        parts = leaf.chunk(self.tp, dim=dim)
        return [parts[r] for r in self.group.ranks]

    def _mm(self, role: str) -> str:
        return self.model._mm(role)

    def backbone(self, params: Tree, ids: torch.Tensor, qscales=None,
                 qobs: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """:meth:`backbone_aux`'s hidden states."""
        return self.backbone_aux(params, ids, qscales, qobs)[0]

    def backbone_aux(self, params: Tree, ids: torch.Tensor, qscales=None,
                     qobs: Optional[Dict[str, torch.Tensor]] = None):
        """Embedding and the Megatron blocks -> ((B, T, d_model), the MoE
        aux summed over the layers or None); fp8 as the dense model's
        ``backbone`` (``qscales`` read, the block roles' observations
        maxed into ``qobs``)."""
        m, c, group = self.model, self.model.cfg, self.group
        lay = self._layout(params)
        positions = global_positions(c.attention, self.seq_group,
                                     ids.shape[1], ids.device)
        top = {k: self._full(params, k) for k in ("embed", "pos")
               if k in params}
        if self.vocab_parallel:
            x = m.add_pos(top, megatron.vocab_parallel_embed(
                self._chunks(top["embed"]["table"], 0), ids, group),
                positions)
        else:
            x = m.embed(top, ids, positions)
        rope = c.rope_theta if c.pos_encoding == "rope" else None
        collect = qobs is not None and c.matmul_dtype == "fp8"

        def attend(q, k, v):
            return sequence_sharded_attention(
                c.attention, q, k, v, group=self.seq_group, causal=True,
                block_q=c.flash_block_q, block_k=c.flash_block_k,
                rope_theta=rope)

        def block_fn(layer, specs, h):
            obs = {} if collect else None
            layer = lay.gather_fsdp(layer, specs)
            shards = megatron.shard_layer(
                layer, 1 if lay.tensor_sliced else self.tp,
                self._qkv(ids.device))
            if not lay.tensor_sliced:
                shards = [shards[r] for r in group.ranks]
            out = megatron.tp_block_apply(
                c, shards, h, group, attention_fn=attend, qscales=qscales,
                qobs=obs, mm=self._mm, batch=self.batch_group,
                ffn_fn=self._ffn_fn)
            if self._ffn_fn is None:
                return out, obs, None
            return out[0], obs, out[1]

        if m._remat is not None:
            block_fn = m._remat(block_fn)
        if collect:
            for r in m.quant_roles():
                if r != "head":
                    qobs[r] = torch.zeros((), dtype=torch.float32,
                                          device=x.device)
        spec_layers = lay.spec_tree["blocks"]
        aux_total = None
        for i, layer in enumerate(layer_params(params)):
            specs = (spec_layers[i] if isinstance(spec_layers, list)
                     else spec_layers)
            x, obs, aux = block_fn(layer, specs, x)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
            if collect:
                for r in qobs:
                    if r in obs:
                        qobs[r] = torch.maximum(qobs[r], obs[r])
        return x, aux_total

    def _logits_local(self, params: Tree, x: torch.Tensor, qscales=None,
                      qobs=None, split: bool = True) -> List[torch.Tensor]:
        """The vocab-split head's f32 logits shards held here (``split``
        False: the whole head's logits, one shard, quantized)."""
        h = self.model.final_norm(params, x)
        w = self._full(params, "head")["w"]
        group = self.group if split else megatron.LocalTensorGroup(1)
        ws = self._chunks(w, 1) if split else [w]
        fmt = self._mm("head")
        if fmt == "bf16":
            return megatron.vocab_parallel_logits(
                h, ws, group, compute_dtype=self.model.cfg.compute_dtype)
        cdt = self.model.cfg.compute_dtype
        if qobs is not None and fmt == "fp8":
            qobs["head"] = qmm.tensor_amax(h)
        a = None if qscales is None or fmt != "fp8" else qscales.get("head")
        return [y.to(cdt).float() for y in qmm.qdot_col(
            group.f(h.to(cdt)), ws, fmt=fmt, group=group, scales=a,
            batch=self.batch_group)]

    def _transformer_logits(self, params: Tree, ids: torch.Tensor,
                            qscales=None, qobs=None):
        """(f32 logits, the MoE aux or None)."""
        x, aux = self.backbone_aux(params, ids, qscales=qscales, qobs=qobs)
        if self._head_split(params):
            return self.group.gather(self._logits_local(params, x, qscales,
                                                        qobs), dim=-1), aux
        if self._mm("head") != "bf16":
            (logits,) = self._logits_local(params, x, qscales, qobs,
                                           split=False)
            return logits, aux
        head = {k: self._full(params, k) for k in ("ln_f", "head")}
        return self.model.head_logits(head, x), aux

    # ---- the MLP ----
    def _mlp_modes(self, params: Tree) -> List[Optional[str]]:
        """Per layer of the Sequential: "col" / "row" when its product is
        split, else None.  A row-parallel Linear whose input arrives whole
        (the Linear before it did not split) runs whole."""
        specs = self._specs(params)
        modes, split_in = [], False
        for layer, sp in zip(self.model.net.layers, specs):
            mode = None
            if isinstance(layer, Linear):
                dim = sp["w"].tensor
                mode = {1: "col", 0: "row" if split_in else None}.get(dim)
                split_in = mode == "col"
            modes.append(mode)
        return modes

    def _mlp_apply(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        group, lay = self.group, self._layout(params)
        parts = None            # the split activation's shards held here
        for layer, p, sp, mode in zip(self.model.net.layers, params,
                                      lay.spec_tree, self._mlp_modes(params)):
            if isinstance(layer, Activation):
                if parts is not None:
                    parts = [layer.apply(p, t) for t in parts]
                else:
                    x = layer.apply(p, x)
                continue
            p = lay.gather_fsdp(p, sp)
            cdt = layer.compute_dtype or x.dtype
            if mode == "col":
                xin = group.f(x).to(cdt)
                parts = [xin @ w.to(cdt) + b.to(cdt) for w, b in zip(
                    self._chunks(p["w"], 1), self._chunks(p["b"], 0))]
            elif mode == "row":
                x = group.g([t.to(cdt) @ w.to(cdt) for t, w in zip(
                    parts, self._chunks(p["w"], 0))]) + p["b"].to(cdt)
                parts = None
            else:
                if parts is not None:
                    x, parts = group.gather(parts, dim=-1), None
                x = layer.apply(p, x)
        return x if parts is None else group.gather(parts, dim=-1)

    # ---- the entry points the train and eval steps call ----
    def apply(self, params: Tree, x: torch.Tensor, qscales=None,
              return_qobs: bool = False, return_aux: bool = False):
        """The model's output, whole, on every rank of the group; with
        ``return_qobs`` (the fp8 step's), (output, {role: observed
        amax}); with ``return_aux`` (an MoE model's), (output, the aux per
        routing group)."""
        if self.transformer:
            qobs = {} if return_qobs else None
            out, aux = self._transformer_logits(params, x, qscales, qobs)
            if return_aux:
                return out, aux
            return (out, qobs) if return_qobs else out
        if isinstance(self.model, MLP):
            return self._mlp_apply(params, x)
        lay = self._layout(params)
        return self.model.apply(lay.gather_fsdp(params, lay.spec_tree), x)

    def fused_loss_sum(self, loss_name: str):
        """Under ``vocab_parallel``: (params, batch) -> (loss_sum, count)
        by the vocab-parallel cross-entropy; else None."""
        if not self.vocab_parallel:
            return None

        def loss_fn(params, batch):
            logits = self._logits_local(params,
                                        self.backbone(params, batch["x"]))
            return megatron.vocab_parallel_cross_entropy(
                logits, batch["y"], batch.get("mask"), self.group)

        return loss_fn

    def eval_sums(self, params: Tree, batch,
                  with_accuracy: bool) -> Optional[List[torch.Tensor]]:
        """Under ``vocab_parallel``, [loss_sum, count(, hits, examples)]
        of one batch by the vocab-parallel loss and accuracy; else None
        (the eval step's own, on :meth:`apply`'s logits)."""
        if not self.vocab_parallel:
            return None
        logits = self._logits_local(params, self.backbone(params,
                                                          batch["x"]))
        vals = list(megatron.vocab_parallel_cross_entropy(
            logits, batch["y"], batch.get("mask"), self.group))
        if with_accuracy:
            vals += list(megatron.vocab_parallel_accuracy(
                logits, batch["y"], batch.get("mask"), self.group))
        return vals
