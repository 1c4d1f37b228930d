"""Expert parallelism: the MoE train and eval steps over an expert group,
the port of the JAX package's ``parallel/expert.py``.

Layout (JAX's GShard arrangement):

* **Tokens** ride data x expert (x seq): each expert shard carries its
  own batch rows, so the expert axis is extra data parallelism too, and
  each shard (and each sequence shard) routes its own tokens.
* **Expert weights** (the leaves under ``.../moe/experts``) are split
  over the expert group on their leading E dim: shard j owns experts
  ``[j E/ep, (j+1) E/ep)``.  The router and every other leaf are
  replicated.  Under EP x TP the experts' hidden dim is split over the
  tensor group too (:data:`TENSOR_SHARDED_EXPERT_LEAVES`).
* Each MoE layer sends its routed slots to the shards owning their
  experts and brings the outputs home (``models.moe.MoEFFN`` with an
  expert group).

Where the JAX package binds an ``expert`` mesh axis inside ``shard_map``,
the port passes an explicit expert group:

* ``ProcessExpertGroup(pg)``: one expert shard per rank of a
  ``torch.distributed`` process group (NCCL on cards, gloo on the CPU);
  the exchange is ``parallel.collectives.all_to_all`` (an
  ``all_to_all_single`` whose backward is the reverse exchange) and each
  rank holds its experts' slices (``parallel.tensor_parallel.
  StateLayout``).
* ``LocalExpertGroup(ep)``: all ``ep`` shards in one process, one card,
  each with its own rows and routing; every expert is held here, so the
  exchange is a regrouping of the slots and one batched product per layer
  runs every expert over every shard's slots.

The steps (:func:`make_moe_train_step` for EP and seq x EP,
:func:`make_moe_tp_train_step` for EP x TP, seq x EP x TP and seq x TP
with an MoE FFN) follow JAX's: per shard the task loss sum plus
``aux_weight * aux * count`` (``aux_weight`` 0.01), microbatched shard
by shard under ``accum_steps`` (:func:`_moe_accumulate`); the gradient
rule of :func:`_moe_grad_psum` (expert-sharded leaves summed over data x
seq, every other leaf over data x expert x seq, both divided by the
global token count); the global-norm clip of :func:`_global_norm_clip`
(each leaf's square summed over the groups it is split over first), and
the optimizer's plain update.  The metrics are the global mean loss and
``aux``, the mean over every shard of its load-balance aux.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.moe import TENSOR_SPLIT_DIMS, _join_groups, _split_groups
from ..ops import losses as losses_lib
from ..ops.optim import Optimizer
from ..train.state import TrainState
from ..utils.tree import leaves, unflatten
from . import collectives
from . import data_parallel as dp
from . import megatron
from .distributed import World
from .sequence import SEQ_SHARDED_IMPLS, validate_ulysses_under_tp

Tree = Any
Batch = Dict[str, torch.Tensor]

AUX_WEIGHT = 0.01

# the expert-FFN leaves with a tensor-split dim under EP x TP (each
# expert's hidden dim f): w_in (E, d, f) and w_gate column-parallel, b_in
# and b_gate with them, w_out (E, f, d) row-parallel; b_out (E, d) adds
# after the row sum and is split over the expert group only
TENSOR_SHARDED_EXPERT_LEAVES = ("w_in", "b_in", "w_gate", "b_gate",
                                "w_out")


# ---------------------------------------------------------------------------
# expert groups
# ---------------------------------------------------------------------------

class LocalExpertGroup:
    """All ``size`` expert shards in this process, every expert held."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"expert group size must be >= 1, got {size}")
        self.size = size
        self.rank = 0
        self.ranks = tuple(range(size))

    def dispatch(self, slots: torch.Tensor) -> torch.Tensor:
        """(G, E, C, d) slots of the G routing groups held here -> (E,
        G * C, d): each expert's slots of every group."""
        return _join_groups(slots)

    def combine(self, out: torch.Tensor, groups: int) -> torch.Tensor:
        return _split_groups(out, groups)


class ProcessExpertGroup:
    """One expert shard per rank of the process group ``pg``."""

    def __init__(self, pg):
        self.pg = pg
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.ranks = (self.rank,)

    def dispatch(self, slots: torch.Tensor) -> torch.Tensor:
        """(G, E, C, d) -> (E / ep, ep * G * C, d): the slots every rank
        routed to this rank's experts (JAX's ``all_to_all(split_axis=0,
        concat_axis=1, tiled=True)``)."""
        (out,) = collectives.all_to_all([_join_groups(slots)], self, 0, 1)
        return out

    def combine(self, out: torch.Tensor, groups: int) -> torch.Tensor:
        """The reverse exchange: (E / ep, ep * G * C, d) -> (G, E, C, d)."""
        (back,) = collectives.all_to_all([out], self, 1, 0)
        return _split_groups(back, groups)


def _held(group) -> int:
    """The shards of ``group`` whose rows this process holds."""
    return 1 if group is None else len(group.ranks)


def _is_process(group) -> bool:
    return group is not None and hasattr(group, "pg") and group.size > 1


# ---------------------------------------------------------------------------
# the partition rules
# ---------------------------------------------------------------------------

def is_expert_leaf(names: Tuple[str, ...]) -> bool:
    return "experts" in names


def expert_leaf_tensor_spec(leaf_name: str, ndim: int) -> Optional[int]:
    """The tensor-split dim of one expert-FFN leaf (its hidden dim f, as
    ``models.moe.TENSOR_SPLIT_DIMS`` places it): the last for the column
    leaves, the one before it for ``w_out``; None for ``b_out`` and the
    router (EP x TP, seq x TP with an MoE FFN)."""
    if leaf_name not in TENSOR_SHARDED_EXPERT_LEAVES:
        return None
    return ndim + TENSOR_SPLIT_DIMS[leaf_name]


def moe_param_specs(params: Tree, expert: bool = True, tp: int = 1) -> Tree:
    """The ``tensor_parallel.LeafSpec`` of every leaf on the MoE layouts:
    expert leaves split on their leading E dim over the expert group
    (``expert``) and, with ``tp`` > 1, on their hidden dim over the tensor
    group; with ``tp`` > 1 the Megatron block leaves as on ``sp_tp``
    (qkv columns permuted); the rest whole."""
    from .spmd import sp_tp_param_specs
    from .tensor_parallel import LeafSpec

    dims = sp_tp_param_specs(params) if tp > 1 else None

    def spec(names, leaf):
        t = None
        if dims is not None:
            node = dims
            for k in names:
                node = node[int(k) if isinstance(node, list) else k]
            t = node
        return LeafSpec(t, expert=0 if expert and is_expert_leaf(names)
                        else None)

    return megatron.map_with_path(spec, params)


def moe_state_layout(model, params: Tree, tensor_group=None,
                     expert_group=None):
    """The ``tensor_parallel.StateLayout`` of the MoE layouts' params:
    this rank's experts (and hidden-dim slices) under process groups,
    every leaf whole under local ones."""
    from .tensor_parallel import StateLayout

    tp = 1 if tensor_group is None else tensor_group.size
    spec_tree = moe_param_specs(params, expert_group is not None
                                and expert_group.size > 1, tp)
    paths = megatron.leaf_paths(params)
    return StateLayout(spec_tree, [tuple(x.shape) for _, x in paths],
                       [n for n, _ in paths],
                       tensor_group or megatron.LocalTensorGroup(1),
                       expert_group=expert_group)


# ---------------------------------------------------------------------------
# the step's pieces
# ---------------------------------------------------------------------------

def _group_counts(batch: Batch, g_e: int, g_s: int) -> torch.Tensor:
    """The token count of each routing group held here, (g_e * g_s,) in
    the layer's group order (expert shard major): JAX's per-device
    ``count``."""
    y = batch["y"]
    per_row = 1
    for n in y.shape[1:]:
        per_row *= n
    mask = batch.get("mask")
    if mask is None:
        rows = torch.full((g_e,), float(y.shape[0] // g_e),
                          device=y.device)
    else:
        rows = mask.float().reshape(g_e, -1).sum(1)
    return (rows * (per_row / g_s))[:, None].expand(g_e, g_s).reshape(-1)


def _microbatches(batch: Batch, accum_steps: int, row_shards: int
                  ) -> List[Batch]:
    """Each shard's rows split into ``accum_steps`` microbatches, the
    shards' m-th microbatches joined (JAX splits each device's rows)."""
    out = [dict() for _ in range(accum_steps)]
    for k, v in batch.items():
        rows = v.shape[0] // row_shards
        if rows % accum_steps:
            raise ValueError(
                f"per-device batch rows {rows} (leaf {k!r}) not "
                f"divisible by accum_steps={accum_steps}")
        parts = v.reshape((row_shards, accum_steps, rows // accum_steps)
                          + v.shape[1:])
        for m in range(accum_steps):
            out[m][k] = parts[:, m].reshape((-1,) + v.shape[1:])
    return out


def _moe_accumulate(micro_grads: Callable, params: Tree, batch: Batch,
                    accum_steps: int, row_shards: int = 1):
    """``micro_grads`` over ``accum_steps`` microbatches of every shard's
    rows: loss sum, count and gradients summed (in f32), the aux of each
    routing group count-weighted so it comes out the token-weighted mean.
    Returns ``(loss_sum, count, aux, group_counts, grads)`` as one
    ``micro_grads`` call does."""
    if accum_steps <= 1:
        return micro_grads(params, batch)
    s = cnt = aux_w = gcs = grads = None
    for mb in _microbatches(batch, accum_steps, row_shards):
        ms, mc, ma, mg, mgr = micro_grads(params, mb)
        if grads is None:
            s, cnt, aux_w, gcs = ms, mc, ma * mg, mg
            grads = [g.float() for g in mgr]
        else:
            s, cnt = s + ms, cnt + mc
            aux_w, gcs = aux_w + ma * mg, gcs + mg
            torch._foreach_add_(grads, [g.float() for g in mgr])
    return s, cnt, aux_w / torch.clamp(gcs, min=1.0), gcs, grads


def _all_reduce(vals: List[torch.Tensor], pg) -> List[torch.Tensor]:
    return dp._all_reduce(vals, pg) if vals else vals


def _moe_grad_psum(grads: List[torch.Tensor], expert: List[bool],
                   extra: List[torch.Tensor], world: World,
                   expert_sliced: bool):
    """THE gradient-reduction rule of every MoE layout: the expert-sharded
    leaves summed over the data x seq ranks of their expert index, every
    other leaf (and ``extra``: the loss sum, count and aux) over the data
    x expert x seq ranks.  In place on ``grads``; returns the reduced
    ``extra``.  Under a local expert group every leaf is whole here and
    sums over the same ranks as the rest."""
    if not world.initialized:
        return extra
    own_pg = world.expert_replica_pg if expert_sliced else world.replica_pg
    idx_e = [i for i, e in enumerate(expert) if e]
    idx_r = [i for i, e in enumerate(expert) if not e]
    if not expert_sliced:
        idx_r, idx_e = idx_r + idx_e, []
    vals = _all_reduce([grads[i] for i in idx_r] + list(extra),
                       world.replica_pg)
    for i, v in zip(idx_r, vals):
        grads[i] = v
    for i, v in zip(idx_e, _all_reduce([grads[i] for i in idx_e], own_pg)):
        grads[i] = v
    return vals[len(idx_r):]


def _global_norm_clip(grads: List[torch.Tensor], grad_clip: float,
                      clip_groups: Sequence[Tuple[Any, ...]]
                      ) -> List[torch.Tensor]:
    """Clip by the GLOBAL norm on a split layout: ``clip_groups[i]``
    names the process groups leaf i is split over; its squared norm sums
    over exactly those (leaves grouped by their groups, one all-reduce per
    distinct set) before the norms combine into the one global norm every
    rank agrees on."""
    partial: Dict[Tuple[Any, ...], torch.Tensor] = {}
    for g, groups in zip(grads, clip_groups):
        term = g.float().square().sum()
        partial[groups] = partial.get(groups, 0.0) + term
    gsq = None
    for groups, sq in partial.items():
        for pg in groups:
            sq = sq.clone()
            dist.all_reduce(sq, group=pg)
        gsq = sq if gsq is None else gsq + sq
    scale = torch.clamp(grad_clip / torch.clamp(torch.sqrt(gsq), min=1e-12),
                        max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads]


def _make_step(forward: Callable, optimizer: Optimizer, world: World,
               expert_group, seq_group, tensor_group, layout,
               loss_name: str, aux_weight: float, grad_clip: float,
               accum_steps: int):
    """The step every MoE layout shares; ``forward(params, ids) ->
    (logits, aux per routing group)``."""
    base = losses_lib.get(loss_name)
    g_e, g_s = _held(expert_group), _held(seq_group)
    expert_sliced = _is_process(expert_group)
    tensor_sliced = _is_process(tensor_group)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def micro_grads(params, batch):
        logits, aux = forward(params, batch["x"])
        s, cnt = base(logits, batch["y"], batch.get("mask"))
        gc = _group_counts(batch, g_e, g_s)
        # per shard the loss sum plus aux_weight * aux * count: the global
        # mean task loss + aux_weight * mean aux out of the same sum
        total = s + aux_weight * (aux * gc).sum()
        ps = leaves(params)
        grads = torch.autograd.grad(total, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        return s.detach(), cnt.detach(), aux.detach(), gc, grads

    names = None
    clip_groups = None

    def step(state: TrainState, batch: Batch):
        nonlocal names, clip_groups
        if names is None:
            names = [n for n, _ in megatron.leaf_paths(state.params)]
            specs = (layout.stored if layout is not None
                     else [None] * len(names))
            clip_groups = []
            for n, sp in zip(names, specs):
                groups = []
                if expert_sliced and is_expert_leaf(n):
                    groups.append(expert_group.pg)
                if tensor_sliced and sp is not None and \
                        sp.tensor is not None:
                    groups.append(tensor_group.pg)
                clip_groups.append(tuple(groups))
        s, cnt, aux, _, grads = _moe_accumulate(
            micro_grads, state.params, batch, accum_steps, g_e)
        s, cnt, aux_sum = _moe_grad_psum(
            grads, [is_expert_leaf(n) for n in names],
            [s.reshape(1), cnt.reshape(1), aux.sum().reshape(1)], world,
            expert_sliced)
        total = cnt[0]
        grads = [g / total for g in grads]
        shards = aux.numel() * (dist.get_world_size(world.replica_pg)
                                if world.initialized else 1)
        metrics = {"loss": s[0] / total, "aux": aux_sum[0] / shards}
        if grad_clip > 0:
            grads = _global_norm_clip(grads, grad_clip, clip_groups)
        params, opt_state = optimizer.update(
            unflatten(state.params, grads), state.opt_state, state.params)
        return TrainState(state.step + 1, params, opt_state,
                          state.qstate), metrics

    return step


class _Logits:
    """A forward's logits alone, for ``data_parallel.make_eval_step``."""

    def __init__(self, forward: Callable):
        self.forward = forward

    def apply(self, params, x):
        return self.forward(params, x)[0]


def _check_seq(model, seq_group):
    if seq_group is not None and seq_group.size > 1 and \
            model.cfg.attention not in SEQ_SHARDED_IMPLS:
        raise ValueError(f"seq axis active but model attention="
                         f"{model.cfg.attention!r} is not seq-sharded")


def _check_experts(model, expert_group):
    c = model.cfg
    ep = 1 if expert_group is None else expert_group.size
    if c.moe_experts <= 0:
        raise ValueError("model has no MoE layers; use the spmd/gspmd step")
    if c.moe_experts % ep:
        raise ValueError(f"{c.moe_experts} experts not divisible over "
                         f"expert axis of size {ep}")
    if model.expert_group is not expert_group:
        raise ValueError("the model's expert group is not the step's: "
                         "build the Transformer with expert_group=")
    return ep


# ---------------------------------------------------------------------------
# EP and seq x EP
# ---------------------------------------------------------------------------

def make_moe_train_step(model, optimizer: Optimizer, world: World,
                        expert_group, loss_name: str = "cross_entropy",
                        aux_weight: float = AUX_WEIGHT,
                        grad_clip: float = 0.0, accum_steps: int = 1,
                        seq_group=None):
    """(state, this rank's batch) -> (state, {"loss", "aux"}) over data x
    expert (x seq with ``seq_group``: a sequence-sharded attention
    composed with the expert exchange).  ``model``: the MoE Transformer
    built with this ``expert_group`` (and ``seq_group``); under a process
    expert group the params hold this rank's experts only.
    ``grad_clip`` clips by the global norm inside the step; do not wrap
    the optimizer in ``with_clipping``."""
    _check_experts(model, expert_group)
    _check_seq(model, seq_group)

    def forward(params, ids):
        return model.forward(params, ids, return_aux=True)

    return _make_step(forward, optimizer, world, expert_group, seq_group,
                      None, None, loss_name, aux_weight, grad_clip,
                      accum_steps)


def make_moe_eval_step(model, world: World, loss_name: str = "cross_entropy",
                       with_accuracy: bool = True):
    """(params, batch) -> global-mean metrics over data x expert (x seq),
    as ``data_parallel.make_eval_step`` (each seq shard scores its own
    tokens)."""
    return dp.make_eval_step(_Logits(lambda p, x: model.forward(
        p, x, return_aux=True)), world, loss_name=loss_name,
        with_accuracy=with_accuracy)


# ---------------------------------------------------------------------------
# EP x TP, seq x EP x TP and seq x TP with an MoE FFN
# ---------------------------------------------------------------------------

def moe_ffn_fn(cfg, expert_group=None, tensor_group=None,
               seq_shards: int = 1, batch=None):
    """The MoE FFN injection of ``megatron.tp_block_apply``: the block's
    ``moe`` params (the same dict on every tensor shard) through the
    layer with the expert and tensor groups -> ``(ff, aux)``; ``batch``:
    the GSPMD layout's batch group, over which one group routes."""
    from ..models.moe import MoEFFN

    ffn = MoEFFN(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                 capacity_factor=cfg.moe_capacity_factor,
                 capacity=cfg.moe_capacity, activation=cfg.activation,
                 param_dtype=cfg.param_dtype,
                 compute_dtype=cfg.compute_dtype,
                 router_top_k=cfg.moe_top_k)

    def ffn_fn(layer_shards, h):
        return ffn.apply(layer_shards[0]["moe"], h, expert_group,
                         tensor_group, seq_shards, batch)

    return ffn_fn


def _validate_moe_tp(model, expert_group, tensor_group, seq_group=None):
    """JAX's checks and messages for the MoE x TP step."""
    c = model.cfg
    ep = 1 if expert_group is None else expert_group.size
    tp = 1 if tensor_group is None else tensor_group.size
    sp = 1 if seq_group is None else seq_group.size
    use_seq = sp > 1
    if tp < 2 or (ep < 2 and not use_seq):
        raise ValueError(f"the MoE x TP step needs tensor>1 and "
                         f"(expert>1 or an active seq axis); got expert="
                         f"{ep}, tensor={tp}, seq={sp} — use the plain "
                         "expert/gspmd/spmd paths otherwise")
    if c.moe_experts <= 0:
        raise ValueError("EP x TP requires a transformer with moe_experts "
                         "> 0 (--moe_experts)")
    if c.moe_experts % max(ep, 1):
        raise ValueError(f"{c.moe_experts} experts not divisible over "
                         f"expert axis of size {ep}")
    megatron.validate_tp(c, tp)
    if use_seq:
        if c.attention not in SEQ_SHARDED_IMPLS:
            raise ValueError(
                f"seq axis 'seq'={sp} is active but attention="
                f"{c.attention!r} is not seq-sharded "
                f"({SEQ_SHARDED_IMPLS})")
        if c.attention == "ulysses":
            validate_ulysses_under_tp(c.n_heads, tp, sp)
    elif c.attention not in ("dense", "auto"):
        raise ValueError("the EP x TP step runs Megatron attention over the "
                         f"full local sequence; attention={c.attention!r} "
                         "needs seq_axis (SP x EP x TP) or the sp/sp_ep "
                         "paths")
    if c.scan_layers:
        raise ValueError("scan_layers is a plain-DP/SP layout; the EP x TP "
                         "step owns its own per-layer loop")
    return ep, tp


def moe_tp_model(model, tensor_group, expert_group=None, seq_group=None,
                 layout=None):
    """The (SP x) EP x TP forward: ``tensor_parallel.TensorParallelModel``
    over permuted qkv columns with the MoE FFN of :func:`moe_ffn_fn` in
    each Megatron block."""
    from .tensor_parallel import TensorParallelModel

    _validate_moe_tp(model, expert_group, tensor_group, seq_group)
    return TensorParallelModel(model, tensor_group, qkv_order="permuted",
                               seq_group=seq_group, layout=layout,
                               expert_group=expert_group)


def make_moe_tp_train_step(model, optimizer: Optimizer, world: World,
                           tensor_group, expert_group=None,
                           loss_name: str = "cross_entropy",
                           aux_weight: float = AUX_WEIGHT,
                           grad_clip: float = 0.0, accum_steps: int = 1,
                           seq_group=None, layout=None):
    """(state, batch) -> (state, {"loss", "aux"}) over data x expert x
    tensor (x seq): Megatron attention over the tensor group, the experts
    split over the expert group (whole experts, the slot exchange) and the
    tensor group (each expert's hidden dim, the ``g`` sum).  With no
    expert group (or one of size 1) and a sequence group this is seq x TP
    with an MoE FFN: experts whole, their hidden dim tensor-split, no
    exchange.  The params hold the qkv columns permuted for the tensor
    group (``spmd.permute_params``)."""
    tpm = moe_tp_model(model, tensor_group, expert_group, seq_group, layout)

    def forward(params, ids):
        return tpm.apply(params, ids, return_aux=True)

    return _make_step(forward, optimizer, world, expert_group, seq_group,
                      tensor_group, layout, loss_name, aux_weight,
                      grad_clip, accum_steps)


def make_moe_tp_eval_step(model, world: World, tensor_group,
                          expert_group=None, loss_name: str = "cross_entropy",
                          with_accuracy: bool = True, seq_group=None,
                          layout=None):
    """(params, batch) -> global-mean metrics on the (SP x) EP x TP
    layout, params consumed in place."""
    tpm = moe_tp_model(model, tensor_group, expert_group, seq_group, layout)
    return dp.make_eval_step(_Logits(lambda p, x: tpm.apply(
        p, x, return_aux=True)), world, loss_name=loss_name,
        with_accuracy=with_accuracy)
