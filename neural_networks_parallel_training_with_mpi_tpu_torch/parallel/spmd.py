"""The DP x SP x TP train and eval steps (``--sp`` x ``--tp``), the port
of the JAX package's ``parallel/spmd.py`` ``sp_tp`` part.

Megatron blocks over the tensor group (``parallel.megatron``) with a
sequence-sharded attention over the sequence group (``ring``,
``ring_flash``, ``striped``, ``striped_flash`` or ``ulysses``), in the
data-parallel step of ``parallel.data_parallel``: the gradient is the
global-batch mean over every token.  The params hold the qkv columns in
the permuted order (:func:`init_sp_tp_state`), so each tensor shard's
heads are one contiguous slice, and a snapshot records ``qkv_tp`` = tp,
as the JAX package saves it.  ``vocab_parallel`` splits the embedding
table on its rows and the LM head on its columns over the tensor group
and trains on the vocab-parallel cross-entropy, so the full (B, T, V)
logits never exist.  ``grad_clip`` clips by the global norm, which every
rank takes over its own slices (``parallel.tensor_parallel``): under a
process group each rank holds only its tensor slice of the split leaves,
params and optimizer slots, as JAX's ``shard_map`` specs slice them over
``tensor``.  An MoE model is refused here, as in JAX, and sent to
``parallel.expert.make_moe_tp_train_step`` (seq x TP with an MoE FFN).
"""

from __future__ import annotations

from typing import Any, Dict

from ..ops import optim as optim_lib
from ..ops.optim import Optimizer
from ..train.state import TrainState
from . import data_parallel as dp
from . import megatron
from .distributed import World
from .sequence import SEQ_SHARDED_IMPLS, validate_ulysses_under_tp
from .tensor_parallel import TensorParallelModel

Tree = Any


def sp_tp_param_specs(params: Tree, vocab_parallel: bool = False) -> Tree:
    """The slice rule of every leaf under ``sp_tp``: the block leaves of
    ``megatron.is_tensor_sharded`` split (columns on their last dim, row
    weights on their input dim, stacked ``scan_layers`` leaves one dim
    right), an MoE FFN's expert leaves on their hidden dim
    (``expert.expert_leaf_tensor_spec``: the seq x TP layout with an MoE
    FFN, experts whole), the embedding table on dim 0 and the head on dim
    1 under ``vocab_parallel``; None (whole) for the rest."""
    from .expert import expert_leaf_tensor_spec, is_expert_leaf

    def spec(names, leaf):
        ndim = leaf.dim()
        if names[0] == "blocks":
            if is_expert_leaf(names):
                return expert_leaf_tensor_spec(names[-1], ndim)
            if not megatron.is_tensor_sharded(names):
                return None
            row = "attn_out" in names or "ff_out" in names
            return ndim - 2 if row else ndim - 1
        if vocab_parallel and names[0] == "embed":
            return 0
        if vocab_parallel and names[0] == "head":
            return 1
        return None

    return megatron.map_with_path(spec, params)


def init_sp_tp_state(model, optimizer: Optimizer, generator, tp: int
                     ) -> TrainState:
    """Dense init, then the head-aligned qkv column permutation (each
    tensor shard's heads contiguous; the inverse restores the dense
    order)."""
    return TrainState.from_params(permute_params(model, model.init(
        generator), tp), optimizer, model)


def permute_params(model, params: Dict[str, Any], tp: int,
                   inverse: bool = False) -> Dict[str, Any]:
    """``params`` with their blocks' qkv columns permuted for ``tp``
    tensor shards (or back to the dense order)."""
    if tp <= 1:
        return params
    c = model.cfg
    return dict(params, blocks=megatron.permute_qkv(
        params["blocks"], c.d_model, c.n_heads, tp, inverse=inverse,
        kv_heads=c.kv_heads))


def _validate_vocab_parallel(model, tp: int, loss_name: str) -> None:
    if model.cfg.vocab_size % tp:
        raise ValueError(f"vocab_size={model.cfg.vocab_size} not divisible "
                         f"by tensor axis size {tp}")
    if loss_name != "cross_entropy":
        raise ValueError(
            "vocab_parallel computes softmax cross-entropy over the "
            f"sharded logits; got loss {loss_name!r} (label smoothing is "
            "not wired on the sharded loss)")


def _sp_tp_forward(model, group, seq_group, vocab_parallel: bool = False,
                   layout=None) -> TensorParallelModel:
    """The shared SP x TP forward: embedding at the shard's global
    positions, Megatron blocks with the sequence-sharded attention, the
    final LayerNorm and head (vocab-split under ``vocab_parallel``)."""
    c = model.cfg
    if c.attention not in SEQ_SHARDED_IMPLS:
        raise ValueError(f"SP x TP needs a seq-sharded attention impl "
                         f"{SEQ_SHARDED_IMPLS}, got {c.attention!r}")
    return TensorParallelModel(model, group, qkv_order="permuted",
                               seq_group=seq_group,
                               vocab_parallel=vocab_parallel, layout=layout)


def make_sp_tp_train_step(model, optimizer: Optimizer, world: World, group,
                          seq_group, loss_name: str = "cross_entropy",
                          accum_steps: int = 1, grad_clip: float = 0.0,
                          vocab_parallel: bool = False, layout=None):
    """(state, this rank's batch) -> (state, global mean loss) over a
    data x seq x tensor world, with the JAX package's checks; ``layout``:
    the params' ``tensor_parallel.StateLayout`` (sliced under a process
    group)."""
    tp, sp = group.size, seq_group.size
    if tp < 2 or sp < 2:
        raise ValueError(f"SP x TP needs tensor>1 and seq>1; got "
                         f"tensor={tp}, seq={sp} — use the plain "
                         "spmd/gspmd paths otherwise")
    megatron.validate_tp(model.cfg, tp)
    if model.cfg.moe_experts > 0:
        raise ValueError(
            "SP x TP with an MoE FFN rides the expert module: "
            "parallel.expert.make_moe_tp_train_step(seq_group=...) — with "
            "the mesh's expert axis at 1 the experts stay whole and only "
            "their hidden dim is tensor-sharded; expert>1 gives the full "
            "SP x EP x TP composition.  The Trainer routes MoE models "
            "there automatically")
    if model.cfg.attention == "ulysses":
        validate_ulysses_under_tp(model.cfg.n_heads, tp, sp)
    if vocab_parallel:
        _validate_vocab_parallel(model, tp, loss_name)
    if grad_clip > 0:
        optimizer = optim_lib.with_clipping(
            optimizer, grad_clip, optim_lib.combine_norms if layout is None
            else layout.combine)
    return dp.make_train_step(
        _sp_tp_forward(model, group, seq_group, vocab_parallel, layout),
        optimizer, world, loss_name=loss_name, accum_steps=accum_steps)


def make_sp_tp_eval_step(model, world: World, group, seq_group,
                         loss_name: str = "cross_entropy",
                         with_accuracy: bool = False,
                         vocab_parallel: bool = False, layout=None):
    """(params, batch) -> metrics, as ``data_parallel.make_eval_step``
    (the vocab-parallel loss and accuracy under ``vocab_parallel``)."""
    if vocab_parallel:
        _validate_vocab_parallel(model, group.size, loss_name)
    return dp.make_eval_step(
        _sp_tp_forward(model, group, seq_group, vocab_parallel, layout),
        world, loss_name=loss_name, with_accuracy=with_accuracy)
