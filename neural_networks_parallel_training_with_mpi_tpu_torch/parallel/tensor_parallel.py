"""Tensor parallelism: the partition rules and the split forward, the port
of the JAX package's ``parallel/tensor_parallel.py``.

In the JAX package a rule maps each parameter's path to a
``PartitionSpec`` over the mesh's ``tensor`` (and ``fsdp``) axes and XLA's
partitioner inserts the collectives.  In the port a rule is a *slice
rule*: the dim of a leaf that is split over the tensor group, or None for
a leaf that stays whole (every leaf whose dim does not divide, as JAX's
``_divisible``).  With no ``fsdp`` axis ported, the rules give the same
placement as JAX's specs on a ``data x tensor`` mesh:

* transformer (Megatron): ``qkv`` / ``ff_in`` / ``ff_gate`` weights and
  biases column-parallel (their output dim), ``attn_out`` / ``ff_out``
  weights row-parallel (their input dim), the LM head's weight on its
  vocab dim; LayerNorms, row biases and the embeddings whole;
* MLP: Megatron's alternating column / row Linears (``mlp_rules``);
* anything else: whole (``generic_rules``).

:class:`TensorParallelModel` is the model's forward with that split: the
counterpart of the JAX GSPMD step's global-view forward (``--tp``, qkv
columns kept in the dense order and taken head-aligned per shard) and of
``parallel/spmd.py``'s ``sp_tp`` forward (``--sp`` x ``--tp``, qkv columns
stored permuted, optionally the vocab-parallel embedding and head).  The
train and eval steps of ``parallel.data_parallel`` run it as they run the
model.

Every rank keeps the whole state, in the layout a snapshot holds (dense,
or permuted under ``sp_tp``); the tensor group splits the forward and
backward (activations, products, attention heads).  Each shard's
gradient lands in its slice of the whole leaf.  Under a local group all
slices are in this process.  Under a process group the gradient
all-reduce over the world completes them: a split leaf's slices come one
from each tensor rank, and a whole leaf, whose gradient every tensor
rank holds equal (``f``'s backward), is counted from tensor rank 0 only
(:meth:`TensorParallelModel.contributes`).  Every rank then holds the
global-batch gradient of the dense model, so the clip, the skip guard
and the telemetry take the global norm as they do under data
parallelism, and count no leaf twice.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from ..models.core import Activation, Linear
from ..models.mlp import MLP
from ..models.transformer import Transformer, layer_params
from . import megatron
from .sequence import global_positions, sequence_sharded_attention

Tree = Any
Rule = Callable[[Tuple[str, ...], Any], Optional[int]]


def _divisible(dim: int, tp: int) -> bool:
    return tp > 1 and dim % tp == 0


def transformer_rules(tp: int) -> Rule:
    """Megatron rules keyed on the transformer's param paths."""

    def rule(path: Tuple[str, ...], leaf) -> Optional[int]:
        shape = tuple(leaf.shape)
        col = "qkv" in path or "ff_in" in path or "ff_gate" in path
        row = "attn_out" in path or "ff_out" in path
        if path[-1] == "w" and len(shape) == 2:
            in_dim, out_dim = shape
            if col and _divisible(out_dim, tp):
                return 1
            if row and _divisible(in_dim, tp):
                return 0
            if path[0] == "head" and _divisible(out_dim, tp):
                return 1
            return None
        if path[-1] == "b" and col and _divisible(shape[0], tp):
            return 0
        return None

    return rule


def mlp_rules(tp: int) -> Rule:
    """Alternating column / row parallelism for the MLP (a Sequential of
    [Linear, Activation]*depth + Linear, Linears at even indices): the
    1st, 3rd, ... Linear column-parallel, the 2nd, 4th, ... row-parallel;
    a dim that does not divide stays whole."""

    def rule(path: Tuple[str, ...], leaf) -> Optional[int]:
        shape = tuple(leaf.shape)
        try:
            ordinal = int(path[-2]) // 2
        except (ValueError, IndexError):
            ordinal = 0
        col = ordinal % 2 == 0
        if path[-1] == "w" and len(shape) == 2:
            in_dim, out_dim = shape
            if col and _divisible(out_dim, tp):
                return 1
            if not col and _divisible(in_dim, tp):
                return 0
            return None
        if (path[-1] == "b" and col and len(shape) == 1
                and _divisible(shape[0], tp)):
            return 0
        return None

    return rule


def generic_rules(tp: int) -> Rule:
    """Models with no tensor structure: every leaf whole."""
    return lambda path, leaf: None


def rules_for(model, tp: int) -> Rule:
    if isinstance(model, Transformer):
        return transformer_rules(tp)
    if isinstance(model, MLP):
        return mlp_rules(tp)
    return generic_rules(tp)


def param_specs(model, params: Tree, tp: int) -> Tree:
    """The slice rule of every leaf of ``params``: the split dim or None."""
    rule = rules_for(model, tp)
    return megatron.map_with_path(rule, params)


class TensorParallelModel:
    """``model``'s forward with its tensor dim split over ``group``.

    ``qkv_order``: ``"dense"`` (the params keep the dense model's qkv
    columns; each shard takes its heads' columns by
    ``megatron.qkv_tp_permutation``) or ``"permuted"`` (the params hold
    the permuted order, ``sp_tp``'s).  ``seq_group``: the sequence group
    of a sequence-sharded attention.  ``vocab_parallel``: the embedding
    table row-split and the head column-split, the loss the vocab-parallel
    cross-entropy (``fused_loss_sum``), never the full logits; otherwise
    :meth:`apply` returns the full f32 logits, gathered when the head is
    split."""

    def __init__(self, model, group, qkv_order: str = "dense",
                 seq_group=None, vocab_parallel: bool = False):
        if qkv_order not in ("dense", "permuted"):
            raise ValueError(f"unknown qkv_order {qkv_order!r}")
        self.model, self.group, self.seq_group = model, group, seq_group
        self.qkv_order, self.vocab_parallel = qkv_order, vocab_parallel
        self.tp = group.size
        self.transformer = isinstance(model, Transformer)
        if self.transformer:
            megatron.validate_tp(model.cfg, self.tp)
        self._qkv_index = {}

    # ---- which leaves are split ----
    def split_leaves(self, params: Tree) -> List[bool]:
        """Per leaf of ``params`` (in ``leaves`` order): True when the
        forward splits it over the group, so each tensor rank's gradient
        holds only its slice."""
        if self.transformer:
            head = self._head_split(params)
            return [megatron.is_tensor_sharded(names)
                    if names[0] == "blocks" else
                    head if names[0] == "head" else
                    self.vocab_parallel and names[0] == "embed"
                    for names, _ in megatron.leaf_paths(params)]
        # a column Linear splits its weight and bias, a row one its weight
        # (its bias is added to the summed output)
        return [mode == "col" or (mode == "row" and name == "w")
                for p, mode in zip(params, self._mlp_modes(params))
                for name in p]

    def contributes(self, params: Tree) -> Optional[List[bool]]:
        """Which leaves' gradients (and the loss sum and count) this
        process adds to the world's all-reduce: None for all of them (a
        local group, or tensor rank 0); else the split leaves only."""
        if self.group.rank == 0 or self.tp == 1:
            return None
        return self.split_leaves(params)

    # ---- the transformer ----
    def _head_split(self, params: Tree) -> bool:
        if self.vocab_parallel:
            return True
        if self.qkv_order == "permuted":    # sp_tp: the head stays whole
            return False
        return transformer_rules(self.tp)(("head", "w"),
                                          params["head"]["w"]) == 1

    def _qkv(self, device) -> Optional[torch.Tensor]:
        if self.qkv_order == "permuted":
            return None
        idx = self._qkv_index.get(device)
        if idx is None:
            c = self.model.cfg
            idx = torch.as_tensor(megatron.qkv_tp_permutation(
                c.d_model, c.n_heads, self.tp, c.kv_heads), device=device)
            self._qkv_index[device] = idx
        return idx

    def _chunks(self, leaf: torch.Tensor, dim: int) -> List[torch.Tensor]:
        parts = leaf.chunk(self.tp, dim=dim)
        return [parts[r] for r in self.group.ranks]

    def backbone(self, params: Tree, ids: torch.Tensor) -> torch.Tensor:
        """Embedding and the Megatron blocks -> (B, T, d_model)."""
        m, c, group = self.model, self.model.cfg, self.group
        positions = global_positions(c.attention, self.seq_group,
                                     ids.shape[1], ids.device)
        if self.vocab_parallel:
            x = m.add_pos(params, megatron.vocab_parallel_embed(
                self._chunks(params["embed"]["table"], 0), ids, group),
                positions)
        else:
            x = m.embed(params, ids, positions)
        rope = c.rope_theta if c.pos_encoding == "rope" else None

        def attend(q, k, v):
            return sequence_sharded_attention(
                c.attention, q, k, v, group=self.seq_group, causal=True,
                block_q=c.flash_block_q, block_k=c.flash_block_k,
                rope_theta=rope)

        def block_fn(shards, h):
            return megatron.tp_block_apply(c, shards, h, group,
                                           attention_fn=attend)

        if m._remat is not None:
            block_fn = m._remat(block_fn)
        qkv = self._qkv(ids.device)
        for layer in layer_params(params):
            shards = megatron.shard_layer(layer, self.tp, qkv)
            x = block_fn([shards[r] for r in group.ranks], x)
        return x

    def _logits_local(self, params: Tree, x: torch.Tensor
                      ) -> List[torch.Tensor]:
        """The vocab-split head's f32 logits shards held here."""
        return megatron.vocab_parallel_logits(
            self.model.final_norm(params, x),
            self._chunks(params["head"]["w"], 1), self.group,
            compute_dtype=self.model.cfg.compute_dtype)

    def _transformer_logits(self, params: Tree,
                            ids: torch.Tensor) -> torch.Tensor:
        x = self.backbone(params, ids)
        if not self._head_split(params):
            return self.model.head_logits(params, x)
        return self.group.gather(self._logits_local(params, x), dim=-1)

    # ---- the MLP ----
    def _mlp_modes(self, params: Tree) -> List[Optional[str]]:
        """Per layer of the Sequential: "col" / "row" when its product is
        split, else None.  A row-parallel Linear whose input arrives whole
        (the Linear before it did not split) runs whole."""
        rule = mlp_rules(self.tp)
        modes, split_in = [], False
        for i, (layer, p) in enumerate(zip(self.model.net.layers, params)):
            mode = None
            if isinstance(layer, Linear):
                dim = rule((str(i), "w"), p["w"])
                mode = {1: "col", 0: "row" if split_in else None}.get(dim)
                split_in = mode == "col"
            modes.append(mode)
        return modes

    def _mlp_apply(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        group = self.group
        parts = None            # the split activation's shards held here
        for layer, p, mode in zip(self.model.net.layers, params,
                                  self._mlp_modes(params)):
            if isinstance(layer, Activation):
                if parts is not None:
                    parts = [layer.apply(p, t) for t in parts]
                else:
                    x = layer.apply(p, x)
                continue
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
    def apply(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        """The model's output, whole, on every rank of the group."""
        if self.transformer:
            return self._transformer_logits(params, x)
        if isinstance(self.model, MLP):
            return self._mlp_apply(params, x)
        return self.model.apply(params, x)

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
