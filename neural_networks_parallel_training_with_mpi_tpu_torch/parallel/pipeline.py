"""Pipeline parallelism over a pipe group (GPipe microbatching and its
virtual-stage interleave): the port of the JAX package's
``parallel/pipeline.py``.

The layout is JAX's: the transformer blocks stacked into one tree whose
leaves carry a leading ``(n_stages, layers_per_stage)`` axis
(:func:`stack_blocks`), or ``(v, n_stages, layers_per_slice)`` under the
interleave ``v`` (device ``d`` owns virtual stages ``d, d+S, ...,
d+(v-1)S``); under a tensor group the fused qkv columns are permuted
head-aligned (``megatron.permute_qkv``), so a snapshot records ``qkv_tp``
= tp, as the JAX package's.  The embedding, the position table, the final
LayerNorm and the head live on every stage.  The schedule is JAX's
(:func:`schedule_ticks`, :func:`_schedule_indices`): at tick ``t`` device
``d`` works on microbatch ``m`` and chunk ``j`` of ``t' = t - d``; stage
0 injects each microbatch's embedding, the last stage applies the final
LayerNorm and the head (or the model's chunked cross-entropy under
``ce_chunk``) and sums the loss, and each output hops to the next stage.

Where the JAX package runs the schedule inside ``shard_map`` over a
``pipe`` mesh axis, the port passes an explicit *pipe group*, as
``parallel.megatron`` passes a tensor group:

* ``ProcessPipeGroup(pg)``: one stage per rank of a ``torch.distributed``
  process group (NCCL on cards, gloo on the CPU).  The hop is a
  point-to-point send to ``(s+1) % S`` and receive from ``(s-1) % S``
  inside an ``autograd.Function`` whose backward is the reverse rotation;
  a token threads every hop of a rank in tick order, so the backward
  exchanges run in exactly the reverse order on every rank and pair up.
* ``LocalPipeGroup(S)``: all S stages in this process (one card), the hop
  the hand-off of one tensor.

Where the designs differ: JAX applies every stage on every tick, warmup
and drain ticks included, on stale activations, and masks their results
out.  The port runs only the active (stage, microbatch, chunk)
applications: a stale tick's output reaches only other stale ticks and
the masked loss, so dropping them changes no value.  The schedule is host
ints fixed when the step is built, so the step makes no host sync and a
CUDA graph captures it (``--steps_per_dispatch``).  One card runs the
stages in turn, so it shows no bubble: :func:`bubble_fraction` is the
formula for a pipe of S cards.

The train step is ``parallel.data_parallel``'s over :class:`PipelineModel`
(the schedule's loss sum and count): the gradients of the leaves every
stage holds, the loss sum and the count are summed over the pipe group
(their gradient is non-zero on one stage only), then everything over the
data (x seq) ranks that hold the same stage and tensor slice, and divided
by the global token count, as JAX's ``blocks_psum`` and ``reduce_axes``
psums.  ``grad_clip`` clips inside the step by the global norm, the
blocks' squares summed over pipe (and tensor for the split leaves), as
JAX's.  Accumulation folds into the schedule (the Trainer passes
``n_microbatches = S x accum_steps``).  MoE blocks (pipe x expert) are not
ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops import losses as losses_lib
from ..ops import optim as optim_lib
from . import data_parallel as dp
from . import megatron
from .sequence import (SEQ_SHARDED_IMPLS, global_positions,
                       sequence_sharded_attention, validate_ulysses_under_tp)

Tree = Any


# ---------------------------------------------------------------------------
# parameter layout: per-layer list -> (n_stages, layers_per_stage, ...) stack
# ---------------------------------------------------------------------------

def _map(fn, *trees):
    """``fn`` over the leaves of trees of dicts (a block's layout)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaf_list(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_list(tree[k])]
    return [tree]


def stack_blocks(blocks, n_stages: int, interleave: int = 1) -> Tree:
    """A list of per-layer block trees of tensors -> one tree whose
    leaves have a leading ``(n_stages, layers_per_stage)`` axis,
    or ``(v, n_stages, layers_per_slice)`` under ``interleave=v > 1``
    (virtual stage ``j*n_stages + d`` is slice ``[j, d]``)."""
    n_layers = len(blocks)
    total = n_stages * interleave
    if n_layers % total:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{interleave} x {n_stages} virtual stages")
    per = n_layers // total
    lead = ((n_stages, per) if interleave == 1
            else (interleave, n_stages, per))

    def stack(*xs):
        x = torch.stack(xs)
        return x.reshape(lead + tuple(x.shape[1:]))

    return _map(stack, *blocks)


def unstack_blocks(stacked: Tree, stack_ndims: int = 2) -> list:
    """Inverse of :func:`stack_blocks`: back to a per-layer list (row-major
    over the stack dims, the layers' order); ``stack_ndims=3`` for an
    interleaved ``(v, n_stages, per)`` stack."""
    lead = tuple(_leaf_list(stacked)[0].shape[:stack_ndims])
    n = math.prod(lead)
    flat = _map(lambda x: x.reshape((n,) + tuple(x.shape[stack_ndims:])),
                stacked)
    return [_map(lambda x: x[i], flat) for i in range(n)]


def infer_stack_ndims(blocks: Tree) -> int:
    """How many leading stack axes a transformer ``blocks`` tree carries:
    0 a per-layer list, 1 a ``scan_layers`` ``(L, ...)`` stack, 2 a
    pipeline ``(S, per)`` stack, 3 an interleaved ``(v, S, per)`` one
    (every block's dense qkv weight is 2-d)."""
    if not isinstance(blocks, dict):
        return 0
    return len(blocks["qkv"]["w"].shape) - 2


def dense_layer_blocks(blocks: Tree, model_cfg=None,
                       saved_tp: int = 1) -> Tree:
    """Snapshot ``blocks`` in any training layout -> the dense layout the
    unpipelined model and the decoders read: the head-aligned qkv column
    permutation undone (``saved_tp``, a snapshot's ``qkv_tp``; needs
    ``model_cfg`` when > 1), then a pipeline or interleaved stack
    flattened to the per-layer list (its depth inferred from the leaves).
    A ``scan_layers`` ``(L, ...)`` stack is returned as it is."""
    if saved_tp > 1:
        blocks = megatron.permute_qkv(blocks, model_cfg.d_model,
                                      model_cfg.n_heads, saved_tp,
                                      inverse=True,
                                      kv_heads=model_cfg.kv_heads)
    stack = infer_stack_ndims(blocks)
    if stack >= 2:
        return unstack_blocks(blocks, stack_ndims=stack)
    return blocks


def init_pipeline_params(model, generator: torch.Generator, n_stages: int,
                         tp: int = 1, interleave: int = 1) -> Tree:
    """``model.init`` then the blocks restacked for the pipeline; with
    ``tp > 1`` the fused qkv columns permuted head-aligned, so each tensor
    shard holds whole heads."""
    params = dict(model.init(generator))
    params["blocks"] = to_pipeline_blocks(params["blocks"], model.cfg,
                                          n_stages, tp, interleave)
    return params


def to_pipeline_blocks(blocks: Tree, cfg, n_stages: int, tp: int = 1,
                       interleave: int = 1) -> Tree:
    """Dense per-layer blocks -> the pipeline layout (stacked, qkv
    permuted for ``tp``)."""
    blocks = stack_blocks(blocks, n_stages, interleave)
    if tp > 1:
        blocks = megatron.permute_qkv(blocks, cfg.d_model, cfg.n_heads, tp,
                                      kv_heads=cfg.kv_heads)
    return blocks


def pipeline_param_specs(params: Tree, tp: int = 1,
                         interleave: int = 1) -> Tree:
    """The ``tensor_parallel.LeafSpec`` of every leaf (JAX's
    ``pipeline_param_specs``): the stacked block leaves split over the
    pipe group on their stage dim (0, or 1 under the interleaved stack),
    and with ``tp > 1`` the Megatron column leaves on their last dim and
    the row weights on their input dim (right after the stack dims); the
    embeddings, the final norm and the head whole."""
    from .tensor_parallel import WHOLE, LeafSpec

    nstack = 2 if interleave == 1 else 3

    def spec(names, leaf):
        if names[0] != "blocks":
            return WHOLE
        pipe = nstack - 2
        if tp <= 1 or not megatron.is_tensor_sharded(names):
            return LeafSpec(pipe=pipe)
        col = "qkv" in names or "ff_in" in names or "ff_gate" in names
        ndim = len(leaf.shape)
        if names[-1] == "w" and ndim == nstack + 2:
            return LeafSpec(tensor=nstack + 1 if col else nstack, pipe=pipe)
        if names[-1] == "b" and ndim == nstack + 1:
            return LeafSpec(tensor=nstack, pipe=pipe)
        raise ValueError(f"unexpected tensor-sharded leaf {names} "
                         f"ndim={ndim} (stack dims {nstack})")

    return megatron.map_with_path(spec, params)


# ---------------------------------------------------------------------------
# schedule accounting
# ---------------------------------------------------------------------------

def schedule_ticks(n_stages: int, n_microbatches: int,
                   interleave: int = 1) -> int:
    """Ticks of the ring schedule: ``interleave * n_microbatches``
    stage-applications per device plus the (n_stages - 1) fill."""
    return interleave * n_microbatches + n_stages - 1


def bubble_fraction(n_stages: int, n_microbatches: int,
                    interleave: int = 1) -> float:
    """Fraction of the ticks that are warmup/drain on a pipe of
    ``n_stages`` devices: ``(S - 1) / (v M + S - 1)``."""
    return (n_stages - 1) / schedule_ticks(n_stages, n_microbatches,
                                           interleave)


def _schedule_indices(tick_i: int, stage_idx: int, n_stages: int,
                      n_mb: int, interleave: int):
    """The interleaved ring schedule's indices of one device at one tick,
    as host ints (v=1 is the plain GPipe ring): ``(m, j, injecting,
    producing, active)`` — the microbatch (clipped into range), the chunk
    on this device, whether device 0 injects an embedding, whether the
    last device finishes a microbatch, and whether this device applies
    its stage to a real microbatch at all."""
    v = interleave
    vs = v * n_stages
    tprime = tick_i - stage_idx
    r = tprime % vs
    j = min(max(r // n_stages, 0), v - 1)
    active = 0 <= tprime < v * n_mb
    m = min(max((tprime // vs) * n_stages + tprime % n_stages, 0), n_mb - 1)
    injecting = stage_idx == 0 and r < n_stages
    producing = active and stage_idx == n_stages - 1 and j == v - 1
    return m, j, injecting, producing, active


def _validate_pipe(model, n_stages: int, tp: int = 1, sp: int = 1,
                   interleave: int = 1) -> Tuple[int, int]:
    """The JAX package's checks of a pipeline layout, with its messages
    and exception types (the pipe, tensor and seq sizes in the place of
    its mesh)."""
    c = model.cfg
    if n_stages < 2:
        raise ValueError("pipeline needs mesh axis 'pipe' > 1; use the plain "
                         "spmd/data_parallel step otherwise")
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if c.n_layers % (n_stages * interleave):
        raise ValueError(f"n_layers={c.n_layers} not divisible by "
                         f"{interleave} x {n_stages} virtual stages")
    if c.attention in SEQ_SHARDED_IMPLS:
        if sp < 2:
            raise NotImplementedError(
                f"the pipeline path runs seq-sharded attention="
                f"{c.attention!r} only with a 'seq' mesh axis > 1 "
                f"(PP x SP); without it use dense or flash on the "
                f"unsharded sequence")
        if c.attention == "ulysses" and tp > 1:
            validate_ulysses_under_tp(c.n_heads, tp, sp)
    elif sp > 1:
        raise ValueError(
            f"mesh 'seq'={sp} but attention={c.attention!r} is "
            f"not seq-sharded; pick one of the ring/striped/ulysses impls "
            f"or drop the seq axis")
    elif c.attention not in ("dense", "dense_blockwise", "flash", "auto"):
        raise NotImplementedError(
            f"unknown/unwired attention={c.attention!r} on the pipeline "
            f"path (dense, flash, or a seq-sharded impl with a "
            f"'seq' mesh axis)")
    if tp > 1:
        megatron.validate_tp(c, tp)
    return n_stages, tp


# ---------------------------------------------------------------------------
# pipe groups
# ---------------------------------------------------------------------------

class LocalPipeGroup:
    """All ``size`` pipeline stages in this process."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"pipe group size must be >= 1, got {size}")
        self.size = size
        self.rank = 0
        self.ranks = tuple(range(size))

    def hop(self, token, sent: Dict[int, torch.Tensor], receivers, like):
        """Each stage's output handed to the next stage."""
        return token, {(d + 1) % self.size: y for d, y in sent.items()}

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _Hop(torch.autograd.Function):
    """Forward: this rank's output to the next stage, the previous
    stage's output received.  Backward: the received tensor's gradient
    back to the previous stage, the sent tensor's gradient received from
    the next.  ``token`` passes through, threading the hops in order."""

    @staticmethod
    def forward(ctx, group, recv_like, token, *sent):
        ctx.group = group
        ctx.recv = recv_like is not None
        ctx.sent_like = ((sent[0].shape, sent[0].dtype, sent[0].device)
                         if sent else None)
        got = group.exchange(sent[0] if sent else None, recv_like,
                             forward=True)
        return (token.clone(),) + ((got,) if ctx.recv else ())

    @staticmethod
    def backward(ctx, grad_token, *grads):
        back = ctx.group.exchange(grads[0] if ctx.recv else None,
                                  ctx.sent_like, forward=False)
        return (None, None, grad_token) + (
            (back,) if ctx.sent_like is not None else ())


class ProcessPipeGroup:
    """One pipeline stage per rank of the process group ``pg``."""

    def __init__(self, pg):
        self.pg = pg
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.ranks = (self.rank,)
        self._next = dist.get_global_rank(pg, (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(pg, (self.rank - 1) % self.size)
        # a collective first: NCCL's batched point-to-point calls may then
        # involve a subset of the group
        dist.barrier(group=pg)

    def hop(self, token, sent: Dict[int, torch.Tensor], receivers, like):
        """This rank's output (when it sends) to the next stage, and the
        previous stage's (when it receives)."""
        y = sent.get(self.rank)
        recv = self.rank in receivers
        if y is None and not recv:
            return token, {}
        outs = _Hop.apply(self, like if recv else None, token,
                          *([] if y is None else [y]))
        return outs[0], ({self.rank: outs[1]} if recv else {})

    def exchange(self, send: Optional[torch.Tensor], recv_like,
                 forward: bool) -> Optional[torch.Tensor]:
        """Send ``send`` one way round the ring and receive a tensor like
        ``recv_like`` (shape, dtype, device) from the other side."""
        to, frm = ((self._next, self._prev) if forward
                   else (self._prev, self._next))
        ops, buf = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), to,
                                  self.pg))
        if recv_like is not None:
            shape, dtype, device = recv_like
            buf = torch.empty(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, buf, frm, self.pg))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return buf

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.pg)
        return x


# ---------------------------------------------------------------------------
# the schedule over the stages this process holds
# ---------------------------------------------------------------------------

class PipelineModel:
    """``model`` run by the ring schedule over ``group``: the loss sum and
    count of a batch (:meth:`fused_loss_sum`, the hook the data-parallel
    step calls) and the eval sums (:meth:`eval_sums`).

    ``n_microbatches`` (default the stage count) splits this rank's rows;
    a batch they do not divide is padded with mask-0 rows.
    ``tensor_group``: the stages' Megatron blocks
    (``megatron.tp_block_apply``, qkv columns stored permuted); the
    sequence-sharded attentions run over the model's sequence group.
    ``layout``: the params' ``tensor_parallel.StateLayout`` (sliced under
    process groups); by default, on the first call, every leaf whole.
    ``loss_name``: the eval sums' loss."""

    def __init__(self, model, group, n_microbatches: Optional[int] = None,
                 interleave: int = 1, tensor_group=None, layout=None,
                 loss_name: str = "cross_entropy"):
        tp = tensor_group.size if tensor_group is not None else 1
        sp = model.seq_group.size if model.seq_group is not None else 1
        self.n_stages, _ = _validate_pipe(model, group.size, tp, sp,
                                          interleave)
        n_mb = int(n_microbatches or self.n_stages)
        if interleave > 1 and n_mb % self.n_stages:
            raise ValueError(f"interleaved schedule packs microbatches in "
                             f"groups of n_stages={self.n_stages}; "
                             f"n_microbatches={n_mb} does not divide")
        if layout is None and (hasattr(group, "pg")
                               or hasattr(tensor_group, "pg")):
            raise ValueError("a process pipe or tensor group holds sliced "
                             "params: pass their StateLayout")
        self.model, self.group, self.tensor_group = model, group, tensor_group
        self.n_mb, self.interleave, self.layout = n_mb, interleave, layout
        self.schedule = [[_schedule_indices(t, d, self.n_stages, n_mb,
                                            interleave)
                          for d in range(self.n_stages)]
                         for t in range(schedule_ticks(self.n_stages, n_mb,
                                                       interleave))]
        self.loss_name = loss_name
        self._block = self._block_fn(model, tensor_group)

    @property
    def cfg(self):
        return self.model.cfg

    def _layout(self, params: Tree):
        if self.layout is None:
            from .tensor_parallel import state_layout

            self.layout = state_layout(
                self.model, params, self.tensor_group
                or megatron.LocalTensorGroup(1), qkv_order="permuted",
                pipe_group=self.group, interleave=self.interleave)
        return self.layout

    def combine(self, norms: List[torch.Tensor]) -> torch.Tensor:
        """The global norm from the per-leaf norms this rank holds."""
        if self.layout is None:
            return optim_lib.combine_norms(norms)
        return self.layout.combine(norms)

    def _block_fn(self, model, tensor_group):
        """One layer of a stage: the dense model's block, or the Megatron
        block over the tensor group; under ``--remat`` recomputed in the
        backward."""
        c = model.cfg
        if tensor_group is None or tensor_group.size == 1:
            def block(layer, h, positions):
                return model.block(layer, h, positions, model.attend)
        else:
            rope = c.rope_theta if c.pos_encoding == "rope" else None
            sliced = hasattr(tensor_group, "pg")

            def attend(q, k, v):
                return sequence_sharded_attention(
                    c.attention, q, k, v, group=model.seq_group, causal=True,
                    block_q=c.flash_block_q, block_k=c.flash_block_k,
                    rope_theta=rope)

            def block(layer, h, positions):
                shards = megatron.shard_layer(
                    layer, 1 if sliced else tensor_group.size)
                if not sliced:
                    shards = [shards[r] for r in tensor_group.ranks]
                return megatron.tp_block_apply(c, shards, h, tensor_group,
                                               attention_fn=attend)
        if model._remat is not None:
            block = model._remat(block)
        return block

    def _stage_layers(self, blocks: Tree) -> List[List[list]]:
        """``[j][i]``: the layers of chunk ``j`` of the ``i``-th stage held
        here, each leaf unbound once per stack dim (views; the backward
        stacks each leaf's gradient once)."""
        v = self.interleave

        def split(x):
            chunks = [x] if v == 1 else x.unbind(0)
            return [[list(stage.unbind(0)) for stage in chunk.unbind(0)]
                    for chunk in chunks]

        per_leaf = _map(split, blocks)
        first = _leaf_list(per_leaf)[0]
        return [[[_map(lambda s, j=j, i=i, l=l: s[j][i][l], per_leaf)
                  for l in range(len(first[j][i]))]
                 for i in range(len(first[j]))] for j in range(len(first))]

    def _microbatches(self, batch):
        """(ids, targets, mask) split into the step's microbatches, the
        rows padded with mask-0 rows to a multiple of their count."""
        ids, tgts = batch["x"], batch["y"]
        b, t = ids.shape
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones((b,), dtype=torch.float32, device=ids.device)
        pad = (-b) % self.n_mb
        if pad:
            ids = torch.cat([ids, ids.new_zeros((pad, t))])
            tgts = torch.cat([tgts, tgts.new_zeros((pad,)
                                                   + tuple(tgts.shape[1:]))])
            mask = torch.cat([mask, mask.new_zeros((pad,))])
        mb = (b + pad) // self.n_mb
        return (ids.reshape(self.n_mb, mb, t),
                tgts.reshape((self.n_mb, mb) + tuple(tgts.shape[1:])),
                mask.reshape(self.n_mb, mb))

    def _run(self, params: Tree, ids_mb: torch.Tensor, on_output):
        """The schedule over this rank's stages on the microbatches
        ``ids_mb`` (n_mb, mb, t): ``on_output(y, m)`` at each microbatch
        the last stage finishes.  Returns the hop token (None under a
        local group), which the caller ties into its loss."""
        model, c, group = self.model, self.model.cfg, self.group
        self._layout(params)
        _, mb, t = ids_mb.shape
        positions = global_positions(c.attention, model.seq_group, t,
                                     ids_mb.device)
        layers = self._stage_layers(params["blocks"])
        local = {d: i for i, d in enumerate(group.ranks)}
        emb = None
        if 0 in local:      # stage 0 embeds every microbatch once
            emb = model.embed(params, ids_mb.reshape(-1, t),
                              positions).reshape(
                self.n_mb, mb, t, c.d_model).unbind(0)
        like = ((mb, t, c.d_model), c.compute_dtype, ids_mb.device)
        token = None
        if hasattr(group, "pg"):
            # a zero that depends on a param: a hop that only receives is
            # then on the backward's path to the params, and runs
            token = _leaf_list(params["ln_f"])[0].reshape(-1)[0].float() * 0
        acts: Dict[int, torch.Tensor] = {}
        ticks = len(self.schedule)
        for tick, row in enumerate(self.schedule):
            sent = {}
            for d, i in local.items():
                m, j, injecting, producing, active = row[d]
                if not active:
                    continue
                x = emb[m] if injecting else acts.pop(d)
                for layer in layers[j][i]:
                    x = self._block(layer, x, positions)
                if producing:
                    on_output(x, m)
                else:
                    sent[d] = x
            if tick + 1 < ticks:
                receivers = [d for d, s in enumerate(self.schedule[tick + 1])
                             if s[4] and not s[2]]
                token, acts = group.hop(token, sent, receivers, like)
        return token

    def fused_loss_sum(self, loss_name: str):
        """(params, batch) -> (loss_sum, count) of this rank's stages: the
        last stage's head and loss over the microbatches it finishes (the
        model's chunked cross-entropy under ``ce_chunk``), zeros on the
        others."""
        model, c = self.model, self.model.cfg
        base = losses_lib.get(loss_name)
        ce_base, _, smooth = loss_name.partition("@")
        chunked = c.ce_chunk > 0 and ce_base == "cross_entropy"
        smoothing = float(smooth) if smooth else 0.0

        def loss_fn(params, batch):
            ids_mb, tgt_mb, mask_mb = self._microbatches(batch)
            sums = []

            def on_output(y, m):
                if chunked:
                    sums.append(model._chunked_ce_sum(
                        params, model.final_norm(params, y), tgt_mb[m],
                        mask_mb[m], smoothing))
                else:
                    sums.append(base(model.head_logits(params, y),
                                     tgt_mb[m], mask_mb[m]))

            token = self._run(params, ids_mb, on_output)
            zero = torch.zeros((), dtype=torch.float32,
                               device=batch["x"].device)
            s, cnt = zero, zero
            for ls, cn in sums:     # in the microbatches' order, as JAX
                s, cnt = s + ls, cnt + cn
            if token is not None:   # every hop's backward runs, in order
                s = s + token * 0.0
            return s, cnt

        return loss_fn

    @torch.no_grad()
    def eval_sums(self, params: Tree, batch,
                  with_accuracy: bool) -> List[torch.Tensor]:
        """[loss_sum, count(, hits, examples)] of one batch, summed over
        the pipe group (the last stage holds them)."""
        model = self.model
        base = losses_lib.get(self.loss_name)
        ids_mb, tgt_mb, mask_mb = self._microbatches(batch)
        sums: List[List[torch.Tensor]] = []

        def on_output(y, m):
            logits = model.head_logits(params, y)
            vals = list(base(logits, tgt_mb[m], mask_mb[m]))
            if with_accuracy:
                vals += list(losses_lib.accuracy(logits, tgt_mb[m],
                                                 mask_mb[m]))
            sums.append(vals)

        self._run(params, ids_mb, on_output)
        n = 4 if with_accuracy else 2
        out = torch.zeros(n, dtype=torch.float32, device=batch["x"].device)
        for vals in sums:
            out = out + torch.stack([v.float() for v in vals])
        return list(self.group.sum(out).unbind(0))

    def apply(self, params: Tree, x: torch.Tensor):
        raise NotImplementedError(
            "the pipeline model has no whole-batch forward: the train and "
            "eval steps run its schedule (fused_loss_sum, eval_sums)")


def make_pipeline_train_step(model, optimizer, world, group,
                             loss_name: str = "cross_entropy",
                             n_microbatches: Optional[int] = None,
                             grad_clip: float = 0.0, interleave: int = 1,
                             tensor_group=None, layout=None):
    """(state, this rank's batch) -> (state, global mean loss): the ring
    schedule over ``group`` inside ``parallel.data_parallel``'s step (see
    the module docstring).  ``state`` holds the pipeline layout
    (:func:`init_pipeline_params`; this rank's slices under process
    groups, ``layout``); ``grad_clip`` clips by the global norm inside
    the step (do not wrap ``optimizer`` in ``optim.with_clipping``)."""
    pm = PipelineModel(model, group, n_microbatches, interleave,
                       tensor_group, layout)
    if grad_clip > 0:
        optimizer = optim_lib.with_clipping(optimizer, grad_clip, pm.combine)
    return dp.make_train_step(pm, optimizer, world, loss_name=loss_name)


def make_pipeline_eval_step(model, world, group,
                            loss_name: str = "cross_entropy",
                            with_accuracy: bool = False,
                            n_microbatches: Optional[int] = None,
                            interleave: int = 1, tensor_group=None,
                            layout=None):
    """(pipelined params, batch) -> {"loss", "count"[, "accuracy",
    "example_count"]}: the ring schedule forward only, on the params in
    place, as ``data_parallel.make_eval_step``."""
    pm = PipelineModel(model, group, n_microbatches, interleave,
                       tensor_group, layout, loss_name)
    return dp.make_eval_step(pm, world, loss_name=loss_name,
                             with_accuracy=with_accuracy)
