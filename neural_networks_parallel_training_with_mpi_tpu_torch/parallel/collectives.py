"""Collectives over the port's groups, the port of the JAX package's
``parallel/collectives.py``.

Where the JAX functions take a pytree and a mesh axis name and run inside
``shard_map``, these take the values this process holds, one tree per
rank of ``group.ranks``, and return one tree per rank, as the other
parallel modules do (``parallel.megatron``, ``parallel.sequence``):

* a local group (``LocalTensorGroup``, ``LocalSeqGroup``,
  ``parallel.expert.LocalExpertGroup``, ...: all ``size`` ranks in this
  process) takes the list of every rank's tree and computes the
  collective on the list, with no communication;
* a process group (one with a ``pg``: ``ProcessTensorGroup``,
  ``ProcessExpertGroup``, ...) takes a list of this rank's one tree and
  runs ``torch.distributed`` over ``group.pg`` (NCCL on the card, gloo on
  the CPU).

``all_to_all`` is differentiable over a process group (its backward is
the reverse exchange): ``parallel.expert``'s slot exchange and
``parallel.sequence``'s Ulysses exchange ride it.  The others are the
forward collectives the tests and the steps need.
"""

from __future__ import annotations

import functools
from typing import Any, List, Sequence

import torch
import torch.distributed as dist

from ..utils.tree import leaves, unflatten

Tree = Any


def _is_process(group) -> bool:
    return hasattr(group, "pg")


def _per_leaf(fn, trees: Sequence[Tree]) -> List[Tree]:
    """``fn(list of the ranks' values of one leaf) -> list of results``
    over every leaf of the held trees."""
    cols = list(zip(*(leaves(t) for t in trees)))
    outs = [fn(list(col)) for col in cols]
    return [unflatten(t, [o[i] for o in outs]) for i, t in enumerate(trees)]


def _rank_list(group) -> List[int]:
    return list(group.ranks)


def psum(trees: Sequence[Tree], group) -> List[Tree]:
    """The sum over the group, on every rank."""
    def fn(xs):
        if _is_process(group):
            y = xs[0].detach().clone()
            dist.all_reduce(y, group=group.pg)
            return [y]
        total = functools.reduce(torch.add, xs)
        return [total] * len(xs)
    return _per_leaf(fn, trees)


def pmean(trees: Sequence[Tree], group) -> List[Tree]:
    """The mean over the group: the reference's gather, average and send
    round in one collective."""
    return _per_leaf(lambda xs: [x / group.size for x in xs],
                     psum(trees, group))


def all_gather(trees: Sequence[Tree], group, axis_index: int = 0,
               tiled: bool = True) -> List[Tree]:
    """Every rank's value joined along ``axis_index`` in rank order
    (stacked on a new axis there when not ``tiled``)."""
    def join(parts):
        return (torch.cat(parts, dim=axis_index) if tiled
                else torch.stack(parts, dim=axis_index))

    def fn(xs):
        if _is_process(group):
            parts = [torch.empty_like(xs[0]) for _ in range(group.size)]
            dist.all_gather(parts, xs[0].contiguous(), group=group.pg)
            return [join(parts)]
        return [join(xs)] * len(xs)
    return _per_leaf(fn, trees)


def reduce_scatter(trees: Sequence[Tree], group,
                   scatter_axis: int = 0) -> List[Tree]:
    """The sum over the group, of which rank r keeps block r along
    ``scatter_axis``: the building block of ZeRO / fsdp gradients."""
    def fn(xs):
        if _is_process(group):
            x = xs[0].movedim(scatter_axis, 0).contiguous()
            out = x.new_empty((x.shape[0] // group.size,) + x.shape[1:])
            dist.reduce_scatter_tensor(out, x, group=group.pg)
            return [out.movedim(0, scatter_axis)]
        total = functools.reduce(torch.add, xs)
        blocks = total.chunk(group.size, dim=scatter_axis)
        return [blocks[r] for r in _rank_list(group)]
    return _per_leaf(fn, trees)


def broadcast_from(trees: Sequence[Tree], group, src: int = 0
                   ) -> List[Tree]:
    """Rank ``src``'s value on every rank: ``comm.bcast(..., root=0)``."""
    def fn(xs):
        if _is_process(group):
            y = xs[0].detach().clone()
            dist.broadcast(y, dist.get_global_rank(group.pg, src),
                           group=group.pg)
            return [y]
        return [xs[src]] * len(xs)
    return _per_leaf(fn, trees)


def ppermute_ring(trees: Sequence[Tree], group, shift: int = 1
                  ) -> List[Tree]:
    """Rank i's value moves to rank i + ``shift`` (mod size): the ring
    step of the pipeline and of ring attention."""
    n = group.size

    def fn(xs):
        if _is_process(group):
            x = xs[0].contiguous()
            out = torch.empty_like(x)
            me = group.rank
            to = dist.get_global_rank(group.pg, (me + shift) % n)
            frm = dist.get_global_rank(group.pg, (me - shift) % n)
            ops = [dist.P2POp(dist.isend, x, to, group.pg),
                   dist.P2POp(dist.irecv, out, frm, group.pg)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return [out]
        return [xs[(j - shift) % n] for j in range(n)]
    return _per_leaf(fn, trees)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of ``x`` split along ``split_axis`` into
    ``size`` blocks (block j to rank j), the received blocks joined along
    ``concat_axis`` in rank order.  Its backward is the reverse exchange
    (the axes swapped)."""

    @staticmethod
    def forward(ctx, pg, size, split_axis, concat_axis, x):
        ctx.args = (pg, size, split_axis, concat_axis)
        return _exchange(pg, size, split_axis, concat_axis, x)

    @staticmethod
    def backward(ctx, grad):
        pg, size, split_axis, concat_axis = ctx.args
        return (None, None, None, None,
                _exchange(pg, size, concat_axis, split_axis, grad))


def _exchange(pg, size: int, split_axis: int, concat_axis: int,
              x: torch.Tensor) -> torch.Tensor:
    send = torch.stack(x.chunk(size, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=pg)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def all_to_all(trees: Sequence[Tree], group, split_axis: int,
               concat_axis: int) -> List[Tree]:
    """JAX's ``all_to_all(tiled=True)``: each rank splits its value along
    ``split_axis`` into ``size`` blocks and sends block j to rank j; rank
    j joins the blocks it receives along ``concat_axis``, in the senders'
    rank order.  Differentiable over a process group."""
    n = group.size

    def fn(xs):
        if _is_process(group):
            return [_AllToAll.apply(group.pg, n, split_axis, concat_axis,
                                    xs[0])]
        blocks = [x.chunk(n, dim=split_axis) for x in xs]
        return [torch.cat([b[j] for b in blocks], dim=concat_axis)
                for j in range(n)]
    return _per_leaf(fn, trees)


def axis_index(group) -> List[int]:
    """Each held rank's coordinate in the group: the reference's
    ``comm.Get_rank()``."""
    return _rank_list(group)


def axis_size(group) -> int:
    """The group's size: the reference's ``comm.Get_size()``."""
    return group.size
