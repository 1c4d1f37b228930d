"""Fully-sharded data parallelism (``--fsdp``): the fsdp groups and the
gather of a sliced leaf where it is used, the counterpart of the JAX
package's ``fsdp`` mesh axis on the GSPMD path (``parallel/gspmd.py``,
``parallel/tensor_parallel.py``'s rules), where XLA inserts these
collectives itself.

A leaf the rules split on an fsdp dim is held as F slices of that dim.
Under a process group (:class:`ProcessFsdpGroup`, one per (data, tensor)
index over its F ranks) each rank holds its slice; the forward
all-gathers it where it is used, one transformer block at a time
(:meth:`ProcessFsdpGroup.gather`, an ``autograd.Function``), and the
backward reduce-scatters the gathered leaf's gradient over the same
group: each rank is left with its slice of the gradient summed over the
F ranks' batch rows, which the data ranks then all-reduce among
themselves (``parallel.data_parallel``).

Under a local group (:class:`LocalFsdpGroup`, every slice in one process:
one card) the F slices of a leaf are held side by side, stacked on a new
leading dim in rank order.  The gather is their concatenation, and its
backward splits the gradient of the whole batch, which this process
holds, back into the F slices: the reduce-scatter's sum is already taken.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

Tree = Any


def all_gather_dim(part: torch.Tensor, dim: int, pg, n: int
                   ) -> torch.Tensor:
    """The group's slices joined along ``dim`` in rank order."""
    x = part.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=pg)
    return out.movedim(0, dim)


def reduce_scatter_dim(full: torch.Tensor, dim: int, pg, n: int
                       ) -> torch.Tensor:
    """The sum over the group of ``full``, this rank's slice along
    ``dim``."""
    x = full.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=pg)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """All-gather over the fsdp group forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, group, dim, part):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(part, dim, group.pg, group.size)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return None, None, reduce_scatter_dim(grad, ctx.dim, g.pg, g.size)


class ProcessFsdpGroup:
    """One fsdp slice per rank of the process group ``pg``."""

    def __init__(self, pg):
        self.pg = pg
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)

    def slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of the whole leaf ``x`` (split on ``dim``)."""
        return x.chunk(self.size, dim)[self.rank]

    def gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from this rank's slice ``part``; its gradient
        comes back reduce-scattered."""
        return _Gather.apply(self, dim, part)

    def whole(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from every rank's slice (no gradient)."""
        return all_gather_dim(part, dim, self.pg, self.size)


class LocalFsdpGroup:
    """Every one of ``size`` fsdp slices in this process, stacked."""

    pg = None

    def __init__(self, size: int):
        if size < 2:
            raise ValueError(f"a local fsdp group needs >= 2 slices, got "
                             f"{size}")
        self.size = size

    def slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ``size`` slices of the whole leaf ``x`` (split on ``dim``),
        stacked on a new leading dim."""
        return torch.stack(x.chunk(self.size, dim))

    def gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from the stacked slices ``part``; its gradient
        comes back split into them."""
        return torch.cat(part.unbind(0), dim)

    whole = gather
