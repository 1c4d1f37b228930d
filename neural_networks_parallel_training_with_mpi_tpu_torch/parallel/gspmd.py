"""The GSPMD train and eval steps (``--tp`` and / or ``--fsdp``, no
``--sp``): the port of the JAX package's ``parallel/gspmd.py``.

The JAX step is written in global view and XLA's partitioner splits it
by ``parallel/tensor_parallel.py``'s specs.  The port computes the same
numbers with the split written out: the model's forward runs as
``tensor_parallel.TensorParallelModel`` (Megatron blocks over the tensor
group, each shard on whole heads; the head column-split and gathered;
an MLP's Linears alternating column / row; every fsdp-split leaf
all-gathered over the fsdp group where it is used, one block at a time),
inside the data-parallel step of ``parallel.data_parallel``.  So the loss
is the exact masked global-batch mean over the data x fsdp rows, and
``accum_steps``, the guard, ``--grad_clip`` (``optim.with_clipping``),
the telemetry metrics, ``--matmul_dtype int8|fp8`` (``ops.qmm``'s
tensor-parallel seam) and the CUDA-graph dispatch (``GraphedTrainStep``)
run as they run under data parallelism.

The state is the ``layout``'s (``tensor_parallel.StateLayout``): under
process groups each rank holds only its tensor / fsdp slice of every
split leaf, params and optimizer slots alike (under a local fsdp group,
one card, every fsdp slice, stacked), and
``update_sharding="sharded"`` splits the optimizer state further over
the data ranks (JAX's ``gspmd_opt_specs``).  The params keep the dense
qkv column order: a snapshot records ``qkv_tp`` 1, as the JAX GSPMD
trainer's.
"""

from __future__ import annotations

from typing import Optional

from ..ops.optim import Optimizer
from . import data_parallel as dp
from .distributed import BatchGroup, World
from .tensor_parallel import StateLayout, TensorParallelModel


def _batch(world: World) -> Optional[BatchGroup]:
    """The batch ranks of JAX's global-view scales (None: one process)."""
    return BatchGroup(world) if world.initialized else None


def make_gspmd_train_step(model, optimizer: Optimizer, world: World, group,
                          loss_name: str = "mse", accum_steps: int = 1,
                          with_metrics: bool = False,
                          layout: Optional[StateLayout] = None,
                          update_sharding: str = "replicated",
                          grad_clip: float = 0.0):
    """(state, this rank's batch) -> (state, global mean loss), or the
    metrics dict with ``with_metrics``; params in the dense order.
    ``grad_clip`` clips inside the ``sharded`` update (the replicated
    update takes ``optim.with_clipping``)."""
    return dp.make_train_step(
        TensorParallelModel(model, group, layout=layout,
                            batch_group=_batch(world)), optimizer, world,
        loss_name=loss_name, accum_steps=accum_steps,
        update_sharding=update_sharding, grad_clip=grad_clip,
        with_metrics=with_metrics)


def make_gspmd_eval_step(model, world: World, group, loss_name: str = "mse",
                         with_accuracy: bool = False,
                         layout: Optional[StateLayout] = None):
    """(params, batch) -> {"loss", "count"[, "accuracy",
    "example_count"]}, global means."""
    return dp.make_eval_step(TensorParallelModel(model, group,
                                                 layout=layout,
                                                 batch_group=_batch(world)),
                             world,
                             loss_name=loss_name,
                             with_accuracy=with_accuracy)
