"""The DP x TP train and eval steps (``--tp`` with no ``--sp``): the port
of the JAX package's ``parallel/gspmd.py`` for ``tensor > 1, fsdp == 1``.

The JAX step is written in global view and XLA's partitioner splits it
by ``parallel/tensor_parallel.py``'s specs.  The port computes the same
numbers with the split written out: the model's forward runs as
``tensor_parallel.TensorParallelModel`` (Megatron blocks over the tensor
group, each shard on whole heads: the dense qkv columns taken in
``megatron.qkv_tp_permutation``'s order; the head column-split and
gathered; an MLP's Linears alternating column / row), inside the
data-parallel step of ``parallel.data_parallel``.  So the loss is the
exact masked global-batch mean, the params stay in the dense column
order (a snapshot records ``qkv_tp`` 1, as the JAX GSPMD trainer's), and
``accum_steps``, the guard, ``--grad_clip`` (``optim.with_clipping``),
the telemetry metrics and the CUDA-graph dispatch (``GraphedTrainStep``)
run as they run under data parallelism.

Every rank holds the whole state (see ``parallel.tensor_parallel``), so
the JAX package's ``shard_state`` and ``shard_batch`` have nothing to
place: the loader's rows are the batch's placement, the same rows on
every tensor rank of a data index.
"""

from __future__ import annotations

from ..ops.optim import Optimizer
from . import data_parallel as dp
from .distributed import World
from .tensor_parallel import TensorParallelModel


def make_gspmd_train_step(model, optimizer: Optimizer, world: World, group,
                          loss_name: str = "mse", accum_steps: int = 1,
                          with_metrics: bool = False):
    """(state, this rank's batch) -> (state, global mean loss), or the
    metrics dict with ``with_metrics``; params in the dense order."""
    return dp.make_train_step(TensorParallelModel(model, group), optimizer,
                              world, loss_name=loss_name,
                              accum_steps=accum_steps,
                              with_metrics=with_metrics)


def make_gspmd_eval_step(model, world: World, group, loss_name: str = "mse",
                         with_accuracy: bool = False):
    """(params, batch) -> {"loss", "count"[, "accuracy",
    "example_count"]}, global means."""
    return dp.make_eval_step(TensorParallelModel(model, group), world,
                             loss_name=loss_name,
                             with_accuracy=with_accuracy)
