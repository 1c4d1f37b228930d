"""Child process of ``tests/test_torch_qmm.py``: one gloo rank of the
port's quantized training layouts, started as

    python tests/torch_qmm_child.py RANK SIZE TMPDIR

For each format (int8, fp8) and layout (``dp``: replicated; ``zero1``;
``sharded``; ``dpsp``: ring attention over a ``LocalSeqGroup(2)`` on
every data rank), three Adam steps of the small LM from JAX's init
(``TMPDIR/init.pkl``), each rank on its rows of the global batches
(``TMPDIR/batches.pkl``).  The losses, the params and the fp8 histories
go to ``TMPDIR/out<RANK>.pkl``.  The test runs the same steps in one
process over the whole batches with ``accum_steps = SIZE`` (one
microbatch per rank's rows), which the layouts must equal bit for bit.

    python tests/torch_qmm_child.py sp RANK TMPDIR

is one of 2 ranks of the Trainer under ``--sp 2`` (a ``ProcessSeqGroup``:
the rank holds half of every sequence, so its Linears quantize only
its own rows): for each format, the trainer's flags and JAX's init from
``TMPDIR/sp_in.pkl``, the steps of its loader's epochs, and the losses,
params and fp8 histories to ``TMPDIR/sp_out<RANK>.pkl``.
"""

import pickle
import sys

LAYOUTS = ("dp", "zero1", "sharded", "dpsp")
FORMATS = ("int8", "fp8")
SMALL_LM = dict(vocab_size=64, max_seq_len=32, n_layers=2, d_model=32,
                n_heads=4, d_ff=64)
STEPS = 3


def build(layout, fmt, init, world):
    """(model, train state, step) of one layout, from JAX's
    init; ``world`` is the port's ``World`` (a 1-process one for the
    test's reference run)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        params_from_jax,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (  # noqa: E501
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        optim, qmm,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        data_parallel as dp,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        update_sharding as us,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        LocalSeqGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )

    seq = LocalSeqGroup(2) if layout == "dpsp" else None
    cfg = TransformerConfig(**SMALL_LM, matmul_dtype=fmt,
                            attention="ring" if seq else "dense")
    model = Transformer(cfg, device="cpu", seq_group=seq)
    opt = optim.adam(1e-2)
    params = params_from_jax(init, cfg, "cpu")
    sharding = {"zero1": "zero1", "sharded": "sharded"}.get(layout,
                                                           "replicated")
    accum = 1
    if world.world_size == 1:
        accum = 2           # the reference: one microbatch per rank
    if sharding == "replicated":
        state = TrainState.from_params(params, opt, model)
    else:
        params = TrainState.from_params(params, None).params
        if sharding == "zero1":
            opt_state, _ = dp.zero1_opt_state(opt, params, world)
        else:
            opt_state, _ = us.init_opt_state(
                opt, params, us.plan_updates(params, world.dp), world.dp,
                world.data_rank, world.data_pg)
        state = TrainState(0, params, opt_state, qmm.init_qstate(model))
    step = dp.make_train_step(model, opt, world, loss_name="cross_entropy",
                              update_sharding=sharding, accum_steps=accum)
    return model, state, step


def run(layout, fmt, init, batches, world, rows=None):
    """Losses, params and qstate (numpy) after STEPS steps on ``rows`` of
    each batch (all rows: None)."""
    import torch

    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        tree_to_numpy,
    )

    _, state, step = build(layout, fmt, init, world)
    losses = []
    for b in batches[:STEPS]:
        sl = slice(None) if rows is None else rows
        batch = {"x": torch.tensor(b["x"][sl]).long(),
                 "y": torch.tensor(b["y"][sl]).long(),
                 "mask": torch.tensor(b["mask"][sl])}
        state, loss = step(state, batch)
        losses.append(float(loss))
    return dict(losses=losses, params=tree_to_numpy(state.params),
                qstate=tree_to_numpy(state.qstate))


def main_sp(rank, tmp):
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        params_from_jax, tree_to_numpy,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        ProcessSeqGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )

    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/sp_store",
                                                         2),
                            rank=rank, world_size=2)
    with open(tmp + "/sp_in.pkl", "rb") as f:
        runs = pickle.load(f)
    out = {}
    for fmt, (flags, init) in runs.items():
        trainer = Trainer(config_from_args(build_argparser().parse_args(
            flags)), device="cpu")
        assert isinstance(trainer.seq_group, ProcessSeqGroup)
        assert (trainer.world.seq_rank, trainer.loader.sp) == (rank, 2)
        trainer.state = TrainState.from_params(
            params_from_jax(init, trainer.model.cfg, "cpu"),
            trainer.optimizer, trainer.model)
        losses = []
        for epoch in range(2):
            for batch in trainer.loader.epoch(epoch):
                trainer.state, loss = trainer.train_step(trainer.state,
                                                         batch)
                losses.append(float(loss))
        out[fmt] = dict(losses=losses,
                        params=tree_to_numpy(trainer.state.params),
                        qstate=tree_to_numpy(trainer.state.qstate))
    with open(f"{tmp}/sp_out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def main():
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        world_setup,
    )

    if sys.argv[1] == "sp":
        return main_sp(int(sys.argv[2]), sys.argv[3])
    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", size),
                            rank=rank, world_size=size)
    with open(tmp + "/init.pkl", "rb") as f:
        init = pickle.load(f)
    with open(tmp + "/batches.pkl", "rb") as f:
        batches = pickle.load(f)
    world = world_setup("cpu")
    per = batches[0]["x"].shape[0] // size
    rows = slice(rank * per, (rank + 1) * per)
    out = {(fmt, layout): run(layout, fmt, init, batches, world, rows)
           for fmt in FORMATS for layout in LAYOUTS}
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
