"""Child process of ``tests/test_torch_pipeline.py``: one gloo rank,
started as

    python tests/torch_pipeline_child.py RANK SIZE TMPDIR

``TMPDIR/in.pkl`` holds ``{"jobs": {name: flags}}``: trainer runs of the
port's CLI flags over the world's ranks (``--pp`` a
``parallel.pipeline.ProcessPipeGroup``, ``--tp`` a ``ProcessTensorGroup``),
each from the trainer's own seeded init; each rank writes every job's
per-step losses and final global params (the stacked pipeline layout,
gathered over the stages) to ``TMPDIR/out<RANK>.pkl``.  A job with
``--checkpoint_dir`` runs ``Trainer.fit`` instead (its final snapshot
gathered to rank 0; under ``--resume`` restored and sliced for each rank
first) and reports the final loss alone.  The test runs the same flags
over a ``LocalPipeGroup`` in its own process.
"""

import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(trainer):
    """Every step of the trainer's epochs from its seeded init: (per-step
    losses, the final global params as numpy); with a checkpoint
    directory, ``fit`` ([final loss], the final global params)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        tree_to_numpy,
    )

    if trainer.cfg.checkpoint_dir:
        result = trainer.fit()
        return [result["final_loss"]], tree_to_numpy(trainer.whole_params())
    trainer.init_state()
    losses = []
    for epoch in range(trainer.cfg.nepochs):
        for batch in trainer.loader.epoch(epoch):
            trainer.state, loss = trainer.train_step(trainer.state, batch)
            losses.append(float(loss))
    return losses, tree_to_numpy(trainer.whole_params())


def spawn(tmp, size, jobs, timeout=240):
    """Run ``size`` gloo ranks of this script on ``jobs`` and return each
    rank's outputs."""
    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump({"jobs": jobs}, f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(size),
         str(tmp)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(size)]
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-4000:]
    outs = []
    for r in range(size):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def main():
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.pipeline import (  # noqa: E501
        ProcessPipeGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )

    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store",
                                                         size),
                            rank=rank, world_size=size)
    with open(tmp + "/in.pkl", "rb") as f:
        spec = pickle.load(f)
    out = {}
    for name, flags in spec["jobs"].items():
        trainer = Trainer(config_from_args(build_argparser().parse_args(
            flags)), device="cpu")
        assert isinstance(trainer.pipe_group, ProcessPipeGroup)
        out[name] = run(trainer)
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
