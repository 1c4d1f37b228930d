"""Child process of ``tests/test_torch_pipeline_expert.py``: one gloo
rank of a pipe x expert world, started as

    python tests/torch_pipeline_expert_child.py RANK SIZE TMPDIR

``TMPDIR/in.pkl`` holds ``{"flags": the port's CLI flags, "steps": N}``
(``--pp`` x ``--ep`` over the world's ranks: a ``ProcessPipeGroup`` and a
``ProcessExpertGroup``).  Each rank trains N steps from the seeded init,
saves the final snapshot (rank 0 writes it) and writes (its losses, the
global params gathered from every rank, its own held params) to
``TMPDIR/out<RANK>.pkl``.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_expert_child import spawn as _spawn  # noqa: E402


def main():
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        tree_to_numpy,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.expert import (  # noqa: E501
        ProcessExpertGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.pipeline import (  # noqa: E501
        ProcessPipeGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        checkpoint as ckpt,
    )

    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store",
                                                         size),
                            rank=rank, world_size=size)
    with open(tmp + "/in.pkl", "rb") as f:
        spec = pickle.load(f)
    trainer = Trainer(config_from_args(build_argparser().parse_args(
        spec["flags"])), device="cpu")
    assert isinstance(trainer.pipe_group, ProcessPipeGroup)
    assert isinstance(trainer.expert_group, ProcessExpertGroup)
    trainer.init_state()
    losses = []
    for batch in list(trainer.loader.epoch(0))[:spec["steps"]]:
        trainer.state, loss = trainer.train_step(trainer.state, batch)
        losses.append(float(loss))
    out = (losses, tree_to_numpy(trainer.whole_params()),
           tree_to_numpy(trainer.state.params))
    trainer.save(final=True)
    ckpt.wait_pending()
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def spawn(tmp, size, spec, timeout=300):
    """``size`` gloo ranks of this script on ``spec``; each rank's
    outputs."""
    return _spawn(tmp, size, spec, timeout, script=os.path.abspath(__file__))


if __name__ == "__main__":
    main()
