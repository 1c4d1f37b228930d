"""Child process of ``tests/test_torch_collectives.py`` and
``tests/test_torch_expert.py``: one gloo rank, started as

    python tests/torch_expert_child.py RANK SIZE TMPDIR

``TMPDIR/in.pkl`` holds ``{"collectives": inputs or None, "jobs": {name:
(flags, init, max_steps)}}``.  ``collectives``: each case of
``tests/test_collectives.py`` run over the world as one process group
(``ProcessExpertGroup``), plus the all-to-all's gradient.  ``jobs``:
trainer runs of the port's CLI flags over the world's ranks (``--ep`` a
``ProcessExpertGroup``, with ``--sp`` / ``--tp`` their process groups)
from the JAX init ``init``; each rank writes its step outputs and the
final global params (and, for a job named ``*state``, its own held
slices, after which it writes the final snapshot) to
``TMPDIR/out<RANK>.pkl``.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tp_child import ROOT, run  # noqa: E402

LM = ["--dataset", "lm", "--no-full-batch", "--batch_size", "8",
      "--nepochs", "1", "--n_samples", "24", "--seq_len", "16",
      "--vocab_size", "64", "--n_layers", "2", "--d_model", "32",
      "--n_heads", "4", "--d_ff", "64", "--optimizer", "sgd", "--lr", "0.1",
      "--momentum", "0.9", "--moe_experts", "4", "--attention", "dense"]


def moe_flags(*extra):
    """The MoE LM job; ``extra`` sets the layout (a later
    ``--attention`` wins)."""
    return LM + list(extra)


def collectives(inputs):
    """Every case of tests/test_collectives.py over this world's ranks."""
    import torch

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        collectives as coll,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.expert import (  # noqa: E501
        ProcessExpertGroup,
    )
    import torch.distributed as dist

    g = ProcessExpertGroup(dist.group.WORLD)
    r = g.rank
    x = [torch.tensor(inputs["x"][r])]
    out = {
        "pmean": coll.pmean(x, g)[0].numpy(),
        "psum": coll.psum([torch.ones(1, 2)], g)[0].numpy(),
        "broadcast": coll.broadcast_from(x, g, src=3)[0].numpy(),
        "ppermute": coll.ppermute_ring(x, g, shift=1)[0].numpy(),
        "all_gather": coll.all_gather(x, g)[0].numpy(),
        "reduce_scatter": coll.reduce_scatter(
            [torch.tensor(inputs["rs"])], g, scatter_axis=1)[0].numpy(),
        "axis_index": coll.axis_index(g),
        "axis_size": coll.axis_size(g),
    }
    a = torch.tensor(inputs["a2a"][r], requires_grad=True)
    (y,) = coll.all_to_all([a], g, split_axis=0, concat_axis=1)
    (y * torch.tensor(inputs["a2a_ct"][r])).sum().backward()
    out["all_to_all"] = (y.detach().numpy(), a.grad.numpy())
    return out


def main():
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        tree_to_numpy,
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
    if spec.get("collectives") is not None:
        out["collectives"] = collectives(spec["collectives"])
    for name, (flags, init, max_steps) in spec.get("jobs", {}).items():
        trainer = Trainer(config_from_args(build_argparser().parse_args(
            flags)), device="cpu")
        out[name] = run(trainer, init, max_steps)
        if name.endswith("state"):
            out[name] += (tree_to_numpy(trainer.state.params),)
            trainer.save(final=True)
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def spawn(tmp, size, spec, timeout=300):
    """``size`` gloo ranks of this script on ``spec``; each rank's
    outputs."""
    import subprocess

    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump(spec, f)
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


if __name__ == "__main__":
    main()
