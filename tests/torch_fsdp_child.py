"""Child process of the port's ``--fsdp`` / sliced-state tests
(``tests/test_torch_fsdp.py``, ``tests/test_torch_tp_state.py``,
``tests/test_torch_update_sharding.py``, ``tests/test_torch_qmm.py``,
``tests/test_torch_sdc.py``, ``tests/test_torch_elastic.py``): one gloo
rank, started as

    python tests/torch_fsdp_child.py RANK SIZE TMPDIR

``TMPDIR/in.pkl`` holds ``{"jobs": {name: job}}``, each job a dict:

* ``flags``: the port's CLI flags (``--dp`` / ``--fsdp`` / ``--tp`` over
  this world's ranks, each axis a process group);
* ``init``: JAX's global params (a host tree) to start from (a fit's
  resume restores over them), or None for the seeded init;
* ``steps``: at most this many steps (None: every step of the epochs);
* ``fit``: run ``Trainer.fit`` instead (its ``--checkpoint_dir`` /
  ``--resume`` / ``--elastic`` apply) and report its final state;
* ``local``: the tensor and fsdp axes as local groups of this process
  (``LocalTensorGroup``, ``LocalFsdpGroup``), not process groups (the
  pytest process runs such a job itself, with no world).

Each rank writes ``{name: {"outs", "params", "held", "shapes", "qstate",
"fp", "sdc", "layout"}}`` to ``TMPDIR/out<RANK>.pkl``: the per-step
losses (or metrics dicts), the global params gathered from every rank's
slices (numpy), the values this rank holds (``{"params": n, "opt": n}``)
and the shapes of the param leaves it holds, the
fp8 histories, the fingerprint's leaf paths and the SDC policy's
(incidents, healed) (with ``--sdc_check_every``), and the trainer's
layout tag.
"""

import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LM = ["--dataset", "lm", "--no-full-batch", "--batch_size", "8",
      "--nepochs", "1", "--n_samples", "16", "--seq_len", "16",
      "--vocab_size", "64", "--n_layers", "2", "--d_model", "32",
      "--n_heads", "4", "--d_ff", "64", "--optimizer", "sgd", "--lr",
      "0.1", "--momentum", "0.9"]
# JAX's test_gspmd_fsdp_mlp_adam: an MLP (digits: 64 -> 64 -> 32 -> 10)
# with Adam
MLP = ["--dataset", "digits", "--no-full-batch", "--batch_size", "64",
       "--nepochs", "1", "--optimizer", "adam", "--lr", "0.003"]
MLP_STEPS = 3


def run_job(job):
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        rank_state_from_jax, tree_to_numpy,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.fsdp import (  # noqa: E501
        LocalFsdpGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )

    cfg = config_from_args(build_argparser().parse_args(job["flags"]))
    groups = {}
    if job.get("local"):
        if cfg.mesh.fsdp > 1:
            groups["fsdp_group"] = LocalFsdpGroup(cfg.mesh.fsdp)
        if cfg.mesh.tensor > 1:
            groups["tensor_group"] = LocalTensorGroup(cfg.mesh.tensor)
    trainer = Trainer(cfg, device="cpu", **groups)
    outs = []
    if job.get("init") is not None:
        trainer.state, trainer.layout = rank_state_from_jax(trainer,
                                                            job["init"])
    if job.get("fit"):
        trainer.fit()
    else:
        if trainer.state is None:
            trainer.init_state()
        steps = job.get("steps")
        for epoch in range(trainer.cfg.nepochs):
            for batch in trainer.loader.epoch(epoch):
                if steps is not None and len(outs) == steps:
                    break
                trainer.state, out = trainer.train_step(trainer.state, batch)
                outs.append({k: float(v) for k, v in out.items()}
                            if isinstance(out, dict) else float(out))
    s = trainer.state
    return {"outs": outs,
            "params": tree_to_numpy(trainer.whole_params()),
            "held": {"params": sum(x.numel() for x in leaves(s.params)),
                     "opt": sum(x.numel() for x in leaves(s.opt_state)
                                if x.dim())},
            "shapes": [tuple(x.shape) for x in leaves(s.params)],
            "qstate": tree_to_numpy(s.qstate),
            "fp": None if trainer._fp is None else list(trainer._fp.paths),
            "sdc": None if trainer._sdc_policy is None else (
                trainer._sdc_policy.incidents, trainer._sdc_policy.healed),
            "layout": trainer.layout_tag}


def spawn(tmp, size, jobs, timeout=300):
    """Run ``size`` gloo ranks of this script on ``jobs`` (see the module
    docstring) and return each rank's outputs."""
    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump({"jobs": jobs}, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(size),
         str(tmp)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(size)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        errs.append((p.returncode, err))
    for rc, err in errs:
        assert rc == 0, err[-4000:]
    outs = []
    for r in range(size):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def main():
    import torch.distributed as dist

    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store",
                                                         size),
                            rank=rank, world_size=size)
    with open(tmp + "/in.pkl", "rb") as f:
        spec = pickle.load(f)
    out = {name: run_job(job) for name, job in spec["jobs"].items()}
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
