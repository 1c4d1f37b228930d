"""Child process of ``tests/test_torch_megatron.py``,
``tests/test_torch_tensor_parallel.py`` and ``tests/test_torch_sp_tp.py``:
one gloo rank, started as

    python tests/torch_tp_child.py RANK SIZE TMPDIR

``TMPDIR/in.pkl`` holds ``{"ops": ..., "jobs": {name: (flags, init)}}``.
``ops`` (2 ranks): inputs of the megatron functions and of ulysses,
run over a ``ProcessTensorGroup`` / ``ProcessSeqGroup`` of the world.
``jobs``: trainer runs of the port's CLI flags (``--tp`` / ``--sp`` x
``--tp`` over the world's ranks, each a ``ProcessTensorGroup`` and, under
``--sp``, a ``ProcessSeqGroup``) from the JAX init ``init``; each rank
writes its losses (or metrics) and final params to
``TMPDIR/out<RANK>.pkl``.  The flags are shared with the tests, which run
the same jobs through the JAX Trainer.
"""

import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LM = ["--dataset", "lm", "--no-full-batch", "--batch_size", "4",
      "--nepochs", "2", "--n_samples", "8", "--seq_len", "32",
      "--vocab_size", "64", "--n_layers", "2", "--d_model", "32",
      "--n_heads", "4", "--d_ff", "64", "--optimizer", "sgd", "--lr", "0.1",
      "--momentum", "0.9"]
# the transformer variants of the DP x TP runs
VARIANTS = {"mha": [], "gqa": ["--n_kv_heads", "2"],
            "swiglu": ["--ffn_activation", "swiglu"],
            "rope": ["--pos_encoding", "rope"]}
# the MLP of Megatron's alternating rules: digits, 64 -> 64 -> 32 -> 10
MLP = ["--dataset", "digits", "--no-full-batch", "--batch_size", "64",
       "--nepochs", "1", "--optimizer", "adam", "--lr", "0.003"]
MLP_STEPS = 4


def lm_flags(variant="mha", *extra):
    return LM + VARIANTS[variant] + list(extra)


def set_init(trainer, init):
    """The trainer's state from the JAX init (a host tree of the global
    params): this rank's slices of it under a sliced layout."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        rank_state_from_jax,
    )

    trainer.state, trainer.layout = rank_state_from_jax(trainer, init)


def run(trainer, init, max_steps=None):
    """Every step of the trainer's epochs (at most ``max_steps``) from the
    JAX init: (per-step losses, or metrics dicts, and the final global
    params as numpy)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        tree_to_numpy,
    )

    set_init(trainer, init)
    outs = []
    for epoch in range(trainer.cfg.nepochs):
        for batch in trainer.loader.epoch(epoch):
            if max_steps is not None and len(outs) == max_steps:
                break
            trainer.state, out = trainer.train_step(trainer.state, batch)
            outs.append({k: float(v) for k, v in out.items()}
                        if isinstance(out, dict) else float(out))
    return outs, tree_to_numpy(trainer.whole_params())


def ops(inputs):
    """The megatron functions and ulysses over this world's 2 ranks."""
    import torch
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        megatron, sequence,
    )

    world = dist.group.WORLD
    group = megatron.ProcessTensorGroup(world)
    r = group.rank
    out = {}
    # f / g: forward values and the input's gradient
    x = torch.tensor(inputs["x"], requires_grad=True)
    w = torch.tensor(inputs["w"][r])
    y = group.g([group.f(x) @ w])
    (y * torch.tensor(inputs["ct"])).sum().backward()
    out["fg"] = (y.detach().numpy(), x.grad.numpy())
    # the vocab-parallel functions over this rank's shard
    table = torch.tensor(inputs["table"]).chunk(2, 0)[r].clone() \
        .requires_grad_()
    head = torch.tensor(inputs["head"]).chunk(2, 1)[r].clone() \
        .requires_grad_()
    h = torch.tensor(inputs["h"], requires_grad=True)
    ids = torch.tensor(inputs["ids"])
    tgt = torch.tensor(inputs["tgt"])
    mask = torch.tensor(inputs["mask"])
    emb = megatron.vocab_parallel_embed([table], ids, group)
    logits = megatron.vocab_parallel_logits(h, [head], group)
    s, c = megatron.vocab_parallel_cross_entropy(logits, tgt, mask, group)
    hs, hc = megatron.vocab_parallel_accuracy(logits, tgt, mask, group)
    (s + (emb * torch.tensor(inputs["emb_ct"])).sum()).backward()
    s = s.detach()
    out["vocab"] = dict(emb=emb.detach().numpy(), s=float(s), c=float(c),
                        hs=float(hs), hc=float(hc), table=table.grad.numpy(),
                        head=head.grad.numpy(), h=h.grad.numpy())
    # ulysses over a ProcessSeqGroup: this rank's sequence shard
    seq = sequence.ProcessSeqGroup(world)
    for causal in (True, False):
        q, k, v = (torch.tensor(a).chunk(2, dim=1)[r].contiguous()
                   .requires_grad_() for a in inputs["qkv"])
        o = sequence.ulysses_attention(q, k, v, seq, causal=causal)
        do = torch.tensor(inputs["do"]).chunk(2, dim=1)[r]
        (o * do).sum().backward()
        out[f"ulysses_{causal}"] = (o.detach().numpy(), q.grad.numpy(),
                                    k.grad.numpy(), v.grad.numpy())
    return out


def spawn(tmp, size, spec, timeout=240):
    """Run ``size`` gloo ranks of this script on ``spec`` (see the module
    docstring) and return each rank's outputs."""
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


def main():
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        ProcessTensorGroup,
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
    if spec.get("ops") is not None:
        out["ops"] = ops(spec["ops"])
    for name, (flags, init, max_steps) in spec.get("jobs", {}).items():
        trainer = Trainer(config_from_args(build_argparser().parse_args(
            flags)), device="cpu")
        assert isinstance(trainer.tensor_group, ProcessTensorGroup)
        out[name] = run(trainer, init, max_steps)
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
