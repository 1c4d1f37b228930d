"""Child process of ``tests/test_torch_update_sharding.py``: one gloo rank
of the port's update-sharding jobs, started as

    python tests/torch_update_sharding_child.py RANK SIZE TMPDIR

With SIZE 2: the replicated, sharded and zero1 jobs (with and without
clipping), the master-weights job, and at the padded width a snapshot of
each sharded layout written and JAX's restored.  With SIZE 4: the DP x SP
job.  Every run starts from JAX's init (``TMPDIR/init.pkl``); the results
go to ``TMPDIR/out<RANK>.pkl``.  The job configs are shared with the test,
which builds the same jobs in the JAX package's config classes.
"""

import json
import pickle
import sys

# the padded width: its (65, 65) slots pad to (66, 65) over 2 ranks
PAD_HIDDEN = 65
LAYOUTS = ("sharded", "zero1", "master")


def job(pkg, update_sharding, optimizer="adam", hidden=64, data=2, **kw):
    """JAX's ``tests/test_update_sharding.py`` job (regression MLP, lr
    1e-4) over 2 data ranks, in either package's config classes;
    ``update_sharding="master"``: sharded with bf16 params and master
    weights."""
    if update_sharding == "master":
        update_sharding = "sharded"
        kw.update(param_dtype="bfloat16", master_weights=True)
    return pkg.TrainConfig(
        nepochs=2, batch_size=16, full_batch=False, shuffle=False, lr=1e-4,
        optimizer=optimizer, update_sharding=update_sharding,
        data=pkg.DataConfig(dataset="regression", n_samples=64,
                            n_features=8),
        model=pkg.ModelConfig(arch="mlp", in_features=8,
                              hidden=(hidden, hidden), out_features=1),
        mesh=pkg.MeshConfig(data=data), **kw)


def lm_job(pkg, update_sharding, **kw):
    """JAX's DP x SP job: the small LM with ring attention over 2 data x
    2 seq ranks."""
    return pkg.TrainConfig(
        nepochs=1, batch_size=8, full_batch=False, shuffle=False, lr=1e-3,
        optimizer="adam", update_sharding=update_sharding,
        loss="cross_entropy",
        data=pkg.DataConfig(dataset="lm", n_samples=32, seq_len=32,
                            vocab_size=64),
        model=pkg.ModelConfig(arch="transformer", n_layers=2, d_model=32,
                              n_heads=4, d_ff=64, vocab_size=64,
                              max_seq_len=32, attention="ring"),
        mesh=pkg.MeshConfig(data=2, seq=2), **kw)



def main():
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch import (
        config as pc,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        params_from_jax, tree_from_jax, tree_to_numpy,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.mlp import (
        MLP,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
        Transformer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
        Trainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        checkpoint as ckpt,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        update_sharding as us,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (
        TrainState,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (
        leaves, unflatten,
    )

    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", size),
                            rank=rank, world_size=size)
    with open(tmp + "/init.pkl", "rb") as f:
        init = pickle.load(f)
    # the frameworks' random streams differ: every run starts from JAX's
    MLP.init = lambda self, gen: tree_from_jax(init[self.hidden[0]], "cpu",
                                               self.param_dtype)
    Transformer.init = lambda self, gen: params_from_jax(
        init["lm"], self.cfg, "cpu")

    def host(state):
        return [a for _, a, _ in ckpt.host_state(state)]

    def global_opt(t):
        """The global padded opt state on every rank: this rank's slices
        joined over the data ranks (the snapshot goes to rank 0 only)."""
        lay, opt = t.layout, t.state.opt_state
        if lay is None:
            return opt
        return unflatten(opt, [
            x if a is None else us.all_gather(x, a, lay.n, lay.group)
            for x, a in zip(leaves(opt), lay.axes)])

    def global_state(t):
        return TrainState(t.state.step, t.state.params, global_opt(t))

    def shapes(tree):
        """The shapes of the leaves that hold values per element (not the
        optimizer's 0-d count, which every rank holds whole)."""
        return [tuple(x.shape) for x in leaves(tree) if x.dim()]

    out = {}
    if size == 4:       # DP x SP
        t = Trainer(lm_job(pc, "sharded"), device="cpu")
        r = t.fit()
        out["dpsp"] = (r["final_loss"], tree_to_numpy(t.state.params))
    else:
        for layout in ("replicated", "sharded", "zero1"):
            t = Trainer(job(pc, layout), device="cpu")
            t.init_state()
            local = shapes(t.state.opt_state)
            glob = shapes(global_opt(t))
            r = t.fit()
            out[layout] = dict(loss=r["final_loss"], local=local, glob=glob,
                               params=tree_to_numpy(t.state.params))
            t = Trainer(job(pc, layout, optimizer="sgd", grad_clip=1e-3),
                        device="cpu")
            r = t.fit()
            out["clip_" + layout] = (r["final_loss"],
                                     tree_to_numpy(t.state.params))
        t = Trainer(job(pc, "master"), device="cpu")
        r = t.fit()
        master = global_opt(t).master
        out["master"] = dict(
            loss=r["final_loss"], local=shapes(t.state.opt_state.master),
            dtypes=sorted({str(p.dtype) for p in leaves(t.state.params)}),
            master_dtypes=sorted({str(m.dtype) for m in leaves(master)}),
            equal=all(p.equal(m[tuple(slice(0, s) for s in p.shape)].to(
                p.dtype)) for p, m in zip(leaves(t.state.params),
                                           leaves(master))))
        for layout in LAYOUTS:
            # the port writes a snapshot at the padded width ...
            d = f"{tmp}/port_{layout}"
            t = Trainer(job(pc, layout, hidden=PAD_HIDDEN, checkpoint_dir=d),
                        device="cpu")
            r = t.fit()
            # what a save writes: the global arrays on rank 0's host, and
            # nothing on the other rank
            snap = t.snapshot_state()
            written = host(snap) if rank == 0 else snap.opt_state
            with open(f"{d}/ckpt-{r['steps']}/meta.json") as f:
                meta = json.load(f)
            # ... and restores the JAX package's
            t = Trainer(job(pc, layout, hidden=PAD_HIDDEN, resume=True,
                            checkpoint_dir=f"{tmp}/jax_{layout}"),
                        device="cpu")
            t.init_state()
            step = t.maybe_resume()
            out["ckpt_" + layout] = dict(
                written=written, step=step, restored=host(global_state(t)),
                local=shapes(t.state.opt_state),
                glob=shapes(global_opt(t)),
                params=shapes(t.state.params), meta=meta)
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
