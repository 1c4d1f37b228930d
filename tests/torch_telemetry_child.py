"""Child process of ``tests/test_torch_telemetry.py``: one gloo rank of
the port's telemetry jobs over 2 ranks (2 data ranks, or 1 data x 2 seq
ranks: a ``ProcessSeqGroup``), started as

    python tests/torch_telemetry_child.py RANK SIZE TMPDIR

Every job starts from JAX's init (``TMPDIR/init.pkl``) and writes its
metrics stream under ``TMPDIR/port_<layout>`` (rank 0 writes).  The job
configs are the test's (``two_rank_job``), built in either package's
config classes.
"""

import pickle
import sys

TWO_RANK_LAYOUTS = {
    "replicated": dict(),
    "zero1": dict(update_sharding="zero1"),
    "sharded": dict(update_sharding="sharded"),
    "sharded_guard": dict(update_sharding="sharded", skip_nonfinite=True,
                          faults="nan@2"),
    "sp2": None,
}


def two_rank_job(pkg, layout, telemetry_dir):
    """The regression MLP at the padded width 65 (its (65, 65) weight
    pads to (66, 65) over 2 ranks) over 2 data ranks, Adam at lr 1e-2;
    ``sp2``: the small LM with ring_flash over 1 data x 2 seq ranks."""
    if layout == "sp2":
        return pkg.TrainConfig(
            nepochs=1, batch_size=4, full_batch=False, shuffle=True,
            lr=3e-3, optimizer="adam", metrics_every=1,
            telemetry_dir=telemetry_dir, loss="cross_entropy",
            data=pkg.DataConfig(dataset="lm", n_samples=8, seq_len=32,
                                vocab_size=64),
            model=pkg.ModelConfig(arch="transformer", n_layers=2,
                                  d_model=32, n_heads=4, d_ff=64,
                                  vocab_size=64, max_seq_len=32,
                                  attention="ring_flash"),
            mesh=pkg.MeshConfig(data=1, seq=2))
    return pkg.TrainConfig(
        nepochs=2, batch_size=8, full_batch=False, shuffle=True, lr=1e-2,
        optimizer="adam", metrics_every=1, telemetry_dir=telemetry_dir,
        data=pkg.DataConfig(dataset="regression", n_samples=32,
                            n_features=8),
        model=pkg.ModelConfig(arch="mlp", in_features=8, hidden=(65, 65),
                              out_features=1),
        mesh=pkg.MeshConfig(data=2), **TWO_RANK_LAYOUTS[layout])


def main():
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch import (
        config as pc,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        params_from_jax, tree_from_jax,
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

    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", size),
                            rank=rank, world_size=size)
    with open(tmp + "/init.pkl", "rb") as f:
        init = pickle.load(f)
    MLP.init = lambda self, gen: tree_from_jax(init["mlp"], "cpu")
    Transformer.init = lambda self, gen: params_from_jax(
        init["lm"], self.cfg, "cpu")
    for layout in TWO_RANK_LAYOUTS:
        Trainer(two_rank_job(pc, layout, f"{tmp}/port_{layout}"),
                device="cpu").fit()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
