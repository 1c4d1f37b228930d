"""Child process of ``tests/test_torch_sdc.py`` and
``tests/test_torch_elastic.py``: one gloo rank, started as

    python tests/torch_sdc_child.py SUITE RANK SIZE TMPDIR

``sdc`` (4 ranks, ``LOCAL_WORLD_SIZE=4``: one node of 4 replicas, the
counterpart of JAX's mesh of 4 host devices): the replica-consistency jobs
of ``sdc_job`` one after another in one process group.  ``elastic_save``
(2 ranks): the zero1 and ``sharded`` jobs at the padded width train and
write their snapshots; ``elastic_grow`` (2 ranks): the same jobs resume a
1-rank snapshot with ``--elastic`` and write it again.  Results go to
``TMPDIR/<SUITE>_out<RANK>.pkl``.
"""

import dataclasses
import json
import os
import pickle
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_update_sharding_child import PAD_HIDDEN, job  # noqa: E402

# name -> (TrainConfig keywords, LOCAL_WORLD_SIZE); the JAX package's
# tests/test_sdc.py jobs with shard indices that fit 4 ranks
SDC_JOBS = {
    "bitflip": (dict(nepochs=3, sdc_check_every=1, telemetry=True,
                     faults="bitflip@5?shard=3&bit=9"), 4),
    "clean": (dict(nepochs=3, sdc_check_every=1), 4),
    "desync": (dict(nepochs=3, sdc_check_every=1,
                    faults="desync@6?eps=0.01&shard=3"), 4),
    "det": (dict(sdc_check_every=1, telemetry=True,
                 faults="desync@4?det&eps=0.001"), 4),
    "strikes": (dict(nepochs=3, sdc_check_every=1, sdc_strikes=2,
                     faults="bitflip@4?shard=3&bit=9,"
                            "bitflip@10?shard=3&bit=9"), 4),
    "nosnap": (dict(nepochs=2, sdc_check_every=1, sdc_strikes=1,
                    checkpoint=True, checkpoint_every=1,
                    faults="bitflip@7?shard=2&bit=9"), 4),
    "legacy": (dict(check_replicas_every=1,
                    faults="bitflip@4?shard=2&bit=9"), 4),
    "off": (dict(lr=1e-2), 4),
    "on": (dict(lr=1e-2, sdc_check_every=1, telemetry=True), 4),
    "zero1": (dict(nepochs=3, sdc_check_every=1, update_sharding="zero1",
                   faults="bitflip@5?shard=3&bit=9"), 4),
    "sharded": (dict(nepochs=3, sdc_check_every=1, optimizer="adam",
                     update_sharding="sharded",
                     faults="bitflip@5?shard=1&bit=9"), 4),
    # two nodes of 2: ranks 2 and 3 (node 1) flip the same bit alike, so
    # node 1 agrees with itself and not with node 0
    "cross": (dict(nepochs=2, sdc_check_every=1, checkpoint=True,
                   checkpoint_every=2, telemetry=True,
                   faults="bitflip@5?shard=2&bit=9&max=1,"
                          "bitflip@5?shard=3&bit=9&max=1"), 2),
    "dpsp": (dict(lm=True, sdc_check_every=1,
                  faults="bitflip@2?shard=1&bit=9"), 4),
}


def sdc_job(pkg, name, tmp=None):
    """The job ``name`` of :data:`SDC_JOBS` in either package's config
    classes: JAX's ``_cfg`` (the regression MLP, 64 samples, batch 8, lr
    1e-3, momentum 0.9) over 4 data ranks; ``dpsp``: the small LM with
    ring attention over 2 data x 2 seq ranks."""
    kw = dict(SDC_JOBS[name][0])
    if kw.pop("telemetry", False):
        kw["telemetry_dir"] = f"{tmp}/telem_{name}"
    if kw.pop("checkpoint", False):
        kw["checkpoint_dir"] = f"{tmp}/ckpt_{name}"
    if kw.pop("lm", False):
        return pkg.TrainConfig(
            nepochs=1, batch_size=8, full_batch=False, shuffle=False,
            lr=1e-3, optimizer="adam", loss="cross_entropy",
            data=pkg.DataConfig(dataset="lm", n_samples=32, seq_len=32,
                                vocab_size=64),
            model=pkg.ModelConfig(arch="transformer", n_layers=2,
                                  d_model=32, n_heads=4, d_ff=64,
                                  vocab_size=64, max_seq_len=32,
                                  attention="ring"),
            mesh=pkg.MeshConfig(data=2, seq=2), **kw)
    base = dict(nepochs=2, full_batch=False, batch_size=8, lr=1e-3,
                momentum=0.9, data=pkg.DataConfig(n_samples=64),
                mesh=pkg.MeshConfig(data=4))
    base.update(kw)
    return pkg.TrainConfig(**base)


def elastic_job(pkg, layout, ckpt_dir, data, nepochs=1, **kw):
    """The update-sharding job at the padded width over ``data`` ranks,
    writing its snapshot at the end (one epoch: 4 steps)."""
    return dataclasses.replace(
        job(pkg, layout, hidden=PAD_HIDDEN, data=data,
            checkpoint_dir=ckpt_dir, **kw), nepochs=nepochs)


def _records(d):
    path = os.path.join(d, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def run_sdc(pc, tmp, rank):
    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        tree_to_numpy,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
        Trainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        checkpoint as ckpt,
        consistency,
    )

    out = {}
    for name, (_, local) in SDC_JOBS.items():
        os.environ["LOCAL_WORLD_SIZE"] = str(local)
        cfg = sdc_job(pc, name, tmp)
        t = Trainer(cfg, device="cpu")
        res = {"error": None}
        try:
            r = t.fit()
            res.update(final_loss=r["final_loss"],
                       incidents=r.get("sdc_incidents"),
                       healed=r.get("sdc_healed"))
        except Exception as e:  # noqa: BLE001 — the test reads it
            res["error"] = (type(e).__name__, str(e))
            if not isinstance(e, (AssertionError, RuntimeError)):
                res["trace"] = traceback.format_exc()
        res["params"] = tree_to_numpy(t.state.params)
        res["diverged"] = consistency.check_replicas(
            t.state, sharded_opt=t.layout is not None)
        res["fp_paths"] = None if t._fp is None else list(t._fp.paths)
        res["rollbacks"] = list(t.rollbacks)
        if t._sdc_policy is not None:
            res["policy"] = (t._sdc_policy.incidents,
                             dict(t._sdc_policy.counts))
        if cfg.telemetry_dir:
            res["records"] = _records(cfg.telemetry_dir)
            pm = os.path.join(cfg.telemetry_dir, "postmortem.json")
            if os.path.exists(pm):
                with open(pm) as f:
                    res["postmortem"] = json.load(f)
        if cfg.checkpoint_dir:
            res["latest"] = ckpt.latest_step(cfg.checkpoint_dir)
        out[name] = res
    return out


def run_elastic(pc, tmp, rank, suite):
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
        Trainer,
    )

    out = {}
    for layout in ("zero1", "sharded"):
        if suite == "elastic_save":
            t = Trainer(elastic_job(pc, layout, f"{tmp}/{layout}_dp2", 2),
                        device="cpu")
            out[layout] = t.fit()["steps"]
        else:
            t = Trainer(elastic_job(pc, layout, f"{tmp}/{layout}_dp1", 2,
                                    resume=True, elastic=True),
                        device="cpu")
            t.init_state()
            out[layout] = t.maybe_resume()
            # what the 2-rank world writes from the 1-rank snapshot
            t.cfg = dataclasses.replace(
                t.cfg, checkpoint_dir=f"{tmp}/{layout}_back")
            t.save()
    return out


def main():
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch import (
        config as pc,
    )

    suite, rank, size, tmp = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{tmp}/store_{suite}", size),
        rank=rank, world_size=size)
    if suite == "sdc":
        out = run_sdc(pc, tmp, rank)
    else:
        out = run_elastic(pc, tmp, rank, suite)
    with open(f"{tmp}/{suite}_out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
