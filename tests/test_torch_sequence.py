"""The port's sequence parallelism against the JAX package, on the CPU.

Ring and striped attention (plain and flash) over ``LocalSeqGroup`` and
over a two-rank gloo ``ProcessSeqGroup``, the stripe permutation and
global positions, the sequence-sharded loader, and whole training runs
with ``--sp 2``, each against the JAX package on a ``seq`` mesh of fake
CPU devices (``jax.shard_map``; the Pallas kernels in interpret mode).
Same inputs from numpy, f32 on both sides.  Tolerance 1e-5 (rtol and
atol) for the flash paths and the trainers, which differ from JAX only in
summation order; the plain ring keeps the JAX test's own 2e-4 / 2e-5.
"""

import functools
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.data.loader import (
    ShardedLoader as JaxLoader,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    sequence as jsq,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu_torch import cli
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (
    ShardedLoader,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
    flash_attention as fa,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    sequence as sq,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (
    world_setup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (
    TrainState,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
RING_TOL = dict(rtol=2e-4, atol=2e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = ("ring", "ring_flash", "striped", "striped_flash")


def _seq_mesh(s):
    return make_mesh(jconfig.MeshConfig(data=1, seq=s),
                     devices=jax.devices("cpu")[:s])


def _qkv(b=2, t=32, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_impl(impl, causal, block=8):
    if impl == "ring":
        return functools.partial(jsq.ring_attention, causal=causal)
    if impl == "striped":
        return functools.partial(jsq.ring_attention, causal=causal,
                                 striped=True)
    fn = (jsq.ring_flash_attention if impl == "ring_flash"
          else jsq.striped_ring_flash_attention)
    return functools.partial(fn, causal=causal, block_q=block,
                             block_k=block, interpret=True)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,s", [(32, 2), (32, 4), (12, 3)])
def test_striped_permutation_matches_jax(t, s):
    np.testing.assert_array_equal(sq.striped_permutation(t, s),
                                  jsq.striped_permutation(t, s))
    np.testing.assert_array_equal(sq.inverse_striped_permutation(t, s),
                                  jsq.inverse_striped_permutation(t, s))
    with pytest.raises(ValueError):
        sq.striped_permutation(t + 1, s)


@pytest.mark.parametrize("s", [2, 4])
def test_global_positions_match_jax(s):
    """Each shard's positions under JAX's shard_map, concatenated, are the
    local group's positions of the whole sequence."""
    t_local = 8
    mesh = _seq_mesh(s)
    for impl in IMPLS + ("dense", "flash"):
        if impl in IMPLS:
            want = jax.jit(jax.shard_map(
                lambda: jsq.global_positions(impl, "seq", t_local),
                mesh=mesh, in_specs=(), out_specs=P("seq"),
                check_vma=False))()
        else:
            want = jsq.global_positions(impl, "seq", s * t_local)
        got = sq.global_positions(impl, sq.LocalSeqGroup(s), s * t_local)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=impl)


def test_loader_shards_rows_then_columns_like_jax():
    """A data=2 x seq=2 mesh with the stripe permutation: the four ranks'
    (rows, columns) blocks tile the JAX loader's global batch, and the
    per-row mask stays whole on every sequence rank."""
    n, t = 10, 8
    data = {"x": np.arange(n * t, dtype=np.int32).reshape(n, t),
            "y": np.arange(n * t, dtype=np.int32).reshape(n, t) + 1000}
    perm = sq.striped_permutation(t, 2)
    mesh = make_mesh(jconfig.MeshConfig(data=2, seq=2),
                     devices=jax.devices("cpu")[:4])
    jl = JaxLoader(mesh, data, 6, seed=3, seq_axis="seq", prefetch=0,
                   seq_permutation=perm)
    ranks = {(d, s): ShardedLoader(data, 6, rank=d, world_size=2, seq_rank=s,
                                   sp=2, device="cpu", seed=3, prefetch=0,
                                   seq_permutation=perm)
             for d in range(2) for s in range(2)}
    want = [jax.device_get(b) for b in jl.epoch(0)]
    got = {key: list(ld.epoch(0)) for key, ld in ranks.items()}
    for i, w in enumerate(want):
        for k in ("x", "y"):
            rows = [np.concatenate([got[(d, s)][i][k].numpy()
                                    for s in range(2)], axis=1)
                    for d in range(2)]
            np.testing.assert_array_equal(np.concatenate(rows),
                                          np.asarray(w[k]))
        for d in range(2):
            np.testing.assert_array_equal(got[(d, 0)][i]["mask"].numpy(),
                                          got[(d, 1)][i]["mask"].numpy())
        np.testing.assert_array_equal(
            np.concatenate([got[(d, 0)][i]["mask"].numpy()
                            for d in range(2)]), np.asarray(w["mask"]))


# ---------------------------------------------------------------------------
# ring attention over a local group against shard_map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("impl", IMPLS)
def test_ring_impls_match_jax_shard_map(impl, s, causal):
    """Output and q/k/v gradients of sum(out * w), B 2, T 32, H 4, D 8,
    blocks 8; the striped impls on striped-permuted inputs."""
    _check_ring_against_shard_map(impl, s, causal, _qkv(seed=s), 8,
                                  seed=10 + s)


@pytest.mark.parametrize("impl", ["ring_flash", "striped_flash"])
def test_flash_rings_at_t_local_32_match_jax_shard_map(impl):
    """T 128 over 4 shards, causal, the default blocks (clipped to the
    shard): each ring block is a T 32 flash call, under the CUDA kernels'
    64-row tile (a masked tail tile on the card).  B 1, H 2, D 8."""
    _check_ring_against_shard_map(impl, 4, True,
                                  _qkv(b=1, t=128, h=2, seed=21), 128,
                                  seed=22)


def _check_ring_against_shard_map(impl, s, causal, qkv, block, seed):
    q, k, v = qkv
    w = np.random.default_rng(seed).standard_normal(q.shape).astype(
        np.float32)
    if impl.startswith("striped"):
        perm = sq.striped_permutation(q.shape[1], s)
        q, k, v = (x[:, perm] for x in (q, k, v))
    jfn = _jax_impl(impl, causal, block)
    spec = P(None, "seq")
    ring = jax.shard_map(lambda a, b_, c: jfn(a, b_, c, axis="seq"),
                         mesh=_seq_mesh(s), in_specs=(spec, spec, spec),
                         out_specs=spec, check_vma=False)
    want_out = jax.jit(ring)(q, k, v)
    want_grads = jax.jit(jax.grad(
        lambda a, b_, c: (ring(a, b_, c) * w).sum(), argnums=(0, 1, 2)))(
            q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = sq.sequence_sharded_attention(impl, tq, tk, tv,
                                        group=sq.LocalSeqGroup(s),
                                        causal=causal, block_q=block,
                                        block_k=block)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), (tq, tk, tv))
    tol = TOL if impl.endswith("flash") else RING_TOL
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **tol)
    for g, j, name in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=name,
                                   **tol)


def test_ring_flash_skips_future_blocks_and_striped_runs_all():
    """Block calls per ring: causal ring_flash S(S+1)/2 (future blocks
    launch nothing), striped_flash S^2; counted by wrapping the B5 entry
    point the ring functions call."""
    q, k, v = map(torch.tensor, _qkv())
    calls = []
    real = sq.flash_attention_with_lse

    def counting(*args, **kw):
        calls.append(kw.get("mask_mode"))
        return real(*args, **kw)

    sq.flash_attention_with_lse = counting
    try:
        for impl, want in (("ring_flash", 10), ("striped_flash", 16)):
            calls.clear()
            sq.sequence_sharded_attention(impl, q, k, v,
                                          group=sq.LocalSeqGroup(4),
                                          block_q=8, block_k=8)
            assert len(calls) == want, impl
        assert calls.count("causal") == 10 and \
            calls.count("causal_exclusive") == 6
    finally:
        sq.flash_attention_with_lse = real
    assert fa.flash_attention_with_lse.launches == 0   # CPU: plain path


def test_sequence_sharded_attention_rope_and_refusals():
    """RoPE by global position before the ring equals rotating the whole
    sequence and attending densely; ulysses and dense_blockwise (ported)
    equal dense attention, and a seq impl needs a group."""
    q, k, v = map(torch.tensor, _qkv())
    perm = torch.tensor(sq.striped_permutation(32, 4))
    got = sq.sequence_sharded_attention(
        "striped_flash", q[:, perm], k[:, perm], v[:, perm],
        group=sq.LocalSeqGroup(4), block_q=8, block_k=8, rope_theta=100.0)
    want = sq.sequence_sharded_attention("dense", q, k, v,
                                         rope_theta=100.0)
    np.testing.assert_allclose(got.numpy(), want[:, perm].numpy(), **TOL)
    for impl in ("ulysses", "dense_blockwise"):
        got = sq.sequence_sharded_attention(impl, q, k, v,
                                            group=sq.LocalSeqGroup(2),
                                            rope_theta=100.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    with pytest.raises(ValueError, match="sequence group"):
        sq.sequence_sharded_attention("ring", q, k, v)


# ---------------------------------------------------------------------------
# training with --sp 2 against the JAX Trainer on a seq=2 mesh
# ---------------------------------------------------------------------------

def _flags(impl):
    return ["--dataset", "lm", "--no-full-batch", "--batch_size", "4",
            "--nepochs", "2", "--n_samples", "8", "--seq_len", "32",
            "--vocab_size", "64", "--n_layers", "2", "--d_model", "32",
            "--n_heads", "4", "--d_ff", "64", "--ce_chunk", "8",
            "--optimizer", "sgd", "--lr", "0.1", "--momentum", "0.9",
            "--sp", "2", "--attention", impl]


def _run(state_step, epochs):
    """Per-step losses over the loader's epochs."""
    losses = []
    for epoch in range(2):
        for batch in epochs(epoch):
            losses.append(float(state_step(batch)))
    return losses


@functools.lru_cache(maxsize=None)
def _jax_trajectory(impl):
    """(init params, per-step losses, final params) of the JAX Trainer on
    a data=1 x seq=2 mesh."""
    from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
        Trainer as JaxTrainer,
    )

    jcfg = jconfig.config_from_args(
        jconfig.build_argparser().parse_args(_flags(impl)))
    jt = JaxTrainer(jcfg, mesh=_seq_mesh(2))
    jt.init_state()
    init = jax.device_get(jt.state.params)

    def step(batch):
        jt.state, loss = jt.train_step(jt.state, batch)
        return loss

    losses = _run(step, jt.loader.epoch)
    return init, losses, jax.device_get(jt.state.params)


def _port_trajectory(trainer, init):
    trainer.state = TrainState.from_params(
        params_from_jax(init, trainer.model.cfg, "cpu"), trainer.optimizer)

    def step(batch):
        trainer.state, loss = trainer.train_step(trainer.state, batch)
        return loss

    return _run(step, trainer.loader.epoch), tree_to_numpy(
        trainer.state.params)


def _assert_params_close(got, want):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path), **TOL)


@pytest.mark.parametrize("impl", ["striped_flash", "ring_flash"])
def test_trainer_local_seq_group_matches_jax_seq2(impl):
    init, want_losses, want_params = _jax_trajectory(impl)
    cfg = config_from_args(build_argparser().parse_args(_flags(impl)))
    trainer = Trainer(cfg, device="cpu", seq_group=sq.LocalSeqGroup(2))
    assert trainer.loader.sp == 1          # the whole (permuted) sequence
    losses, params = _port_trajectory(trainer, init)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    _assert_params_close(params, want_params)


_CHILD = r"""
import pickle, sys
import torch.distributed as dist
from neural_networks_parallel_training_with_mpi_tpu_torch.config import build_argparser, config_from_args
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import params_from_jax, tree_to_numpy
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import ProcessSeqGroup
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import TrainState
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import Trainer

rank, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", 2),
                        rank=rank, world_size=2)
with open(tmp + "/in.pkl", "rb") as f:
    runs = pickle.load(f)
out = {}
for impl, (flags, init) in runs.items():
    trainer = Trainer(config_from_args(build_argparser().parse_args(flags)),
                      device="cpu")
    assert isinstance(trainer.seq_group, ProcessSeqGroup)
    assert (trainer.world.seq_rank, trainer.loader.sp) == (rank, 2)
    trainer.state = TrainState.from_params(
        params_from_jax(init, trainer.model.cfg, "cpu"), trainer.optimizer)
    losses = []
    for epoch in range(2):
        for batch in trainer.loader.epoch(epoch):
            assert batch["x"].shape[1] == 16
            trainer.state, loss = trainer.train_step(trainer.state, batch)
            losses.append(float(loss))
    out[impl] = (losses, tree_to_numpy(trainer.state.params))
with open(f"{tmp}/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def test_two_rank_gloo_sp2_matches_jax_seq2(tmp_path):
    """Two spawned gloo ranks, --sp 2 (a ProcessSeqGroup: each rank holds
    16 of the 32 columns and the K/V blocks cross by batch_isend_irecv),
    striped_flash then ring_flash, against the JAX seq=2 trajectory."""
    impls = ("striped_flash", "ring_flash")
    want = {impl: _jax_trajectory(impl) for impl in impls}
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump({impl: (_flags(impl), want[impl][0]) for impl in impls},
                    f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r),
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    for r in range(2):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            got = pickle.load(f)
        for impl in impls:
            _, losses, params = want[impl]
            np.testing.assert_allclose(got[impl][0], losses, **TOL)
            _assert_params_close(got[impl][1], params)


def test_cli_sp2_in_one_process_raises_naming_torchrun():
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(_flags("striped_flash") + ["--platform", "cpu"])


def test_seq_impl_needs_a_group_and_dp_sp_must_fit_the_world():
    flags = _flags("ring")
    flags[flags.index("--sp") + 1] = "1"
    args = build_argparser().parse_args(
        [f for f in flags if f not in ("--attention", "ring")])
    cfg = config_from_args(args)
    cfg.model.attention = "ring"
    with pytest.raises(ValueError, match="LocalSeqGroup"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError):
        world_setup("cpu", sp=2)
    with pytest.raises(ValueError):
        world_setup("cpu", dp=2)
    assert world_setup("cpu", sp=1).seq_rank == 0
