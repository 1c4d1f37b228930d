"""An MoE model on the port's GSPMD layout (``--tp`` and / or ``--fsdp``,
no ``--ep`` or ``--sp``: ``parallel.gspmd`` over
``tensor_parallel.TensorParallelModel``) against the JAX GSPMD
``Trainer``, on the CPU.

JAX runs the GSPMD step in global view: its MoE layer routes every row of
the global batch as one group (capacity from the global token count,
queue positions in the global row order), no aux enters the loss, and
under ``--accum_steps`` row i goes to microbatch i mod accum.  Its
``Trainer`` wants a mesh of all 8 virtual devices, so its runs carry data
ranks beside tensor / fsdp (``data=4 x tensor=2``, ``data=4 x fsdp=2``,
``data=2 x tensor=2 x fsdp=2``); the port's one process holds every row
over a ``LocalTensorGroup`` / ``LocalFsdpGroup`` and routes them as one
group too.  The capacity is tight (top-2 at factor 1.0), so tokens are
dropped and the global routing shows.  4 gloo ranks of
``tests/torch_expert_child.py`` run ``--dp 2 --tp 2``: each data rank
routes its own rows with the offsets of the other's (one all-gather of
the counts a layer) and equals the one-process run; each rank holds the
experts whole and the tensor slices of the Megatron leaves.  The
``StateLayout`` specs of the MoE leaves against JAX's ``param_specs``
(experts whole, ``gate.w`` fsdp-split), and ``models.moe``'s global-batch
routing against one group's on the same tokens, split over ranks by
hand.

f32 on both sides.  Tolerance 1e-5 (rtol and atol) after three steps, as
``tests/test_torch_tensor_parallel.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    tensor_parallel as jtp,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.moe import (
    MoEFFN,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    tensor_parallel as tp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.fsdp import (
    LocalFsdpGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (
    LocalTensorGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from torch_expert_child import spawn
from torch_tp_child import run

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 3
LM = ["--dataset", "lm", "--no-full-batch", "--batch_size", "8",
      "--nepochs", "1", "--n_samples", "24", "--seq_len", "16",
      "--vocab_size", "64", "--n_layers", "2", "--d_model", "32",
      "--n_heads", "4", "--d_ff", "64", "--optimizer", "sgd", "--lr", "0.1",
      "--momentum", "0.9", "--moe_experts", "4", "--moe_top_k", "2",
      "--moe_capacity_factor", "1.0"]

# name -> (the JAX Trainer's mesh flags, the port's layout flags)
JOBS = {
    "tp2": (["--dp", "4", "--tp", "2"], ["--tp", "2"]),
    "fsdp2": (["--dp", "4", "--fsdp", "2"], ["--fsdp", "2"]),
    "tp2_fsdp2_accum2": (["--dp", "2", "--tp", "2", "--fsdp", "2",
                          "--accum_steps", "2"],
                         ["--tp", "2", "--fsdp", "2", "--accum_steps", "2"]),
    "tp2_swiglu_top1_clip": (
        ["--dp", "4", "--tp", "2", "--ffn_activation", "swiglu",
         "--moe_top_k", "1", "--grad_clip", "0.05"],
        ["--tp", "2", "--ffn_activation", "swiglu", "--moe_top_k", "1",
         "--grad_clip", "0.05"]),
}


def _jcfg(flags):
    return jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))


@functools.lru_cache(maxsize=None)
def jax_trajectory(name):
    """(init params, per-step losses, final params) of the JAX Trainer on
    its 8-device mesh."""
    jcfg = _jcfg(LM + JOBS[name][0])
    m = jcfg.mesh
    jt = JaxTrainer(jcfg, mesh=make_mesh(m, devices=jax.devices("cpu")[
        :m.data * m.tensor * m.fsdp]))
    assert jt.gspmd
    jt.init_state()
    init = jax.device_get(jt.state.params)
    losses = []
    for batch in jt.loader.epoch(0):
        if len(losses) == STEPS:
            break
        jt.state, loss = jt.train_step(jt.state, batch)
        losses.append(float(loss))
    return init, losses, jax.device_get(jt.state.params)


def _cfg(flags):
    return config_from_args(build_argparser().parse_args(flags))


def _port(name):
    cfg = _cfg(LM + JOBS[name][1])
    kw = {}
    if cfg.mesh.tensor > 1:
        kw["tensor_group"] = LocalTensorGroup(cfg.mesh.tensor)
    if cfg.mesh.fsdp > 1:
        kw["fsdp_group"] = LocalFsdpGroup(cfg.mesh.fsdp)
    return Trainer(cfg, device="cpu", **kw)


def assert_params_close(got, want, **tol):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **(tol or TOL))


@pytest.mark.parametrize("name", list(JOBS))
def test_local_groups_trainer_matches_jax_gspmd(name):
    init, want, want_params = jax_trajectory(name)
    trainer = _port(name)
    assert trainer.gspmd and trainer.layout_tag == "gspmd"
    got, params = run(trainer, init, STEPS)
    np.testing.assert_allclose(got, want, **TOL)
    assert_params_close(params, want_params)


def test_tokens_are_dropped_and_accum_is_congruent():
    """The capacity drops tokens (so the global routing is what the
    trajectories above pin), and the congruence microbatches are not the
    contiguous ones: routed as contiguous chunks, the accumulated step
    leaves JAX's trajectory."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        data_parallel as dp,
    )

    init, want, _ = jax_trajectory("tp2_fsdp2_accum2")
    t = _port("tp2")
    t.init_state()
    batch = next(iter(t.loader.epoch(0)))
    x = t.model.embed(t.state.params, batch["x"], torch.arange(16))
    r = t.model.moe().route(t.state.params["blocks"][0]["moe"]["gate"]["w"],
                            x.reshape(1, -1, 32))
    assert int((r.dest == 4 * r.capacity).sum()) > 0
    contiguous = _port("tp2_fsdp2_accum2")
    model = tp.TensorParallelModel(contiguous.model, contiguous.tensor_group,
                                   layout=contiguous.state_layout)
    assert model.congruent_microbatches
    model.congruent_microbatches = False
    contiguous.train_step = dp.make_train_step(
        model, contiguous.optimizer, contiguous.world,
        loss_name="cross_entropy", accum_steps=2)
    got, _ = run(contiguous, init, STEPS)
    assert not np.allclose(got, want, **TOL)


def test_gloo_dp2_tp2_equals_one_process():
    """--dp 2 --tp 2 over 4 gloo ranks (rank = data * 2 + tensor): each
    data rank routes its own 4 rows with the offsets of the other's; the
    losses and params equal the one-process run (and so JAX's), and each
    rank holds the experts whole, the Megatron leaves' tensor slices."""
    import tempfile

    init, want, want_params = jax_trajectory("tp2")
    with tempfile.TemporaryDirectory() as tmp:
        outs = spawn(tmp, 4, {"jobs": {"dp2_tp2_state": (
            LM + ["--dp", "2", "--tp", "2"], init, STEPS)}})
    for rank, out in enumerate(outs):
        got, params, held = out["dp2_tp2_state"]
        np.testing.assert_allclose(got, want, **TOL)
        assert_params_close(params, want_params)
        layer = held["blocks"][0]
        for k, v in layer["moe"]["experts"].items():
            assert v.shape == np.shape(init["blocks"][0]["moe"]["experts"][k])
        assert layer["qkv"]["w"].shape == (32, 48)     # 96 columns / 2
        np.testing.assert_array_equal(
            layer["moe"]["experts"]["w_in"],
            params["blocks"][0]["moe"]["experts"]["w_in"])


def _spec_dims(spec):
    def dim(axis):
        dims = [i for i, a in enumerate(spec) if a == axis]
        return dims[0] if dims else None

    return tp.LeafSpec(dim("tensor"), dim("fsdp"))


@pytest.mark.parametrize("tensor,fsdp", [(2, 1), (1, 2), (2, 2), (4, 2)])
def test_state_layout_specs_match_jax(tensor, fsdp):
    """JAX's rules leave every expert leaf whole and split gate.w (d, E)
    over fsdp: the port's StateLayout gives the same specs, and under
    process groups a rank would hold 1/F of gate.w and whole experts."""
    init = jax_trajectory("tp2")[0]
    mesh = make_mesh(jconfig.MeshConfig(data=8 // (tensor * fsdp),
                                        tensor=tensor, fsdp=fsdp),
                     devices=jax.devices("cpu")[:8])
    trainer = _port("tp2")
    want = jax.tree_util.tree_map(
        _spec_dims, jtp.param_specs(jax_like(trainer), init, mesh),
        is_leaf=lambda x: isinstance(x, P))
    got = tp.param_specs(trainer.model, init, tensor, fsdp)
    moe = [(path, s) for path, s in
           jax.tree_util.tree_flatten_with_path(
               got, is_leaf=lambda x: isinstance(x, tp.LeafSpec))[0]
           if "moe" in jax.tree_util.keystr(path)]
    wmoe = dict(jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, tp.LeafSpec))[0])
    assert moe
    for path, s in moe:
        assert s == wmoe[path], jax.tree_util.keystr(path)
        name = jax.tree_util.keystr(path)
        if "experts" in name:
            assert s == tp.WHOLE
        elif "gate" in name:
            assert s == tp.LeafSpec(None, 0 if fsdp > 1 else None)


def jax_like(trainer):
    """The JAX model of the port trainer's config (its rules key on the
    model's type)."""
    from neural_networks_parallel_training_with_mpi_tpu.models.registry import (  # noqa: E501
        build_model,
    )

    return build_model(_jcfg(LM).model)


class _FakeBatch:
    """A batch group of ``size`` ranks in one process: ``all_gather``
    returns the counts each rank reported, as the collective would."""

    def __init__(self, size, index, every):
        self.size, self.index, self.every = size, index, every

    def all_gather(self, x):
        self.every[self.index] = x
        return torch.stack(self.every)


@pytest.mark.parametrize("top_k,factor", [(1, 1.0), (2, 1.0), (2, 0.5)])
def test_global_batch_routing_equals_one_group(top_k, factor):
    """models.moe's global-batch routing split over 3 ranks by hand (each
    rank's counts gathered first) gives every token the output one group
    of all the ranks' tokens gives it, dropped tokens included."""
    torch.manual_seed(0)
    layer = MoEFFN(16, 32, 4, capacity_factor=factor, router_top_k=top_k)
    params = layer.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(3, 10, 16)
    whole, _ = layer.apply(params, x.reshape(1, 30, 16))
    r = layer.route(params["gate"]["w"], x.reshape(1, 30, 16))
    assert int((r.dest == 4 * r.capacity).sum()) > 0 or factor > 0.5
    # the counts every rank reports, then each rank's own routing
    counts = []
    for b in range(3):
        onehots = [(i == torch.arange(4)[:, None]).long()
                   for i in _choices(layer, params, x[b])]
        counts.append(torch.stack([o.sum(-1) for o in onehots]))
    parts = [layer.apply(params, x[b:b + 1], batch=_FakeBatch(
        3, b, list(counts)))[0] for b in range(3)]
    torch.testing.assert_close(torch.cat(parts).reshape(1, 30, 16), whole,
                               rtol=1e-6, atol=1e-6)


def _choices(layer, params, toks):
    probs = torch.softmax(toks.float() @ params["gate"]["w"].float(), -1)
    out, left = [], probs
    for _ in range(layer.router_top_k):
        i = left.argmax(-1)
        out.append(i)
        left = left.masked_fill(i[:, None] == torch.arange(4), -1.0)
    return out
