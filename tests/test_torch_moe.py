"""The port's MoE layer (``models.moe``) and the MoE transformer against
the JAX package's, on the CPU.

(a) ``MoEFFN.apply`` against JAX's on the same params (carried across
by ``interop``) and numpy inputs: top-1, top-2, capacity drops, SwiGLU,
int8 expert scales (``ops.quant`` on both sides), bf16 compute; the
output, the aux and the gradients of the params and the input.  (b) The
index dispatch and combine against the one-hot einsum form
(``dispatch_combine_onehot``): bitwise in f32 under top-1, 1e-6 under
top-2.  (c) Routing groups: a ``LocalExpertGroup`` / ``seq_shards``
split routes each group alone, as JAX devices do.  (d) The MoE
transformer's forward and aux against ``Transformer.apply(return_aux=
True)``, per layer and ``scan_layers``, and ``fwd_flops``.  (e) The plain
DP and DP x seq Trainers over an MoE model (no aux in the loss, as JAX's)
against the JAX Trainer, three steps.

Tolerances: f32 1e-6 (rtol and atol) forward, 1e-5 for gradients and
three-step trajectories; bf16 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.models.moe import (
    MoEFFN as JaxMoEFFN,
)
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxTransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.ops import quant as jquant
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
    Trainer as JaxTrainer,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.moe import (
    MoEFFN, dispatch_combine_onehot,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import quant
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.expert import (
    LocalExpertGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (
    LocalSeqGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)

pytestmark = pytest.mark.torch_port

FWD = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
D, F, E = 32, 64, 4

LAYERS = {
    "top1": dict(),
    "top2": dict(router_top_k=2),
    "drops": dict(capacity=2),
    "top2_drops": dict(router_top_k=2, capacity=3),
    "swiglu": dict(activation="swiglu"),
    "relu": dict(activation="relu"),
    "int8": dict(activation="swiglu", quantized=True),
    "bf16": dict(compute_dtype="bf16"),
}


def _layers(name):
    kw = dict(LAYERS[name])
    quantized = kw.pop("quantized", False)
    cdt = kw.pop("compute_dtype", None)
    jkw, tkw = dict(kw), dict(kw)
    if cdt == "bf16":
        jkw["compute_dtype"] = jnp.bfloat16
        tkw["compute_dtype"] = torch.bfloat16
    return JaxMoEFFN(D, F, E, **jkw), MoEFFN(D, F, E, **tkw), quantized


def _inputs(seed=0, shape=(4, 6)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (D,)).astype(np.float32)
    ct = rng.standard_normal(shape + (D,)).astype(np.float32)
    return x, ct


@functools.lru_cache(maxsize=None)
def jax_layer(name):
    """(params, y, aux, grads of the params, grad of x) of JAX's layer on
    the loss sum(y * ct) + 0.5 * aux."""
    jl, _, quantized = _layers(name)
    params = jl.init(jprng.init_key(3))
    if quantized:
        params = jquant.quantize_params({"moe": params})["moe"]
    x, ct = _inputs()

    def loss(p, xx):
        y, aux = jl.apply(p, xx)
        return (y.astype(jnp.float32) * ct).sum() + 0.5 * aux, (y, aux)

    diff = ((0, 1) if not quantized else 1)
    (_, (y, aux)), grads = jax.value_and_grad(loss, argnums=diff,
                                              has_aux=True)(params, x)
    if quantized:
        gp, gx = None, grads
    else:
        gp, gx = grads
    return (jax.device_get(params), np.asarray(y, np.float32),
            float(aux), jax.device_get(gp), np.asarray(gx))


@pytest.mark.parametrize("name", list(LAYERS))
def test_moe_layer_matches_jax(name):
    """Output, aux and gradients against JAX's layer on JAX's params."""
    params, want_y, want_aux, want_gp, want_gx = jax_layer(name)
    _, layer, quantized = _layers(name)
    tp = tree_from_jax(params, "cpu")
    if not quantized:
        tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(), tp)
    x, ct = _inputs()
    tx = torch.tensor(x, requires_grad=True)
    y, aux = layer.apply(tp, tx)
    assert aux.shape == (1,)
    ((y.float() * torch.tensor(ct)).sum() + 0.5 * aux.sum()).backward()
    tol = BF16 if name == "bf16" else FWD
    np.testing.assert_allclose(y.detach().float().numpy(), want_y, **tol)
    np.testing.assert_allclose(float(aux.detach()), want_aux, **tol)
    np.testing.assert_allclose(tx.grad.numpy(), want_gx,
                               **(BF16 if name == "bf16" else GRAD))
    if not quantized:
        got = {k: {n: v.grad.numpy() for n, v in sub.items()}
               for k, sub in tp.items()}
        for k in want_gp:
            for n in want_gp[k]:
                np.testing.assert_allclose(
                    got[k][n], np.asarray(want_gp[k][n]), err_msg=f"{k}/{n}",
                    **(BF16 if name == "bf16" else GRAD))
    if name in ("drops", "top2_drops"):     # capacity bites
        lay_full = MoEFFN(D, F, E, router_top_k=layer.router_top_k)
        full, _ = lay_full.apply(tp, torch.tensor(x))
        assert not torch.allclose(full, y.detach())


@pytest.mark.parametrize("name", ["top1", "drops", "top2", "top2_drops",
                                  "swiglu", "bf16"])
def test_index_form_matches_onehot_einsum(name):
    """The index dispatch and combine against the one-hot einsum form:
    the output bitwise in f32 under top-1, 1e-6 under top-2 (two weighted
    terms summed in another order); the input gradient within 1e-6 (the
    combine weight's gradient is a length-d dot product, reduced in
    another order by the einsum)."""
    _, layer, _ = _layers(name)
    params = layer.init(torch.Generator().manual_seed(1), "cpu")
    x, ct = _inputs(seed=1, shape=(8, 16))
    outs = []
    for fn in (lambda p, xx: layer.apply(p, xx),
               lambda p, xx: dispatch_combine_onehot(layer, p, xx)):
        tx = torch.tensor(x, requires_grad=True)
        y, aux = fn(params, tx)
        (y.float() * torch.tensor(ct)).sum().backward()
        outs.append((y.detach().float(), aux, tx.grad))
    (y0, a0, g0), (y1, a1, g1) = outs
    assert torch.equal(a0, a1)
    tol = BF16 if name == "bf16" else FWD
    if layer.router_top_k == 1 and name != "bf16":
        assert torch.equal(y0, y1)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), **tol)
    np.testing.assert_allclose(g0.numpy(), g1.numpy(), **tol)


@pytest.mark.parametrize("g_e,g_s", [(2, 1), (1, 2), (2, 2)])
def test_routing_groups_route_alone(g_e, g_s):
    """A LocalExpertGroup's row blocks times seq_shards' column blocks:
    each group routes alone, the output and aux of running JAX's layer
    on each group's tokens."""
    jl, layer, _ = _layers("drops")
    params = jax.device_get(jl.init(jprng.init_key(5)))
    x, _ = _inputs(seed=2, shape=(4, 8))
    y, aux = layer.apply(tree_from_jax(params, "cpu"), torch.tensor(x),
                         LocalExpertGroup(g_e) if g_e > 1 else None,
                         seq_shards=g_s)
    assert aux.shape == (g_e * g_s,)
    rows, cols = 4 // g_e, 8 // g_s
    for i in range(g_e):
        for s in range(g_s):
            blk = x[i * rows:(i + 1) * rows, s * cols:(s + 1) * cols]
            wy, waux = jl.apply(params, blk)
            np.testing.assert_allclose(
                y[i * rows:(i + 1) * rows, s * cols:(s + 1) * cols].numpy(),
                np.asarray(wy), **FWD)
            np.testing.assert_allclose(float(aux[i * g_s + s]), float(waux),
                                       **FWD)


def test_top_k_out_of_range_refused_with_jax_message():
    with pytest.raises(ValueError) as theirs:
        JaxMoEFFN(D, F, E, router_top_k=5)
    with pytest.raises(ValueError) as ours:
        MoEFFN(D, F, E, router_top_k=5)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# (d) the MoE transformer
# ---------------------------------------------------------------------------

def _model_kw(**kw):
    base = dict(vocab_size=64, max_seq_len=16, n_layers=2, d_model=D,
                n_heads=4, d_ff=F, attention="dense", moe_experts=E)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [
    dict(), dict(scan_layers=True), dict(moe_top_k=2, activation="swiglu"),
    dict(moe_capacity=3)], ids=["list", "scan", "top2_swiglu", "drops"])
def test_moe_transformer_forward_matches_jax(kw):
    jm = JaxTransformer(JaxTransformerConfig(**_model_kw(**kw)))
    params = jax.device_get(jm.init(jprng.init_key(0)))
    ids = np.random.default_rng(0).integers(0, 64, (4, 16)).astype(np.int32)
    want, want_aux = jm.apply(params, ids, return_aux=True)
    m = Transformer(TransformerConfig(**_model_kw(**kw)), device="cpu")
    p = params_from_jax(params, m.cfg, "cpu")
    got, aux = m.forward(p, torch.tensor(ids), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)
    np.testing.assert_allclose(float(aux[0]), float(want_aux), **FWD)
    assert m.fwd_flops((4, 16)) == jm.fwd_flops((4, 16))
    # the carried tree goes back leaf for leaf
    back = tree_to_numpy(p)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(params)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b))
    # the port's own init has the JAX tree's names and shapes
    mine = m.init(torch.Generator().manual_seed(0))
    assert [(jax.tree_util.keystr(k), v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(tree_to_numpy(mine))[0]] \
        == [(jax.tree_util.keystr(k), np.shape(v)) for k, v in
            jax.tree_util.tree_flatten_with_path(params)[0]]


def test_ptq_moe_transformer_decodes_like_jax():
    """int8 PTQ of an MoE tree (expert kernels per (expert, column),
    the router kept) carried across, the forward against JAX's."""
    jm = JaxTransformer(JaxTransformerConfig(**_model_kw()))
    params = jquant.quantize_params(jm.init(jprng.init_key(0)))
    ids = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    want = jm.apply(params, ids)
    m = Transformer(TransformerConfig(**_model_kw()), device="cpu")
    p = tree_from_jax(jax.device_get(params), "cpu")
    mine = quant.quantize_params(params_from_jax(
        jax.device_get(jm.init(jprng.init_key(0))), m.cfg, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(mine)),
                    jax.tree_util.tree_leaves(tree_to_numpy(p))):
        np.testing.assert_array_equal(a, b)
    assert p["blocks"][0]["moe"]["experts"]["w_in"].dtype == torch.int8
    np.testing.assert_allclose(m.forward(p, torch.tensor(ids)).numpy(),
                               np.asarray(want), **GRAD)


# ---------------------------------------------------------------------------
# (e) the plain DP and DP x seq Trainers over an MoE model
# ---------------------------------------------------------------------------

LM = ["--dataset", "lm", "--no-full-batch", "--batch_size", "4",
      "--nepochs", "1", "--n_samples", "12", "--seq_len", "16",
      "--vocab_size", "64", "--n_layers", "2", "--d_model", "32",
      "--n_heads", "4", "--d_ff", "64", "--optimizer", "sgd", "--lr", "0.1",
      "--momentum", "0.9", "--moe_experts", "4"]

DP_JOBS = {
    "dp_top1": [],
    "dp_top2_factor_ce_chunk_accum": ["--moe_top_k", "2",
                                      "--moe_capacity_factor", "0.5",
                                      "--ce_chunk", "8", "--accum_steps",
                                      "2"],
    "dp_seq_ring_flash": ["--sp", "2", "--attention", "ring_flash"],
}


def _trajectory(trainer, init, jax_side):
    losses = []
    for batch in trainer.loader.epoch(0):
        trainer.state, loss = trainer.train_step(trainer.state, batch)
        losses.append(float(loss))
    params = (jax.device_get(trainer.state.params) if jax_side
              else tree_to_numpy(trainer.state.params))
    return losses, params


@pytest.mark.parametrize("name", list(DP_JOBS))
def test_dp_trainer_over_moe_matches_jax(name):
    """The DP / DP x seq step over an MoE model, the aux NOT in the loss
    (JAX's data_parallel step calls apply without return_aux)."""
    flags = LM + DP_JOBS[name]
    jcfg = jconfig.config_from_args(jconfig.build_argparser().parse_args(
        flags))
    n = jcfg.mesh.seq
    jt = JaxTrainer(jcfg, mesh=make_mesh(jcfg.mesh,
                                         devices=jax.devices("cpu")[:n]))
    jt.init_state()
    init = jax.device_get(jt.state.params)
    want, want_params = _trajectory(jt, init, True)
    cfg = config_from_args(build_argparser().parse_args(flags))
    kw = {"seq_group": LocalSeqGroup(2)} if n > 1 else {}
    t = Trainer(cfg, device="cpu", **kw)
    assert t.layout_tag in ("dp", "sp")
    t.init_state()
    t.state = t.state._replace(params=params_from_jax(init, t.model.cfg,
                                                      "cpu"))
    t.state = t.state._replace(
        params=jax.tree_util.tree_map(lambda x: x.requires_grad_(),
                                      t.state.params),
        opt_state=t.optimizer.init(t.state.params))
    got, params = _trajectory(t, init, False)
    assert len(got) == 3
    np.testing.assert_allclose(got, want, **GRAD)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD)
