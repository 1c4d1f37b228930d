"""The port's pipe x expert layouts (``parallel.pipeline`` with MoE stages:
pp x ep, pp x ep x tp, pp x sp x ep, the interleave) against the JAX
package's, on the CPU.

(a) The partition rules against JAX's ``pipeline_param_specs`` on MoE
params (tp 1 and 2, the interleave).  (b) The train step over
``LocalPipeGroup`` x ``LocalExpertGroup`` (x ``LocalSeqGroup`` /
``LocalTensorGroup``) against JAX's ``make_pipeline_train_step`` on a
``pipe x expert`` mesh of fake CPU devices, two SGD-momentum steps from
the same stacked init (``interop``) and batches: the ring and striped
attentions, the interleave with top-2 and SwiGLU, pp x ep x tp with
accumulation, the clip, a ragged batch and dropped tokens.  (c) JAX's rescheduling identities: pp x ep equals the
DP x EP step with ``accum_steps = n_microbatches``
(``tests/test_trainer_pp_ep.py``), pp x ep x tp the EP x TP step, and the
four-axis pp x sp x ep x tp (16 JAX devices) the port's own seq x ep x tp
step, which is pinned to JAX.  (d) The aux carry (the objective against
the task loss), the shard-by-shard microbatches and the eval sums.  The
Trainer's ``--pp --ep`` is ``tests/test_torch_pipeline_expert_trainer.py``'s.

f32 on both sides.  Tolerances: JAX's own (``tests/test_pipeline.py``,
``tests/test_trainer_pp_ep.py``): loss rtol 1e-5, params rtol 1e-4 /
atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu import config as jconfig
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxTransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.ops import optim as joptim
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    expert as jep,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    pipeline as jpp,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.train.state import (
    TrainState as JaxTrainState,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    expert as ep_lib,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    pipeline as pp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (
    world_setup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.expert import (
    LocalExpertGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (
    LocalTensorGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.pipeline import (
    LocalPipeGroup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (
    LocalSeqGroup, striped_permutation,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (
    TrainState,
)

pytestmark = pytest.mark.torch_port

VOCAB, T = 64, 16
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _model_kw(n_layers=2, attention="dense", **kw):
    return dict(vocab_size=VOCAB, max_seq_len=T, n_layers=n_layers,
                d_model=32, n_heads=4, d_ff=64, attention=attention,
                moe_experts=4, **kw)


def jax_model(**kw):
    return JaxTransformer(JaxTransformerConfig(moe_expert_axis="expert",
                                               **_model_kw(**kw)))


def port_model(seq_group=None, expert_group=None, **kw):
    return Transformer(TransformerConfig(**_model_kw(**kw)), device="cpu",
                       seq_group=seq_group, expert_group=expert_group)


def lm_batch(rows, seed=0, striped_over=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, VOCAB, (rows, T + 1))
    x, y = tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)
    if striped_over > 1:
        perm = striped_permutation(T, striped_over)
        x, y = x[:, perm], y[:, perm]
    return {"x": x, "y": y, "mask": np.ones((rows,), np.float32)}


def _mesh(pipe=2, expert=2, seq=1, tensor=1):
    return make_mesh(jconfig.MeshConfig(data=1, pipe=pipe, expert=expert,
                                        seq=seq, tensor=tensor),
                     devices=jax.devices("cpu")[:pipe * expert * seq
                                                * tensor])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def assert_trees_close(got, want, **tol):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **(tol or PARAM_TOL))


# ---------------------------------------------------------------------------
# (a) the partition rules
# ---------------------------------------------------------------------------

def _spec_dims(spec):
    def dim(axis):
        dims = [i for i, a in enumerate(spec) if a == axis]
        return dims[0] if dims else None

    return [dim("tensor"), dim("pipe"), dim("expert")]


@pytest.mark.parametrize("tp,interleave", [(1, 1), (2, 1), (2, 2)])
def test_pipeline_param_specs_match_jax_on_moe(tp, interleave):
    params = _np(jpp.init_pipeline_params(
        jax_model(n_layers=4, activation="swiglu"), jprng.init_key(0), 2,
        tp, interleave))
    want = jax.tree_util.tree_map(_spec_dims, jpp.pipeline_param_specs(
        params, tp, interleave), is_leaf=lambda x: isinstance(x, P))
    got = jax.tree_util.tree_map(lambda s: [s.tensor, s.pipe, s.expert],
                                 pp.pipeline_param_specs(params, tp,
                                                         interleave))
    lists = dict(is_leaf=lambda x: isinstance(x, list) and (
        not x or not isinstance(x[0], dict)))
    assert jax.tree_util.tree_flatten_with_path(got, **lists)[0] == \
        jax.tree_util.tree_flatten_with_path(want, **lists)[0]


# ---------------------------------------------------------------------------
# (b) the train step against JAX's
# ---------------------------------------------------------------------------

STEPS = {
    "pp2_ep2": dict(n_mb=2),
    "pp2_sp2_ep2_ring": dict(seq=2, model=dict(attention="ring")),
    "pp2_sp2_ep2_striped": dict(seq=2, model=dict(attention="striped")),
    "interleave2_top2_swiglu": dict(v=2, n_mb=2, model=dict(
        n_layers=4, moe_top_k=2, activation="swiglu")),
    # with tp 2: 3 rows a shard padded to 4 microbatches of 1, tokens
    # dropped, the clip
    "pp2_ep2_tp2_accum_clip_ragged_drop": dict(
        tensor=2, n_mb=4, rows=6, grad_clip=0.05,
        model=dict(moe_capacity_factor=0.5)),
}


def _case(name):
    c = dict(STEPS[name])
    for k, v in (("seq", 1), ("tensor", 1), ("v", 1), ("n_mb", None),
                 ("rows", 8), ("grad_clip", 0.0), ("model", {})):
        c.setdefault(k, v)
    striped = c["model"].get("attention", "").startswith("striped")
    c["batch"] = lm_batch(c["rows"], striped_over=c["seq"] if striped
                          else 1)
    return c


def _placed(mesh, batch, seq):
    rows = ("data", "fsdp", "expert")
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P(rows, "seq") if seq > 1 and k != "mask" else P(rows)))
        for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_steps(name, steps=2):
    """(stacked init, per-step losses, final params) of JAX's pipeline
    step on the case's pipe x expert mesh."""
    c = _case(name)
    model = jax_model(**c["model"])
    mesh = _mesh(seq=c["seq"], tensor=c["tensor"])
    opt = joptim.sgd(lr=0.1, momentum=0.9)
    state = jpp.init_pipeline_state(model, opt, jprng.init_key(0), 2,
                                    c["tensor"], c["v"])
    init = _np(state.params)
    state = jpp.shard_pipeline_state(state, mesh, opt, c["v"])
    step = jpp.make_pipeline_train_step(
        model, opt, mesh, n_microbatches=c["n_mb"], donate=False,
        grad_clip=c["grad_clip"], interleave=c["v"])
    placed = _placed(mesh, c["batch"], c["seq"])
    losses = []
    for _ in range(steps):
        state, loss = step(state, placed)
        losses.append(float(loss))
    return init, losses, _np(state.params)


def _groups(c):
    seq = LocalSeqGroup(c["seq"]) if c["seq"] > 1 else None
    tensor = LocalTensorGroup(c["tensor"]) if c["tensor"] > 1 else None
    return seq, tensor, LocalExpertGroup(2)


def port_steps(name, init, steps=2, aux_weight=0.01):
    c = _case(name)
    seq, tensor, expert = _groups(c)
    model = port_model(seq, expert, **c["model"])
    opt = optim.sgd(0.1, 0.9, steps=steps)
    state = TrainState.from_params(params_from_jax(init, model.cfg, "cpu"),
                                   opt, model)
    step = pp.make_pipeline_train_step(
        model, opt, world_setup("cpu"), LocalPipeGroup(2),
        n_microbatches=c["n_mb"], grad_clip=c["grad_clip"],
        interleave=c["v"], tensor_group=tensor, expert_group=expert,
        aux_weight=aux_weight)
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, tree_to_numpy(state.params)


@pytest.mark.parametrize("name", list(STEPS))
def test_local_groups_step_matches_jax(name):
    init, want, want_params = jax_steps(name)
    got, params = port_steps(name, init)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert_trees_close(params, want_params)


def test_aux_carry_enters_the_objective_not_the_loss():
    """The objective is the task loss sum plus 0.01 x the count-weighted
    aux of every active application; the reported loss is the task loss:
    the first step's loss does not depend on aux_weight, the update
    does."""
    init = jax_steps("pp2_ep2")[0]
    with_aux, p1 = port_steps("pp2_ep2", init, steps=1)
    without, p0 = port_steps("pp2_ep2", init, steps=1, aux_weight=0.0)
    assert with_aux == without
    assert not np.allclose(p1["blocks"]["moe"]["gate"]["w"],
                           p0["blocks"]["moe"]["gate"]["w"], atol=0,
                           rtol=0)
    # the objective's aux term: 0.01 x sum over the active (stage,
    # microbatch) applications of each group's aux x its loss count
    c = _case("pp2_ep2")
    group = LocalExpertGroup(2)
    model = port_model(None, group)
    pm = pp.PipelineModel(model, LocalPipeGroup(2), 2,
                          expert_group=group)
    params = params_from_jax(init, model.cfg, "cpu")
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    (s, obj), cnt = pm.fused_loss_sum("cross_entropy")(params, batch)
    auxes = []
    ids_mb, _, _ = pm._microbatches(batch)
    pm._run(params, ids_mb, lambda y, m: None,
            lambda aux, m: auxes.append(aux))
    assert len(auxes) == 2 * 2      # 2 stages x 2 microbatches
    per_group = float(cnt) / 2 / 2  # each group: a shard's microbatch
    want = 0.01 * per_group * float(sum(a.sum() for a in auxes))
    np.testing.assert_allclose(float(obj - s), want, rtol=1e-5)


def test_microbatches_are_shard_by_shard():
    """A microbatch is every expert shard's m-th piece: with 2 shards of
    4 rows and 2 microbatches, microbatch 0 holds rows 0, 1, 4, 5; a
    shard's ragged rows pad inside the shard."""
    group = LocalExpertGroup(2)
    pm = pp.PipelineModel(port_model(None, group), LocalPipeGroup(2), 2,
                          expert_group=group)
    x = torch.arange(8)[:, None].expand(8, T)
    ids, _, mask = pm._microbatches({"x": x, "y": x})
    assert ids[0, :, 0].tolist() == [0, 1, 4, 5]
    assert ids[1, :, 0].tolist() == [2, 3, 6, 7]
    ids, _, mask = pm._microbatches({"x": x[:6], "y": x[:6]})
    assert ids[:, :, 0].tolist() == [[0, 1, 3, 4], [2, 0, 5, 0]]
    assert mask.tolist() == [[1, 1, 1, 1], [1, 0, 1, 0]]


# ---------------------------------------------------------------------------
# (c) the rescheduling identities
# ---------------------------------------------------------------------------

def test_pp_ep_is_a_pure_rescheduling_of_dp_ep():
    """JAX's identity (tests/test_trainer_pp_ep.py) on the port: pp 2 x
    ep 2 with 2 microbatches equals JAX's DP x EP step with accum_steps 2
    (same shards, the same shard-by-shard split, the same aux), loss and
    params, one step."""
    c = _case("pp2_ep2")
    jm = jax_model()
    opt = joptim.sgd(lr=0.1, momentum=0.9)
    emesh = make_mesh(jconfig.MeshConfig(data=1, expert=2),
                      devices=jax.devices("cpu")[:2])
    state = jep.shard_moe_state(JaxTrainState.create(jm, opt,
                                                     jprng.init_key(0)),
                                emesh, opt)
    jstep = jep.make_moe_train_step(jm, opt, emesh, accum_steps=2,
                                    donate=False)
    state, metrics = jstep(state, {k: jax.device_put(
        jnp.asarray(v), NamedSharding(emesh, P(jep.TOKEN_AXES)))
        for k, v in c["batch"].items()})
    init = jax_steps("pp2_ep2")[0]
    got, params = port_steps("pp2_ep2", init, steps=1)
    np.testing.assert_allclose(got[0], float(metrics["loss"]), rtol=1e-5,
                               atol=1e-6)
    want = _np(state.params)
    for g, w in zip(pp.unstack_blocks(params["blocks"]), want["blocks"]):
        assert_trees_close(g, w)
    for k in ("embed", "pos", "ln_f", "head"):
        assert_trees_close(params[k], want[k])


def _port_moe_tp_step(flags_model, tensor, seq, expert, init, batch, n_mb):
    """The port's (seq x) EP x TP step (pinned to JAX's) with
    accum_steps = n_mb from the dense-layout ``init`` (qkv permuted)."""
    model = port_model(seq, expert, **flags_model)
    opt = optim.sgd(0.1, 0.9, steps=1)
    state = TrainState.from_params(params_from_jax(init, model.cfg, "cpu"),
                                   opt, model)
    step = ep_lib.make_moe_tp_train_step(
        model, opt, world_setup("cpu"), tensor, expert, accum_steps=n_mb,
        seq_group=seq)
    state, metrics = step(state, {k: torch.tensor(v)
                                  for k, v in batch.items()})
    return float(metrics["loss"]), tree_to_numpy(state.params)


@pytest.mark.parametrize("seq", [1, 2], ids=["pp_ep_tp", "pp_sp_ep_tp"])
def test_pp_ep_tp_is_a_pure_rescheduling_of_ep_tp(seq):
    """pp 2 x ep 2 x tp 2 equals the EP x TP step with accum_steps 2, and
    the four-axis pp 2 x sp 2 x ep 2 x tp 2 (16 devices: more than JAX's
    8 virtual CPU devices) the seq x EP x TP step, over local groups,
    loss and params, one step."""
    model_kw = dict(attention="ring" if seq > 1 else "dense")
    jm = jax_model(**model_kw)
    stacked = _np(jpp.init_pipeline_params(jm, jprng.init_key(0), 2, 2))
    batch = lm_batch(8)
    dense_order = dict(stacked, blocks=pp.unstack_blocks(stacked["blocks"]))
    tensor = LocalTensorGroup(2)
    sq = LocalSeqGroup(seq) if seq > 1 else None
    want_loss, want = _port_moe_tp_step(model_kw, tensor, sq,
                                        LocalExpertGroup(2), dense_order,
                                        batch, 2)
    expert = LocalExpertGroup(2)
    model = port_model(sq, expert, **model_kw)
    opt = optim.sgd(0.1, 0.9, steps=1)
    state = TrainState.from_params(params_from_jax(stacked, model.cfg,
                                                   "cpu"), opt, model)
    step = pp.make_pipeline_train_step(
        model, opt, world_setup("cpu"), LocalPipeGroup(2), n_microbatches=2,
        tensor_group=tensor, expert_group=expert)
    state, loss = step(state, {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = tree_to_numpy(state.params)
    for g, w in zip(pp.unstack_blocks(got["blocks"]), want["blocks"]):
        assert_trees_close(g, w)
    for k in ("embed", "pos", "ln_f", "head"):
        assert_trees_close(got[k], want[k])


# ---------------------------------------------------------------------------
# (d) the eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pp2_ep2", "pp2_sp2_ep2_ring"])
def test_eval_step_matches_jax(name):
    """Loss and accuracy of the eval step (the aux dropped; the seq
    shards' accuracies averaged, SP x EP eval's convention)."""
    c = _case(name)
    init = jax_steps(name)[0]
    jmodel = jax_model(**c["model"])
    mesh = _mesh(seq=c["seq"], tensor=c["tensor"])
    jstep = jpp.make_pipeline_eval_step(jmodel, mesh, with_accuracy=True,
                                        n_microbatches=c["n_mb"])
    specs = jpp.pipeline_param_specs(init, c["tensor"], c["v"])
    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), init, specs)
    want = {k: float(v) for k, v in jax.device_get(
        jstep(placed, _placed(mesh, c["batch"], c["seq"]))).items()}
    seq, tensor, expert = _groups(c)
    model = port_model(seq, expert, **c["model"])
    step = pp.make_pipeline_eval_step(
        model, world_setup("cpu"), LocalPipeGroup(2), with_accuracy=True,
        n_microbatches=c["n_mb"], tensor_group=tensor, expert_group=expert)
    got = step(params_from_jax(init, model.cfg, "cpu"),
               {k: torch.tensor(v) for k, v in c["batch"].items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)
