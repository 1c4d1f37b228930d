"""The port's pipeline parallelism (``parallel.pipeline``) against the
JAX package's, on the CPU (the Trainer's ``--pp`` is
``tests/test_torch_pipeline_trainer.py``'s).

(a) The layout and accounting functions on the same trees (JAX's numpy
leaves, the port's tensors through ``interop``):
``stack_blocks``, ``unstack_blocks``, ``dense_layer_blocks``,
``infer_stack_ndims``, ``pipeline_param_specs``, ``schedule_ticks``,
``bubble_fraction`` and ``_schedule_indices`` over a grid of (S, M, v),
equal.  (b) The train step over a ``LocalPipeGroup`` against
``make_pipeline_train_step`` on a ``pipe`` mesh of fake CPU devices
((pipe, data, n_mb) (2, 1, 4), (4, 1, 4), (2, 2, 2); the interleave v 2
at n_mb 2 and 4; ``--remat``; ``ce_chunk``; the clip; a ragged batch),
from the same stacked init (``interop``) and numpy batches, two
SGD-momentum steps.  (c) The eval step, loss and accuracy, against
``make_pipeline_eval_step``.  (d) The compositions against JAX's DP x TP
x PP, PP x SP (``ring_flash``, ``striped_flash``; the Pallas kernels in
interpret mode) and PP x SP x TP steps, over ``LocalTensorGroup(2)`` and
``LocalSeqGroup(2)``.  (g) The schedule's refusal of microbatches that do
not group under the interleave, with JAX's message.

f32 on both sides.  Tolerances: JAX's own (``tests/test_pipeline.py``):
loss rtol 1e-5, params rtol 1e-4 / atol 1e-5.
"""

import functools

import jax
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
    pipeline as jpp,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import make_mesh
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    pipeline as pp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (
    world_setup,
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


def _model_kw(n_layers=4, attention="dense", **kw):
    return dict(vocab_size=VOCAB, max_seq_len=T, n_layers=n_layers,
                d_model=32, n_heads=4, d_ff=64, attention=attention,
                flash_block_q=8, flash_block_k=8, **kw)


def jax_model(**kw):
    return JaxTransformer(JaxTransformerConfig(**_model_kw(**kw)))


def port_model(seq_group=None, **kw):
    return Transformer(TransformerConfig(**_model_kw(**kw)), device="cpu",
                       seq_group=seq_group)


def lm_batch(rows, seed=0, striped_over=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, VOCAB, (rows, T + 1))
    x, y = tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)
    if striped_over > 1:    # the layout the striped impls read
        perm = striped_permutation(T, striped_over)
        x, y = x[:, perm], y[:, perm]
    return {"x": x, "y": y, "mask": np.ones((rows,), np.float32)}


def _mesh(data=1, pipe=2, seq=1, tensor=1, fsdp=1):
    n = data * pipe * seq * tensor * fsdp
    return make_mesh(jconfig.MeshConfig(data=data, pipe=pipe, seq=seq,
                                        tensor=tensor, fsdp=fsdp),
                     devices=jax.devices("cpu")[:n])


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
# (a) the layout and accounting functions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_blocks(n_layers):
    return _np(jax_model(n_layers=n_layers).init(
        jprng.init_key(0))["blocks"])


@pytest.mark.parametrize("n_stages,interleave,tp", [
    (2, 1, 1), (4, 1, 1), (2, 2, 1), (2, 1, 2), (2, 2, 2)])
def test_layout_functions_match_jax(n_stages, interleave, tp):
    blocks = _jax_blocks(4)
    layers = tree_from_jax(blocks, "cpu")
    got = pp.stack_blocks(layers, n_stages, interleave)
    want = _np(jpp.stack_blocks(blocks, n_stages, interleave))
    assert_trees_close(tree_to_numpy(got), want, rtol=0, atol=0)
    nd = 2 if interleave == 1 else 3
    assert pp.infer_stack_ndims(got) == jpp.infer_stack_ndims(want) == nd
    assert pp.infer_stack_ndims(layers) == 0
    back = tree_to_numpy(pp.unstack_blocks(got, nd))
    assert_trees_close(back, _np(jpp.unstack_blocks(want, nd)), rtol=0,
                       atol=0)
    assert_trees_close(back, blocks, rtol=0, atol=0)
    # the saved layouts (qkv permuted under tp) back to the dense one
    cfg = port_model().cfg
    jmodel = jax_model()
    stacked = _np(jpp.init_pipeline_params(
        jmodel, jprng.init_key(0), n_stages, tp, interleave)["blocks"])
    dense = tree_to_numpy(pp.dense_layer_blocks(
        tree_from_jax(stacked, "cpu"), cfg, tp))
    assert_trees_close(dense, _np(jpp.dense_layer_blocks(
        stacked, jmodel.cfg, tp)), rtol=0, atol=0)
    assert_trees_close(dense, blocks, rtol=0, atol=0)
    # and the way back: dense per-layer blocks to the saved layout
    t = pp.to_pipeline_blocks(layers, cfg, n_stages, tp, interleave)
    assert_trees_close(tree_to_numpy(t), stacked, rtol=0, atol=0)
    back = pp.dense_layer_blocks(pp.unstack_blocks(t, nd), cfg, tp)
    assert_trees_close(tree_to_numpy(back), blocks, rtol=0, atol=0)
    # tensors on a device no host copy is made for (a card's; here the
    # meta device's) stay on their device
    meta = pp.dense_layer_blocks(
        [jax.tree_util.tree_map(lambda x: x.to("meta"), b) for b in layers],
        cfg, tp)
    assert {x.device.type for x in jax.tree_util.tree_leaves(meta)} == {
        "meta"}


def _spec_dims(spec):
    """A JAX PartitionSpec as the port's rule: the dims of its tensor and
    pipe axes."""
    def dim(axis):
        dims = [i for i, a in enumerate(spec) if a == axis]
        return dims[0] if dims else None

    return [dim("tensor"), dim("pipe")]


@pytest.mark.parametrize("tp,interleave", [(1, 1), (2, 1), (2, 2)])
def test_pipeline_param_specs_match_jax(tp, interleave):
    params = _np(jpp.init_pipeline_params(jax_model(), jprng.init_key(0), 2,
                                          tp, interleave))
    want = jax.tree_util.tree_map(_spec_dims, jpp.pipeline_param_specs(
        params, tp, interleave), is_leaf=lambda x: isinstance(x, P))
    got = jax.tree_util.tree_map(lambda s: [s.tensor, s.pipe],
                                 pp.pipeline_param_specs(params, tp,
                                                         interleave))
    lists = dict(is_leaf=lambda x: isinstance(x, list) and (
        not x or not isinstance(x[0], dict)))
    assert jax.tree_util.tree_flatten_with_path(got, **lists)[0] == \
        jax.tree_util.tree_flatten_with_path(want, **lists)[0]


GRID = [(s, m, v) for s in (2, 3, 4) for v in (1, 2, 3)
        for m in (s, 2 * s, 3 * s + (1 if v == 1 else 0))]


def test_schedule_matches_jax():
    jidx = jax.jit(jpp._schedule_indices, static_argnums=(2, 3, 4))
    for s, m, v in GRID:
        ticks = pp.schedule_ticks(s, m, v)
        assert ticks == jpp.schedule_ticks(s, m, v)
        assert pp.bubble_fraction(s, m, v) == jpp.bubble_fraction(s, m, v)
        t_ = np.arange(ticks)[:, None]
        d_ = np.arange(s)[None, :]
        want = [np.broadcast_to(np.asarray(a), (ticks, s))
                for a in jidx(t_, d_, s, m, v)]
        for t in range(ticks):
            for d in range(s):
                got = pp._schedule_indices(t, d, s, m, v)
                assert tuple(int(g) for g in got) == tuple(
                    int(w[t, d]) for w in want), (s, m, v, t, d)


# ---------------------------------------------------------------------------
# (b)-(d) the train and eval steps against JAX's
# ---------------------------------------------------------------------------

STEPS = {
    "pipe2_mb4": dict(pipe=2, n_mb=4),
    "pipe4_mb4": dict(pipe=4, n_mb=4),
    "pipe2_data2_mb2": dict(pipe=2, data=2, n_mb=2),
    "interleave2_mb2": dict(pipe=2, v=2, n_mb=2),
    "interleave2_mb4": dict(pipe=2, v=2, n_mb=4),
    "remat": dict(pipe=2, n_mb=4, model=dict(remat=True)),
    "ce_chunk": dict(pipe=2, n_mb=2, model=dict(ce_chunk=8)),
    "grad_clip": dict(pipe=2, n_mb=4, grad_clip=0.05),
    "ragged": dict(pipe=2, n_mb=4, rows=7),
    # (d) the compositions
    "dp_tp_pp": dict(pipe=2, data=2, tensor=2, n_mb=2),
    "pp_sp_ring_flash": dict(pipe=2, seq=2, model=dict(
        attention="ring_flash", n_layers=2)),
    "pp_sp_striped_flash": dict(pipe=2, seq=2, model=dict(
        attention="striped_flash", n_layers=2)),
    "pp_sp_tp": dict(pipe=2, seq=2, tensor=2, model=dict(
        attention="ring_flash", n_layers=2)),
}


def _case(name):
    c = dict(STEPS[name])
    c.setdefault("data", 1)
    c.setdefault("seq", 1)
    c.setdefault("tensor", 1)
    c.setdefault("v", 1)
    c.setdefault("n_mb", None)
    c.setdefault("rows", 8)
    c.setdefault("grad_clip", 0.0)
    c.setdefault("model", {})
    striped = c["model"].get("attention", "").startswith("striped")
    c["batch"] = lm_batch(c["rows"], striped_over=c["seq"] if striped
                          else 1)
    return c


@functools.lru_cache(maxsize=None)
def jax_steps(name, steps=2):
    """(stacked init, per-step losses, final params) of JAX's pipeline step
    on the case's mesh."""
    c = _case(name)
    model = jax_model(**c["model"])
    mesh = _mesh(c["data"], c["pipe"], c["seq"], c["tensor"])
    opt = joptim.sgd(lr=0.1, momentum=0.9)
    state = jpp.init_pipeline_state(model, opt, jprng.init_key(0), c["pipe"],
                                    c["tensor"], c["v"])
    init = _np(state.params)
    state = jpp.shard_pipeline_state(state, mesh, opt, c["v"])
    rows = ("data", "fsdp")
    placed = {k: jax.device_put(v, NamedSharding(
        mesh, P(rows, "seq") if c["seq"] > 1 and k != "mask" else P(rows)))
        for k, v in c["batch"].items()}
    step = jpp.make_pipeline_train_step(
        model, opt, mesh, n_microbatches=c["n_mb"], donate=False,
        grad_clip=c["grad_clip"], interleave=c["v"])
    losses = []
    for _ in range(steps):
        state, loss = step(state, placed)
        losses.append(float(loss))
    return init, losses, _np(state.params)


def _port_groups(c):
    seq = LocalSeqGroup(c["seq"]) if c["seq"] > 1 else None
    tensor = LocalTensorGroup(c["tensor"]) if c["tensor"] > 1 else None
    return seq, tensor


def port_steps(name, init, steps=2):
    c = _case(name)
    seq, tensor = _port_groups(c)
    model = port_model(seq_group=seq, **c["model"])
    opt = optim.sgd(0.1, 0.9, steps=steps)
    state = TrainState.from_params(params_from_jax(init, model.cfg, "cpu"),
                                   opt, model)
    step = pp.make_pipeline_train_step(
        model, opt, world_setup("cpu"), LocalPipeGroup(c["pipe"]),
        n_microbatches=c["n_mb"], grad_clip=c["grad_clip"],
        interleave=c["v"], tensor_group=tensor)
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, tree_to_numpy(state.params)


@pytest.mark.parametrize("name", list(STEPS))
def test_local_pipe_group_step_matches_jax(name):
    init, want, want_params = jax_steps(name)
    got, params = port_steps(name, init)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert_trees_close(params, want_params)
    if name == "grad_clip":     # the clip bites
        assert not np.allclose(want_params["head"]["w"],
                               jax_steps("pipe2_mb4")[2]["head"]["w"])


@pytest.mark.parametrize("name,with_accuracy", [
    ("pipe2_mb4", True), ("interleave2_mb4", True), ("pp_sp_tp", True),
    ("ragged", False)])
def test_eval_step_matches_jax(name, with_accuracy):
    c = _case(name)
    init = jax_steps(name)[0]
    jmodel = jax_model(**c["model"])
    mesh = _mesh(c["data"], c["pipe"], c["seq"], c["tensor"])
    jstep = jpp.make_pipeline_eval_step(
        jmodel, mesh, with_accuracy=with_accuracy,
        n_microbatches=c["n_mb"], interleave=c["v"])
    specs = jpp.pipeline_param_specs(init, c["tensor"], c["v"])
    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), init, specs)
    rows = ("data", "fsdp")
    batch = {k: jax.device_put(v, NamedSharding(
        mesh, P(rows, "seq") if c["seq"] > 1 and k != "mask" else P(rows)))
        for k, v in c["batch"].items()}
    want = {k: float(v) for k, v in jax.device_get(
        jstep(placed, batch)).items()}
    seq, tensor = _port_groups(c)
    model = port_model(seq_group=seq, **c["model"])
    step = pp.make_pipeline_eval_step(
        model, world_setup("cpu"), LocalPipeGroup(c["pipe"]),
        with_accuracy=with_accuracy, n_microbatches=c["n_mb"],
        interleave=c["v"], tensor_group=tensor)
    got = step(params_from_jax(init, model.cfg, "cpu"),
               {k: torch.tensor(v) for k, v in c["batch"].items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (g) the schedule's refusal, with JAX's message
# ---------------------------------------------------------------------------

def test_microbatches_must_group_under_interleave_as_in_jax():
    with pytest.raises(ValueError) as want:
        jpp.make_pipeline_train_step(jax_model(), joptim.sgd(0.1), _mesh(),
                                     n_microbatches=3, interleave=2)
    opt = optim.sgd(0.1, steps=1)
    for make in (lambda: pp.make_pipeline_train_step(
                     port_model(), opt, world_setup("cpu"),
                     LocalPipeGroup(2), n_microbatches=3, interleave=2),
                 lambda: pp.make_pipeline_eval_step(
                     port_model(), world_setup("cpu"), LocalPipeGroup(2),
                     n_microbatches=3, interleave=2)):
        with pytest.raises(ValueError) as got:
            make()
        assert str(got.value) == str(want.value)
