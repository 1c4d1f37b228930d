"""The port's ``--remat``, ``--scan-layers`` and ``attention="auto"``
against the JAX package, on the CPU.

Mirrors ``tests/test_scan_layers.py`` and ``tests/test_attention_auto.py``:
every remat policy leaves the loss and gradients those of JAX (rtol 1e-5,
atol 1e-7, JAX's own bar between its remat and plain runs) and saves what
its name says; the stacked ``scan_layers`` tree is JAX's, its logits,
3-step trajectory and greedy decode equal the per-layer loop's and JAX's,
and it crosses ``interop`` and the checkpoint both ways; remat + scan
run on ``striped_flash`` over ``LocalSeqGroup(4)``; the ``auto`` table is
pinned by device and compute dtype, ``auto`` is dense on the CPU at every
T, and a shape that auto sends to flash but the kernels do not take is
refused, naming ``--attention dense``.  Weights come from
JAX's init, carried across with ``interop``; data from numpy seeds.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neural_networks_parallel_training_with_mpi_tpu.models.generate import (
    generate as jax_generate,
)
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.ops import losses as jlosses
from neural_networks_parallel_training_with_mpi_tpu.ops import optim as joptim
from neural_networks_parallel_training_with_mpi_tpu.train.state import (
    TrainState as JaxTrainState,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import (
    checkpoint as jckpt,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
    build_argparser, config_from_args,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.core import (
    make_remat,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate import (
    generate,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, layer_params,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import losses
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    data_parallel as dp,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (
    world_setup,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (
    AUTO_FLASH_MIN_SEQ, LocalSeqGroup, resolve_attention_impl,
    striped_permutation,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
    Scheduler, ServeConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (
    TrainState,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (
    Trainer,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
    checkpoint as ckpt,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (
    leaves,
)

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(vocab_size=64, max_seq_len=16, n_layers=2, d_model=32,
             n_heads=4, d_ff=64)
POLICIES = ("full", "dots", "dots_no_batch")


def _ids(seed, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


def _stack(blocks):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks)


def _jax_params(seed=0, **cfg):
    return jax.device_get(JaxTransformer(JaxConfig(**dict(SMALL, **cfg)))
                          .init(jprng.init_key(seed)))


def _same_leaves(got, want):
    """Exact equality leaf for leaf, in ``jax.tree_util`` order."""
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _port(**cfg):
    return Transformer(TransformerConfig(**SMALL, attention="dense", **cfg),
                       device="cpu")


def _loss_and_grads(model, params, ids, tgt):
    ps = leaves(params)
    for p in ps:
        p.requires_grad_()
    s, c = losses.softmax_cross_entropy(
        model.forward(params, torch.tensor(ids).long()),
        torch.tensor(tgt).long())
    loss = s / c
    return loss, torch.autograd.grad(loss, ps)


# ------------------------------------------------------------------ remat

@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_loss_and_grads_match_jax(policy):
    """JAX's remat run and the port's from the same params: the loss and
    every gradient, at JAX's own bar between its remat and plain runs."""
    ids, tgt = _ids(0), _ids(1)
    jcfg = JaxConfig(**SMALL, remat=True, remat_policy=policy)
    jparams = _jax_params()

    def loss(p):
        s, c = jlosses.softmax_cross_entropy(
            JaxTransformer(jcfg).apply(p, jnp.asarray(ids)), jnp.asarray(tgt))
        return s / c

    jv, jg = jax.value_and_grad(loss)(jparams)
    model = _port(remat=True, remat_policy=policy)
    params = params_from_jax(jparams, model.cfg, "cpu")
    v, g = _loss_and_grads(model, params, ids, tgt)
    assert float(v) == pytest.approx(float(jv), rel=1e-6)
    want = [np.asarray(x) for x in
            jax.tree_util.tree_leaves(tree_to_numpy(params))]
    assert len(want) == len(g)
    got = tree_to_numpy(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree_to_numpy(params)),
        [x.numpy() for x in g]))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                                atol=1e-7),
        got, jax.device_get(jg))


class _Ops(TorchDispatchMode):
    """Counts the aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(**kw):
    model = _port(**kw)
    params = params_from_jax(_jax_params(), model.cfg, "cpu")
    for p in leaves(params):
        p.requires_grad_()
    out = model.forward(params, torch.tensor(_ids(0)).long()).sum()
    ops = _Ops()
    with ops:
        out.backward()
    return ops.n


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_saves_what_it_names(policy):
    """The backward's matmuls beyond the plain backward's gradient
    products: ``full`` recomputes the forward products of the 2 blocks
    that the backward needs (qkv, attn_out, ff_in: 3 mm per layer, the
    recompute stopping before ff_out, whose output no gradient reads;
    scores and values: 2 bmm per layer); ``dots`` none (mm and bmm
    saved); ``dots_no_batch`` the batched attention products only.
    Every policy recomputes the softmax."""
    plain = _backward_ops()
    ops = _backward_ops(remat=True, remat_policy=policy)
    recomputed = {k: ops.get(k, 0) - plain.get(k, 0) for k in ("mm", "bmm")}
    want = {"full": {"mm": 6, "bmm": 4}, "dots": {"mm": 0, "bmm": 0},
            "dots_no_batch": {"mm": 0, "bmm": 4}}[policy]
    assert recomputed == want
    assert (plain.get("_softmax", 0), ops.get("_softmax", 0)) == (0, 2)


def test_make_remat_rejects_unknown_policy():
    with pytest.raises(ValueError, match="unknown remat policy"):
        make_remat("everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        _port(remat=True, remat_policy="everything")
    cfg = config_from_args(build_argparser().parse_args(
        ["--dataset", "lm", "--remat"]))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat_policy="everything"))
    with pytest.raises(ValueError, match="unknown remat policy"):
        Trainer(cfg, device="cpu")


# ------------------------------------------------------------ scan_layers

def test_scan_init_is_stacked_and_equal():
    """The stacked init is the loop init stacked (the same draws), in JAX's
    stacked tree: the same leaf paths and shapes."""
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    loop = _port().init(gen())
    scan = _port(scan_layers=True).init(gen())
    assert isinstance(scan["blocks"], dict)
    for k in ("embed", "pos", "ln_f", "head"):
        for a, b in zip(leaves(scan[k]), leaves(loop[k])):
            assert torch.equal(a, b)
    for name, sub in scan["blocks"].items():
        for leaf, x in sub.items():
            assert torch.equal(x, torch.stack([b[name][leaf]
                                               for b in loop["blocks"]]))
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     _jax_params(scan_layers=True))
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), scan)
    assert jshapes == tshapes


def test_scan_params_from_jax_keep_the_stack():
    jp = _jax_params(1, scan_layers=True)
    model = _port(scan_layers=True)
    params = params_from_jax(jp, model.cfg, "cpu")
    assert isinstance(params["blocks"], dict)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           tree_to_numpy(params), jp)
    with pytest.raises(ValueError, match="per-layer list"):
        params_from_jax(_jax_params(1), model.cfg, "cpu")


def test_scan_logits_match_loop_and_jax():
    jp = _jax_params(1)
    stacked = dict(jp, blocks=_stack(jp["blocks"]))
    ids = _ids(2)
    want = np.asarray(JaxTransformer(JaxConfig(**SMALL, scan_layers=True))
                      .apply(stacked, jnp.asarray(ids)))
    loop, scan = _port(), _port(scan_layers=True)
    got_loop = loop.forward(params_from_jax(jp, loop.cfg, "cpu"),
                            torch.tensor(ids).long())
    got_scan = scan.forward(params_from_jax(stacked, scan.cfg, "cpu"),
                            torch.tensor(ids).long())
    np.testing.assert_array_equal(got_scan.numpy(), got_loop.numpy())
    np.testing.assert_allclose(got_scan.numpy(), want, **TOL)


def _port_trajectory(model, params, batches):
    opt = optim.sgd(1e-2, 0.9, steps=len(batches))
    state = TrainState.from_params(params, opt)
    step = dp.make_train_step(model, opt, world_setup("cpu"),
                              loss_name="cross_entropy")
    out = []
    for x, y in batches:
        state, loss = step(state, {"x": torch.tensor(x).long(),
                                   "y": torch.tensor(y).long()})
        out.append(float(loss))
    return out, state.params


def test_scan_three_steps_equal_loop_and_jax():
    jp = _jax_params(2)
    batches = [(_ids(10 + i), _ids(20 + i)) for i in range(3)]
    loop, scan = _port(), _port(scan_layers=True)
    l_loop, p_loop = _port_trajectory(
        loop, params_from_jax(jp, loop.cfg, "cpu"), batches)
    stacked = dict(jp, blocks=_stack(jp["blocks"]))
    l_scan, p_scan = _port_trajectory(
        scan, params_from_jax(stacked, scan.cfg, "cpu"), batches)
    assert l_scan == l_loop
    for a, b in zip(leaves(dict(p_scan, blocks=layer_params(p_scan))),
                    leaves(p_loop)):
        assert torch.equal(a, b)
    # JAX: the same 3 SGD-momentum steps on the stacked tree
    jm = JaxTransformer(JaxConfig(**SMALL, scan_layers=True))
    jopt = joptim.sgd(1e-2, 0.9)
    jparams, jstate, jl = stacked, jopt.init(stacked), []
    for x, y in batches:
        def loss(p):
            s, c = jlosses.softmax_cross_entropy(jm.apply(p, jnp.asarray(x)),
                                                 jnp.asarray(y))
            return s / c
        v, g = jax.value_and_grad(loss)(jparams)
        jparams, jstate = jopt.update(g, jstate, jparams)
        jl.append(float(v))
    np.testing.assert_allclose(l_scan, jl, **TOL)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
        tree_to_numpy(p_scan), jax.device_get(jparams))


def test_scan_generate_matches_loop_and_jax():
    jp = _jax_params(1)
    stacked = dict(jp, blocks=_stack(jp["blocks"]))
    prompt = [[1, 2, 3], [7, 8, 9]]
    want = np.asarray(jax_generate(
        JaxTransformer(JaxConfig(**SMALL, scan_layers=True)), stacked,
        jnp.asarray(prompt, jnp.int32), 6))
    loop, scan = _port(), _port(scan_layers=True)
    got_scan = generate(scan, params_from_jax(stacked, scan.cfg, "cpu"),
                        prompt, 6, device="cpu")
    got_loop = generate(loop, params_from_jax(jp, loop.cfg, "cpu"), prompt,
                        6, device="cpu")
    np.testing.assert_array_equal(got_scan.numpy(), got_loop.numpy())
    np.testing.assert_array_equal(got_scan.numpy(), want)


def test_paged_server_takes_the_stacked_tree():
    """The server walks per-layer views of the stacked leaves (no copy)
    and serves the loop tree's tokens."""
    jp = _jax_params(1, max_seq_len=64)
    cfg = dict(SMALL, max_seq_len=64)
    stacked = dict(jp, blocks=_stack(jp["blocks"]))
    requests = [([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 8), ([7, 8], 6),
                ([5, 9, 11, 13], 9)]
    got = {}
    for scan in (False, True):
        model = Transformer(TransformerConfig(**cfg, scan_layers=scan),
                            device="cpu")
        params = params_from_jax(stacked if scan else jp, model.cfg, "cpu")
        sched = Scheduler(model, params, ServeConfig(
            slots=2, num_blocks=24, block_size=4, prefill_chunk=4),
            device="cpu")
        if scan:
            w = params["blocks"]["qkv"]["w"]
            assert sched.server.layers[1]["qkv"]["w"].data_ptr() == \
                w[1].data_ptr()
        rids = [sched.submit(p, n) for p, n in requests]
        sched.run_until_drained()
        got[scan] = [sched.result(r) for r in rids]
    assert got[True] == got[False]


def test_scan_interop_round_trips_a_jax_train_state():
    jm = JaxTransformer(JaxConfig(**SMALL, scan_layers=True))
    jstate = jax.device_get(JaxTrainState.create(jm, joptim.adam(1e-3),
                                                 jprng.init_key(2)))
    state = tree_from_jax(jstate, "cpu")
    assert isinstance(state.params["blocks"], dict)
    _same_leaves((state.step, tree_to_numpy(state.params),
                  tree_to_numpy(state.opt_state)),
                 (jstate.step, jstate.params, jstate.opt_state))


def _port_scan_state():
    model = _port(scan_layers=True)
    return TrainState.from_params(model.init(torch.Generator().manual_seed(0)),
                                  optim.adam(1e-3, steps=0))


def test_scan_snapshot_paths_are_jaxs(tmp_path):
    """The port writes the stacked tree under JAX's flatten paths."""
    target = ckpt.save(str(tmp_path), _port_scan_state())
    paths = json.loads((target / ckpt.LEAVES).read_text())
    jm = JaxTransformer(JaxConfig(**SMALL, scan_layers=True))
    jstate = JaxTrainState.create(jm, joptim.adam(1e-3), jprng.init_key(0))
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "name",
                                                      getattr(k, "idx", k))))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(
                  (jstate.step, jstate.params, jstate.opt_state))[0]]
    assert len(paths) == len(jpaths)
    assert [p.split("/", 1)[1] for p in paths[1:]] == [
        p.split("/", 1)[1] for p in jpaths[1:]]
    assert "params/blocks/qkv/w" in paths


def test_scan_jax_snapshot_restores_into_the_port(tmp_path):
    jm = JaxTransformer(JaxConfig(**SMALL, scan_layers=True))
    jstate = JaxTrainState.create(jm, joptim.adam(1e-3), jprng.init_key(4))
    jstate = jstate._replace(step=jnp.asarray(3, jnp.int32))
    jckpt.save(str(tmp_path), jstate)
    restored = ckpt.restore(str(tmp_path), _port_scan_state())
    assert restored.step == 3
    j = jax.device_get(jstate)
    _same_leaves([restored.step, tree_to_numpy(restored.params),
                  tree_to_numpy(restored.opt_state)],
                 [j.step, j.params, j.opt_state])


def test_scan_port_snapshot_restores_through_jax(tmp_path):
    state = _port_scan_state()
    with torch.no_grad():
        for p in leaves(state.params):
            p.mul_(1.5)
    state = state._replace(step=7)
    target = ckpt.save(str(tmp_path), state)
    jm = JaxTransformer(JaxConfig(**SMALL, scan_layers=True))
    template = jax.device_get(JaxTrainState.create(jm, joptim.adam(1e-3),
                                                   jprng.init_key(0)))
    (target / "treedef.pkl").write_bytes(
        pickle.dumps(jax.tree_util.tree_structure(template)))
    restored = jckpt.restore(str(tmp_path), template)
    assert int(restored.step) == 7
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           tree_to_numpy(state.params),
                           jax.device_get(restored.params))


# ------------------------------------------- remat + scan on the striped ring

def test_remat_scan_striped_flash_equals_flash():
    """f32, 3 SGD steps: remat + scan_layers with striped_flash over
    LocalSeqGroup(4) (the kernels' plain versions on the CPU) against
    flash without either, within the striped identity's bars (losses
    rtol 1e-5, params 1e-6)."""
    cfg = dict(SMALL, max_seq_len=32)
    jp = jax.device_get(JaxTransformer(JaxConfig(**cfg)).init(
        jprng.init_key(5)))
    batches = [(_ids(30 + i, (2, 32)), _ids(40 + i, (2, 32)))
               for i in range(3)]
    runs = {}
    for name, kw, group in (
            ("flash", dict(attention="flash"), None),
            ("striped", dict(attention="striped_flash", remat=True,
                             scan_layers=True), LocalSeqGroup(4))):
        model = Transformer(TransformerConfig(**cfg, **kw), device="cpu",
                            seq_group=group)
        tree = dict(jp, blocks=_stack(jp["blocks"])) if group else jp
        params = params_from_jax(tree, model.cfg, "cpu")
        perm = striped_permutation(32, 4) if group else None
        opt = optim.sgd(1e-2, 0.9, steps=len(batches))
        state = TrainState.from_params(params, opt)
        step = dp.make_train_step(model, opt, world_setup("cpu"),
                                  loss_name="cross_entropy")
        out = []
        for x, y in batches:
            if perm is not None:
                x, y = x[:, perm], y[:, perm]
            state, loss = step(state, {"x": torch.tensor(x).long(),
                                       "y": torch.tensor(y).long()})
            out.append(float(loss))
        runs[name] = (out, leaves(dict(state.params,
                                       blocks=layer_params(state.params))))
    (lf, pf), (ls, ps) = runs["flash"], runs["striped"]
    np.testing.assert_allclose(ls, lf, rtol=1e-5)
    assert len(ps) == len(pf)
    for a, b in zip(ps, pf):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-6)


# ------------------------------------------------------------------- auto

def test_auto_table_pinned():
    """The H100's rows are phase 17a's measurement, by compute dtype; the
    CPU has no row."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert AUTO_FLASH_MIN_SEQ == {("cuda", bf16): 256, ("cuda", f32): 256}
    for dtype in (bf16, f32):
        for t in (16, 128, 255):
            assert resolve_attention_impl("auto", t, "cuda", dtype) == "dense"
        for t in (256, 1024, 8192):
            assert resolve_attention_impl("auto", t, "cuda", dtype) == "flash"
    for t in (128, 2048, 65536):
        assert resolve_attention_impl("auto", t, "cuda",
                                      torch.float16) == "dense"
        for dtype in (bf16, f32):
            assert resolve_attention_impl("auto", t, "cpu", dtype) == "dense"
    for impl in ("dense", "flash", "ring", "ring_flash", "striped",
                 "striped_flash"):
        assert resolve_attention_impl(impl, 8192, "cuda", bf16) == impl


@pytest.mark.parametrize("t,head_dim,scale,why", [
    (300, 64, None, "divisible"), (1000, 64, None, "divisible"),
    (256, 96, None, "head_dim"), (512, 64, 0.1, "scale")],
    ids=["T300", "T1000", "head_dim96", "scale"])
def test_auto_refuses_what_flash_cannot_take(t, head_dim, scale, why):
    """Where auto picks flash for a shape the kernels do not take it
    raises, naming --attention dense, in bf16 and in f32; it never falls
    back quietly.  float16 has no row, so auto stays dense there."""
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match=f"{why}.*--attention dense"):
            resolve_attention_impl("auto", t, "cuda", dtype, head_dim,
                                   scale=scale)
        # under the row no kernel is asked, whatever the shape
        assert resolve_attention_impl("auto", 200, "cuda", dtype, head_dim,
                                      scale=scale) == "dense"
    assert resolve_attention_impl("auto", t, "cuda", torch.float16,
                                  head_dim, scale=scale) == "dense"


def test_auto_refusal_at_construction(monkeypatch):
    """A CPU row (set here) stands in for the card's: the model refuses a
    head_dim the kernels do not take, the trainer a seq_len the blocks do
    not divide, both before anything runs, and the forward any other
    such length."""
    monkeypatch.setitem(AUTO_FLASH_MIN_SEQ, ("cpu", torch.float32), 256)
    with pytest.raises(ValueError, match="head_dim.*--attention dense"):
        Transformer(TransformerConfig(**dict(SMALL, d_model=96, n_heads=1,
                                             max_seq_len=512)),
                    device="cpu")
    # under the row the model takes any head_dim
    Transformer(TransformerConfig(**dict(SMALL, d_model=96, n_heads=1,
                                         max_seq_len=255)), device="cpu")
    flags = ["--dataset", "lm", "--no-full-batch", "--batch_size", "2",
             "--n_samples", "4", "--seq_len", "300", "--n_layers", "1",
             "--d_model", "32", "--n_heads", "4", "--d_ff", "64",
             "--vocab_size", "64", "--nepochs", "1"]
    cfg = config_from_args(build_argparser().parse_args(flags))
    with pytest.raises(ValueError, match="300.*--attention dense"):
        Trainer(cfg, device="cpu")
    cfg = config_from_args(build_argparser().parse_args(
        flags[:flags.index("--seq_len") + 1] + ["256"]
        + flags[flags.index("--seq_len") + 2:]))
    Trainer(cfg, device="cpu")
    model = Transformer(TransformerConfig(**dict(SMALL, max_seq_len=512)),
                        device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="300.*--attention dense"):
        model.forward(params, torch.zeros((1, 300), dtype=torch.long))


@pytest.mark.parametrize("t", [16, 256, 512])
def test_auto_equals_dense_on_cpu(t):
    cfg = dict(SMALL, max_seq_len=512)
    jp = jax.device_get(JaxTransformer(JaxConfig(**cfg)).init(
        jprng.init_key(0)))
    ids = torch.tensor(_ids(3, (1, t))).long()
    out = {}
    for attention in ("auto", "dense"):
        model = Transformer(TransformerConfig(**cfg, attention=attention),
                            device="cpu")
        out[attention] = model.forward(params_from_jax(jp, model.cfg, "cpu"),
                                       ids)
    assert torch.equal(out["auto"], out["dense"])
