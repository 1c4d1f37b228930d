"""The port's Megatron functions and its two new attentions against the
JAX package, on the CPU.

``f``/``g``, the qkv column permutation, the checks, ``tp_block_apply``
and the four vocab-parallel functions over a ``LocalTensorGroup(2)`` and
over 2 gloo ranks (``ProcessTensorGroup``), against JAX's functions under
``shard_map`` on a ``tensor`` mesh of 2 fake CPU devices; their
gradients against the port's dense forms; ``ulysses`` (over
``LocalSeqGroup`` and a 2-rank ``ProcessSeqGroup``) and
``dense_blockwise`` against JAX's.  Same inputs from numpy, f32 on both
sides.  Tolerance 1e-5 (rtol and atol): the two differ in summation
order only (JAX's own TP test, ``tests/test_composition.py``, holds rtol
2e-4 with atol 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    TransformerConfig as JaxTConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    megatron as jmeg,
    sequence as jsq,
    spmd as jspmd,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    tree_from_jax,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import losses
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    megatron,
    sequence as sq,
)
from torch_tp_child import spawn

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(vocab_size=64, max_seq_len=32, n_layers=1, d_model=32,
             n_heads=4, d_ff=64)
BLOCK_VARIANTS = {"mha": {}, "gqa": dict(n_kv_heads=2),
                  "swiglu": dict(activation="swiglu"),
                  "rope": dict(pos_encoding="rope")}


def _mesh(axis, n):
    return Mesh(np.array(jax.devices("cpu")[:n]), (axis,))


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# f / g
# ---------------------------------------------------------------------------

def _fg_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((3, 8)).astype(np.float32),
                w=rng.standard_normal((2, 8, 5)).astype(np.float32),
                ct=rng.standard_normal((3, 5)).astype(np.float32))


def _fg_jax(inp):
    """JAX's g(f(x) @ w_r) under shard_map and the input's gradient."""
    f, g = jmeg.make_megatron_ops()

    def fn(x, w):
        return g(f(x) @ w[0])

    def loss(x):
        y = jax.shard_map(fn, mesh=_mesh("tensor", 2),
                          in_specs=(P(), P("tensor")), out_specs=P(),
                          check_vma=False)(x, inp["w"])
        return jnp.sum(y * inp["ct"]), y

    (_, y), gx = jax.value_and_grad(loss, has_aux=True)(inp["x"])
    return np.asarray(y), np.asarray(gx)


def test_f_g_local_group_match_jax_and_the_dense_product():
    inp = _fg_inputs()
    y_j, gx_j = _fg_jax(inp)
    group = megatron.LocalTensorGroup(2)
    f, g = megatron.make_megatron_ops(group)
    x = torch.tensor(inp["x"], requires_grad=True)
    y = g([f(x) @ torch.tensor(w) for w in inp["w"]])
    (y * torch.tensor(inp["ct"])).sum().backward()
    np.testing.assert_allclose(_np(y), y_j, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), gx_j, **TOL)
    # the dense form: x @ (w_0 + w_1), gradient ct @ (w_0 + w_1)^T
    w = inp["w"].sum(0)
    np.testing.assert_allclose(_np(y), inp["x"] @ w, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), inp["ct"] @ w.T, **TOL)


# ---------------------------------------------------------------------------
# the qkv permutation and the checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,h,tp,kv", [(32, 4, 2, 0), (32, 4, 4, 0),
                                       (64, 8, 2, 2), (64, 8, 4, 4),
                                       (1024, 16, 4, 0), (48, 6, 3, 3)])
def test_qkv_tp_permutation_matches_jax_and_round_trips(d, h, tp, kv):
    want = jmeg.qkv_tp_permutation(d, h, tp, kv)
    got = megatron.qkv_tp_permutation(d, h, tp, kv)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    cfg = TransformerConfig(**dict(SMALL, d_model=d, n_heads=h, d_ff=2 * d,
                                   n_kv_heads=kv or None))
    params = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    blocks = params["blocks"]
    perm = megatron.permute_qkv(blocks, d, h, tp, kv_heads=kv)
    back = megatron.permute_qkv(perm, d, h, tp, inverse=True, kv_heads=kv)
    jperm = jmeg.permute_qkv(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), blocks), d, h, tp, kv_heads=kv)
    for layer, p, b, jp in zip(blocks, perm, back, jperm):
        for sub in layer:
            for name, t in layer[sub].items():
                assert torch.equal(b[sub][name], t)
                np.testing.assert_array_equal(_np(p[sub][name]),
                                              np.asarray(jp[sub][name]))


@pytest.mark.parametrize("over,tp", [(dict(n_kv_heads=2), 4),
                                     (dict(d_ff=66), 4),
                                     (dict(n_heads=2, d_model=32), 4),
                                     (dict(d_model=30, n_heads=3), 4)])
def test_validate_tp_raises_jax_messages(over, tp):
    cfg = dict(SMALL, **over)
    jcfg = JaxTConfig(**cfg)
    with pytest.raises(ValueError) as want:
        jmeg.validate_tp(jcfg, tp)
    with pytest.raises(ValueError) as got:
        megatron.validate_tp(TransformerConfig(**cfg), tp)
    assert str(got.value) == str(want.value)
    megatron.validate_tp(TransformerConfig(**SMALL), 2)


def test_validate_ulysses_under_tp_raises_jax_message():
    with pytest.raises(ValueError) as want:
        jsq.validate_ulysses_under_tp(8, 2, 3)
    with pytest.raises(ValueError) as got:
        sq.validate_ulysses_under_tp(8, 2, 3)
    assert str(got.value) == str(want.value)
    sq.validate_ulysses_under_tp(8, 2, 2)


# ---------------------------------------------------------------------------
# tp_block_apply
# ---------------------------------------------------------------------------

def _block_case(variant, seed=0):
    cfg = dict(SMALL, **BLOCK_VARIANTS[variant])
    tcfg = TransformerConfig(**cfg, attention="dense")
    model = Transformer(tcfg, device="cpu")
    layer = model.init(torch.Generator().manual_seed(seed))["blocks"][0]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ct = rng.standard_normal((2, 16, 32)).astype(np.float32)
    return cfg, model, layer, x, ct


@pytest.mark.parametrize("variant", list(BLOCK_VARIANTS))
def test_tp_block_apply_matches_jax_shard_map(variant):
    cfg, model, layer, x, _ = _block_case(variant)
    jcfg = JaxTConfig(**cfg)
    perm = megatron.permute_qkv([layer], 32, 4, 2,
                                kv_heads=model.cfg.kv_heads)[0]
    jlayer = jax.tree_util.tree_map(lambda t: jnp.asarray(_np(t)), perm)
    specs = jspmd.sp_tp_param_specs({"blocks": [jlayer]})["blocks"][0]
    want = jax.shard_map(
        lambda lp, h: jmeg.tp_block_apply(jcfg, lp, h, 2),
        mesh=_mesh("tensor", 2), in_specs=(specs, P()), out_specs=P(),
        check_vma=False)(jlayer, x)
    shards = megatron.shard_layer(perm, 2)
    got = megatron.tp_block_apply(model.cfg, shards, torch.tensor(x),
                                  megatron.LocalTensorGroup(2))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", list(BLOCK_VARIANTS))
def test_tp_block_apply_gradients_equal_the_dense_block(variant):
    """The shards of a dense-order layer taken head-aligned
    (``shard_layer`` with the permutation's index): output and every
    gradient (x, and each leaf of the dense layer) equal the dense
    block's."""
    cfg, model, layer, x, ct = _block_case(variant)
    c = model.cfg
    idx = torch.as_tensor(megatron.qkv_tp_permutation(32, 4, 2, c.kv_heads))

    def run(fn):
        lp = {s: {k: t.clone().requires_grad_() for k, t in sub.items()}
              for s, sub in layer.items()}
        xt = torch.tensor(x, requires_grad=True)
        out = fn(lp, xt)
        (out * torch.tensor(ct)).sum().backward()
        return out, xt.grad, lp

    pos = torch.arange(16)
    dense = run(lambda lp, xt: model.block(lp, xt, pos, model.attend))
    tp = run(lambda lp, xt: megatron.tp_block_apply(
        c, megatron.shard_layer(lp, 2, idx), xt,
        megatron.LocalTensorGroup(2)))
    np.testing.assert_allclose(_np(tp[0]), _np(dense[0]), **TOL)
    np.testing.assert_allclose(_np(tp[1]), _np(dense[1]), **TOL)
    for sub in layer:
        for k in layer[sub]:
            np.testing.assert_allclose(
                _np(tp[2][sub][k].grad), _np(dense[2][sub][k].grad),
                err_msg=f"{sub}/{k}", **TOL)


def test_shard_layer_takes_whole_heads_of_a_dense_layer():
    cfg, model, layer, _, _ = _block_case("gqa")
    idx = torch.as_tensor(megatron.qkv_tp_permutation(32, 4, 2, 2))
    shards = megatron.shard_layer(layer, 2, idx)
    perm = megatron.permute_qkv([layer], 32, 4, 2, kv_heads=2)[0]
    for r, sh in enumerate(shards):
        assert torch.equal(sh["qkv"]["w"], perm["qkv"]["w"].chunk(2, -1)[r])
        assert torch.equal(sh["attn_out"]["w"],
                           layer["attn_out"]["w"].chunk(2, 0)[r])
        assert sh["ln1"]["scale"] is layer["ln1"]["scale"]


# ---------------------------------------------------------------------------
# vocab parallelism
# ---------------------------------------------------------------------------

def _vocab_inputs(seed=0, b=2, t=8, d=16, v=64):
    rng = np.random.default_rng(seed)
    return dict(
        table=rng.standard_normal((v, d)).astype(np.float32),
        head=rng.standard_normal((d, v)).astype(np.float32) * 0.5,
        h=rng.standard_normal((b, t, d)).astype(np.float32),
        ids=rng.integers(0, v, (b, t)).astype(np.int64),
        tgt=rng.integers(0, v, (b, t)).astype(np.int64),
        mask=np.array([1.0, 0.0][:b], np.float32),
        emb_ct=rng.standard_normal((b, t, d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _vocab_jax(seed=0):
    inp = _vocab_inputs(seed)

    def fn(table, head, h, ids, tgt, mask):
        emb = jmeg.vocab_parallel_embed(table, ids)
        logits = jmeg.vocab_parallel_logits(h, head)
        s, c = jmeg.vocab_parallel_cross_entropy(logits, tgt, mask)
        hs, hc = jmeg.vocab_parallel_accuracy(logits, tgt, mask)
        return emb, s, c, hs, hc

    out = jax.shard_map(
        fn, mesh=_mesh("tensor", 2),
        in_specs=(P("tensor", None), P(None, "tensor"), P(), P(), P(), P()),
        out_specs=P(), check_vma=False)(
            inp["table"], inp["head"], inp["h"], inp["ids"].astype(np.int32),
            inp["tgt"].astype(np.int32), inp["mask"])
    return [np.asarray(a) for a in out]


def _vocab_port(inp, group):
    table = torch.tensor(inp["table"], requires_grad=True)
    head = torch.tensor(inp["head"], requires_grad=True)
    h = torch.tensor(inp["h"], requires_grad=True)
    ids, tgt = torch.tensor(inp["ids"]), torch.tensor(inp["tgt"])
    mask = torch.tensor(inp["mask"])
    emb = megatron.vocab_parallel_embed(list(table.chunk(2, 0)), ids, group)
    logits = megatron.vocab_parallel_logits(h, list(head.chunk(2, 1)), group)
    s, c = megatron.vocab_parallel_cross_entropy(logits, tgt, mask, group)
    hs, hc = megatron.vocab_parallel_accuracy(logits, tgt, mask, group)
    (s + (emb * torch.tensor(inp["emb_ct"])).sum()).backward()
    s = s.detach()
    return dict(emb=_np(emb), s=float(s), c=float(c), hs=float(hs),
                hc=float(hc), table=table.grad.numpy(),
                head=head.grad.numpy(), h=h.grad.numpy())


def _vocab_dense(inp):
    """The dense forms: table[ids], the full logits' softmax CE and
    argmax accuracy, and their gradients."""
    table = torch.tensor(inp["table"], requires_grad=True)
    head = torch.tensor(inp["head"], requires_grad=True)
    h = torch.tensor(inp["h"], requires_grad=True)
    mask = torch.tensor(inp["mask"])
    emb = table[torch.tensor(inp["ids"])]
    logits = h @ head
    s, c = losses.softmax_cross_entropy(logits, torch.tensor(inp["tgt"]),
                                        mask)
    hs, hc = losses.accuracy(logits, torch.tensor(inp["tgt"]), mask)
    (s + (emb * torch.tensor(inp["emb_ct"])).sum()).backward()
    s = s.detach()
    return dict(emb=_np(emb), s=float(s), c=float(c), hs=float(hs),
                hc=float(hc), table=table.grad.numpy(),
                head=head.grad.numpy(), h=h.grad.numpy())


def _check_vocab(got, inp):
    emb, s, c, hs, hc = _vocab_jax()
    np.testing.assert_allclose(got["emb"], emb, **TOL)
    np.testing.assert_allclose([got["s"], got["c"], got["hs"], got["hc"]],
                               [s, c, hs, hc], **TOL)
    dense = _vocab_dense(inp)
    for k in ("table", "head", "h"):
        np.testing.assert_allclose(got[k], dense[k], err_msg=k, **TOL)


def test_vocab_parallel_functions_local_group_match_jax():
    inp = _vocab_inputs()
    _check_vocab(_vocab_port(inp, megatron.LocalTensorGroup(2)), inp)


def test_vocab_parallel_accuracy_breaks_ties_to_the_first_index():
    """Equal maxima on both shards: the smallest global index wins, as
    argmax's first occurrence (and JAX's pmin)."""
    lg = torch.zeros(1, 1, 8)
    lg[0, 0, 1] = lg[0, 0, 5] = 3.0
    for tgt, hit in ((1, 1.0), (5, 0.0)):
        hs, hc = megatron.vocab_parallel_accuracy(
            list(lg.chunk(2, -1)), torch.tensor([[tgt]]), None,
            megatron.LocalTensorGroup(2))
        assert (float(hs), float(hc)) == (hit, 1.0)


# ---------------------------------------------------------------------------
# ulysses and dense_blockwise
# ---------------------------------------------------------------------------

def _qkv(b=2, t=32, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_ulysses(qkv, s, causal):
    fn = functools.partial(jsq.ulysses_attention, causal=causal)
    spec = P(None, "seq")
    return np.asarray(jax.shard_map(
        fn, mesh=_mesh("seq", s), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False)(*qkv))


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_local_group_matches_jax_and_dense(s, causal):
    qkv = _qkv()
    want = _jax_ulysses(qkv, s, causal)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in qkv)
    got = sq.sequence_sharded_attention("ulysses", q, k, v,
                                        group=sq.LocalSeqGroup(s),
                                        causal=causal)
    np.testing.assert_allclose(_np(got), want, **TOL)
    do = torch.tensor(np.random.default_rng(1).standard_normal(
        got.shape).astype(np.float32))
    (got * do).sum().backward()
    q2, k2, v2 = (torch.tensor(a, requires_grad=True) for a in qkv)
    ref = sq.attention_reference(q2, k2, v2, causal=causal)
    (ref * do).sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **TOL)


def test_ulysses_needs_heads_divisible_by_the_group():
    q, k, v = (torch.tensor(a) for a in _qkv(h=6))
    with pytest.raises(ValueError, match="n_heads=6 not divisible by seq "
                                         "axis size 4"):
        sq.ulysses_attention(q, k, v, sq.LocalSeqGroup(4))


@pytest.mark.parametrize("t", [320, 512, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_blockwise_matches_jax_and_dense(t, causal):
    """T 320 and 96 are not multiples of the 256-row block: the block
    becomes T's largest divisor under 256 (160, 96), as in JAX."""
    qkv = _qkv(b=1, t=t, h=2, d=8)
    want = np.asarray(jsq.attention_dense_blockwise(*qkv, causal=causal))
    got = sq.sequence_sharded_attention(
        "dense_blockwise", *(torch.tensor(a) for a in qkv), causal=causal)
    np.testing.assert_allclose(_np(got), want, **TOL)
    ref = sq.attention_reference(*(torch.tensor(a) for a in qkv),
                                 causal=causal)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_global_positions_of_ulysses_are_contiguous_like_jax():
    got = sq.global_positions("ulysses", sq.LocalSeqGroup(4), 32)
    want = np.concatenate([np.asarray(jax.shard_map(
        lambda: jsq.global_positions("ulysses", "seq", 8)[None],
        mesh=_mesh("seq", 4), in_specs=(), out_specs=P("seq"),
        check_vma=False)())])
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1))


# ---------------------------------------------------------------------------
# the same over 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("megatron_ranks")
    rng = np.random.default_rng(3)
    qkv = _qkv(seed=3)
    inputs = dict(_fg_inputs(), **_vocab_inputs(), qkv=qkv,
                  do=rng.standard_normal(qkv[0].shape).astype(np.float32))
    return inputs, spawn(str(tmp), 2, {"ops": inputs})


def test_f_g_over_two_gloo_ranks_match_jax(two_ranks):
    inputs, outs = two_ranks
    y_j, gx_j = _fg_jax(inputs)
    for out in outs:
        y, gx = out["ops"]["fg"]
        np.testing.assert_allclose(y, y_j, **TOL)
        np.testing.assert_allclose(gx, gx_j, **TOL)


def test_vocab_parallel_over_two_gloo_ranks_match_jax(two_ranks):
    """Each rank's shard gradients are its slice of the dense ones; the
    replicated results are the same on both ranks."""
    inputs, outs = two_ranks
    got = dict(outs[0]["ops"]["vocab"])
    for k, dim in (("table", 0), ("head", 1)):
        got[k] = np.concatenate([o["ops"]["vocab"][k] for o in outs], dim)
    _check_vocab(got, inputs)
    for k in ("emb", "h"):
        np.testing.assert_array_equal(outs[0]["ops"]["vocab"][k],
                                      outs[1]["ops"]["vocab"][k])


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_over_two_gloo_ranks_matches_jax(two_ranks, causal):
    inputs, outs = two_ranks
    want = _jax_ulysses(inputs["qkv"], 2, causal)
    o = np.concatenate([out["ops"][f"ulysses_{causal}"][0] for out in outs],
                       axis=1)
    np.testing.assert_allclose(o, want, **TOL)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in inputs["qkv"])
    ref = sq.attention_reference(q, k, v, causal=causal)
    (ref * torch.tensor(inputs["do"])).sum().backward()
    for i, t in enumerate((q, k, v), start=1):
        g = np.concatenate([out["ops"][f"ulysses_{causal}"][i]
                            for out in outs], axis=1)
        np.testing.assert_allclose(g, t.grad.numpy(), **TOL)


def test_tree_from_jax_keeps_the_permuted_layer():
    """A JAX-permuted layer carried across stays in its order (the sp_tp
    parity tests rest on it)."""
    _, model, layer, _, _ = _block_case("mha")
    perm = megatron.permute_qkv([layer], 32, 4, 2)
    back = tree_from_jax(jmeg.permute_qkv(jax.tree_util.tree_map(
        lambda t: jnp.asarray(_np(t)), [layer]), 32, 4, 2), "cpu")
    assert torch.equal(back[0]["qkv"]["w"], perm[0]["qkv"]["w"])
