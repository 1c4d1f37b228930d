"""The port's weights-only int8 PTQ (``ops/quant.py``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_quant.py`` for everything the port has: the same
numpy-seeded arrays go through both quantizers (zero, mixed-zero,
non-default-axis and stacked cases), the parameter walk (``skip``, the
router ``gate``, expert dicts, idempotence), the byte accounting, a
Linear and a whole Transformer forward over PTQ params (dequant, and the
int8 x int8 product), the KV-cache decode and ``--generate --quantize
int8`` against JAX's greedy ids, and fp8 over PTQ weights refused with
JAX's message and exit code.

Tolerances: the codes and scales are the same bits (``torch.round``
rounds half to even as ``jnp.round`` does, and the arithmetic is the same
f32 operations), so quantizer outputs are compared exactly; the int8 x
int8 product is an exact integer sum scaled in JAX's order, held to 1e-6
relative; the dequant product is an f32 matmul that differs from XLA's
in summation order only (1e-5, the port's f32 parity tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu import cli as jcli
from neural_networks_parallel_training_with_mpi_tpu.models.core import (
    Linear as JaxLinear,
)
from neural_networks_parallel_training_with_mpi_tpu.models.generate import (
    generate as jax_generate,
)
from neural_networks_parallel_training_with_mpi_tpu.models.moe import MoEFFN
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxTConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.ops import quant as jquant
from neural_networks_parallel_training_with_mpi_tpu.utils import prng as jprng
from neural_networks_parallel_training_with_mpi_tpu_torch import cli
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax, tree_to_numpy,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models import core
from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate import (
    generate,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import quant

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)      # f32, summation order only
INT8_TOL = dict(rtol=1e-6, atol=0)    # exact integer sums, JAX's scaling
SMALL_LM = dict(vocab_size=64, max_seq_len=48, n_layers=2, d_model=32,
                n_heads=4, d_ff=64)


def _pair(a):
    return jnp.asarray(a), torch.tensor(a)


def _assert_quantized_equal(jq, tq):
    (q1, s1), (q2, s2) = jq, tq
    assert q2.dtype == torch.int8 and s2.dtype == torch.float32
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q1))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    """Same paths, dtypes and values (bf16 compared as f32)."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert str(g[k].dtype) == str(w[k].dtype), k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_array_matches_jax(dtype):
    """Random (64, 48) kernel: the same codes and scales, which round-trip
    within scale/2 and never use -128; a bf16 kernel too (widened inside
    the ops)."""
    w = np.random.default_rng(0).standard_normal((64, 48)).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.tensor(w).to(getattr(torch, dtype))
    jq, tq = jquant.quantize_array(jw), quant.quantize_array(tw)
    _assert_quantized_equal(jq, tq)
    q, scale = tq
    assert int(q.min()) >= -127 and scale.shape == (48,)
    recon = quant.dequantize_array(q, scale)
    np.testing.assert_array_equal(
        recon.numpy(), np.asarray(jquant.dequantize_array(*jq)))
    err = (recon - tw.float()).abs()
    assert bool((err <= scale[None, :] / 2 + 1e-7).all())


def test_quantize_array_zero_column():
    jq = jquant.quantize_array(jnp.zeros((8, 4), jnp.float32))
    tq = quant.quantize_array(torch.zeros(8, 4))
    _assert_quantized_equal(jq, tq)
    assert bool((tq[0] == 0).all()) and bool((tq[1] == 1.0).all())


def test_quantize_array_mixed_zero_columns():
    """Zero columns get scale 1, live columns their own scale."""
    w = np.random.default_rng(7).standard_normal((16, 6)).astype(np.float32)
    w[:, 1] = 0.0
    w[:, 4] = 0.0
    jw, tw = _pair(w)
    tq = quant.quantize_array(tw)
    _assert_quantized_equal(jquant.quantize_array(jw), tq)
    assert float(tq[1][1]) == 1.0 and float(tq[1][4]) == 1.0


def test_quantize_array_nondefault_axis():
    """axis=-1: per-row scales (the activation quantizer of ops.qmm), the
    codes of w.T quantized on the default axis, transposed."""
    w = np.random.default_rng(8).standard_normal((6, 16)).astype(np.float32)
    jw, tw = _pair(w)
    tq = quant.quantize_array(tw, axis=-1)
    _assert_quantized_equal(jquant.quantize_array(jw, axis=-1), tq)
    assert tq[1].shape == (6,)
    np.testing.assert_array_equal(
        quant.dequantize_array(*tq, axis=-1).numpy(),
        np.asarray(jquant.dequantize_array(
            *jquant.quantize_array(jw, axis=-1), axis=-1)))
    qt, st = quant.quantize_array(tw.t())
    np.testing.assert_array_equal(qt.t().numpy(), tq[0].numpy())
    np.testing.assert_array_equal(st.numpy(), tq[1].numpy())


def test_quantize_array_stacked_blocks():
    """(n_layers, in, out) keeps per-layer scales (n_layers, out)."""
    w = np.random.default_rng(1).standard_normal((3, 16, 8)).astype(
        np.float32)
    jw, tw = _pair(w)
    tq = quant.quantize_array(tw)
    _assert_quantized_equal(jquant.quantize_array(jw), tq)
    assert tq[1].shape == (3, 8)


def test_quantize_array_rounds_half_to_even():
    """Values landing exactly on .5 codes round to even, as jnp.round
    does (scale 1 after the amax 127 column)."""
    w = np.array([[127.0], [0.5], [1.5], [2.5], [-0.5], [-3.5]], np.float32)
    jw, tw = _pair(w)
    tq = quant.quantize_array(tw)
    _assert_quantized_equal(jquant.quantize_array(jw), tq)
    assert tq[0][:, 0].tolist() == [127, 0, 2, 2, 0, -4]


# ---------------------------------------------------------------------------
# the parameter walk and its bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skip", [(), ("head",)], ids=["all", "skip_head"])
@pytest.mark.parametrize("scan_layers", [False, True],
                         ids=["layers", "stacked"])
def test_quantize_params_walk_matches_jax(skip, scan_layers):
    """A Transformer tree: the same leaves quantized (every Linear's w,
    also stacked; never LayerNorm, embedding or a skipped site), the same
    codes and scales, the same bytes; the input tree is left as it was
    and a second pass changes nothing."""
    jm = JaxTransformer(JaxTConfig(**SMALL_LM, scan_layers=scan_layers))
    jp = jax.device_get(jm.init(jprng.init_key(0)))
    cfg = TransformerConfig(**SMALL_LM, scan_layers=scan_layers)
    tp = params_from_jax(jp, cfg, "cpu")
    before = {k: v.clone() for k, v in _flat_t(tp).items()}
    jq = jax.device_get(jquant.quantize_params(jp, skip=skip))
    tq = quant.quantize_params(tp, skip=skip)
    # the port unstacks nothing when scan_layers: the trees align
    _assert_trees_equal(tree_to_numpy(tq), jq)
    assert ("w_scale" in tq["head"]) == (not skip)
    assert tq["embed"]["table"].dtype == torch.float32
    assert quant.quantized_bytes(tq) == jquant.quantized_bytes(jq)
    assert quant.quantized_bytes(tp) == jquant.quantized_bytes(jp)
    assert quant.quantized_bytes(tq) < quant.quantized_bytes(tp)
    for k, v in _flat_t(tp).items():
        assert torch.equal(v, before[k]), k
    again = quant.quantize_params(tq, skip=skip)
    for k, v in _flat_t(again).items():
        assert torch.equal(v, _flat_t(tq)[k]), k


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat_t(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_t(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def test_quantize_params_expert_dict_zero_and_gate():
    """The JAX package's MoE tree (the port builds no MoE model, but the
    walk treats the tree the same): expert kernels quantized per (expert,
    out column), an all-zero w_out with scale 1, w_gate along, the router
    gate untouched."""
    params = jax.device_get(MoEFFN(16, 32, 2, activation="swiglu").init(
        jprng.init_key(0)))
    params["experts"]["w_out"] = np.zeros_like(params["experts"]["w_out"])
    jq = jax.device_get(jquant.quantize_params({"moe": params}))
    tq = quant.quantize_params(tree_from_jax({"moe": params}, "cpu"))
    _assert_trees_equal(tree_to_numpy(tq), jq)
    e = tq["moe"]["experts"]
    assert e["w_in"].dtype == e["w_gate"].dtype == torch.int8
    assert bool((e["w_out"] == 0).all()) and bool((e["w_out_scale"] == 1).all())
    assert tq["moe"]["gate"]["w"].dtype == torch.float32


def test_quantized_bytes_accounting_pin():
    """int8 kernels 1 byte per element, their f32 scales and untouched
    f32 leaves 4."""
    lin = core.Linear(32, 16)
    params = lin.init(torch.Generator().manual_seed(0), "cpu")
    assert quant.quantized_bytes(params) == (32 * 16 + 16) * 4
    q = quant.quantize_params(params)
    assert quant.quantized_bytes(q) == 32 * 16 + 16 * 4 + 16 * 4


# ---------------------------------------------------------------------------
# consumers: Linear, the Transformer forward, the KV-cache decode, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["bf16", "int8"],
                         ids=["dequant", "int8_compute"])
def test_linear_apply_consumes_quantized(fmt):
    """JAX's Linear and the port's over the same PTQ params: the dequant
    product (y * w_scale) and the int8 x int8 product (int8_serve_dot)."""
    rng = np.random.default_rng(2)
    jlin = JaxLinear(32, 16, matmul_dtype=fmt)
    jp = jquant.quantize_params(jlin.init(jprng.init_key(0)))
    x = rng.standard_normal((4, 32)).astype(np.float32)
    want = np.asarray(jlin.apply(jp, jnp.asarray(x)))
    tp = tree_from_jax(jax.device_get(jp), "cpu")
    assert tp["w"].dtype == torch.int8
    got = core.Linear(32, 16, matmul_dtype=fmt).apply(tp, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want,
                               **(INT8_TOL if fmt == "int8" else TOL))


def test_linear_refuses_fp8_over_ptq():
    lin = core.Linear(8, 8, matmul_dtype="fp8")
    p = quant.quantize_params(lin.init(torch.Generator().manual_seed(0),
                                       "cpu"))
    with pytest.raises(ValueError, match="cannot run over int8 PTQ"):
        lin.apply(p, torch.zeros(2, 8))


@pytest.mark.parametrize("fmt", ["bf16", "int8"],
                         ids=["dequant", "int8_compute"])
@pytest.mark.parametrize("scan_layers", [False, True],
                         ids=["layers", "stacked"])
def test_transformer_forward_parity(fmt, scan_layers):
    """The whole LM over PTQ params (head kept full precision, as
    --quantize_skip head does), against JAX's logits: f32 tolerance, the
    int8 product included (its inputs differ from JAX's by summation
    order in the LayerNorms and attention)."""
    kw = dict(SMALL_LM, scan_layers=scan_layers, matmul_dtype=fmt)
    jm = JaxTransformer(JaxTConfig(**kw))
    jp = jquant.quantize_params(jm.init(jprng.init_key(0)), skip=("head",))
    ids = np.random.default_rng(3).integers(0, 64, (2, 12))
    want = np.asarray(jm.apply(jp, jnp.asarray(ids, jnp.int32)))
    model = Transformer(TransformerConfig(**kw, attention="dense"),
                        device="cpu")
    tp = tree_from_jax(jax.device_get(jp), "cpu")
    with torch.no_grad():
        got = model.forward(tp, torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fmt", ["bf16", "int8"],
                         ids=["dequant", "int8_compute"])
def test_kv_cache_decode_greedy_equals_jax(fmt):
    """generate() over PTQ params, dense and int8 KV cache: JAX's greedy
    ids from JAX's weights."""
    cfg = dict(SMALL_LM, matmul_dtype=fmt)
    jm = JaxTransformer(JaxTConfig(**cfg))
    jp = jquant.quantize_params(jm.init(jprng.init_key(0)))
    model = Transformer(TransformerConfig(**cfg, attention="dense"),
                        device="cpu")
    tp = tree_from_jax(jax.device_get(jp), "cpu")
    prompt = [[1, 2, 3]]
    for kv in (False, True):
        want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt, jnp.int32),
                                       12, kv_quant=kv))
        got = generate(model, tp, prompt, 12, kv_quant=kv, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


LM_FLAGS = ["--dataset", "lm", "--seq_len", "32", "--vocab_size", "64",
            "--n_layers", "2", "--d_model", "32", "--n_heads", "4",
            "--d_ff", "64"]


def _last_ids(text):
    return [int(t) for t in text.strip().splitlines()[-1].split(",")]


@pytest.mark.parametrize("extra", [
    ["--quantize_skip", "head"],
    ["--matmul_dtype", "int8"],
    ["--matmul_dtype", "int8", "--quantize_skip", "head"],
], ids=["dequant_skip_head", "int8_compute", "int8_compute_skip_head"])
def test_cli_generate_quantized_equals_jax(capsys, extra):
    """--generate --quantize int8 from a fresh init (JAX's weights stand
    in: the port draws its own, so the test restores JAX's snapshot of
    them): the same log lines and greedy ids as the JAX CLI."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu.config import (
        build_argparser as jargs, config_from_args as jcfg,
    )
    from neural_networks_parallel_training_with_mpi_tpu.train.trainer import (
        Trainer as JaxTrainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu.parallel.mesh import (
        make_mesh,
    )

    with tempfile.TemporaryDirectory() as d:
        cfg = jcfg(jargs().parse_args(
            LM_FLAGS + ["--no-full-batch", "--batch_size", "16",
                        "--n_samples", "16", "--nepochs", "1",
                        "--checkpoint_dir", d]))
        JaxTrainer(cfg, mesh=make_mesh(cfg.mesh,
                                       devices=jax.devices("cpu")[:1])).fit()
        capsys.readouterr()
        gen = LM_FLAGS + ["--checkpoint_dir", d, "--generate", "1,2,3",
                          "--max_new_tokens", "10", "--quantize", "int8",
                          "--platform", "cpu"] + extra
        assert jcli.main(gen) == 0
        jout = capsys.readouterr().out
        assert cli.main(gen) == 0
        tout = capsys.readouterr().out
    assert _last_ids(tout) == _last_ids(jout)
    for needle in ("int8 weights-only PTQ: param bytes",
                   "int8 COMPUTE decode"):
        assert (needle in tout) == (needle in jout), needle
    jline = [ln for ln in jout.splitlines() if "param bytes" in ln][0]
    tline = [ln for ln in tout.splitlines() if "param bytes" in ln][0]
    assert tline.split("param bytes")[1] == jline.split("param bytes")[1]


def test_cli_refuses_fp8_over_ptq():
    flags = LM_FLAGS + ["--generate", "1,2", "--max_new_tokens", "2",
                        "--quantize", "int8", "--matmul_dtype", "fp8",
                        "--platform", "cpu"]
    assert jcli.main(flags) == 2
    assert cli.main(flags) == 2
