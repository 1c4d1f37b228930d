"""Parity of the PyTorch port's model layers with the JAX package.

Same inputs (numpy, from a seed) and the same weights (JAX init, carried
across with ``interop.params_from_jax``) through both frameworks, in f32
on the CPU.  Tolerance: rtol 1e-5, atol 1e-5 — both sides compute in f32
and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.models import core as jcore
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.ops.rope import (
    rope_rotate as jax_rope_rotate,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models import core
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops.rope import (
    rope_rotate,
)

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(vocab_size=64, max_seq_len=64, n_layers=2, d_model=32,
             n_heads=4, d_ff=64)


def _t(a):
    return torch.tensor(np.asarray(a))    # a copy: JAX host arrays are read-only


def _jax_params(module, seed=0):
    return jax.device_get(module.init(jax.random.PRNGKey(seed)))


def test_linear_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    jlin = jcore.Linear(16, 24)
    p = _jax_params(jlin)
    want = np.asarray(jlin.apply(p, jnp.asarray(x)))
    got = core.Linear(16, 24).apply({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_linear_refuses_quantized_matmuls():
    """The quantized matmuls are ported (tests/test_torch_qmm.py); what
    Linear still refuses, as the JAX Linear does, is fp8 over int8 PTQ
    weights."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops.quant import (
        quantize_params,
    )

    lin = core.Linear(4, 4, matmul_dtype="fp8")
    p = quantize_params(lin.init(torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="cannot run over int8 PTQ"):
        lin.apply(p, torch.zeros(2, 4))


def test_layernorm_matches_jax():
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.normal(size=(4, 7, 32))).astype(np.float32)
    p = {"scale": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    want = np.asarray(jcore.LayerNorm(32).apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = core.LayerNorm(32).apply({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_embedding_matches_jax():
    jemb = jcore.Embedding(50, 8)
    p = _jax_params(jemb)
    ids = np.random.default_rng(2).integers(0, 50, (3, 6)).astype(np.int32)
    want = np.asarray(jemb.apply(p, jnp.asarray(ids)))
    got = core.Embedding(50, 8).apply({"table": _t(p["table"])},
                                      _t(ids).long())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(core.ACTIVATIONS))
def test_activation_matches_jax(name):
    """gelu is the trap: jax.nn.gelu is the tanh approximation."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jcore.ACTIVATIONS[name](jnp.asarray(x)))
    got = core.ACTIVATIONS[name](_t(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_rotate_matches_jax(per_row):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 500, (2, 6)) if per_row
           else np.arange(6) + 9).astype(np.int32)
    want = np.asarray(jax_rope_rotate(jnp.asarray(x), jnp.asarray(pos)))
    got = rope_rotate(_t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("variant", [
    dict(activation="gelu", pos_encoding="learned"),
    dict(activation="swiglu", pos_encoding="rope", n_kv_heads=2),
], ids=["gelu-learned", "swiglu-rope-gqa"])
def test_transformer_forward_matches_jax(variant):
    cfg = dict(SMALL, **variant)
    jm = JaxTransformer(JaxConfig(**cfg, attention="dense"))
    jp = jm.init(prng.init_key(0))
    model = Transformer(TransformerConfig(**cfg), device="cpu")
    params = params_from_jax(jax.device_get(jp), model.cfg, "cpu")
    ids = np.random.default_rng(4).integers(0, 64, (2, 24)).astype(np.int32)
    want = np.asarray(jm.apply(jp, jnp.asarray(ids)))
    got = model.forward(params, _t(ids).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_params_from_jax_unstacks_scan_layers():
    """A scan_layers tree (leaves stacked on a layer axis) lands in the
    per-layer layout the port's model reads, with identical logits."""
    jm = JaxTransformer(JaxConfig(**SMALL, attention="dense",
                                  scan_layers=True))
    jp = jm.init(prng.init_key(1))
    model = Transformer(TransformerConfig(**SMALL), device="cpu")
    params = params_from_jax(jax.device_get(jp), model.cfg, "cpu")
    assert isinstance(params["blocks"], list) and len(params["blocks"]) == 2
    ids = np.random.default_rng(5).integers(0, 64, (1, 10)).astype(np.int32)
    want = np.asarray(jm.apply(jp, jnp.asarray(ids)))
    np.testing.assert_allclose(
        model.forward(params, _t(ids).long()).numpy(), want, **TOL)


def test_init_tree_matches_jax_layout():
    """The port's own init builds the JAX package's tree: same leaf names
    and shapes, so a JAX checkpoint and a port init are interchangeable."""
    for variant in (dict(), dict(activation="swiglu", pos_encoding="rope",
                                 n_kv_heads=2)):
        cfg = dict(SMALL, **variant)
        jp = jax.device_get(JaxTransformer(JaxConfig(**cfg)).init(
            prng.init_key(0)))
        tp = Transformer(TransformerConfig(**cfg), device="cpu").init(
            torch.Generator().manual_seed(0))
        jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
        assert jshapes == tshapes


# "ring": the sequence-sharded family; ring and striped are ported
# (tests/test_torch_sequence.py), ulysses is not.  "fp8": fp8 is ported
# (tests/test_torch_qmm.py), over MoE FFNs it still refuses
@pytest.mark.parametrize("bad", [dict(moe_experts=2),
                                 dict(matmul_dtype="fp8", moe_experts=2),
                                 dict(attention="ulysses")],
                         ids=["moe", "fp8", "ring"])
def test_unported_configs_refuse(bad):
    with pytest.raises(NotImplementedError):
        Transformer(TransformerConfig(**SMALL, **bad), device="cpu")
