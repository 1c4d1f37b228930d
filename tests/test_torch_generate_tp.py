"""The port's tensor-parallel decoding (``models.generate_tp``) against the
JAX package's, on the CPU: ``tests/test_generate_tp.py``'s cases
mirrored.

The same params (JAX's init, carried over by ``interop``; the qkv columns
permuted head-aligned for the tensor size, the training layout) and
prompts go through JAX's ``generate_tp`` on a ``data=2 x tensor=T`` mesh
of fake CPU devices and through the port's over a ``LocalTensorGroup(T)``
in one process.  Greedy decoding is held to JAX's tokens and to the
dense KV-cache decode (``models.generate``), token for token: the small
LM with and without ``vocab_parallel``, ragged prompts, GQA, RoPE,
SwiGLU, MoE (ample capacity, as JAX's), a ``scan_layers`` stack, and a
pipeline snapshot's stage stack (``pipeline_params_for_decode``) at the
snapshot's tensor size and at another (the qkv columns re-permuted).
Sampling: torch's generator cannot give JAX's noise, so the temperature
cases check what JAX's do: seeded runs repeat and differ across seeds,
tokens stay in range and in the dense top-k set, and the Gumbel-max
frequencies of the vocab-split sampler match the categorical
distribution.  ``top_p`` under ``vocab_parallel`` is refused with JAX's
type and words.  Rows over data ranks: 4 gloo ranks of
``tests/torch_generate_tp_child.py`` (data 2 x tensor 2 process groups)
decode JAX's greedy tokens and, sampling, independent continuations for
the same prompt on the two data ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.config import MeshConfig
from neural_networks_parallel_training_with_mpi_tpu.models.generate import (
    generate as jax_generate,
)
from neural_networks_parallel_training_with_mpi_tpu.models.generate_tp import (
    generate_tp as jax_generate_tp,
)
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxTransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.parallel import (
    mesh as mesh_lib,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax, tree_from_jax,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate import (
    generate,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate_tp import (
    generate_tp, pipeline_params_for_decode,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
    megatron,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (
    LocalTensorGroup,
)

pytestmark = pytest.mark.torch_port

V = 32
BASE = dict(vocab_size=V, max_seq_len=32, n_layers=2, d_model=32,
            n_heads=4, d_ff=64)


@functools.lru_cache(maxsize=None)
def _models(seed=0, **kw):
    """(JAX model, its params as numpy, the port's model and params)."""
    cfg = dict(BASE, **kw)
    jm = JaxTransformer(JaxTransformerConfig(**cfg))
    jp = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jm.init(prng.init_key(seed))))
    m = Transformer(TransformerConfig(**cfg), device="cpu")
    return jm, jp, m, params_from_jax(jp, m.cfg, "cpu")


def _mesh(tensor):
    return mesh_lib.make_mesh(MeshConfig(data=2, tensor=tensor),
                              devices=np.asarray(jax.devices()[:2 * tensor]))


def _permuted(model, params, tp):
    c = model.cfg
    return dict(params, blocks=megatron.permute_qkv(
        params["blocks"], c.d_model, c.n_heads, tp, kv_heads=c.kv_heads))


def _jax_permuted(jm, jp, tp):
    from neural_networks_parallel_training_with_mpi_tpu.parallel import (
        megatron as jmeg,
    )

    c = jm.cfg
    return dict(jp, blocks=jmeg.permute_qkv(jp["blocks"], c.d_model,
                                            c.n_heads, tp,
                                            kv_heads=c.kv_heads))


def _parity(tp, prompt, n, seed=0, vocab_parallel=False, prompt_lens=None,
            **kw):
    """Greedy tokens of JAX's generate_tp, the port's over
    LocalTensorGroup(tp) and the port's dense decode: all equal."""
    jm, jp, m, params = _models(seed, **kw)
    want = np.asarray(jax_generate_tp(
        jm, _jax_permuted(jm, jp, tp), jnp.asarray(prompt, jnp.int32),
        _mesh(tp), n, vocab_parallel=vocab_parallel,
        prompt_lens=None if prompt_lens is None
        else jnp.asarray(prompt_lens, jnp.int32)))
    got = generate_tp(m, _permuted(m, params, tp), prompt,
                      LocalTensorGroup(tp), n, vocab_parallel=vocab_parallel,
                      prompt_lens=prompt_lens, device="cpu")
    dense = generate(m, params, prompt, n, prompt_lens=prompt_lens,
                     device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dense.numpy(), want)


def test_greedy_parity_vs_dense():
    prompt = np.random.default_rng(0).integers(0, V, (4, 4))
    _parity(4, prompt, 8)


def test_greedy_parity_vocab_parallel():
    prompt = np.random.default_rng(1).integers(0, V, (4, 3))
    _parity(4, prompt, 6, vocab_parallel=True)


def test_ragged_prompts_parity():
    rng = np.random.default_rng(2)
    full = rng.integers(1, V, (4, 6))
    lens = np.asarray([3, 6, 4, 5])
    pad = np.where(np.arange(6)[None, :] < lens[:, None], full, 0)
    _parity(4, pad, 4, prompt_lens=lens)


@pytest.mark.parametrize("kw", [
    dict(n_kv_heads=2),
    dict(n_kv_heads=2, pos_encoding="rope"),
    dict(n_kv_heads=2, activation="swiglu", pos_encoding="rope", seed=5),
    dict(moe_experts=4, moe_capacity=256, seed=3),
], ids=["gqa", "rope_gqa", "swiglu_rope_gqa", "moe"])
@pytest.mark.parametrize("vocab_parallel", [False, True])
def test_variant_parity_vs_dense(kw, vocab_parallel):
    kw = dict(kw)
    seed = kw.pop("seed", 0)
    prompt = np.random.default_rng(3).integers(0, V, (4, 4))
    _parity(2, prompt, 8, seed=seed, vocab_parallel=vocab_parallel, **kw)


def test_scan_layers_checkpoint_decodes():
    """A scan_layers stack (the training layout's (L, ...) leaves) decodes
    as the per-layer params do."""
    jm, jp, m, params = _models(4, scan_layers=True)
    prompt = np.random.default_rng(5).integers(0, V, (4, 4))
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt), 6))
    got = generate_tp(m, _permuted(m, params, 4), prompt,
                      LocalTensorGroup(4), 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("decode_tp", [2, 4])
def test_pipeline_checkpoint_decodes_natively(decode_tp):
    """A pp 2 x tp 2 pipeline snapshot's stage stack (JAX's
    init_pipeline_params: qkv permuted for tp 2) -> per-layer blocks; at
    tensor size 2 as it is, at 4 re-permuted (qkv_tp 2, decode_tp 4):
    JAX's dense decode of the weights the pipeline init started from,
    token for token."""
    from neural_networks_parallel_training_with_mpi_tpu.parallel import (
        pipeline as jpp,
    )

    jm, jp, m, _ = _models(0)
    stacked = jax.device_get(jpp.init_pipeline_params(jm, prng.init_key(0),
                                                      2, 2))
    params = tree_from_jax(stacked, "cpu")
    if decode_tp == 2:
        dec = pipeline_params_for_decode(params, m)
    else:
        dec = pipeline_params_for_decode(params, m, qkv_tp=2, decode_tp=4)
    prompt = np.random.default_rng(6).integers(0, V, (4, 4))
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt), 6))
    got = generate_tp(m, dec, prompt, LocalTensorGroup(decode_tp), 6,
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(dec["blocks"]) == m.cfg.n_layers


def test_vocab_parallel_rejects_top_p():
    jm, jp, m, params = _models(0)
    with pytest.raises(NotImplementedError) as want:
        jax_generate_tp(jm, _jax_permuted(jm, jp, 4),
                        jnp.zeros((4, 2), jnp.int32), _mesh(4), 4,
                        temperature=1.0, top_p=0.9,
                        key=jax.random.PRNGKey(0), vocab_parallel=True)
    with pytest.raises(NotImplementedError) as got:
        generate_tp(m, _permuted(m, params, 4), np.zeros((4, 2)),
                    LocalTensorGroup(4), 4, temperature=1.0, top_p=0.9,
                    generator=torch.Generator().manual_seed(0),
                    vocab_parallel=True, device="cpu")
    assert str(got.value) == str(want.value)


def _sampled(seed, prompt, n, **kw):
    _, _, m, params = _models(0)
    return generate_tp(m, _permuted(m, params, 4), prompt,
                       LocalTensorGroup(4), n, temperature=1.0,
                       generator=torch.Generator().manual_seed(seed),
                       device="cpu", **kw)


@pytest.mark.parametrize("vocab_parallel", [True, False])
def test_temperature_sampling_seeded_and_valid(vocab_parallel):
    prompt = np.zeros((4, 2), np.int64)
    a = _sampled(7, prompt, 6, vocab_parallel=vocab_parallel)
    b = _sampled(7, prompt, 6, vocab_parallel=vocab_parallel)
    c = _sampled(8, prompt, 6, vocab_parallel=vocab_parallel)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    assert int(a.max()) < V and int(a.min()) >= 0
    # every row draws its own noise: identical prompts diverge
    assert len({tuple(r) for r in a[:, 2:].tolist()}) > 1


def test_gumbel_max_matches_categorical_distribution():
    """The vocab-split Gumbel-max sampler is categorical sampling: over
    many draws from one skewed row, the top token's frequency is its
    softmax probability within 4 sigma."""
    _, _, m, params = _models(0)
    prompt = np.full((64, 3), 5)
    draws = []
    for s in range(8):
        draws += _sampled(s, prompt, 1, vocab_parallel=True)[:, -1].tolist()
    probs = torch.softmax(m.apply(params, torch.as_tensor(prompt[:1]))[
        0, -1], -1).numpy()
    counts = np.bincount(draws, minlength=V) / len(draws)
    top = int(np.argmax(probs))
    se = np.sqrt(probs[top] * (1 - probs[top]) / len(draws))
    assert abs(counts[top] - probs[top]) < 4 * se + 1e-3
    # and the rest of the row within the same bound, token by token
    se_all = np.sqrt(probs * (1 - probs) / len(draws))
    assert np.all(np.abs(counts - probs) < 4 * se_all + 2e-3)


def test_vocab_parallel_top_k_stays_in_dense_candidate_set():
    _, _, m, params = _models(0)
    prompt = np.full((4, 3), 9)
    k = 5
    logits = m.apply(params, torch.as_tensor(prompt))[:, -1]
    allowed = set(torch.topk(logits[0], k).indices.tolist())
    for s in range(8):
        out = _sampled(s, prompt, 1, top_k=k, vocab_parallel=True)
        for tok in out[:, -1].tolist():
            assert tok in allowed, (tok, allowed)
    a = _sampled(3, prompt, 4, top_k=k, vocab_parallel=True)
    b = _sampled(3, prompt, 4, top_k=k, vocab_parallel=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gloo_data_and_tensor_ranks(tmp_path):
    """data 2 x tensor 2 gloo ranks: greedy decodes JAX's tokens (with
    and without vocab_parallel), and a sampled run gives the two data
    ranks' identical prompts independent continuations, the same on every
    rank and again under the same seed."""
    from torch_generate_tp_child import spawn

    jm, jp, m, params = _models(0)
    prompt = np.random.default_rng(0).integers(0, V, (4, 4))
    same = np.full((4, 3), 7)
    want = np.asarray(jax_generate_tp(
        jm, _jax_permuted(jm, jp, 2), jnp.asarray(prompt, jnp.int32),
        _mesh(2), 8))
    outs = spawn(str(tmp_path), 4, {"params": jp, "cfg": BASE,
                                    "greedy": prompt, "same": same})
    for out in outs:
        for vp in (False, True):
            np.testing.assert_array_equal(out[f"greedy_{vp}"], want)
            cont = out[f"sampled_{vp}"][:, 3:]
            assert not np.array_equal(cont[0], cont[2])
            np.testing.assert_array_equal(out[f"sampled_{vp}"],
                                          out[f"again_{vp}"])
            np.testing.assert_array_equal(out[f"sampled_{vp}"],
                                          outs[0][f"sampled_{vp}"])
