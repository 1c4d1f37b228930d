"""The port's MoE decode against the JAX package's: greedy tokens.

An MoE transformer (4 experts, top-1 and top-2, the default capacity
factor, so the decode drops tokens as JAX's does: each call routes all
its lanes in lane order, the inactive ones included) with the JAX init
carried across by ``interop``: the KV-cache ``generate`` (ragged prompts,
uniform prompts with and without prefill chunks) and the paged
``Scheduler`` (ragged requests and an evicting pool; ``gathered`` and
``fused`` attention, the fused one the plain version of the B4 kernel on
CPU tensors) against JAX's ``generate`` and ``Scheduler``; then
``--generate`` through the CLI from an ``--ep 2`` snapshot against the
live params' decode.  Tokens identical, f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neural_networks_parallel_training_with_mpi_tpu.models.generate import (
    generate as jax_generate,
)
from neural_networks_parallel_training_with_mpi_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.serve import (
    Scheduler as JaxScheduler,
    ServeConfig as JaxServeConfig,
)
from neural_networks_parallel_training_with_mpi_tpu.utils import prng
from neural_networks_parallel_training_with_mpi_tpu_torch import cli
from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
    params_from_jax,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate import (
    generate,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (
    Transformer, TransformerConfig,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
    Scheduler, ServeConfig,
)
from test_torch_serve import _blocking, _run

pytestmark = pytest.mark.torch_port

SMALL = dict(vocab_size=64, max_seq_len=64, n_layers=2, d_model=32,
             n_heads=4, d_ff=64, moe_experts=4)
REQUESTS = {
    "ragged": (dict(slots=3, num_blocks=24, block_size=4, prefill_chunk=4),
               [([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 8), ([7, 8], 6),
                ([5, 9, 11, 13], 9), ([3] * 20, 5), ([2], 4)]),
    "evict": (dict(slots=3, num_blocks=10, block_size=4, prefill_chunk=8),
              [([4, 5, 6, 7, 8, 9], 12), ([9, 8, 7, 6, 5, 4, 3], 11),
               ([1, 3, 5, 7, 9], 12)]),
}


@functools.lru_cache(maxsize=None)
def _models(top_k=1):
    jm = JaxTransformer(JaxConfig(**SMALL, attention="dense",
                                  moe_top_k=top_k))
    jp = jm.init(prng.init_key(0))
    model = Transformer(TransformerConfig(**SMALL, moe_top_k=top_k),
                        device="cpu")
    params = params_from_jax(jax.device_get(jp), model.cfg, "cpu")
    return jm, jp, model, params


@functools.lru_cache(maxsize=None)
def _jax_reference(name, top_k):
    jm, jp, _, _ = _models(top_k)
    cfg, requests = REQUESTS[name]
    return _run(_blocking(JaxScheduler(jm, jp, JaxServeConfig(**cfg))),
                requests)


@pytest.mark.parametrize("attn_impl", ["gathered", "fused"])
@pytest.mark.parametrize("name,top_k", [("ragged", 1), ("ragged", 2),
                                        ("evict", 1)])
def test_moe_scheduler_tokens_match_jax(name, top_k, attn_impl):
    _, _, model, params = _models(top_k)
    cfg, requests = REQUESTS[name]
    sched = Scheduler(model, params, ServeConfig(**cfg, attn_impl=attn_impl),
                      device="cpu")
    got, evicted = _run(sched, requests)
    want, want_evicted = _jax_reference(name, top_k)
    assert got == want
    assert evicted == want_evicted
    sched.server.allocator.assert_drained()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_generate_matches_jax(top_k):
    """Ragged greedy decode: each call routes every row (lanes in order,
    the finished ones included), as JAX's."""
    jm, jp, model, params = _models(top_k)
    prompts = [p for p, _ in REQUESTS["ragged"][1]]
    lens = [len(p) for p in prompts]
    padded = np.zeros((len(prompts), max(lens)), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(padded), 6,
                                   prompt_lens=jnp.asarray(lens)))
    got = generate(model, params, padded, 6, prompt_lens=lens, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_moe_generate_uniform_prompt_prefill_chunks(kv_quant):
    jm, jp, model, params = _models()
    prompt = np.random.default_rng(0).integers(0, 64, (16, 9)).astype(
        np.int32)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt), 5,
                                   kv_quant=kv_quant))
    for chunk in (0, 4):
        got = generate(model, params, prompt, 5, prefill_chunk=chunk,
                       kv_quant=kv_quant, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_generate_from_an_ep_snapshot(tmp_path, capsys):
    """--generate from a --ep 2 snapshot (every expert, the dense
    layout) prints the decode of the saver's live params."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )

    ck = str(tmp_path / "ck")
    model_flags = ["--dataset", "lm", "--seq_len", "16", "--vocab_size",
                   "64", "--n_layers", "2", "--d_model", "32", "--n_heads",
                   "4", "--d_ff", "64", "--moe_experts", "4"]
    train = model_flags + ["--no-full-batch", "--batch_size", "8",
                           "--nepochs", "1", "--n_samples", "16",
                           "--optimizer", "adam", "--ep", "2",
                           "--checkpoint_dir", ck]
    t = Trainer(config_from_args(build_argparser().parse_args(train)),
                device="cpu")
    assert t.layout_tag == "expert"
    t.fit()
    model = Transformer(TransformerConfig(
        vocab_size=64, max_seq_len=16, n_layers=2, d_model=32, n_heads=4,
        d_ff=64, moe_experts=4), device="cpu")
    want = generate(model, t.state.params, np.asarray([[5, 6, 7]]), 8,
                    device="cpu")[0].tolist()
    capsys.readouterr()
    assert cli.main(model_flags + ["--checkpoint_dir", ck, "--generate",
                                   "5,6,7", "--max_new_tokens", "8",
                                   "--platform", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert [int(v) for v in line.split(",")] == want
