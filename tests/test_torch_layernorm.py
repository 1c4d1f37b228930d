"""The port's fused LayerNorm (B6) against the JAX package's.

The port's CPU path (the plain version the CUDA kernel is held against on
the card) is compared with the JAX ``fused_layernorm``, whose Pallas
kernel runs in interpret mode on the CPU.  Same inputs from numpy.  f32:
tolerance 1e-5 (rtol and atol), both compute the same f32 statistics and
differ only in summation order.  bf16 inputs: each side rounds its f32
result to bf16 once, so they may differ by one bf16 step (2^-8 relative):
tolerance 1e-2.  The CUDA kernel itself is checked on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.ops.pallas_kernels import (
    fused_layernorm as jax_fused_layernorm,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
    layernorm as ln,
)

pytestmark = pytest.mark.torch_port

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    # a large common offset: the mean-of-squared-deviations variance keeps
    # it exact where E[x^2] - mean^2 would cancel
    x = (50.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block_rows", [((64, 128), 16),
                                              ((13, 40), 8),
                                              ((2, 5, 96), 256)],
                         ids=["even", "ragged", "3d"])
def test_fused_layernorm_matches_jax(shape, block_rows, dtype):
    x, scale, bias = _case(shape, seed=len(shape) + shape[-1])
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jax_fused_layernorm(jx, jnp.asarray(scale), jnp.asarray(bias),
                               block_rows=block_rows, interpret=True)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    got = ln.fused_layernorm(tx, torch.tensor(scale), torch.tensor(bias),
                             block_rows=block_rows)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_block_rows_does_not_change_the_result_and_counter_stays_zero():
    x, scale, bias = map(torch.tensor, _case((24, 64), seed=1))
    outs = [ln.fused_layernorm(x, scale, bias, block_rows=br)
            for br in (1, 7, 256)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    assert ln.fused_layernorm.launches == 0          # CPU: plain version


def test_fused_layernorm_validates_its_arguments():
    x, scale, bias = map(torch.tensor, _case((4, 8), seed=2))
    with pytest.raises(ValueError):
        ln.fused_layernorm(x, scale[:4], bias)
    with pytest.raises(ValueError):
        ln.fused_layernorm(x, scale, bias, block_rows=0)
