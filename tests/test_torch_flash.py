"""The port's flash attention against the JAX package's.

The port's CPU path (the plain versions the CUDA kernels are held against
on the card) is compared with the JAX ``flash_attention`` /
``flash_attention_with_lse``, whose Pallas kernels run in interpret mode
on the CPU as ``tests/test_pallas_kernels.py`` runs them.  Same inputs
from numpy, f32 on both sides; tolerance 1e-5 (rtol and atol): both
compute the same online softmax and FA-2 backward in f32 and differ only
in summation order.  The CUDA kernels themselves are checked on the card
by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.ops.pallas_kernels import (
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_lse,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
    flash_attention as fa,
)

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b=2, t=32, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("mask", ["causal", "none", "causal_exclusive"])
@pytest.mark.parametrize("blocks", [(16, 16), (8, 16), (16, 8)],
                         ids=["16x16", "8x16", "16x8"])
def test_forward_out_and_lse_match_jax(mask, blocks):
    q, k, v = _qkv(seed=1)
    want_out, want_lse = jax_flash_lse(
        *map(jnp.asarray, (q, k, v)), True, *blocks, True, mask)
    out, lse = fa.flash_forward(*map(torch.tensor, (q, k, v)), mask, *blocks)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "none"])
@pytest.mark.parametrize("blocks", [(16, 16), (8, 16)], ids=["16x16", "8x16"])
def test_gradients_match_jax_grad(causal, blocks):
    """dq/dk/dv of sum(out * w) through the port's FlashAttention (lse and
    delta decomposition) against jax.grad through the Pallas backward."""
    q, k, v = _qkv(seed=2)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return (jax_flash(q, k, v, causal, *blocks, True) * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal, *blocks)
    got = torch.autograd.grad((out * torch.tensor(w)).sum(), (tq, tk, tv))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)


def test_exclusive_mask_empty_row_is_zero_with_zero_gradient():
    q, k, v = map(torch.tensor, _qkv(seed=4))
    out, lse = fa.flash_forward(q, k, v, "causal_exclusive")
    assert torch.all(out[:, 0] == 0) and torch.all(lse[:, 0] == fa.NEG_INF)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, torch.ones_like(out),
                                   "causal_exclusive")
    assert torch.all(dq[:, 0] == 0)


def test_cpu_path_leaves_the_launch_counters_at_zero():
    before = dict(fa.flash_attention.launches)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in _qkv(seed=5))
    fa.flash_attention(tq, tk, tv).sum().backward()
    assert fa.flash_attention.launches == before
    assert tq.grad is not None and tk.grad is not None


@pytest.mark.parametrize("blocks", [(12, 16), (16, 20)])
def test_seq_len_not_divisible_by_blocks_raises(blocks):
    q, k, v = map(torch.tensor, _qkv(t=32))
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(q, k, v, True, *blocks)


def test_shape_and_mask_validation():
    q, k, v = map(torch.tensor, _qkv())
    with pytest.raises(ValueError):
        fa.flash_forward(q, k[:, :16], v)
    with pytest.raises(ValueError):
        fa.flash_forward(q, k, v, "sliding")
