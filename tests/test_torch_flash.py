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


@pytest.mark.parametrize("mask", ["causal", "none", "causal_exclusive"])
def test_with_lse_values_and_gradients_match_jax_grad(mask):
    """B5: (out, lse) and dq/dk/dv of sum(out * w) + sum(lse * u) (a
    non-zero lse cotangent, folded into delta) through the port's
    FlashAttentionWithLse against jax.grad through the Pallas custom_vjp."""
    q, k, v = _qkv(seed=6)
    rng = np.random.default_rng(7)
    w = rng.standard_normal(q.shape).astype(np.float32)
    u = rng.standard_normal((q.shape[0] * q.shape[2], q.shape[1])).astype(
        np.float32)

    def jloss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, True, 16, 8, True, mask)
        # lse of an empty (causal_exclusive row 0) row is -1e30: its
        # cotangent still enters, but P = 0 there, so it moves nothing
        return (out * w).sum() + (jnp.where(lse > -1e29, lse, 0.0) * u).sum()

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out, want_lse = jax_flash_lse(jq, jk, jv, True, 16, 8, True, mask)
    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, block_q=16, block_k=8,
                                           mask_mode=mask)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse),
                               **TOL)
    loss = (out * torch.tensor(w)).sum() + (
        torch.where(lse > -1e29, lse, 0.0) * torch.tensor(u)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for g, j, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


def test_lse_cotangent_is_a_delta_shift():
    """The plain backward with g_lse equals the one with delta shifted by
    -g_lse, and g_lse = 0 is the plain flash backward."""
    q, k, v = map(torch.tensor, _qkv(seed=8))
    dout = torch.tensor(_qkv(seed=9)[0])
    out, lse = fa.flash_forward(q, k, v, "causal")
    g_lse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(0))
    got = fa.flash_backward(q, k, v, out, lse, dout, "causal", g_lse=g_lse)
    delta = fa.flash_delta(out, dout) - g_lse
    want_dq = fa.flash_dq_reference(q, k, v, dout, lse, delta, "causal")
    want_dk, want_dv = fa.flash_dkv_reference(q, k, v, dout, lse, delta,
                                              "causal")
    for g, w in zip(got, (want_dq, want_dk, want_dv)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    zero = fa.flash_backward(q, k, v, out, lse, dout, "causal",
                             g_lse=torch.zeros_like(lse))
    for g, w in zip(zero, fa.flash_backward(q, k, v, out, lse, dout)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


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
    out, lse = fa.flash_attention_with_lse(tq, tk, tv)
    (out.sum() + lse.sum()).backward()
    assert fa.flash_attention.launches == before
    assert fa.flash_attention_with_lse.launches == 0
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
