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
    _heads_major,
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


MASKS = ("causal", "none", "causal_exclusive")


@pytest.mark.parametrize(
    "mask,t", [(m, 32) for m in MASKS] + [(m, 96) for m in MASKS],
    ids=list(MASKS) + [f"{m}-t96" for m in MASKS])
def test_with_lse_values_and_gradients_match_jax_grad(mask, t):
    """B5: (out, lse) and dq/dk/dv of sum(out * w) + sum(lse * u) (a
    non-zero lse cotangent, folded into delta) through the port's
    FlashAttentionWithLse against jax.grad through the Pallas custom_vjp.
    T 32 and 96: shard lengths under and past the kernels' 64-row tile,
    neither a multiple of it."""
    q, k, v = _qkv(t=t, seed=6)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g_lse", ["none", "contiguous", "strided"])
def test_flash_delta_matches_jax_delta_formula(g_lse, dtype):
    """delta (B*H, T) f32 against JAX's own formula
    (``_flash_backward``, pallas_kernels.py:366-369): rowsum(dO * O) in
    f32 per (b, h) row, shifted by -g_lse; the strided g_lse is what a
    ring merge's gradient can hand over.  Tolerance 1e-5: f32 sums in
    another order."""
    out, dout = _qkv(b=2, t=96, h=3, d=16, seed=17)[:2]
    bh, t = 2 * 3, 96
    rng = np.random.default_rng(18)
    u = None
    if g_lse == "contiguous":
        u = rng.standard_normal((bh, t)).astype(np.float32)
    elif g_lse == "strided":
        u = rng.standard_normal((t, 2 * bh)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jo, jg = jnp.asarray(out, jdt), jnp.asarray(dout, jdt)
    want = (_heads_major(jg).astype(jnp.float32)
            * _heads_major(jo).astype(jnp.float32)).sum(-1)
    tu = None
    if u is not None:
        # strided: a (B*H, T) view with strides (2, 2 B*H) of a (T, 2 B*H)
        ju = jnp.asarray(u if g_lse == "contiguous" else u[:, ::2].T)
        want = want - ju
        tu = torch.tensor(u)
        if g_lse == "strided":
            tu = tu[:, ::2].t()
            assert not tu.is_contiguous() and tu.shape == (bh, t)
    tdt = getattr(torch, dtype)
    got = fa.flash_delta(torch.tensor(out).to(tdt), torch.tensor(dout).to(tdt),
                         tu)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [32, 96])
def test_backward_returns_its_delta_and_takes_both_schedules(t):
    """flash_backward's delta (``return_delta``) is flash_delta's, and its
    dq/dk/dv are the same under either schedule; on the CPU both are the
    plain versions.  head_dim 32: the shared schedule is the sm90
    kernels' (bf16 at head_dim 32/64/128)."""
    q, k, v = (torch.tensor(a).to(torch.bfloat16)
               for a in _qkv(t=t, d=32, seed=19))
    dout = torch.tensor(_qkv(t=t, d=32, seed=20)[0]).to(torch.bfloat16)
    out, lse = fa.flash_forward(q, k, v, "causal")
    g_lse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(1))
    got = {sch: fa.flash_backward(q, k, v, out, lse, dout, "causal",
                                  g_lse=g_lse, schedule=sch,
                                  return_delta=True)
           for sch in ("shared", "serial")}
    torch.testing.assert_close(got["shared"][3],
                               fa.flash_delta(out, dout, g_lse),
                               rtol=0, atol=0)
    for a, b in zip(got["shared"], got["serial"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(fa.flash_backward(q, k, v, out, lse, dout)) == 3
    with pytest.raises(ValueError, match="only the sm90"):
        fa.flash_backward(q.float(), k.float(), v.float(), out.float(), lse,
                          dout.float(), schedule="shared")


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


# ---------------------------------------------------------------------------
# the plain versions that round as the sm90 (bf16) kernels do
# ---------------------------------------------------------------------------

# bf16: the bound the card holds the sm90 kernels to against the unrounded
# plain versions (chip_smoke TOL / GRAD_TOL): out within 2e-2 + 1e-2 |ref|,
# gradients within 1e-2 max|ref| + 1e-2 |ref|.  Rounding P (and dS) to bf16
# moves each term of the second product by at most 2^-9 relative, and the
# result rounds once more to bf16 on both sides.
BF16_OUT = (2e-2, 1e-2)
BF16_GRAD = (1e-2, 1e-2)


def _near(got, want, atol, rtol, scaled=False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    base = np.abs(want).max() if scaled else 1.0
    assert np.all(np.abs(got - want) <= atol * base + rtol * np.abs(want))


@pytest.mark.parametrize("mask", ["causal", "none", "causal_exclusive"])
def test_rounding_plain_versions_are_the_unrounded_ones_in_f32(mask):
    """round_p rounds to the inputs' dtype: on f32 it changes no bit."""
    q, k, v = map(torch.tensor, _qkv(seed=12))
    dout = torch.tensor(_qkv(seed=13)[0])
    for block_k in (8, 16):
        got = fa.flash_forward_reference(q, k, v, mask, block_k, round_p=True)
        want = fa.flash_forward_reference(q, k, v, mask, block_k)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    out, lse = got
    delta = fa.flash_delta(out, dout)
    got = fa.flash_dkv_reference(q, k, v, dout, lse, delta, mask,
                                 round_p=True)
    want = fa.flash_dkv_reference(q, k, v, dout, lse, delta, mask)
    got += (fa.flash_dq_reference(q, k, v, dout, lse, delta, mask,
                                  round_p=True),)
    want += (fa.flash_dq_reference(q, k, v, dout, lse, delta, mask),)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("mask", ["causal", "none", "causal_exclusive"])
def test_rounding_plain_versions_in_bf16_near_unrounded_and_jax(mask):
    """bf16 inputs: out and dq/dk/dv of the rounding plain versions (P,
    dS rounded to bf16) within the stated bound of the unrounded plain
    versions and of JAX's flash_attention_with_lse (Pallas, interpret mode,
    f32 inside, bf16 out) and its jax.grad."""
    q, k, v = _qkv(t=64, seed=14)
    w = np.random.default_rng(15).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tw = (torch.tensor(a).to(torch.bfloat16)
                      for a in (q, k, v, w))
    out, lse = fa.flash_forward_reference(tq, tk, tv, mask, 16, round_p=True)
    u_out, u_lse = fa.flash_forward_reference(tq, tk, tv, mask, 16)
    torch.testing.assert_close(lse, u_lse, rtol=0, atol=0)   # f32 P only
    assert out.dtype == torch.bfloat16
    _near(out.float(), u_out.float(), *BF16_OUT)

    jq, jk, jv, jw = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v, w))
    j_out, j_lse = jax_flash_lse(jq, jk, jv, True, 16, 16, True, mask)
    _near(out.float(), np.asarray(j_out.astype(jnp.float32)), *BF16_OUT)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL)

    def jloss(q, k, v):
        o, _ = jax_flash_lse(q, k, v, True, 16, 16, True, mask)
        return (o.astype(jnp.float32) * jw.astype(jnp.float32)).sum()

    j_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    delta = fa.flash_delta(out, tw)
    got = (fa.flash_dq_reference(tq, tk, tv, tw, lse, delta, mask,
                                 round_p=True),
           *fa.flash_dkv_reference(tq, tk, tv, tw, lse, delta, mask,
                                   round_p=True))
    unrounded = (fa.flash_dq_reference(tq, tk, tv, tw, lse, delta, mask),
                 *fa.flash_dkv_reference(tq, tk, tv, tw, lse, delta, mask))
    for g, u, j in zip(got, unrounded, j_grads):
        assert g.dtype == torch.bfloat16
        _near(g.float(), u.float(), *BF16_GRAD, scaled=True)
        _near(g.float(), np.asarray(j.astype(jnp.float32)), *BF16_GRAD,
              scaled=True)


@pytest.mark.parametrize("b", [1, 2])
def test_delta_is_contiguous_for_the_kernels(b):
    """The kernels read delta as contiguous (B*H, T) f32; at B = 1 the
    reshape of the permuted row sums is a strided view unless copied."""
    out, dout = (torch.tensor(a) for a in _qkv(b=b, seed=16)[:2])
    delta = fa.flash_delta(out, dout)
    assert delta.is_contiguous() and delta.shape == (b * 2, 32)
    want = (out * dout).sum(-1).permute(0, 2, 1).reshape(b * 2, 32)
    torch.testing.assert_close(delta, want, rtol=0, atol=0)
