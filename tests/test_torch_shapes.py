"""The head_dims and block sizes the JAX kernels take, on the port's side.

* Flash (B1-B3, and B5 over them) at head_dim 8 and 16: the route
  ``kernel_design`` picks (bf16 there runs the simt kernels, f32 products
  on the CUDA cores; wgmma needs head_dim >= 32 here), and the port's CPU
  path (the plain versions those kernels are held against on the card)
  against the JAX ``flash_attention`` / ``flash_attention_with_lse`` in
  interpret mode, as ``tests/test_torch_flash.py`` runs them: f32 on both
  sides, tolerance 1e-5.
* Paged attention (B4) at head_dim 32 with pool blocks of 64 and 128 keys,
  f32 and int8 pools: the plain version and the kernel's split-and-merge
  plain version at ``split_plan``'s split against the JAX
  ``paged_attention``, as ``tests/test_torch_paged_attn.py`` runs it:
  tolerance 2e-5 / 2e-6, int8 2e-4 / 2e-5.

The CUDA kernels at these shapes are checked on the card by
``chip_smoke.py`` (phases 3, 5, 6 and 9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.ops.pallas_kernels import (
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_lse,
    paged_attention as jax_paged_attention,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
    flash_attention as fa,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops.paged_attention import (
    SPLIT_KEYS,
    paged_attention,
    paged_attention_reference,
    paged_attention_split_reference,
    split_plan,
)

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
PAGED_TOL = dict(rtol=2e-5, atol=2e-6)
PAGED_INT8_TOL = dict(rtol=2e-4, atol=2e-5)
MASKS = ("causal", "none", "causal_exclusive")


# ---------------------------------------------------------------------------
# flash at head_dim 8 and 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_small_head_dims_route_to_the_simt_kernels(which, dtype, head_dim):
    assert fa.kernel_design(which, dtype, head_dim) == "simt"
    assert fa.launch_design(which, dtype, (2, 96, 4, head_dim)) == "simt"


@pytest.mark.parametrize("head_dim", [8, 16])
def test_small_head_dims_take_the_serial_backward(head_dim):
    """The simt kernels have no shared dq + dk/dv launch: bf16 at head_dim
    8/16 runs in turn at every T, and asking it to share raises."""
    bf16 = torch.bfloat16
    for t in (32, fa.SHARED_MAX_T, 4 * fa.SHARED_MAX_T):
        assert fa.backward_schedule(bf16, t, head_dim=head_dim) == "serial"
    with pytest.raises(ValueError, match="only the sm90"):
        fa.backward_schedule(bf16, 32, "shared", head_dim=head_dim)
    assert fa.backward_schedule(bf16, 32, head_dim=32) == "shared"


def _qkv(d, b=2, t=32, h=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("head_dim", [8, 16])
def test_small_head_dims_with_lse_match_jax(head_dim, mask):
    """B5 at head_dim 8/16: (out, lse) and dq/dk/dv of sum(out * w) +
    sum(lse * u) against jax.grad through the Pallas custom_vjp; the
    forward and the FA-2 backward are B1-B3's plain versions."""
    q, k, v = _qkv(head_dim, seed=head_dim)
    rng = np.random.default_rng(head_dim + 1)
    w = rng.standard_normal(q.shape).astype(np.float32)
    u = rng.standard_normal((q.shape[0] * q.shape[2], q.shape[1])).astype(
        np.float32)

    def jloss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, True, 16, 8, True, mask)
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


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "none"])
@pytest.mark.parametrize("head_dim", [8, 16])
def test_small_head_dims_flash_gradients_match_jax(head_dim, causal):
    """B1-B3 through the port's FlashAttention at T 96 (not a multiple of
    the kernels' 64-row tile) against jax.grad through the Pallas
    backward."""
    q, k, v = _qkv(head_dim, t=96, seed=20 + head_dim)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return (jax_flash(q, k, v, causal, 32, 16, True) * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal, 32, 16)
    got = torch.autograd.grad((out * torch.tensor(w)).sum(), (tq, tk, tv))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)


# ---------------------------------------------------------------------------
# paged attention at head_dim 32, blocks 64 and 128
# ---------------------------------------------------------------------------

def _paged_case(bs, quant, seed, hd=32, kv=2, n_heads=4, width=1):
    """Five lanes over a table of 4 blocks: a full table, a lane one key
    past a block, a lane of exactly one block, one key, and an inactive
    lane."""
    rng = np.random.default_rng(seed)
    nb = 12
    shape = (nb, bs, kv, hd)
    if quant:
        kp = rng.integers(-127, 127, shape).astype(np.int8)
        vp = rng.integers(-127, 127, shape).astype(np.int8)
        scales = [rng.uniform(0.01, 0.1, shape[:3]).astype(np.float32)
                  for _ in range(2)]
    else:
        kp = rng.normal(size=shape).astype(np.float32)
        vp = rng.normal(size=shape).astype(np.float32)
        scales = [None, None]
    tables = np.zeros((5, 4), np.int32)
    tables[0] = [3, 7, 1, 10]
    tables[1, :2] = [2, 9]
    tables[2, :1] = [5]
    tables[3, :1] = [4]
    lens = np.asarray([4 * bs, bs + 1, bs, 1, 0], np.int32)
    starts = np.maximum(lens - width, 0).astype(np.int32)
    q = rng.normal(size=(5, width, n_heads, hd)).astype(np.float32)
    return q, kp, vp, tables, lens, starts, scales


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("width", [1, 4], ids=["decode", "prefill4"])
@pytest.mark.parametrize("bs", [64, 128])
def test_paged_head_dim_32_large_blocks_match_jax(bs, width, quant):
    q, kp, vp, tables, lens, starts, (ks, vs) = _paged_case(
        bs, quant, seed=bs + width, width=width)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(starts),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    args = [t(a) for a in (q, kp, vp, tables, lens, starts)]
    scales = dict(k_scale=t(ks), v_scale=t(vs))
    tol = PAGED_INT8_TOL if quant else PAGED_TOL
    plain = paged_attention_reference(*args, **scales)
    np.testing.assert_allclose(plain.numpy(), want, **tol)
    # the wrapper on CPU tensors is the plain version, uncounted
    before = paged_attention.launches
    np.testing.assert_array_equal(paged_attention(*args, **scales).numpy(),
                                  plain.numpy())
    assert paged_attention.launches == before
    # the kernel's split at split_plan's size (whole pool blocks), and one
    # block per split
    split_blocks, n_splits = split_plan(tables.shape[1], bs)
    assert split_blocks * bs == max(SPLIT_KEYS, bs)
    for sb in {split_blocks, 1}:
        got = paged_attention_split_reference(*args, split_blocks=sb,
                                              **scales)
        np.testing.assert_allclose(got.numpy(), want, **tol)
    assert np.all(plain.numpy()[4] == 0.0)


def test_split_plan_is_whole_blocks_at_every_block_size():
    for bs in (16, 32, 64, 128, 256, 512):
        for max_blocks in range(1, 70):
            split_blocks, n_splits = split_plan(max_blocks, bs)
            assert split_blocks >= 1
            assert split_blocks * bs == max(SPLIT_KEYS, bs)
            assert n_splits * split_blocks >= max_blocks
            assert (n_splits - 1) * split_blocks < max_blocks
    # BENCH_PAGED_ATTN.json's block 128 at 1024 keys: 4 splits of 2 blocks
    assert split_plan(8, 128) == (2, 4)
