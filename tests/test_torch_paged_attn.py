"""The port's paged attention against the JAX package's.

``paged_attention_reference`` (the plain PyTorch version of the CUDA
kernel, and what the wrapper computes for CPU tensors) and
``paged_attention_split_reference`` (the kernel's split over the context
and merge, in plain PyTorch) are held against the JAX
``paged_attention``, which runs its Pallas kernel in interpret mode on
the CPU as ``tests/test_paged_attn.py`` runs it.  Same inputs
from numpy; tolerance rtol 2e-5, atol 2e-6 (f32 on both sides; the
kernel's online softmax and the reference's one-pass softmax differ in
rounding only), 2e-4/2e-5 for int8 pools as in the JAX package's test.
The CUDA kernel itself is checked on the card by ``chip_smoke.py``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.ops.pallas_kernels import (
    paged_attention as jax_paged_attention,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops.paged_attention import (
    SPLIT_KEYS,
    paged_attention,
    paged_attention_reference,
    paged_attention_split_reference,
    split_plan,
)

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=2e-5, atol=2e-6)


def _fixture(seed=0, nb=10, bs=4, kv=2, hd=8, quant=False):
    rng = np.random.default_rng(seed)
    if quant:
        kp = rng.integers(-127, 127, (nb, bs, kv, hd)).astype(np.int8)
        vp = rng.integers(-127, 127, (nb, bs, kv, hd)).astype(np.int8)
    else:
        kp = rng.normal(size=(nb, bs, kv, hd)).astype(np.float32)
        vp = rng.normal(size=(nb, bs, kv, hd)).astype(np.float32)
    tables = np.zeros((3, 5), np.int32)
    tables[0, :3] = [1, 4, 7]
    tables[1, :2] = [2, 9]
    tables[2, :3] = [5, 3, 6]
    return rng, kp, vp, tables


def _both(q, kp, vp, tables, lens, starts, ks=None, vs=None):
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(starts),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    got = paged_attention_reference(
        t(q), t(kp), t(vp), t(tables), t(lens), t(starts), k_scale=t(ks),
        v_scale=t(vs))
    return got.numpy(), want


def test_decode_matches_jax_with_inactive_lane():
    """Width 1: ragged lengths, a stream straddling blocks, and a
    length-0 lane that outputs exactly 0."""
    rng, kp, vp, tables = _fixture()
    lens = np.asarray([11, 6, 0], np.int32)
    starts = np.maximum(lens - 1, 0).astype(np.int32)
    q = rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    got, want = _both(q, kp, vp, tables, lens, starts)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[2] == 0.0)


def test_prefill_chunk_causal_gqa_matches_jax():
    """Width 4 at non-zero starts, causal against absolute positions,
    4 query heads over 2 KV heads."""
    rng, kp, vp, tables = _fixture(seed=1)
    lens = np.asarray([11, 6, 4], np.int32)
    starts = np.asarray([7, 2, 0], np.int32)
    q = rng.normal(size=(3, 4, 4, 8)).astype(np.float32)
    got, want = _both(q, kp, vp, tables, lens, starts)
    np.testing.assert_allclose(got, want, **TOL)


def test_int8_pools_match_jax():
    rng, kq, vq, tables = _fixture(seed=2, quant=True)
    ks = rng.uniform(0.01, 0.1, (10, 4, 2)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (10, 4, 2)).astype(np.float32)
    lens = np.asarray([9, 3, 12], np.int32)
    starts = np.maximum(lens - 1, 0).astype(np.int32)
    q = rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    got, want = _both(q, kq, vq, tables, lens, starts, ks, vs)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_all_lanes_inactive_is_zero():
    rng, kp, vp, tables = _fixture(seed=3)
    zeros = np.zeros(3, np.int32)
    q = rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    got, want = _both(q, kp, vp, tables, zeros, zeros)
    assert np.all(got == 0.0) and np.all(want == 0.0)


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    """CPU tensors compute the plain version; the launch counter counts
    only kernel launches, so it stays where it was."""
    rng, kp, vp, tables = _fixture(seed=4)
    lens = np.asarray([5, 8, 1], np.int32)
    starts = (lens - 1).astype(np.int32)
    q = rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    args = [torch.as_tensor(a) for a in (q, kp, vp, tables, lens, starts)]
    before = paged_attention.launches
    got = paged_attention(*args)
    assert paged_attention.launches == before
    torch.testing.assert_close(got, paged_attention_reference(*args),
                               rtol=0, atol=0)


def test_wrapper_validates_shapes():
    _, kp, vp, tables = _fixture()
    kp, vp, tables = map(torch.as_tensor, (kp, vp, tables))
    lens = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):                # 3 heads over 2 kv
        paged_attention(torch.zeros(3, 1, 3, 8), kp, vp, tables, lens, lens)
    q = torch.zeros(3, 1, 4, 8)
    with pytest.raises(ValueError):                # one scale, not both
        paged_attention(q, kp, vp, tables, lens, lens,
                        k_scale=torch.ones(10, 4, 2))
    with pytest.raises(ValueError):                # scales on a float pool
        paged_attention(q, kp, vp, tables, lens, lens,
                        k_scale=torch.ones(10, 4, 2),
                        v_scale=torch.ones(10, 4, 2))


# ---------------------------------------------------------------------------
# the kernel's split over the context, in plain PyTorch
# ---------------------------------------------------------------------------

def _split_fixture(seed, quant=False, bs=4, kv=2, hd=8):
    """A 16-block pool and 5 lanes of a 5-entry table (capacity 20
    keys): the full capacity, BS + 1, BS, 1 and an inactive lane whose
    table is all sink (block 0) entries."""
    rng = np.random.default_rng(seed)
    shape = (16, bs, kv, hd)
    if quant:
        kp = rng.integers(-127, 127, shape).astype(np.int8)
        vp = rng.integers(-127, 127, shape).astype(np.int8)
        scales = [rng.uniform(0.01, 0.1, shape[:3]).astype(np.float32)
                  for _ in range(2)]
    else:
        kp = rng.normal(size=shape).astype(np.float32)
        vp = rng.normal(size=shape).astype(np.float32)
        scales = [None, None]
    tables = np.zeros((5, 5), np.int32)
    tables[0] = [1, 4, 7, 8, 10]
    tables[1, :2] = [2, 9]
    tables[2, :1] = [5]
    tables[3, :1] = [3]
    lens = np.asarray([20, bs + 1, bs, 1, 0], np.int32)
    return rng, kp, vp, tables, lens, scales


def _split_vs_jax_and_plain(q, kp, vp, tables, lens, starts, scales,
                            split_blocks, tol):
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    args = [t(a) for a in (q, kp, vp, tables, lens, starts)]
    ks, vs = (t(a) for a in scales)
    got = paged_attention_split_reference(
        *args, split_blocks=split_blocks, k_scale=ks, v_scale=vs)
    plain = paged_attention_reference(*args, k_scale=ks, v_scale=vs)
    _, want = _both(q, kp, vp, tables, lens, starts, *scales)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **tol)
    return got.numpy()


# split_blocks 1 (every block its own split), 2 (lanes of BS + 1 end
# inside a split), 3 (a split covers 12 keys: the 20-key lane's last split
# holds 8 and ends mid-table) and 8 (one split covers the table)
SPLITS = [1, 2, 3, 8]


@pytest.mark.parametrize("split_blocks", SPLITS)
def test_split_decode_lanes_match_jax_and_plain(split_blocks):
    """Width 1 at lengths capacity, BS + 1, BS, 1 and 0: the length-0
    lane, whose every split is empty, outputs exactly 0."""
    rng, kp, vp, tables, lens, scales = _split_fixture(seed=10)
    starts = np.maximum(lens - 1, 0).astype(np.int32)
    q = rng.normal(size=(5, 1, 4, 8)).astype(np.float32)
    got = _split_vs_jax_and_plain(q, kp, vp, tables, lens, starts, scales,
                                  split_blocks, TOL)
    assert np.all(got[4] == 0.0)


@pytest.mark.parametrize("split_blocks", SPLITS)
def test_split_lanes_ending_mid_block_match_jax_and_plain(split_blocks):
    """Lengths that end inside a block of a split (7, 10, 3 with BS 4),
    so the last split is partly masked by length."""
    rng, kp, vp, tables, _, scales = _split_fixture(seed=11)
    lens = np.asarray([18, 7, 3, 1, 0], np.int32)
    tables[1, 2] = 11
    starts = np.maximum(lens - 1, 0).astype(np.int32)
    q = rng.normal(size=(5, 1, 4, 8)).astype(np.float32)
    _split_vs_jax_and_plain(q, kp, vp, tables, lens, starts, scales,
                            split_blocks, TOL)


@pytest.mark.parametrize("split_blocks", SPLITS)
def test_split_gqa_prefill_chunk_at_nonzero_start_matches_jax(split_blocks):
    """Width 4 at starts 13 / 1 / 0: causal against absolute positions,
    so early rows see fewer splits than late ones; 4 query heads over 2
    KV heads."""
    rng, kp, vp, tables, lens, scales = _split_fixture(seed=12)
    lens = np.asarray([17, 5, 4, 1, 0], np.int32)
    starts = np.asarray([13, 1, 0, 0, 0], np.int32)
    q = rng.normal(size=(5, 4, 4, 8)).astype(np.float32)
    _split_vs_jax_and_plain(q, kp, vp, tables, lens, starts, scales,
                            split_blocks, TOL)


@pytest.mark.parametrize("split_blocks", SPLITS)
def test_split_int8_pools_match_jax_and_plain(split_blocks):
    """Scales indexed per (position, head) across split boundaries."""
    rng, kq, vq, tables, lens, scales = _split_fixture(seed=13, quant=True)
    starts = np.maximum(lens - 1, 0).astype(np.int32)
    q = rng.normal(size=(5, 1, 4, 8)).astype(np.float32)
    _split_vs_jax_and_plain(q, kq, vq, tables, lens, starts, scales,
                            split_blocks, dict(rtol=2e-4, atol=2e-5))


def test_split_plan_takes_no_lengths_and_covers_the_table():
    """The plan reads the table's capacity and the block size, nothing
    that lives on the device; its splits cover every table entry, and
    none lies wholly past the table."""
    assert list(inspect.signature(split_plan).parameters) == [
        "max_blocks", "block_size"]
    for bs in (16, 32):
        for max_blocks in range(1, 130):
            split_blocks, n_splits = split_plan(max_blocks, bs)
            assert split_blocks == max(1, SPLIT_KEYS // bs)
            assert n_splits * split_blocks >= max_blocks
            assert (n_splits - 1) * split_blocks < max_blocks
    # the server's table: 1024 keys of block 16
    assert split_plan(64, 16) == (SPLIT_KEYS // 16, 1024 // SPLIT_KEYS)


# ---------------------------------------------------------------------------
# head_dim 16: the fleet workers' default geometry (d_model 64, 4 heads)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split_blocks", [2, 8])
@pytest.mark.parametrize("case", ["decode", "int8", "gqa_prefill"])
def test_head_dim_16_matches_jax_and_plain(case, split_blocks):
    """head_dim 16, the shape the CUDA kernel's head_dim-16 instance
    takes on the card (phase 3 of chip_smoke.py holds it there): f32 and
    int8 pools, 4 query heads over 2 KV heads in a width-4 chunk at
    non-zero starts, split (2 blocks a split) and unsplit (one split
    covers the table), against JAX's kernel and the plain version."""
    rng, kp, vp, tables, lens, scales = _split_fixture(
        seed=20, quant=case == "int8", hd=16)
    width = 1
    starts = np.maximum(lens - 1, 0).astype(np.int32)
    if case == "gqa_prefill":
        lens = np.asarray([17, 5, 4, 1, 0], np.int32)
        starts = np.asarray([13, 1, 0, 0, 0], np.int32)
        width = 4
    q = rng.normal(size=(5, width, 4, 16)).astype(np.float32)
    tol = dict(rtol=2e-4, atol=2e-5) if case == "int8" else TOL
    got = _split_vs_jax_and_plain(q, kp, vp, tables, lens, starts, scales,
                                  split_blocks, tol)
    assert np.all(got[4] == 0.0)
