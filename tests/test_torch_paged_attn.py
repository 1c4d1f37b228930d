"""The port's paged attention against the JAX package's.

``paged_attention_reference`` (the plain PyTorch version of the CUDA
kernel, and what the wrapper computes for CPU tensors) is held against
the JAX ``paged_attention``, which runs its Pallas kernel in interpret
mode on the CPU as ``tests/test_paged_attn.py`` runs it.  Same inputs
from numpy; tolerance rtol 2e-5, atol 2e-6 (f32 on both sides; the
kernel's online softmax and the reference's one-pass softmax differ in
rounding only), 2e-4/2e-5 for int8 pools as in the JAX package's test.
The CUDA kernel itself is checked on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu.ops.pallas_kernels import (
    paged_attention as jax_paged_attention,
)
from neural_networks_parallel_training_with_mpi_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
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
