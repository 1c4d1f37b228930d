"""Routing of the port's flash-attention launches between its two kernel
designs, the launch-shape rule, the backward's schedule, and the
alignment rule of the sm90 kernels' copies.

``kernel_design``, ``launch_design``, ``backward_schedule`` and
``for_copies`` are the plain functions the CUDA wrappers call before every
launch, so they are pinned here on the CPU; the kernels themselves run on
the card through ``chip_smoke.py``.  Nothing here needs or looks for a
card.
"""

import pytest
import torch

from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
    flash_attention as fa,
)

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("dtype,which,design", [
    (torch.bfloat16, "fwd", "sm90"),
    (torch.bfloat16, "dkv", "sm90"),
    (torch.bfloat16, "dq", "sm90"),
    (torch.float32, "fwd", "simt"),
    (torch.float32, "dq", "simt"),
    (torch.float32, "dkv", "simt"),
], ids=["bf16-fwd", "bf16-dkv", "bf16-dq", "f32-fwd", "f32-dq", "f32-dkv"])
def test_design_by_dtype_kernel_and_head_dim(dtype, which, design, head_dim):
    assert fa.kernel_design(which, dtype, head_dim) == design


@pytest.mark.parametrize("head_dim", [12, 48, 96, 256])
@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_bf16_head_dim_outside_the_sm90_kernels_raises(which, head_dim):
    """A raise naming the sm90 kernels, never a route to the simt ones."""
    with pytest.raises(ValueError, match="sm90 kernels .* take head_dim"):
        fa.kernel_design(which, torch.bfloat16, head_dim)


def test_simt_head_dims_and_unknown_inputs_raise():
    with pytest.raises(ValueError, match="simt kernels take head_dim"):
        fa.kernel_design("dq", torch.float32, 48)
    with pytest.raises(ValueError, match="simt kernels take head_dim"):
        fa.kernel_design("fwd", torch.float32, 256)
    with pytest.raises(ValueError, match="dtype"):
        fa.kernel_design("fwd", torch.float16, 64)
    with pytest.raises(ValueError, match="kernel must be one of"):
        fa.kernel_design("bwd", torch.bfloat16, 64)


def _qkv_views(width_pad=0, offset=0, b=2, t=64, h=4, d=64,
               dtype=torch.bfloat16):
    """q/k/v as the model takes them: views of one fused (B, T, 3 H D)
    projection (row stride 3 H D + width_pad), starting ``offset``
    elements into each row."""
    qkv = torch.randn(b, t, 3 * h * d + width_pad + offset).to(dtype)
    return [qkv[..., offset + i * h * d:offset + (i + 1) * h * d]
            .reshape(b, t, h, d) for i in range(3)]


@pytest.mark.parametrize("d", [32, 64, 128])
def test_fused_qkv_views_are_read_in_place(d):
    for x in _qkv_views(d=d):
        assert not x.is_contiguous()
        assert fa.aligned_for_copies(x)
        assert fa.for_copies(x) is x


@pytest.mark.parametrize("width_pad,offset", [(0, 1), (4, 0), (3, 5)],
                         ids=["base-off-by-2-bytes", "row-stride-8-bytes",
                              "both"])
def test_misaligned_views_are_copied_contiguous(width_pad, offset):
    for x in _qkv_views(width_pad=width_pad, offset=offset):
        assert not fa.aligned_for_copies(x)
        y = fa.for_copies(x)
        assert y is not x and y.is_contiguous()
        assert fa.aligned_for_copies(y)
        assert torch.equal(y, x)


def test_alignment_rule_details():
    # lse / delta: contiguous (B*H, T) f32
    lse = torch.zeros(8, 128)
    assert fa.aligned_for_copies(lse) and fa.for_copies(lse) is lse
    # a contiguous tensor whose base sits 4 bytes into its storage
    shifted = torch.zeros(8 * 128 + 1)[1:].view(8, 128)
    assert shifted.is_contiguous() and not fa.aligned_for_copies(shifted)
    assert fa.aligned_for_copies(fa.for_copies(shifted))
    # the stride of a length-1 dim is never used, so it does not count
    one = torch.zeros(64, 4, 64, dtype=torch.bfloat16).unsqueeze(0)
    odd = one.as_strided(one.shape, (3,) + one.stride()[1:])
    assert fa.aligned_for_copies(odd)
    # head_dim not contiguous: not readable by 16-byte copies as it is
    t = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16).transpose(2, 3)
    assert not fa.aligned_for_copies(t)
    assert fa.for_copies(None) is None


def test_launch_counters_by_design_start_at_zero_on_the_cpu_path():
    """The CPU path (plain versions, the delta of the backward included)
    launches nothing: every counter, ``delta`` too, stays where it was."""
    before = fa.launch_counts()
    q, k, v = (x.float().requires_grad_() for x in _qkv_views(t=64, d=32))
    fa.flash_attention(q, k, v).sum().backward()
    out, lse = fa.flash_attention_with_lse(q, k, v)
    (out.sum() + lse.sum()).backward()
    after = fa.launch_counts()
    assert after == before
    assert set(after["all"]) == {"fwd", "delta", "dq", "dkv"}
    assert set(after["sm90"]) == {"fwd", "delta", "dq", "dkv"}
    assert set(after["simt"]) == {"fwd", "delta", "dq", "dkv"}


def test_set_launch_counts_restores_and_zeroes():
    saved = fa.launch_counts()
    try:
        fa.flash_attention.launches["fwd"] += 3
        fa.flash_attention.launches["delta"] += 5
        fa.flash_attention.launches_sm90["dkv"] += 2
        fa.flash_attention.launches_sm90["dq"] += 4
        fa.flash_attention.launches_sm90["delta"] += 6
        fa.flash_attention.launches_simt["delta"] += 7
        fa.flash_attention_with_lse.launches += 1
        snap = fa.launch_counts()
        assert (snap["all"]["delta"], snap["sm90"]["delta"],
                snap["simt"]["delta"]) == (saved["all"]["delta"] + 5,
                                           saved["sm90"]["delta"] + 6,
                                           saved["simt"]["delta"] + 7)
        fa.set_launch_counts()
        zero = fa.launch_counts()
        assert all(v == 0 for name in ("all", "sm90", "simt")
                   for v in zero[name].values()) and zero["with_lse"] == 0
        assert zero["all"]["delta"] == 0
        fa.set_launch_counts(snap)
        assert fa.launch_counts() == snap
    finally:
        fa.set_launch_counts(saved)


# ---------------------------------------------------------------------------
# the launch-shape rule: any T the blocks divide, head_dim 32/64/128
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,blocks", [(32, (128, 128)), (96, (128, 128)),
                                      (288, (96, 96)), (100, (50, 25)),
                                      (320, (64, 64)), (1024, (128, 128))],
                         ids=["t32", "t96", "t288-blocks96", "t100",
                              "t320", "t1024"])
@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "sm90"),
                                          (torch.float32, "simt")],
                         ids=["bf16", "f32"])
def test_launch_design_takes_any_t_the_blocks_divide(t, blocks, dtype,
                                                     design):
    """T % 64 != 0 launches (a masked tail tile), as JAX's kernels take
    any T their clipped blocks divide."""
    for which in ("fwd", "dq", "dkv"):
        assert fa.launch_design(which, dtype, (2, t, 4, 64),
                                *blocks) == design


@pytest.mark.parametrize("head_dim", [12, 24, 48, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_launch_design_refuses_head_dims_and_blocks(head_dim, dtype):
    with pytest.raises(ValueError, match="take head_dim 32/64/128"):
        fa.launch_design("fwd", dtype, (2, 96, 4, head_dim))
    with pytest.raises(ValueError, match="not divisible"):
        fa.launch_design("dq", dtype, (2, 96, 4, 64), 64, 64)


def test_backward_schedule_rule_and_overrides():
    bf16, f32 = torch.bfloat16, torch.float32
    assert fa.backward_schedule(bf16, fa.SHARED_MAX_T) == "shared"
    assert fa.backward_schedule(bf16, 32) == "shared"
    assert fa.backward_schedule(bf16, fa.SHARED_MAX_T + 64) == "serial"
    assert fa.backward_schedule(f32, 32) == "serial"
    assert fa.backward_schedule(bf16, 4096, "shared") == "shared"
    assert fa.backward_schedule(f32, 32, "serial") == "serial"
    with pytest.raises(ValueError, match="only the sm90"):
        fa.backward_schedule(f32, 32, "shared")
    with pytest.raises(ValueError, match="schedule must be one of"):
        fa.backward_schedule(bf16, 32, "parallel")
