"""Flash attention with its FlashAttention-2 backward.

``flash_attention`` is the port of the JAX package's
``ops/pallas_kernels.py:flash_attention`` (kernels ``_flash_fwd_kernel``,
``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``).  On CUDA tensors its
three wrappers launch the hand-written kernels of
``csrc/flash_attention.cu`` (built for ``sm_90a`` at first use, see
``ops._build``) or raise; on CPU tensors they compute the plain PyTorch
versions beside them.  There is no fallback from a kernel to its plain
version.

Shapes, as in the JAX package: q/k/v (B, T, H, D) with head_dim
contiguous (the strided views of the fused qkv projection are taken as
they are); out (B, T, H, D) in q's dtype; lse and delta (B*H, T) float32
in JAX's (b, h) order.  Mask modes ``none`` / ``causal`` /
``causal_exclusive``; a row with no attendable key outputs 0 with lse
-1e30 and gets gradient 0.

* ``flash_forward``      -> (out, lse)      kernel ``fwd``
* ``flash_backward_dq``  -> dq              kernel ``dq``
* ``flash_backward_dkv`` -> (dk, dv)        kernel ``dkv``
* ``flash_backward``     delta = rowsum(dO * O) in f32, then dq and dkv
* ``flash_attention``    the ``torch.autograd.Function`` over them

Each kernel launch adds one to ``flash_attention.launches[name]``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
MASK_MODES = ("none", "causal", "causal_exclusive")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WHICH = {"fwd": 0, "dq": 1, "dkv": 2}


def resolve_blocks(t: int, block_q: int, block_k: int) -> Tuple[int, int]:
    """``pallas_kernels._resolve_blocks``: blocks clipped to T, which must
    divide by both."""
    block_q, block_k = min(block_q, t), min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"seq_len {t} not divisible by blocks "
                         f"({block_q}, {block_k})")
    return block_q, block_k


def resolve_mask(causal: bool, mask_mode: Optional[str] = None) -> str:
    mode = mask_mode if mask_mode is not None else (
        "causal" if causal else "none")
    if mode not in MASK_MODES:
        raise ValueError(f"mask_mode must be one of {MASK_MODES}, got "
                         f"{mode!r}")
    return mode


def _check(q, k, v):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, T, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q/k/v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q/k/v must be on one device")


def _keep(t: int, mask: str, device) -> Optional[torch.Tensor]:
    """(T, T) bool, True where query i may attend key j (None: all)."""
    if mask == "none":
        return None
    pos = torch.arange(t, device=device)
    if mask == "causal":
        return pos[None, :] <= pos[:, None]
    return pos[None, :] < pos[:, None]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def flash_forward_reference(q, k, v, mask: str = "causal",
                            block_k: int = 128):
    """The blocked online softmax of ``_blocked_attention_reference``
    (keys in blocks of ``block_k``, running max / denominator /
    accumulator in f32), plus lse and the empty-row convention."""
    _check(q, k, v)
    b, t, h, d = q.shape
    block_k = min(block_k, t)
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    keep = _keep(t, mask, q.device)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=q.device)
    for j0 in range(0, t, block_k):
        s = torch.einsum("bthd,bshd->bhts", qf, kf[:, j0:j0 + block_k])
        if keep is not None:
            s = torch.where(keep[None, None, :, j0:j0 + block_k], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + torch.einsum("bhts,bshd->bhtd", p,
                                        vf[:, j0:j0 + block_k])
        m = m_new
    empty = m < NEG_INF * 0.5
    l_safe = torch.where(empty, 1.0, l)
    out = torch.where(empty, 0.0, acc / l_safe)
    lse = torch.where(empty, NEG_INF, m + torch.log(l_safe))
    return (out.permute(0, 2, 1, 3).to(q.dtype),
            lse.reshape(b * h, t))


def flash_delta(out, dout) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B*H, T): one reduction outside the
    kernels, as the JAX package computes it."""
    b, t, h, _ = out.shape
    d = (dout.float() * out.float()).sum(-1)            # (B, T, H)
    return d.permute(0, 2, 1).reshape(b * h, t)


def _probs(q, k, lse, mask):
    """P = exp(s - lse) recomputed in f32 (B, H, T, T); rows with no key
    (lse -1e30) get P = 0."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _keep(t, mask, q.device)
    if keep is not None:
        s = torch.where(keep[None, None], s, NEG_INF)
    lse4 = lse.reshape(b, h, t, 1)
    live = lse4 > NEG_INF * 0.5
    return torch.where(live, torch.exp(s - torch.where(live, lse4, 0.0)),
                       0.0), scale


def _dscores(q, k, v, dout, lse, delta, mask):
    b, t, h, _ = q.shape
    p, scale = _probs(q, k, lse, mask)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta.reshape(b, h, t, 1)) * scale
    return p, ds


def flash_dq_reference(q, k, v, dout, lse, delta, mask: str = "causal"):
    """dq = dS K with dS = P (dP - delta) / sqrt(D), dP = dO V^T."""
    _, ds = _dscores(q, k, v, dout, lse, delta, mask)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, mask: str = "causal"):
    """dk = dS^T Q, dv = P^T dO."""
    p, ds = _dscores(q, k, v, dout, lse, delta, mask)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float()).to(v.dtype)
    return dk, dv


def flash_backward_reference(q, k, v, out, lse, dout, mask: str = "causal"):
    """(dq, dk, dv) by the FA-2 formulas in plain PyTorch."""
    delta = flash_delta(out, dout)
    dk, dv = flash_dkv_reference(q, k, v, dout, lse, delta, mask)
    return flash_dq_reference(q, k, v, dout, lse, delta, mask), dk, dv


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _launch(which: str, q, k, v, mask: str, block_q: int, block_k: int, *,
            dout=None, lse=None, delta=None, out0=None, out1=None,
            lse_out=None):
    lib, _ = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        for query in (lib.flash_attention_supported, lib.flash_attention_tile):
            query.restype = ctypes.c_int
        lib.flash_attention_supported.argtypes = [ctypes.c_int]
        lib.flash_attention_tile.argtypes = []
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 9
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    b, t, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not supported (float32, "
                         "bfloat16)")
    if not lib.flash_attention_supported(d):
        raise ValueError(f"the CUDA kernels take head_dim 32/64/128, got {d}")
    tile = lib.flash_attention_tile()
    if t % tile:
        raise ValueError(f"the CUDA kernels need seq_len % {tile} == 0, "
                         f"got {t}")
    views = (q, k, v, dout, out0, out1)
    for t_ in views + (lse, delta, lse_out):
        if t_ is not None and t_.device != q.device:
            raise ValueError(f"a tensor is on {t_.device}, q on {q.device}")
    for t_ in views:
        if t_ is not None and t_.stride(-1) != 1:
            raise ValueError("head_dim must be contiguous")
    for t_ in (lse, delta):
        if t_ is not None and (t_.dtype != torch.float32
                               or not t_.is_contiguous()):
            raise ValueError("lse/delta must be contiguous float32")
    strides = []
    for t_ in views:
        strides += list(t_.stride()[:3]) if t_ is not None else [0, 0, 0]
    c_strides = (ctypes.c_longlong * 18)(*strides)
    ptr = lambda t_: None if t_ is None else t_.data_ptr()  # noqa: E731
    err = fn(_WHICH[which], _DTYPE_CODE[q.dtype], d, ptr(q), ptr(k), ptr(v),
             ptr(dout), ptr(lse), ptr(delta), ptr(out0), ptr(out1),
             ptr(lse_out), c_strides, b, h, t, block_q, block_k,
             MASK_MODES.index(mask), 1.0 / math.sqrt(d),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {which} kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention.launches[which] += 1


def _device(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return q.device.type


def flash_forward(q, k, v, mask: str = "causal", block_q: int = 128,
                  block_k: int = 128):
    """(out, lse): the ``fwd`` kernel on CUDA tensors, the plain version on
    CPU tensors."""
    _check(q, k, v)
    resolve_mask(True, mask)
    block_q, block_k = resolve_blocks(q.shape[1], block_q, block_k)
    if _device(q) == "cpu":
        return flash_forward_reference(q, k, v, mask, block_k)
    b, t, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    _launch("fwd", q, k, v, mask, block_q, block_k, out0=out, lse_out=lse)
    return out, lse


def flash_backward_dq(q, k, v, dout, lse, delta, mask: str = "causal",
                      block_q: int = 128, block_k: int = 128):
    """dq: the ``dq`` kernel on CUDA tensors, the plain version on CPU."""
    _check(q, k, v)
    block_q, block_k = resolve_blocks(q.shape[1], block_q, block_k)
    if _device(q) == "cpu":
        return flash_dq_reference(q, k, v, dout, lse, delta, mask)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("dq", q, k, v, mask, block_q, block_k, dout=dout, lse=lse,
            delta=delta, out0=dq)
    return dq


def flash_backward_dkv(q, k, v, dout, lse, delta, mask: str = "causal",
                       block_q: int = 128, block_k: int = 128):
    """(dk, dv): the ``dkv`` kernel on CUDA tensors, the plain version on
    CPU."""
    _check(q, k, v)
    block_q, block_k = resolve_blocks(q.shape[1], block_q, block_k)
    if _device(q) == "cpu":
        return flash_dkv_reference(q, k, v, dout, lse, delta, mask)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("dkv", q, k, v, mask, block_q, block_k, dout=dout, lse=lse,
            delta=delta, out0=dk, out1=dv)
    return dk, dv


def flash_backward(q, k, v, out, lse, dout, mask: str = "causal",
                   block_q: int = 128, block_k: int = 128):
    """(dq, dk, dv): delta in f32, then the dq and dkv kernels (or their
    plain versions on CPU)."""
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    delta = flash_delta(out, dout)
    dq = flash_backward_dq(q, k, v, dout, lse, delta, mask, block_q, block_k)
    dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta, mask, block_q,
                                block_k)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse); backward computes delta and runs
    dq, then dkv."""

    @staticmethod
    def forward(ctx, q, k, v, mask, block_q, block_k):
        out, lse = flash_forward(q, k, v, mask, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (mask, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, *ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Blocked attention, kernel forward + kernel backward.  q/k/v
    (B, T, H, D) -> (B, T, H, D)."""
    return FlashAttention.apply(q, k, v, resolve_mask(causal), block_q,
                                block_k)


flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
