"""Flash attention with its FlashAttention-2 backward.

``flash_attention`` is the port of the JAX package's
``ops/pallas_kernels.py:flash_attention`` (kernels ``_flash_fwd_kernel``,
``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``).  On CUDA tensors its
wrappers launch hand-written kernels (built for ``sm_90a`` at first use,
see ``ops._build``) or raise; on CPU tensors they compute the plain
PyTorch versions beside them.  There is no fallback from a kernel to its
plain version, nor from one kernel design to the other.

Two designs, chosen by :func:`kernel_design` from the inputs before any
launch:

* ``sm90`` (``csrc/flash_attention_sm90.cu``): every bf16 kernel (forward,
  dq, dk/dv), bf16 products on the tensor cores (wgmma), tiles brought in
  by cp.async.  Its operands are read with 16-byte copies: a view whose
  base pointer or (B, T, H) strides are not 16-byte multiples is copied
  contiguous first (:func:`for_copies`).  It rounds P and dS to bf16
  before the last product of each step; ``round_p=True`` makes the plain
  versions do the same.
* ``simt`` (``csrc/flash_attention.cu``): every f32 kernel, and the bf16
  kernels at head_dim 8 and 16; f32 products on the CUDA cores (bf16
  inputs load as f32, P and dS stay f32, outputs round to bf16 once).
  wgmma contracts over 16 bf16 values, so head_dim 8 would need zero
  columns in every sm90 tile, and 16- or 32-byte rows another swizzle
  than the sm90 tiles': at those widths the scores' softmax costs as
  much as their products, and the CUDA cores do both.

Both take any T that :func:`resolve_blocks` accepts, as the JAX kernels
do: the grid covers ceil(T / 64) tiles and masks the last one
(:func:`launch_design` is the rule); head_dim 8, 16, 32, 64 or 128
(:data:`HEAD_DIMS`, the sm90 design :data:`SM90_HEAD_DIMS`).

Shapes, as in the JAX package: q/k/v (B, T, H, D) with head_dim
contiguous (the strided views of the fused qkv projection are taken as
they are); out (B, T, H, D) in q's dtype; lse and delta (B*H, T) float32
in JAX's (b, h) order.  Mask modes ``none`` / ``causal`` /
``causal_exclusive``; a row with no attendable key outputs 0 with lse
-1e30 and gets gradient 0.

* ``flash_forward``      -> (out, lse)      kernel ``fwd``
* ``flash_backward``     -> (dq, dk, dv): one C call that launches the
                         ``delta`` kernel (rowsum(dO * O) - g_lse in f32,
                         ``csrc/flash_delta.cuh``; plain version
                         :func:`flash_delta`), then ``dq`` and ``dkv``,
                         in one shared launch or two
                         (:func:`backward_schedule`)
* ``flash_attention``    the ``torch.autograd.Function`` over them
* ``flash_attention_with_lse``  (out, lse), both differentiable: the port
                         of ``flash_attention_with_lse`` (B5, a
                         ``custom_vjp`` over the same kernels); the
                         building block of ring attention
                         (``parallel.sequence``)

Each kernel launch adds one to ``flash_attention.launches[name]`` and to
``flash_attention.launches_sm90[name]`` or ``launches_simt[name]`` by its
design (a shared dq + dk/dv launch counts one of each); each
``flash_attention_with_lse`` call that launches the forward kernel adds
one to ``flash_attention_with_lse.launches``.
"""

from __future__ import annotations

import array
import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
MASK_MODES = ("none", "causal", "causal_exclusive")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = ("fwd", "dq", "dkv")            # the TPU kernels' ports
COUNTERS = ("fwd", "delta", "dq", "dkv")   # launch counters, by kernel
HEAD_DIMS = (8, 16, 32, 64, 128)   # what the kernels take, in either dtype
SM90_HEAD_DIMS = (32, 64, 128)    # bf16 on the sm90 design; 8, 16 on simt
SCHEDULES = ("shared", "serial")
# the longest sequence whose bf16 backward runs dq and dk/dv as one shared
# launch (measured by chip_smoke.py phase 9: shared is faster up to here)
SHARED_MAX_T = 512


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
                            block_k: int = 128, round_p: bool = False):
    """The blocked online softmax of ``_blocked_attention_reference``
    (keys in blocks of ``block_k``, running max / denominator /
    accumulator in f32), plus lse and the empty-row convention.

    ``round_p`` rounds each block's P to q's dtype before P V (the
    denominator keeps the f32 P), as the sm90 kernel does with its 64-key
    tiles (``block_k=64``); on f32 inputs it changes nothing."""
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
        pv = p.to(q.dtype).float() if round_p else p
        acc = corr * acc + torch.einsum("bhts,bshd->bhtd", pv,
                                        vf[:, j0:j0 + block_k])
        m = m_new
    empty = m < NEG_INF * 0.5
    l_safe = torch.where(empty, 1.0, l)
    out = torch.where(empty, 0.0, acc / l_safe)
    lse = torch.where(empty, NEG_INF, m + torch.log(l_safe))
    return (out.permute(0, 2, 1, 3).to(q.dtype),
            lse.reshape(b * h, t))


def flash_delta(out, dout, g_lse=None) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B*H, T), as the JAX package computes
    it in XLA (``_flash_backward`` :366-369): the plain version of the
    ``delta`` kernel that :func:`flash_backward` launches on CUDA tensors.

    A cotangent ``g_lse`` (B*H, T) on the lse output folds in here: d lse_i
    / d s_ij = p_ij, so dS_ij = p_ij (dP_ij - delta_i + g_lse_i), i.e.
    delta shifts by -g_lse and nothing else changes (dv does not depend on
    lse).  ``None`` counts as zero."""
    b, t, h, _ = out.shape
    d = (dout.float() * out.float()).sum(-1)            # (B, T, H)
    delta = d.permute(0, 2, 1).reshape(b * h, t)
    if g_lse is not None:
        delta = delta - g_lse.float()
    # the kernels read delta contiguous; the reshape is a strided view at
    # B = 1, and the merge's gradient may arrive strided
    return delta.contiguous()


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


def flash_dq_reference(q, k, v, dout, lse, delta, mask: str = "causal",
                       round_p: bool = False):
    """dq = dS K with dS = P (dP - delta) / sqrt(D), dP = dO V^T.
    ``round_p`` rounds dS (computed in f32) to q's dtype before dS K, as
    the sm90 kernel does; on f32 inputs it changes nothing."""
    _, ds = _dscores(q, k, v, dout, lse, delta, mask)
    if round_p:
        ds = ds.to(q.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, mask: str = "causal",
                        round_p: bool = False):
    """dk = dS^T Q, dv = P^T dO.  ``round_p`` rounds P and dS (computed in
    f32) to q's dtype before the two products, as the sm90 kernel does; on
    f32 inputs it changes nothing."""
    p, ds = _dscores(q, k, v, dout, lse, delta, mask)
    if round_p:
        p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float()).to(v.dtype)
    return dk, dv


def flash_backward_reference(q, k, v, out, lse, dout, mask: str = "causal",
                             g_lse=None):
    """(dq, dk, dv) by the FA-2 formulas in plain PyTorch (``g_lse``: the
    lse cotangent, see :func:`flash_delta`)."""
    delta = flash_delta(out, dout, g_lse)
    dk, dv = flash_dkv_reference(q, k, v, dout, lse, delta, mask)
    return flash_dq_reference(q, k, v, dout, lse, delta, mask), dk, dv


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def kernel_design(which: str, dtype: torch.dtype, head_dim: int) -> str:
    """The design a CUDA launch of ``which`` ("fwd", "dq", "dkv") on
    ``dtype`` inputs goes to: ``"sm90"`` (wgmma, ``csrc/
    flash_attention_sm90.cu``) for bf16 at head_dim 32/64/128, ``"simt"``
    (CUDA cores, ``csrc/flash_attention.cu``) for bf16 at head_dim 8/16
    and for every f32 kernel.  A dispatch on the inputs, decided before
    any launch and without looking at a card: a head_dim outside
    :data:`HEAD_DIMS` raises, in bf16 as in f32."""
    if which not in _KERNELS:
        raise ValueError(f"kernel must be one of {_KERNELS}, got "
                         f"{which!r}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {dtype} not supported (float32, "
                         "bfloat16)")
    if head_dim not in HEAD_DIMS:
        if dtype == torch.bfloat16:
            raise ValueError(f"the sm90 kernels (bf16) take head_dim "
                             f"32/64/128 and the simt kernels bf16 head_dim "
                             f"8/16; got {head_dim}")
        raise ValueError(f"the simt kernels take head_dim 32/64/128 and "
                         f"8/16; got {head_dim}")
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "simt"


def launch_design(which: str, dtype: torch.dtype, shape,
                  block_q: int = 128, block_k: int = 128) -> str:
    """The launch-shape rule of the CUDA kernels, checked before every
    launch: any (B, T, H, D) whose T the blocks divide
    (:func:`resolve_blocks`, as JAX requires) and whose head_dim is in
    :data:`HEAD_DIMS`; the grid covers ceil(T / 64) tiles of 64 rows and
    masks the rows and keys of the last one at or past T.  Returns the
    design (:func:`kernel_design`); raises for what the kernels do not
    take."""
    _, t, _, d = shape
    resolve_blocks(t, block_q, block_k)
    return kernel_design(which, dtype, d)


def backward_schedule(dtype: torch.dtype, t: int,
                      schedule: Optional[str] = None,
                      head_dim: int = 64) -> str:
    """How :func:`flash_backward` launches dq and dk/dv after delta:
    ``"shared"``, one launch whose blocks take either role, or
    ``"serial"``, two launches in turn.  ``None`` picks by the rule: the
    sm90 kernels (bf16 at head_dim 32/64/128) share up to T =
    :data:`SHARED_MAX_T`; the simt kernels (f32, and bf16 at head_dim
    8/16) always run in turn, and an explicit ``"shared"`` on them
    raises."""
    sm90 = dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS
    if schedule is None:
        return "shared" if sm90 and t <= SHARED_MAX_T else "serial"
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    if schedule == "shared" and not sm90:
        raise ValueError("only the sm90 (bf16, head_dim 32/64/128) "
                         "kernels share a launch")
    return schedule


def _aligned(x: torch.Tensor, strides) -> bool:
    if strides[-1] != 1 or x.data_ptr() % 16:
        return False
    unit = 16 // x.element_size()   # elements in 16 bytes
    return all(st % unit == 0 or n == 1
               for st, n in zip(strides[:-1], x.shape[:-1]))


def aligned_for_copies(x: torch.Tensor) -> bool:
    """True when the sm90 kernels' 16-byte copies can read ``x`` as it is:
    last dim contiguous, base pointer and the strides of the other dims
    (those longer than 1) multiples of 16 bytes."""
    return _aligned(x, x.stride())


def for_copies(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``x`` as it is when :func:`aligned_for_copies`, else a contiguous
    copy (fresh storage, so aligned)."""
    if x is None or aligned_for_copies(x):
        return x
    return x.clone(memory_format=torch.contiguous_format)


_LIBRARY = {"sm90": "flash_attention_sm90", "simt": "flash_attention"}
_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_STRIDES = ctypes.c_void_p   # the address of an array.array("q")
# (design, entry) -> (C function, argument types)
_SIGNATURES = {
    ("sm90", "forward"): ("flash_sm90_forward",
                          [_I] + [_P] * 5 + [_STRIDES] + [_I] * 4
                          + [_F, _P]),
    ("sm90", "backward"): ("flash_sm90_backward",
                           [_I] + [_P] * 11 + [_STRIDES] + [_I] * 4
                           + [_F, _I, _P]),
    ("simt", "forward"): ("flash_attention_forward",
                          [_I] * 2 + [_P] * 5 + [_STRIDES] + [_I] * 6
                          + [_F, _P]),
    ("simt", "backward"): ("flash_attention_backward",
                           [_I] * 2 + [_P] * 11 + [_STRIDES] + [_I] * 6
                           + [_F, _P]),
}
_ENTRIES = {}


def _entry(design: str, kind: str):
    """The ctypes function of a design's C entry, its types set once."""
    fn = _ENTRIES.get((design, kind))
    if fn is None:
        lib, _ = _build.load(_LIBRARY[design])
        name, argtypes = _SIGNATURES[(design, kind)]
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _ENTRIES[(design, kind)] = fn
    return fn


def _views(device: int, copies: bool, *xs):
    """One pass over a launch's (B, T, H, D) inputs: each on the card
    ``device``, head_dim contiguous and, with ``copies`` (every bf16
    launch: the sm90 kernels and the delta kernel read bf16 rows 16 bytes
    at a time), readable by 16-byte copies or else copied contiguous
    (:func:`for_copies`).  Returns the tensors to launch on (hold them
    until the launch is queued: a copy freed earlier could be handed to
    an output), their data pointers and their (B, T, H) strides, flat."""
    views, ptrs, strides = [], [], []
    for x in xs:
        if x.get_device() != device:
            raise ValueError(f"a tensor is on {x.device}, q on cuda:"
                             f"{device}")
        st = x.stride()
        if st[-1] != 1:
            raise ValueError("head_dim must be contiguous")
        if copies and not _aligned(x, st):
            x = for_copies(x)
            st = x.stride()
        views.append(x)
        ptrs.append(x.data_ptr())
        strides += st[:3]
    return views, ptrs, strides


def _count(design: str, *kernels: str) -> None:
    by_design = getattr(flash_attention, f"launches_{design}")
    for name in kernels:
        flash_attention.launches[name] += 1
        by_design[name] += 1


def _raise_on(err: int, what: str, design: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention {what} ({design}) launch "
                           f"failed: CUDA error {err}")


def _forward_cuda(q, k, v, mask: str, block_q: int, block_k: int):
    """The forward on CUDA tensors, of the design :func:`launch_design`
    routes it to.  Returns (out, lse)."""
    b, t, h, d = q.shape
    design = launch_design("fwd", q.dtype, q.shape, block_q, block_k)
    # views (copies among them) stay alive until the call below returns
    views, ptrs, strides = _views(q.get_device(),
                                  q.dtype == torch.bfloat16, q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    strides += (t * h * d, h * d, d)    # out: fresh, contiguous
    c_strides = array.array("q", strides)   # alive until the call returns
    ptrs += [out.data_ptr(), lse.data_ptr()]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    mask_code, scale = MASK_MODES.index(mask), 1.0 / math.sqrt(d)
    if design == "sm90":
        err = _entry(design, "forward")(d, *ptrs, c_strides.buffer_info()[0],
                                        b, h, t, mask_code, scale, stream)
    else:
        err = _entry(design, "forward")(_DTYPE_CODE[q.dtype], d, *ptrs,
                                        c_strides.buffer_info()[0], b, h, t,
                                        block_q, block_k, mask_code, scale,
                                        stream)
    _raise_on(err, "forward", design)
    _count(design, "fwd")
    return out, lse


def _backward_cuda(q, k, v, out, lse, dout, mask, block_q, block_k, g_lse,
                   schedule):
    """The backward on CUDA tensors in one C call: delta, then dq and
    dk/dv (shared or serial).  Returns (dq, dk, dv, delta)."""
    b, t, h, d = q.shape
    design = launch_design("dq", q.dtype, q.shape, block_q, block_k)
    if out.shape != q.shape or dout.shape != q.shape or (
            out.dtype != q.dtype or dout.dtype != q.dtype):
        raise ValueError("out/dout must match q in shape and dtype")
    if lse.shape != (b * h, t):
        raise ValueError(f"lse must be (B*H, T) = {(b * h, t)}, got "
                         f"{tuple(lse.shape)}")
    dev = q.get_device()
    if lse.get_device() != dev:
        raise ValueError(f"lse is on {lse.device}, q on {q.device}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32")
    g_strides = (0, 0)
    if g_lse is not None:
        # read through its two strides, whatever they are
        if g_lse.shape != (b * h, t):
            raise ValueError(f"g_lse must be (B*H, T) = {(b * h, t)}, got "
                             f"{tuple(g_lse.shape)}")
        if g_lse.get_device() != dev:
            raise ValueError(f"g_lse is on {g_lse.device}, q on {q.device}")
        if g_lse.dtype != torch.float32:
            g_lse = g_lse.float()
        g_strides = g_lse.stride()
    # views (copies among them) stay alive until the call below returns
    views, ptrs, strides = _views(dev, q.dtype == torch.bfloat16, q, k,
                                  v, out, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk, dv = torch.empty_like(dq), torch.empty_like(dq)
    delta = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    # dq, dk, dv: fresh, contiguous
    strides += (t * h * d, h * d, d) * 3 + tuple(g_strides)
    c_strides = array.array("q", strides)   # alive until the call returns
    ptrs += [lse.data_ptr(), None if g_lse is None else g_lse.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr()]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    mask_code, scale = MASK_MODES.index(mask), 1.0 / math.sqrt(d)
    if design == "sm90":
        err = _entry(design, "backward")(d, *ptrs,
                                         c_strides.buffer_info()[0], b, h, t,
                                         mask_code, scale,
                                         int(schedule == "shared"), stream)
    else:
        err = _entry(design, "backward")(_DTYPE_CODE[q.dtype], d, *ptrs,
                                         c_strides.buffer_info()[0], b, h, t,
                                         block_q, block_k, mask_code, scale,
                                         stream)
    _raise_on(err, f"backward ({schedule})", design)
    _count(design, "delta", "dq", "dkv")
    return dq, dk, dv, delta


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
    return _forward_cuda(q, k, v, mask, block_q, block_k)


def flash_backward(q, k, v, out, lse, dout, mask: str = "causal",
                   block_q: int = 128, block_k: int = 128, g_lse=None,
                   schedule: Optional[str] = None,
                   return_delta: bool = False):
    """(dq, dk, dv), and delta too with ``return_delta``: on CUDA tensors
    one C call that launches the ``delta`` kernel (shifted by the lse
    cotangent ``g_lse`` when given), then ``dq`` and ``dkv`` as
    :func:`backward_schedule` says (``schedule`` overrides the rule); on
    CPU tensors the plain versions."""
    _check(q, k, v)
    block_q, block_k = resolve_blocks(q.shape[1], block_q, block_k)
    schedule = backward_schedule(q.dtype, q.shape[1], schedule,
                                 q.shape[-1])
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    if _device(q) == "cpu":
        delta = flash_delta(out, dout, g_lse)
        dq = flash_dq_reference(q, k, v, dout, lse, delta, mask)
        dk, dv = flash_dkv_reference(q, k, v, dout, lse, delta, mask)
    else:
        dq, dk, dv, delta = _backward_cuda(q, k, v, out, lse, dout, mask,
                                           block_q, block_k, g_lse,
                                           schedule)
    return (dq, dk, dv, delta) if return_delta else (dq, dk, dv)


class FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse); backward is
    :func:`flash_backward` (delta, dq, dkv)."""

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


flash_attention.launches = dict.fromkeys(COUNTERS, 0)
flash_attention.launches_sm90 = dict.fromkeys(COUNTERS, 0)
flash_attention.launches_simt = dict.fromkeys(COUNTERS, 0)


class FlashAttentionWithLse(torch.autograd.Function):
    """B5: forward saves (q, k, v, out, lse) and returns both; backward
    gets (g_out, g_lse) and runs :func:`flash_backward` with delta =
    rowsum(dO * O) - g_lse (``_flash_backward`` :362-369 of the JAX
    package)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, block_q, block_k):
        out, lse = flash_forward(q, k, v, mask, block_q, block_k)
        if q.device.type == "cuda":
            flash_attention_with_lse.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (mask, block_q, block_k)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_backward(q, k, v, out, lse, g_out, *ctx.cfg,
                                    g_lse=g_lse)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             block_q: int = 128, block_k: int = 128,
                             mask_mode: Optional[str] = None):
    """(out (B, T, H, D), lse (B*H, T) f32), both differentiable: partial
    outputs over different K/V blocks merge exactly by their lse weights.
    ``mask_mode`` overrides ``causal``: ``none`` / ``causal`` /
    ``causal_exclusive``."""
    return FlashAttentionWithLse.apply(q, k, v, resolve_mask(causal,
                                                             mask_mode),
                                       block_q, block_k)


flash_attention_with_lse.launches = 0


def launch_counts() -> dict:
    """A copy of every flash launch counter: ``{"all": ..., "sm90": ...,
    "simt": ..., "with_lse": n}``."""
    return {"all": dict(flash_attention.launches),
            "sm90": dict(flash_attention.launches_sm90),
            "simt": dict(flash_attention.launches_simt),
            "with_lse": flash_attention_with_lse.launches}


def set_launch_counts(counts: Optional[dict] = None) -> None:
    """Set every flash launch counter from a :func:`launch_counts` copy,
    or to 0 when ``counts`` is None."""
    fa = flash_attention
    for name, d in (("all", fa.launches), ("sm90", fa.launches_sm90),
                    ("simt", fa.launches_simt)):
        for k in d:
            d[k] = counts[name][k] if counts else 0
    flash_attention_with_lse.launches = counts["with_lse"] if counts else 0
