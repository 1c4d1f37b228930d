"""Quantized-matmul seam: low-precision compute for training and serving,
the port of the JAX package's ``ops/qmm.py``.

* **Training** (``--matmul_dtype {bf16,int8,fp8}`` ->
  ``models.core.Linear``): :func:`qdot` runs the dense contraction in the
  quantized domain, with an ``autograd.Function`` whose backward is
  quantized too.

  - ``int8``: symmetric dynamic quantization, activations per row over
    the contraction, weights per output channel, int8 x int8 -> int32,
    both scales applied to the output.  The backward re-derives the
    scales for the transposed contractions (a per-channel scale must not
    span the contraction axis).  Stateless.
  - ``fp8``: e4m3 activations and weights, e5m2 gradients.  Weight and
    gradient scales come from the tensor's own amax; ACTIVATION scales
    from delayed scaling: a per-role amax history in
    ``TrainState.qstate`` (:func:`init_qstate`), read at the top of the
    step and rolled at its end from the step's observed amax
    (:func:`update_qstate`).  A non-finite observation never enters the
    history.

* **Serving** (:func:`int8_serve_dot`, taken by ``Linear.apply`` when the
  params carry ``ops.quant``'s ``w_scale`` and the model has
  ``matmul_dtype='int8'``): int8 activations (dynamic per-token scales)
  against the int8 PTQ weights.

The products.  On a CUDA tensor int8 x int8 -> int32 is
``torch._int_mm`` and e4m3/e5m2 -> f32 is ``torch._scaled_mm`` (both
cuBLASLt on the tensor cores; the JAX package leaves them to XLA's
``dot_general``, outside any Pallas kernel, so no hand-written kernel
replaces them).  :func:`library_gemm` lays the operands out as the two
take them (the first row-major, the second column-major: "TN") and pads
rows, and the contraction and output widths, with zeros to the multiples
they need; a zero pad is exact and is sliced off.  A CUDA device without
fp8 (compute capability below 8.9) raises: there is no fallback on the
card.  On a CPU tensor the products are the plain versions
(:func:`reference_dot`): the exact integer product (summed in f64, exact
for any width the models use) and the f32 product of the fp8 codes, which
is also the yardstick on the card.  ``_scaled_mm`` applies dequantisation
scales, so it is given ``1/sx`` and ``1/sw``; the plain version divides
by ``sx * sw`` after the product as the JAX package does.

Numerics are the JAX package's: the quantizers work on the f32 value of
their input (a bf16 input is widened inside the ops, which is exact, so
the codes and scales are the same bits without an f32 copy), int8 scales
apply in JAX's order, and the gradients come back in the caller's dtypes.

Scale granularity: int8 activations per row; fp8 activations per role
(qkv, attn_out, ff_in, ff_gate, ff_out, head), one history shared across
a stack's layers (the max over layers).  Attention's score and value
products stay in the compute dtype (the flash kernels).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from .quant import quantize_array

FORMATS = ("bf16", "int8", "fp8")

# finite maxima of the fp8 formats: e4m3fn has no inf, max 448; e5m2
# keeps inf/nan, max finite 57344 (gradients get the range)
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
# amax -> scale floor: below it a tensor counts as all zero (scale 1)
_AMAX_TINY = 1e-12

# activation-amax history length of fp8 delayed scaling (the scale comes
# from the max over the last HISTORY steps' amax)
HISTORY = 16


def tensor_amax(x: torch.Tensor) -> torch.Tensor:
    """f32 0-d ``max(|x|)``, detached: the calibration observation, never
    part of the differentiated graph."""
    return x.detach().abs().amax().float()


# ---------------------------------------------------------------------------
# the products
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fp8_capable(index: int) -> bool:
    return torch.cuda.get_device_capability(index) >= (8, 9)


def fp8_dot_supported(device: torch.device) -> bool:
    """Can ``device`` multiply e4m3/e5m2 codes on its tensor cores (a CUDA
    device of compute capability 8.9 or above)?  False on the CPU, where
    the contraction is the f32 product of the same codes.  Cached per
    device; call it before a CUDA graph is captured, not inside."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    return _fp8_capable(device.index if device.index is not None
                        else torch.cuda.current_device())


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` (row-major) zero-padded to (rows, cols); fp8 through its
    bytes (0x00 is +0 in both formats)."""
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    raw = t.view(torch.uint8) if t.element_size() == 1 else t
    out = raw.new_zeros((rows, cols))
    out[:r, :c] = raw
    return out.view(t.dtype)


def library_gemm(a: torch.Tensor, b: torch.Tensor,
                 scale_a: Optional[torch.Tensor] = None,
                 scale_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a @ b`` of 2-d CUDA tensors on the tensor cores: int8 x int8 ->
    int32 (``torch._int_mm``), or fp8 x fp8 -> f32 times ``scale_a *
    scale_b`` (``torch._scaled_mm``, 1-element f32 scales).  Rows are
    padded to a multiple of 16 (at least 32: ``_int_mm`` takes more than
    16), the contraction and the output width to a multiple of 8 (int8)
    or 16 (fp8); ``a`` goes row-major, ``b`` column-major.  Each call
    adds one to ``library_gemm.launches[fmt]``."""
    m, k = a.shape
    n = b.shape[1]
    fmt = "int8" if a.dtype == torch.int8 else "fp8"
    if fmt == "fp8" and not fp8_dot_supported(a.device):
        raise RuntimeError(
            f"fp8 products need compute capability 8.9 or above; "
            f"{torch.cuda.get_device_name(a.device)} has "
            f"{torch.cuda.get_device_capability(a.device)} (operands "
            f"{tuple(a.shape)} x {tuple(b.shape)})")
    mult = 8 if fmt == "int8" else 16
    rows = max(_round_up(m, 16), 32 if fmt == "int8" else 16)
    kp, np_ = _round_up(k, mult), _round_up(n, mult)
    a = _pad2(a.contiguous(), rows, kp)
    bt = _pad2(b.t().contiguous(), np_, kp)     # b column-major
    if fmt == "int8":
        y = torch._int_mm(a, bt.t())
    else:
        y = torch._scaled_mm(a, bt.t(), scale_a=scale_a, scale_b=scale_b,
                             out_dtype=torch.float32)
        if isinstance(y, tuple):        # torch < 2.5 also returns the amax
            y = y[0]
    library_gemm.launches[fmt] += 1
    return y[:m, :n]


library_gemm.launches = {"int8": 0, "fp8": 0}


def reference_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain product of quantized codes: int8 -> the exact int32 sum
    (in f64: exact while |sum| < 2^53), fp8 -> f32 of the f32 codes."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def _dot_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) x int8 (k, n) -> int32 (m, n)."""
    if a.device.type == "cuda":
        return library_gemm(a, b)
    return reference_dot(a, b)


def _dot_fp8(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
             sb: torch.Tensor) -> torch.Tensor:
    """fp8 codes (m, k) x (k, n) with quantization scales ``sa``, ``sb``
    (codes = value * scale) -> the f32 product of the values."""
    if a.device.type == "cuda":
        return library_gemm(a, b, torch.reciprocal(sa),
                            torch.reciprocal(sb))
    return reference_dot(a, b) / (sa * sb)


# ---------------------------------------------------------------------------
# int8: dynamic symmetric quantization, both directions
# ---------------------------------------------------------------------------

def _q8_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize over the LAST (contraction) dim: int8 codes and an f32
    scale shaped like ``x`` with the last dim kept at 1."""
    q, s = quantize_array(x, axis=-1)
    return q, s[..., None]


def _q8_colwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize an (in, out) matrix over its FIRST (contraction) dim:
    per-output-channel scales, shape (1, out)."""
    q, s = quantize_array(w, axis=0)
    return q, s[None, :]


def int8_serve_dot(x: torch.Tensor, w_q: torch.Tensor,
                   w_scale: torch.Tensor) -> torch.Tensor:
    """The decode path's int8 x int8 product against ``ops.quant`` PTQ
    weights: ``x`` (..., in) float, ``w_q`` (in, out) int8 with
    per-output-channel ``w_scale`` (out,).  Activations quantize per
    token; both scales apply to the int32 result.  Returns f32."""
    qx, sx = _q8_rowwise(x)
    y = _dot_int8(qx.reshape(-1, x.shape[-1]), w_q)
    return y.reshape(*x.shape[:-1], -1) * sx * w_scale.float()


class _QDotInt8(torch.autograd.Function):
    """``x @ w`` in int8 both ways; f32 out, gradients in the inputs'
    dtypes.  Saves the full-precision operands: the backward's
    contractions need scales over other axes than the forward's."""

    @staticmethod
    def forward(ctx, x, w):
        qx, sx = _q8_rowwise(x.reshape(-1, x.shape[-1]))
        qw, sw = _q8_colwise(w)
        ctx.save_for_backward(x, w)
        y = _dot_int8(qx, qw) * sx * sw
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])           # (N, in)
        dy2 = dy.reshape(-1, dy.shape[-1])        # (N, out)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx = dy @ w.T, contracting over out: dy per row, w per
            # in-row (w's rows span out, so the row quantizer gives the
            # (in, 1) scales this contraction needs)
            qdy, sdy = _q8_rowwise(dy2)
            qw, sw = _q8_rowwise(w)
            dx = (_dot_int8(qdy, qw.t()) * sdy * sw.reshape(1, -1)
                  ).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # dw = x.T @ dy, contracting over rows: both per column
            qx, sx = _q8_colwise(x2)              # scales (1, in)
            qdy, sdy = _q8_colwise(dy2)           # scales (1, out)
            dw = (_dot_int8(qx.t(), qdy) * sx.t() * sdy).to(w.dtype)
        return dx, dw


# ---------------------------------------------------------------------------
# fp8: e4m3 forward, e5m2 backward, delayed activation scaling
# ---------------------------------------------------------------------------

def _cast_fp8(x: torch.Tensor, amax: torch.Tensor, fmt_max: float,
              dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale ``x`` so that ``amax`` maps to the format's max, saturate,
    cast.  Returns (codes, scale) with ``codes / scale`` ~ ``x``; the
    scale is a 1-element f32 tensor.  ``amax <= 0`` is UNCALIBRATED (a
    fresh history): scale 1, coarse but never saturating."""
    amax = amax.float().reshape(1)
    # a tensor numerator: ``number / tensor`` is the reciprocal times the
    # number in torch, not always JAX's quotient (the fill is a kernel,
    # so a captured CUDA graph replays it)
    scale = torch.where(amax > _AMAX_TINY,
                        torch.full_like(amax, fmt_max)
                        / torch.clamp(amax, min=_AMAX_TINY),
                        torch.ones_like(amax))
    # scale has a dimension, so a bf16 x multiplies in f32
    q = torch.clamp(x * scale, -fmt_max, fmt_max).to(dtype)
    return q, scale


class _QDotFp8(torch.autograd.Function):
    """``x @ w`` with e4m3 operands (the activation's scale from the
    delayed ``a_amax``, the weight's from its own amax) and an e5m2
    gradient; f32 out, gradients in the inputs' dtypes, none for
    ``a_amax``.  Saves the fp8 codes: the backward contracts against
    exactly what the forward multiplied, at a quarter of f32's bytes."""

    @staticmethod
    def forward(ctx, x, w, a_amax):
        qx, sx = _cast_fp8(x.reshape(-1, x.shape[-1]), a_amax, E4M3_MAX,
                           torch.float8_e4m3fn)
        qw, sw = _cast_fp8(w, tensor_amax(w), E4M3_MAX, torch.float8_e4m3fn)
        ctx.save_for_backward(qx, sx, qw, sw)
        ctx.dtypes = (x.dtype, w.dtype)
        ctx.x_shape = x.shape
        y = _dot_fp8(qx, qw, sx, sw)
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, dy):
        qx, sx, qw, sw = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        qdy, sdy = _cast_fp8(dy2, tensor_amax(dy2), E5M2_MAX,
                             torch.float8_e5m2)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dot_fp8(qdy, qw.t(), sdy, sw).reshape(ctx.x_shape).to(
                ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = _dot_fp8(qx.t(), qdy, sx, sdy).to(ctx.dtypes[1])
        return dx, dw, None


# ---------------------------------------------------------------------------
# the public seam
# ---------------------------------------------------------------------------

def qdot(x: torch.Tensor, w: torch.Tensor, *, fmt: str,
         scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Low-precision ``x @ w`` (w: (in, out)) in format ``fmt``,
    differentiable with a low-precision backward; returns f32 (the caller
    casts to its compute dtype and adds the bias).

    ``scales`` is the fp8 delayed activation amax (a device scalar from
    :func:`delayed_amax`); None takes the amax of ``x`` itself (current
    scaling: eval and decode, which carry no calibration state).  int8
    is always scaled dynamically."""
    if fmt == "int8":
        return _QDotInt8.apply(x, w)
    if fmt == "fp8":
        a = scales if scales is not None else tensor_amax(x)
        return _QDotFp8.apply(x, w, a)
    if fmt == "bf16":
        raise ValueError("qdot is the quantized seam; bf16 is the plain "
                         "torch.matmul path (models.core.Linear)")
    raise ValueError(f"unknown qdot format {fmt!r}; have {FORMATS}")


# ---------------------------------------------------------------------------
# fp8 delayed-scaling calibration state
# ---------------------------------------------------------------------------

def model_format(model) -> str:
    """The model's matmul format ('bf16' where the seam is off or the
    model does not thread it)."""
    cfg = getattr(model, "cfg", None)
    return getattr(cfg, "matmul_dtype", "bf16") or "bf16"


def quant_roles(model) -> Tuple[str, ...]:
    """The model's fp8 tensor roles (one amax history each)."""
    hook = getattr(model, "quant_roles", None)
    return tuple(hook()) if hook is not None else ()


def init_qstate(model, history: int = HISTORY) -> Any:
    """Fresh calibration state of an fp8 model, on its device: per-role
    amax histories of zeros (UNCALIBRATED: the fp8 cast takes scale 1
    until the first observation lands; from step 2 the delayed max is
    real).  ``()`` for other models, so their state has no leaves and
    their snapshots hold what they held before the seam."""
    if model_format(model) != "fp8":
        return ()
    device = getattr(model, "device", None)
    return {"amax": {r: torch.zeros(history, dtype=torch.float32,
                                    device=device)
                     for r in quant_roles(model)}}


def delayed_amax(qstate: Any) -> Dict[str, torch.Tensor]:
    """role -> delayed amax (the max over the history): the scale each
    Linear reads at the top of the step."""
    return {r: h.amax() for r, h in qstate["amax"].items()}


def update_qstate(qstate: Any, observed: Dict[str, torch.Tensor]) -> Any:
    """Each role's history rolled one slot, with the step's observed amax
    in front.  A non-finite observation (an overflowed forward) is
    dropped: the slot re-records the current delayed amax, so one bad
    step cannot poison the scales.  Returns new tensors."""
    new = {}
    for r, h in qstate["amax"].items():
        obs = observed[r].float().reshape(1)
        obs = torch.where(torch.isfinite(obs), obs, h.amax())
        new[r] = torch.cat([obs, h[:-1]])
    return {"amax": new}
