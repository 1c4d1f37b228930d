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
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

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


def _shard_rows(t: torch.Tensor, shards: int) -> list:
    """``t`` (..., T, f) as the 2-D (rows, f) blocks of its ``shards``
    contiguous sequence shards (T split along the second-to-last axis,
    as ``parallel.sequence.LocalSeqGroup`` splits it)."""
    if shards == 1:
        return [t.reshape(-1, t.shape[-1])]
    if t.dim() < 2 or t.shape[-2] % shards:
        raise ValueError(f"sequence axis of {tuple(t.shape)} does not split "
                         f"into {shards} shards")
    t4 = t.reshape(-1, shards, t.shape[-2] // shards, t.shape[-1])
    return [t4[:, s].reshape(-1, t.shape[-1]) for s in range(shards)]


def _join_rows(parts: list, shape: torch.Size) -> torch.Tensor:
    """The inverse of :func:`_shard_rows`: per-shard (rows, f) blocks back
    to ``shape``."""
    if len(parts) == 1:
        return parts[0].reshape(shape)
    lead = parts[0].shape[0] // (shape[-2] // len(parts))
    return torch.cat([p.reshape(lead, -1, shape[-1]) for p in parts],
                     dim=1).reshape(shape)


def _sum_f32(parts: list, dtype: torch.dtype) -> torch.Tensor:
    """Per-shard gradients, each in ``dtype`` as a shard's rank returns
    it, summed in f32 in shard order (the seq all-reduce), in ``dtype``."""
    if len(parts) == 1:
        return parts[0].to(dtype)
    total = parts[0].to(dtype).float()
    for p in parts[1:]:
        total = total + p.to(dtype).float()
    return total.to(dtype)


# ---------------------------------------------------------------------------
# the spans of the scales
# ---------------------------------------------------------------------------
#
# The JAX package's GSPMD step quantizes global-view tensors.  Where a
# tensor group splits a dim a scale is taken over, the port takes that
# amax as the max over the group (``group.max``: over the shards held
# here, then over the ranks of a process group), so every shard
# quantizes with the scale the whole tensor would get and the codes are
# JAX's.  A column-parallel product (x whole, w split on its output
# columns) needs it in the backward: dy's rows and w's rows span the
# split output.  A row-parallel product (x split on its columns, w on its
# rows) needs it in the forward: x's rows and w's columns span the split
# contraction.  fp8's per-tensor weight amax of a split operand is the
# group's max too.  The partial products are summed by the caller
# (``g``) or, for a column-parallel dx, here and by ``f``'s backward.
# The ranks that hold other rows of the global batch (data x fsdp;
# ``parallel.distributed.BatchGroup``) do the same for dw's column
# scales, which span every row, and fp8's gradient amax.  A dense
# product (:func:`qdot`) spans only its own operands.

def _own(amaxes: list) -> list:
    return amaxes


def _over(group) -> Callable[[list], list]:
    """Each amax of the shards held here replaced by their max over
    ``group``."""
    def reduce(amaxes):
        m = group.max(amaxes)
        return [m] * len(amaxes)
    return reduce


def _each_over(group) -> Callable[[list], list]:
    """Each amax maxed over ``group`` on its own (one collective per
    distinct amax)."""
    def reduce(amaxes):
        done = {}
        for a in amaxes:
            if id(a) not in done:
                done[id(a)] = group.max([a])
        return [done[id(a)] for a in amaxes]
    return reduce


class _Span(NamedTuple):
    """The reductions of a product's amaxes: ``k`` of those taken over a
    split contraction, ``n`` over a split output, ``rows`` over the
    batch's rows.  Each maps the per-operand amaxes to the scales'."""
    k: Callable[[list], list] = _own
    n: Callable[[list], list] = _own
    rows: Callable[[list], list] = _own


_DENSE = _Span()


def _split_span(group, batch, split: str) -> _Span:
    """The span of a ``"col"``- or ``"row"``-parallel product over
    ``group``, its rows over ``batch`` (None: the rows held here are the
    batch)."""
    over = _over(group)
    return _Span(k=over if split == "row" else _own,
                 n=over if split == "col" else _own,
                 rows=_own if batch is None else _each_over(batch))


def _amaxes(ts, axis: Optional[int]) -> list:
    """Each tensor's f32 amax over ``axis`` (None: per tensor)."""
    return [t.detach().abs().amax().float() if axis is None
            else t.detach().abs().amax(dim=axis).float() for t in ts]


def _q8(x: torch.Tensor, amax: torch.Tensor, axis: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.quant.quantize_array`` with the amax given: int8 codes over
    ``axis`` and the f32 scale, ``axis`` kept at 1."""
    amax = amax.float()
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax)).unsqueeze(axis)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def _pairs(n: int, ws) -> range:
    """The products of ``n`` xs and ``ws``: x ``i % n`` times w ``i``
    (``n`` 1: one x times every w, a column-parallel product's shards;
    else pairwise)."""
    if n not in (1, len(ws)):
        raise ValueError(f"{n} xs do not pair with {len(ws)} ws")
    return range(len(ws))


class _QDotInt8(torch.autograd.Function):
    """``x @ w`` in int8 both ways for each pair of ``xws`` (its first
    ``n`` are the xs, the rest the ws; see :func:`_pairs`); f32 outs,
    gradients in the inputs' dtypes.  Saves the full-precision operands:
    the backward's contractions need scales over other axes than the
    forward's.  ``span``: the reductions of the amaxes (:class:`_Span`).
    ``shards`` > 1: the rows are that many sequence shards held in one
    process, and dw is computed as that many ranks would compute it
    (column scales over each shard's rows, the parts summed in f32); the
    forward and dx have per-row scales, the same either way."""

    @staticmethod
    def forward(ctx, span, shards, n, *xws):
        xs, ws = xws[:n], xws[n:]
        x2s = [x.reshape(-1, x.shape[-1]) for x in xs]
        qxs = [_q8(x, a, -1) for x, a in zip(x2s, span.k(_amaxes(x2s, -1)))]
        qws = [_q8(w, a, 0) for w, a in zip(ws, span.k(_amaxes(ws, 0)))]
        ctx.span, ctx.shards, ctx.n = span, shards, n
        ctx.save_for_backward(*xws)
        outs = []
        for i in _pairs(n, ws):
            (qx, sx), (qw, sw) = qxs[i % n], qws[i]
            outs.append((_dot_int8(qx, qw) * sx * sw).reshape(
                *xs[i % n].shape[:-1], ws[i].shape[1]))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dys):
        span, n = ctx.span, ctx.n
        saved = ctx.saved_tensors
        xs, ws = saved[:n], saved[n:]
        need = ctx.needs_input_grad[3:]
        dxs, dws = [None] * n, [None] * len(ws)
        if any(need[:n]):
            # dx = dy @ w.T, contracting over out: dy per row, w per
            # in-row (w's rows span out, so the row quantizer gives the
            # (in, 1) scales this contraction needs)
            dy2s = [d.reshape(-1, d.shape[-1]) for d in dys]
            a_dy, a_w = span.n(_amaxes(dy2s, -1)), span.n(_amaxes(ws, -1))
            for i in _pairs(n, ws):
                qdy, sdy = _q8(dy2s[i], a_dy[i], -1)
                qw, sw = _q8(ws[i], a_w[i], -1)
                part = _dot_int8(qdy, qw.t()) * sdy * sw.reshape(1, -1)
                j = i % n
                dxs[j] = part if dxs[j] is None else dxs[j] + part
            dxs = [d.reshape(x.shape).to(x.dtype) for d, x in zip(dxs, xs)]
        if any(need[n:]):
            # dw = x.T @ dy, contracting over rows: both per column
            def cols(t):
                rows = _shard_rows(t, ctx.shards)
                return [_q8(r, a, 0)
                        for r, a in zip(rows, span.rows(_amaxes(rows, 0)))]

            qxcs = [cols(x) for x in xs]
            for i in _pairs(n, ws):
                parts = [_dot_int8(qx.t(), qd) * sx.t() * sd
                         for (qx, sx), (qd, sd) in zip(qxcs[i % n],
                                                       cols(dys[i]))]
                dws[i] = _sum_f32(parts, ws[i].dtype)
        return (None, None, None, *dxs, *dws)




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
    """``x @ w`` with e4m3 operands for each pair of ``xws`` (as
    :class:`_QDotInt8`; the activations' scale from ``a_amax``, the
    delayed amax or the caller's current one, each weight's from its own
    amax) and an e5m2 gradient; f32 outs, gradients in the inputs'
    dtypes, none for ``a_amax``.  Saves the fp8 codes: the backward
    contracts against exactly what the forward multiplied, at a quarter
    of f32's bytes.  ``shards`` > 1: the gradient's e5m2 scale comes from
    each sequence shard's own amax, as that many ranks would take it,
    and dw is the f32 sum of the shards' parts."""

    @staticmethod
    def forward(ctx, span, shards, n, a_amax, *xws):
        xs, ws = xws[:n], xws[n:]
        qxs = [_cast_fp8(x.reshape(-1, x.shape[-1]), a_amax, E4M3_MAX,
                         torch.float8_e4m3fn) for x in xs]
        # a split weight's per-tensor amax spans all of it
        qws = [_cast_fp8(w, a, E4M3_MAX, torch.float8_e4m3fn)
               for w, a in zip(ws, span.k(span.n(_amaxes(ws, None))))]
        ctx.save_for_backward(*[t for q in qxs + qws for t in q])
        ctx.span, ctx.shards, ctx.n = span, shards, n
        ctx.x_shapes = [x.shape for x in xs]
        ctx.dtypes = [t.dtype for t in xws]
        return tuple(_dot_fp8(qxs[i % n][0], qws[i][0], qxs[i % n][1],
                              qws[i][1]).reshape(*xs[i % n].shape[:-1],
                                                 ws[i].shape[1])
                     for i in _pairs(n, ws))

    @staticmethod
    def backward(ctx, *dys):
        span, n, shards = ctx.span, ctx.n, ctx.shards
        saved = ctx.saved_tensors
        qxs = [saved[2 * i:2 * i + 2] for i in range(n)]
        qws = [saved[2 * (n + i):2 * (n + i) + 2] for i in range(len(dys))]
        need = ctx.needs_input_grad[4:]
        # each rank's rows of every dy; the e5m2 amax of each spans what
        # the layout splits of dy and the batch's rows
        blocks = [_shard_rows(dy, shards) for dy in dys]
        qdys = [[] for _ in dys]
        for s in range(shards):
            part = [b[s] for b in blocks]
            for i, (d, a) in enumerate(zip(part, span.rows(span.n(
                    _amaxes(part, None))))):
                qdys[i].append(_cast_fp8(d, a, E5M2_MAX, torch.float8_e5m2))
        dxs, dws = [None] * n, [None] * len(dys)
        if any(need[:n]):
            for i in _pairs(n, qws):
                qw, sw = qws[i]
                j = i % n
                d = _join_rows([_dot_fp8(qdy, qw.t(), sdy, sw)
                                for qdy, sdy in qdys[i]], ctx.x_shapes[j])
                dxs[j] = d if dxs[j] is None else dxs[j] + d
            dxs = [d.to(dt) for d, dt in zip(dxs, ctx.dtypes)]
        if any(need[n:]):
            for i in _pairs(n, qws):
                qx, sx = qxs[i % n]
                rows = _shard_rows(qx.view(torch.uint8).reshape(
                    *ctx.x_shapes[i % n][:-1], -1), shards)
                dws[i] = _sum_f32([_dot_fp8(r.view(qx.dtype).t(), qdy, sx,
                                            sdy)
                                   for r, (qdy, sdy) in zip(rows, qdys[i])],
                                  ctx.dtypes[n + i])
        return (None, None, None, None, *dxs, *dws)


# ---------------------------------------------------------------------------
# the public seam
# ---------------------------------------------------------------------------

def qdot(x: torch.Tensor, w: torch.Tensor, *, fmt: str,
         scales: Optional[torch.Tensor] = None,
         shards: int = 1) -> torch.Tensor:
    """Low-precision ``x @ w`` (w: (in, out)) in format ``fmt``,
    differentiable with a low-precision backward; returns f32 (the caller
    casts to its compute dtype and adds the bias).

    ``scales`` is the fp8 delayed activation amax (a device scalar from
    :func:`delayed_amax`); None takes the amax of ``x`` itself (current
    scaling: eval and decode, which carry no calibration state).  int8
    is always scaled dynamically.

    ``shards``: the number of sequence shards ``x`` (..., T, in) holds
    along its second-to-last axis (a ``LocalSeqGroup``'s size); the
    backward then quantizes each shard's rows as its own rank would (the
    JAX package's seq shards, the port's ``ProcessSeqGroup`` ranks)."""
    if fmt == "int8":
        return _QDotInt8.apply(_DENSE, shards, 1, x, w)[0]
    if fmt == "fp8":
        a = scales if scales is not None else tensor_amax(x)
        return _QDotFp8.apply(_DENSE, shards, 1, a, x, w)[0]
    if fmt == "bf16":
        raise ValueError("qdot is the quantized seam; bf16 is the plain "
                         "torch.matmul path (models.core.Linear)")
    raise ValueError(f"unknown qdot format {fmt!r}; have {FORMATS}")


def qdot_col(x: torch.Tensor, ws, *, fmt: str, group,
             scales: Optional[torch.Tensor] = None, batch=None):
    """A column-parallel ``x @ w`` for each shard's ``w`` of ``ws`` (the
    shards ``group`` holds here; ``x`` whole): a list of f32 outputs.
    The backward's dx is the sum of the shards' parts (``f``'s backward
    then sums the ranks').  ``scales`` as :func:`qdot`; ``batch`` the
    batch ranks' group (see above)."""
    span = _split_span(group, batch, "col")
    if fmt == "int8":
        return list(_QDotInt8.apply(span, 1, 1, x, *ws))
    if fmt == "fp8":
        a = scales if scales is not None else span.rows([tensor_amax(x)])[0]
        return list(_QDotFp8.apply(span, 1, 1, a, x, *ws))
    raise ValueError(f"unknown qdot format {fmt!r}; have {FORMATS[1:]}")


def qdot_row(xs, ws, *, fmt: str, group,
             scales: Optional[torch.Tensor] = None, batch=None):
    """A row-parallel ``x @ w`` per shard (``x`` and ``w`` split on the
    contraction): the list of f32 partial products, for ``g`` to sum.
    fp8's current scaling (``scales`` None) takes the group's amax of the
    ``xs``."""
    span, n = _split_span(group, batch, "row"), len(xs)
    if fmt == "int8":
        return list(_QDotInt8.apply(span, 1, n, *xs, *ws))
    if fmt == "fp8":
        a = (scales if scales is not None
             else span.rows(span.k(_amaxes(xs, None)))[0])
        return list(_QDotFp8.apply(span, 1, n, a, *xs, *ws))
    raise ValueError(f"unknown qdot format {fmt!r}; have {FORMATS[1:]}")


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
