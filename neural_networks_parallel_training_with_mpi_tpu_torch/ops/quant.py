"""Weights-only int8 post-training quantization for inference: the port
of the JAX package's ``ops/quant.py``.

Decode at small batch is bound by streaming the weight matrices once per
token, so storing ``W`` as int8 plus one f32 scale per output channel
halves the bytes per token against bf16.  Per-OUTPUT-channel symmetric
scales commute through the contraction::

    (x @ (W_q * s))[..., o] == (x @ W_q)[..., o] * s[o]

so ``models.core.Linear.apply`` multiplies the scale into the product's
output (``y * w_scale``), or, with ``matmul_dtype='int8'``, runs a true
int8 x int8 product against the codes (``ops.qmm.int8_serve_dot``).

:func:`quantize_params` walks a trained (or restored) parameter tree;
every path built on the shared modules (``models.generate``'s KV-cache
loop, ``serve.paged_kv``'s server) consumes the quantized form as it is.
The tree keeps the JAX package's leaf names (``w`` int8, ``w_scale``
f32), so a quantized tree is the same tree in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from ..utils.tree import leaves

# keys of a quantizable dense kernel: Linear stores {"w": (in, out)[, "b"]};
# LayerNorm's {"scale", "bias"} and Embedding's {"table"} do not match
_KERNEL_KEY = "w"
_SCALE_KEY = "w_scale"

# subtrees shaped like Linear params that their module consumes raw (the
# MoE router gate of the JAX package, whose scale would be dropped);
# O(d * E) bytes, nothing to win
_NEVER_QUANTIZE = ("gate",)


def quantize_array(w: torch.Tensor, axis: int = -2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``w`` with one scale per slice
    along every axis but ``axis``, the contraction axis the scale must not
    span: -2 is Linear's ``(in, out)`` layout and, unchanged, the stacked
    ``(n_layers, in, out)`` layout (per-layer scales).

    Returns ``(q, scale)``: ``q`` int8 in [-127, 127] (-128 unused, so
    negation is exact) and ``scale`` f32 shaped like ``w`` without
    ``axis``; an all-zero slice gets scale 1.  The arithmetic is the JAX
    package's in f32 (``torch.round`` rounds half to even, as
    ``jnp.round`` does); a bf16 ``w`` is widened in the ops themselves,
    which is exact, so no f32 copy of ``w`` is made."""
    amax = w.abs().amax(dim=axis).float()
    # a tensor divisor: torch divides by a Python number as a multiply by
    # its reciprocal on CUDA, which is not always JAX's quotient
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_array(q: torch.Tensor, scale: torch.Tensor,
                     axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`quantize_array` (f32)."""
    return q.float() * scale.unsqueeze(axis)


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _is_linear_params(node: Dict) -> bool:
    # ndim 2: a Linear (in, out); ndim 3: stacked blocks (n_layers, in,
    # out).  Quantized dicts are skipped, so the walk is idempotent.
    w = node.get(_KERNEL_KEY)
    return _is_float(w) and w.ndim in (2, 3) and _SCALE_KEY not in node


def _is_expert_params(node: Dict) -> bool:
    # the JAX package's MoE expert kernels {"w_in": (E, d, f), "w_out":
    # (E, f, d)[, "w_gate"]}: per-(expert, out-column) scales.  The port
    # builds no MoE model, but the walk treats the same trees the same way
    w_in, w_out = node.get("w_in"), node.get("w_out")
    return (_is_float(w_in) and isinstance(w_out, torch.Tensor)
            and w_in.ndim == 3 and w_out.ndim == 3
            and "w_in_scale" not in node)


def quantize_params(params: Any, skip: Sequence[str] = ()) -> Any:
    """``params`` with every dense kernel quantized: each dict shaped like
    Linear params (``{"w": 2-d or 3-d float, ...}``) gains ``w_scale``
    and an int8 ``w``; biases, LayerNorms and embedding tables stay as
    they are.  ``skip`` names path components kept in full precision,
    e.g. ``("head",)``; the MoE router ``gate`` is always skipped.  The
    input tree is not modified."""
    skip = tuple(skip) + _NEVER_QUANTIZE

    def walk(node, path):
        if isinstance(node, dict):
            if path and path[-1] in skip:
                return node
            if _is_linear_params(node):
                q, s = quantize_array(node[_KERNEL_KEY].detach())
                return {**node, _KERNEL_KEY: q, _SCALE_KEY: s}
            if _is_expert_params(node):
                out = dict(node)
                for key in ("w_in", "w_out", "w_gate"):
                    if key in node:      # w_gate: SwiGLU experts only
                        out[key], out[key + "_scale"] = quantize_array(
                            node[key].detach())
                return out
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v, path) for v in node)
        return node

    return walk(params, ())


def quantized_bytes(params: Any) -> int:
    """Parameter bytes as stored (int8 kernels 1 byte per element): what
    a decode step streams."""
    return sum(t.numel() * t.element_size() for t in leaves(params))
