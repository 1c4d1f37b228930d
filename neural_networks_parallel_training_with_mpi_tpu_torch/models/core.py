"""Layers over plain dicts of tensors: the port of the JAX package's
``models/core.py`` for the layers the Transformer LM and the MLP use.

Each layer is a small frozen dataclass with ``init(generator, device)``
and ``apply(params, x)``.  Parameters live in plain dicts of tensors
with the JAX leaf names (``w``/``b``, ``scale``/``bias``, ``table``), so
a JAX parameter tree carries across leaf for leaf (``interop``) and the
serving path reads the same dicts the dense forward reads.

Initialisation follows the JAX package (torch's ``nn.Linear`` reset:
U(+-1/sqrt(fan_in)) for weight and bias; N(0, 1) embedding tables), drawn
from an explicit ``torch.Generator``.  The two frameworks' random streams
differ, so parity tests carry weights across instead of re-drawing them.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# what ``make_remat`` may SAVE between forward and backward: the aten ops
# whose outputs are kept (None: nothing)
_REMAT_POLICIES = {
    "full": None,
    "dots": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def make_remat(policy: str = "full") -> Callable[[Callable], Callable]:
    """``fn -> fn`` run under ``torch.utils.checkpoint.checkpoint``
    (non-reentrant): the block's activations are recomputed in the
    backward, as ``jax.checkpoint`` does.  The policy names are JAX's:

    * ``full``: nothing is saved, the whole block runs again;
    * ``dots``: the outputs of ``aten.mm``, ``addmm``, ``bmm`` and
      ``baddbmm`` are saved (JAX's ``dots_saveable``);
    * ``dots_no_batch``: those of ``mm`` and ``addmm`` only (JAX's
      ``dots_with_no_batch_dims_saveable``: the projections, not the
      batched attention products).

    The two saving policies use selective checkpointing
    (``create_selective_checkpoint_contexts``); a torch without it
    raises.  The flash kernels are ``autograd.Function``s, not aten ops:
    no policy saves their output, so the forward kernel runs again in the
    backward under every policy (JAX's policies do not save a
    ``pallas_call`` either).  Nothing in a block draws random numbers, so
    the RNG state is neither saved nor restored, which keeps the step
    capturable as a CUDA graph."""
    try:
        ops = _REMAT_POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown remat policy {policy!r}; have "
                         f"{sorted(_REMAT_POLICIES)}") from None
    from torch.utils import checkpoint as ckpt

    kw: Dict[str, Any] = dict(use_reentrant=False, preserve_rng_state=False)
    if ops is not None:
        if not hasattr(ckpt, "create_selective_checkpoint_contexts"):
            raise RuntimeError(
                f"remat policy {policy!r} needs selective checkpointing "
                f"(torch.utils.checkpoint.create_selective_checkpoint_"
                f"contexts), which torch {torch.__version__} lacks")
        saved = frozenset(getattr(torch.ops.aten, name) for name in ops)

        def save_dots(ctx, op, *args, **kwargs):
            return (ckpt.CheckpointPolicy.MUST_SAVE
                    if op.overloadpacket in saved
                    else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, save_dots)

    def remat(fn: Callable) -> Callable:
        return lambda *args: ckpt.checkpoint(fn, *args, **kw)

    return remat


def _uniform(shape, bound: float, dtype: torch.dtype,
             generator: torch.Generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    t.uniform_(-bound, bound, generator=generator)
    return t.to(device=device, dtype=dtype)


def _normal(shape, dtype: torch.dtype, generator: torch.Generator,
            device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    t.normal_(generator=generator)
    return t.to(device=device, dtype=dtype)


# jax.nn.gelu defaults to the tanh approximation; torch's F.gelu defaults
# to the exact erf form, so the port names the approximation explicitly
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "identity": lambda x: x,
}


@dataclass(frozen=True)
class Linear:
    """``y = x @ w + b`` with ``w`` stored ``(in, out)`` as in the JAX
    package.  ``x`` and ``w`` are cast to ``compute_dtype`` (default: the
    input's dtype) and the bias is added in that dtype.

    ``matmul_dtype`` is the quantized-matmul seam (``ops.qmm``): 'bf16'
    is the plain product; 'int8' and 'fp8' run it in the quantized
    domain (training: ``qdot``; serving: an int8 x int8 product against
    ``ops.quant`` PTQ weights).  ``q_role`` names this layer's fp8 amax
    history (delayed scaling).  ``seq_shards``: the sequence shards an
    input holds along its second-to-last axis (a ``LocalSeqGroup``'s
    size), which the quantized backward treats as that many ranks
    (``ops.qmm.qdot``)."""

    in_features: int
    out_features: int
    use_bias: bool = True
    param_dtype: torch.dtype = torch.float32
    compute_dtype: Optional[torch.dtype] = None
    matmul_dtype: str = "bf16"
    q_role: str = ""
    seq_shards: int = 1

    def init(self, generator: torch.Generator, device) -> Params:
        bound = 1.0 / math.sqrt(self.in_features)
        params = {"w": _uniform((self.in_features, self.out_features),
                                bound, self.param_dtype, generator, device)}
        if self.use_bias:
            params["b"] = _uniform((self.out_features,), bound,
                                   self.param_dtype, generator, device)
        return params

    def apply(self, params: Params, x: torch.Tensor, qscales=None,
              qobserved=None) -> torch.Tensor:
        """``qscales``: role -> delayed fp8 amax (read); ``qobserved``:
        role -> this step's observed amax, max-merged over the layers
        sharing a role (written).  Both only matter under fp8."""
        cdt = self.compute_dtype or x.dtype
        fmt = self.matmul_dtype
        if fmt == "int8" and "w_scale" in params:
            # serving: PTQ weights and a true int8 product
            from ..ops import qmm

            y = qmm.int8_serve_dot(x.to(cdt), params["w"],
                                   params["w_scale"]).to(cdt)
        elif fmt == "fp8" and "w_scale" in params:
            # refused here, not only in the CLI: falling through to the
            # dequant product would mislabel every other caller's run
            raise ValueError(
                "matmul_dtype='fp8' cannot run over int8 PTQ kernels "
                "(params carry w_scale); use matmul_dtype='int8' for "
                "true int8 compute or 'bf16' for the dequant path")
        elif fmt in ("int8", "fp8"):
            from ..ops import qmm

            a_amax = None
            if fmt == "fp8" and qscales is not None and self.q_role:
                a_amax = qscales.get(self.q_role)
            if fmt == "fp8" and qobserved is not None and self.q_role:
                prev = qobserved.get(self.q_role)
                obs = qmm.tensor_amax(x)
                qobserved[self.q_role] = (obs if prev is None
                                          else torch.maximum(prev, obs))
            y = qmm.qdot(x.to(cdt), params["w"], fmt=fmt,
                         scales=a_amax, shards=self.seq_shards).to(cdt)
        else:
            y = torch.matmul(x.to(cdt), params["w"].to(cdt))
            if "w_scale" in params:
                # weights-only int8 (ops.quant.quantize_params): the
                # per-output-channel scale commutes through the product
                y = y * params["w_scale"].to(cdt)
        if self.use_bias:
            y = y + params["b"].to(cdt)
        return y


@dataclass(frozen=True)
class LayerNorm:
    """Row LayerNorm: statistics in f32, eps 1e-5, output in the input's
    dtype."""

    dim: int
    eps: float = 1e-5
    param_dtype: torch.dtype = torch.float32

    def init(self, generator: torch.Generator, device) -> Params:
        return {"scale": torch.ones(self.dim, dtype=self.param_dtype,
                                    device=device),
                "bias": torch.zeros(self.dim, dtype=self.param_dtype,
                                    device=device)}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * params["scale"].float() + params["bias"].float()
        return y.to(x.dtype)


@dataclass(frozen=True)
class Activation:
    """Parameter-free activation (the reference's ``nn.ReLU()``)."""

    name: str = "relu"

    def init(self, generator: torch.Generator, device) -> Params:
        return {}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return ACTIVATIONS[self.name](x)


@dataclass(frozen=True)
class Sequential:
    """Chain of layers (the reference's ``nn.Sequential``); parameters are
    a list aligned with the layers, as in the JAX package."""

    layers: Tuple[Any, ...]

    def init(self, generator: torch.Generator, device) -> List[Params]:
        return [layer.init(generator, device) for layer in self.layers]

    def apply(self, params: List[Params], x: torch.Tensor) -> torch.Tensor:
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x


@dataclass(frozen=True)
class Embedding:
    vocab_size: int
    dim: int
    param_dtype: torch.dtype = torch.float32

    def init(self, generator: torch.Generator, device) -> Params:
        return {"table": _normal((self.vocab_size, self.dim),
                                 self.param_dtype, generator, device)}

    def apply(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return params["table"][ids]
