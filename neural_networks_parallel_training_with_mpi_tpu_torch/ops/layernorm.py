"""Fused row LayerNorm.

``fused_layernorm`` is the port of the JAX package's
``ops/pallas_kernels.py:fused_layernorm`` (kernel ``_ln_kernel``).  On
CUDA tensors it launches the hand-written kernel ``csrc/layernorm.cu``
(built for ``sm_90a`` at first use, see ``ops._build``) or raises; on CPU
tensors it computes the plain PyTorch version,
``fused_layernorm_reference``.  There is no fallback from the kernel to
the plain version.

Normalises the last dim with f32 statistics (the variance as the mean of
squared deviations), eps 1e-5 by default, and returns x's dtype.  Forward
only, like the JAX op (no VJP).  No model calls it, as in the JAX package,
whose models use the plain LayerNorm (``models/core.py``).

Each kernel launch adds one to ``fused_layernorm.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_layernorm_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor,
                              eps: float = 1e-5) -> torch.Tensor:
    """The plain version: ``_ln_kernel``'s arithmetic in f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5,
                    block_rows: int = 256) -> torch.Tensor:
    """LayerNorm over the last dim of ``x`` (any leading shape) with
    ``scale``/``bias`` of shape (d,).  ``block_rows`` is the TPU kernel's
    row tiling; it is validated and does not change the result."""
    d = x.shape[-1]
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"scale/bias must be ({d},), got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if x.device.type == "cpu":
        return fused_layernorm_reference(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm runs on cuda or cpu, not "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {x.dtype} not supported (float32, "
                         "bfloat16)")
    for t_ in (scale, bias):
        if t_.device != x.device:
            raise ValueError(f"scale/bias on {t_.device}, x on {x.device}")
    lib, _ = _build.load("layernorm")
    fn = lib.layernorm_launch
    if fn.argtypes is None:
        lib.layernorm_max_dim.restype = ctypes.c_int
        lib.layernorm_max_dim.argtypes = []
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
    if d > lib.layernorm_max_dim():
        raise ValueError(f"the CUDA kernel takes d <= "
                         f"{lib.layernorm_max_dim()}, got {d}")
    x2 = x.reshape(-1, d).contiguous()
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    err = fn(_DTYPE_CODE[x.dtype], x2.data_ptr(), sc.data_ptr(),
             bi.data_ptr(), y.data_ptr(), x2.shape[0], d, eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_layernorm kernel launch failed: CUDA "
                           f"error {err}")
    fused_layernorm.launches += 1
    return y.reshape(x.shape)


fused_layernorm.launches = 0
