"""Carry a JAX parameter tree into the port.

The JAX package's Transformer parameters are nested dicts and lists with
leaf names ``embed/table``, ``pos/table``, ``blocks[i]/{ln1, qkv,
attn_out, ln2, ff_in, ff_gate, ff_out}/{w, b, scale, bias}``, ``ln_f``
and ``head/w``; the port uses the same tree.  This module imports no
JAX: callers hand it host arrays (``jax.device_get(params)``), and it
returns the same tree as tensors.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .models.transformer import TransformerConfig
from .utils.platform import DeviceLike, resolve_device


def _leaf(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy;
        # widening to f32 is exact
        a = a.astype(np.float32)
    # torch.tensor copies: host arrays from jax.device_get are read-only
    return torch.tensor(a).to(device=device, dtype=dtype)


def _convert(node: Any, dtype: torch.dtype, device: torch.device) -> Any:
    if isinstance(node, dict):
        return {k: _convert(v, dtype, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, dtype, device) for v in node]
    return _leaf(node, dtype, device)


def _unstack(blocks: Any, n_layers: int) -> list:
    """A ``scan_layers`` tree stacks every block leaf on a leading
    (n_layers,) axis; split it back into one dict per layer."""
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]
    return [take(blocks, i) for i in range(n_layers)]


def params_from_jax(tree: Any, cfg: TransformerConfig,
                    device: DeviceLike = None) -> dict:
    """Host copy of a JAX Transformer parameter tree -> the port's tree
    of tensors in ``cfg.param_dtype`` on ``device`` (default: cuda)."""
    dev = resolve_device(device)
    tree = dict(tree)
    if isinstance(tree["blocks"], dict):
        tree["blocks"] = _unstack(tree["blocks"], cfg.n_layers)
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config "
                         f"says n_layers={cfg.n_layers}")
    return _convert(tree, cfg.param_dtype, dev)
