"""Carry JAX trees into the port, and back out as numpy.

The JAX package's parameters are nested dicts and lists (the Transformer:
``embed/table``, ``pos/table``, ``blocks[i]/{ln1, qkv, attn_out, ln2,
ff_in, ff_gate, ff_out}/{w, b, scale, bias}``, ``ln_f``, ``head/w``; the
MLP: a list ``[{w, b}, {}, {w, b}]``); its optimizer and train states are
NamedTuples (``SGDState(count, momentum_buf)``, ``AdamState(count, mu,
nu)``, ``TrainState(step, params, opt_state, qstate)``).  The port uses
the same trees and field names.  This module imports no JAX: callers hand
it host arrays (``jax.device_get(tree)``).

* ``params_from_jax``  a Transformer tree in ``cfg.param_dtype`` (a
  ``scan_layers`` tree stays stacked when ``cfg.scan_layers``, and is
  unstacked into one dict per layer otherwise);
* ``tree_from_jax``    any tree — MLP params, optimizer state, a whole
  train state — with the NamedTuples mapped onto the port's classes of
  the same name and the step counters as host ints;
* ``tree_to_numpy``    the way back: numpy leaves under the same names
  (NamedTuples as dicts of their fields), ready for
  ``jax.tree_util``-level comparison or for rebuilding the JAX state.

A train state's fp8 ``qstate`` (``{"amax": {role: (16,) f32}}``) crosses
as any other subtree; the empty ``qstate=()`` of the other formats stays
an empty tuple.  Quantized params (``ops.quant``: int8 ``w``, f32
``w_scale``) keep their dtypes.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .models.transformer import TransformerConfig
from .ops.optim import AdamState, MasterState, SGDState
from .train.state import TrainState
from .utils.platform import DeviceLike, resolve_device

_PORT_TYPES = {cls.__name__: cls for cls in (SGDState, AdamState,
                                             MasterState, TrainState)}


def _leaf(arr, dtype: Optional[torch.dtype],
          device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    bf16 = a.dtype.kind == "V" or a.dtype.name == "bfloat16"
    if bf16:
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy;
        # widening to f32 is exact
        a = a.astype(np.float32)
    # torch.tensor copies: host arrays from jax.device_get are read-only
    t = torch.tensor(a)
    if dtype is None and bf16:
        dtype = torch.bfloat16
    return t.to(device=device, dtype=dtype)


def _convert(node: Any, dtype: Optional[torch.dtype],
             device: torch.device) -> Any:
    if isinstance(node, dict):
        return {k: _convert(v, dtype, device) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        fields = dict(zip(node._fields, node))
        cls = _PORT_TYPES.get(type(node).__name__)
        if cls is None:
            raise ValueError(f"no port counterpart of {type(node).__name__}")
        extra = [f for f in fields if f not in cls._fields
                 and fields[f] not in ((), None, {})]
        if extra:
            raise ValueError(f"{type(node).__name__} fields {extra} have no "
                             "port counterpart yet")
        return cls(**{f: _convert(fields[f], dtype, device)
                      for f in cls._fields})
    if isinstance(node, list):
        return [_convert(v, dtype, device) for v in node]
    if isinstance(node, tuple):         # the empty qstate of a non-fp8 state
        return tuple(_convert(v, dtype, device) for v in node)
    a = np.asarray(node)
    if a.ndim == 0 and a.dtype.kind in "iu":
        return int(a)                  # step / optimizer counters
    return _leaf(a, dtype, device)


def tree_from_jax(tree: Any, device: DeviceLike = None,
                  dtype: Optional[torch.dtype] = None) -> Any:
    """Host copy of any JAX tree -> the port's tree on ``device`` (default:
    cuda).  Float leaves keep their dtype unless ``dtype`` is given."""
    return _convert(tree, dtype, resolve_device(device))


def params_from_jax(tree: Any, cfg: TransformerConfig,
                    device: DeviceLike = None) -> dict:
    """Host copy of a JAX Transformer parameter tree -> the port's tree of
    tensors in ``cfg.param_dtype`` on ``device`` (default: cuda)."""
    tree = dict(tree)
    stacked = isinstance(tree["blocks"], dict)
    if cfg.scan_layers:
        if not stacked:
            raise ValueError("config has scan_layers=True but the tree's "
                             "blocks are a per-layer list")
        n = {np.shape(a)[0] for a in _leaves(tree["blocks"])}
    else:
        if stacked:
            tree["blocks"] = _unstack(tree["blocks"], cfg.n_layers)
        n = {len(tree["blocks"])}
    if n != {cfg.n_layers}:
        raise ValueError(f"tree has {sorted(n)} blocks, config says "
                         f"n_layers={cfg.n_layers}")
    return tree_from_jax(tree, device, cfg.param_dtype)


def _leaves(node: Any) -> list:
    if isinstance(node, dict):
        return [a for v in node.values() for a in _leaves(v)]
    return [node]


def _unstack(blocks: Any, n_layers: int) -> list:
    """A ``scan_layers`` tree stacks every block leaf on a leading
    (n_layers,) axis; split it back into one dict per layer."""
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]
    return [take(blocks, i) for i in range(n_layers)]


def tree_to_numpy(tree: Any) -> Any:
    """The port's tree -> numpy leaves under the same names: tensors to
    arrays (bf16 widened to f32), host ints to int32 scalars, NamedTuples
    to dicts of their fields."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: tree_to_numpy(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_numpy(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tree_to_numpy(v) for v in tree)
    if isinstance(tree, int):
        return np.asarray(tree, np.int32)
    return tree
