"""Model construction from config, the port of the JAX package's
``models/registry.py`` for ``mlp`` and ``transformer``."""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..utils.platform import DeviceLike
from .mlp import MLP
from .transformer import Transformer, TransformerConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                seq_group=None, expert_group=None):
    """``seq_group``: the sequence group of the sequence-sharded attentions,
    ``expert_group`` the expert group of an MoE model's expert-parallel
    layouts (transformer only)."""
    pdt = DTYPES[cfg.dtype]
    cdt = DTYPES[cfg.compute_dtype]
    if cfg.arch == "mlp":
        return MLP(in_features=cfg.in_features, hidden=tuple(cfg.hidden),
                   out_features=cfg.out_features, activation=cfg.activation,
                   param_dtype=pdt, compute_dtype=cdt, device=device)
    if cfg.arch == "convnet":
        raise NotImplementedError("arch='convnet' is not ported yet")
    if cfg.arch == "transformer":
        tc = TransformerConfig(
            vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len,
            n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads or None,
            pos_encoding=cfg.pos_encoding, activation=cfg.ffn_activation,
            d_ff=cfg.d_ff, attention=cfg.attention, param_dtype=pdt,
            compute_dtype=cdt, remat=cfg.remat,
            remat_policy=cfg.remat_policy,
            moe_experts=cfg.moe_experts,
            moe_capacity_factor=cfg.moe_capacity_factor,
            moe_top_k=cfg.moe_top_k, ce_chunk=cfg.ce_chunk,
            matmul_dtype=cfg.matmul_dtype,
            matmul_skip=tuple(cfg.matmul_skip), scan_layers=cfg.scan_layers)
        return Transformer(tc, device=device, seq_group=seq_group,
                           expert_group=expert_group)
    raise ValueError(f"unknown arch {cfg.arch!r}")
