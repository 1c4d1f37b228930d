"""Decoder-only Transformer LM: the port of the JAX package's
``models/transformer.py`` for the dense model the serving path runs.

Pre-LN blocks ``x + Attn(LN(x))``, ``x + FFN(LN(x))``; learned positions
or RoPE; GQA through ``n_kv_heads``; an untied head whose logits come out
in f32.  Parameters are the JAX package's tree as dicts and lists of
tensors (``embed/table``, ``pos/table``, ``blocks[i]/{ln1, qkv,
attn_out, ln2, ff_in, ff_gate, ff_out}``, ``ln_f``, ``head/w``), so the
serving path (``models.generate``, ``serve.paged_kv``) and the parity
tests share one layout.

Not ported yet, and refused at construction: MoE FFNs, ``scan_layers``
(a stacked tree; ``interop.params_from_jax`` unstacks one) and any
attention other than dense.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..ops.rope import rope_rotate
from ..utils.platform import DeviceLike, resolve_device
from .core import ACTIVATIONS, Embedding, LayerNorm, Linear

NEG_INF = -1e30

Params = Dict[str, Any]


def split_qkv(c: "TransformerConfig", qkv: torch.Tensor):
    """Fused qkv (B, T, qkv_dim) -> q (B, T, H, hd), k/v (B, T, KV, hd);
    the column layout is ``[q | k | v]``.  The results are views."""
    b, t, _ = qkv.shape
    kvw = c.kv_heads * c.head_dim
    q = qkv[..., :c.d_model].reshape(b, t, c.n_heads, c.head_dim)
    k = qkv[..., c.d_model:c.d_model + kvw].reshape(b, t, c.kv_heads,
                                                    c.head_dim)
    v = qkv[..., c.d_model + kvw:].reshape(b, t, c.kv_heads, c.head_dim)
    return q, k, v


def repeat_kv(c: "TransformerConfig", kv: torch.Tensor) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, H, hd); identity for multi-head."""
    groups = c.n_heads // c.kv_heads
    if groups == 1:
        return kv
    return torch.repeat_interleave(kv, groups, dim=2)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain full-sequence attention (B, T, H, hd): f32 scores, softmax,
    probabilities cast to ``v``'s dtype for the value product."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        pos_q = torch.arange(t_q, device=q.device)
        pos_k = torch.arange(t_k, device=q.device)
        mask = pos_k[None, :] <= pos_q[:, None]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    max_seq_len: int = 512
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 512
    activation: str = "gelu"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    attention: str = "auto"            # auto | dense (auto -> dense)
    pos_encoding: str = "learned"      # learned | rope
    rope_theta: float = 10000.0
    n_kv_heads: Optional[int] = None
    scan_layers: bool = False
    moe_experts: int = 0
    matmul_dtype: str = "bf16"

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        assert self.n_heads % kv == 0, (
            f"n_heads={self.n_heads} not divisible by n_kv_heads={kv}")
        return kv

    @property
    def qkv_dim(self) -> int:
        return self.d_model + 2 * self.kv_heads * self.head_dim


class Transformer:
    """The LM over an explicit parameter tree: ``init(generator)`` builds
    the tree on ``self.device``; ``forward(params, ids)`` is the dense
    causal forward.  ``block``/``embed``/``head_logits`` are shared with
    the KV-cache and paged decode paths, which supply only their own
    attention, so the three cannot drift apart."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None):
        if cfg.moe_experts > 0:
            raise NotImplementedError("MoE FFNs are not ported yet")
        if cfg.scan_layers:
            raise NotImplementedError(
                "scan_layers is not ported; build with scan_layers=False "
                "(interop.params_from_jax unstacks a stacked JAX tree)")
        if cfg.attention not in ("auto", "dense"):
            raise NotImplementedError(
                f"attention={cfg.attention!r} is not ported yet; the port "
                "has dense attention only")
        if cfg.matmul_dtype != "bf16":
            raise NotImplementedError(
                f"matmul_dtype={cfg.matmul_dtype!r} is not ported yet")
        if cfg.pos_encoding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_encoding {cfg.pos_encoding!r}")
        if cfg.activation != "swiglu" and cfg.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {cfg.activation!r}")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---- submodules (stateless; parameters live in the tree) ----
    def _block_modules(self):
        c = self.cfg
        lin = lambda i, o: Linear(i, o, param_dtype=c.param_dtype,  # noqa: E731
                                  compute_dtype=c.compute_dtype)
        mods = {
            "ln1": LayerNorm(c.d_model, param_dtype=c.param_dtype),
            "qkv": lin(c.d_model, c.qkv_dim),
            "attn_out": lin(c.d_model, c.d_model),
            "ln2": LayerNorm(c.d_model, param_dtype=c.param_dtype),
            "ff_in": lin(c.d_model, c.d_ff),
        }
        if c.activation == "swiglu":
            mods["ff_gate"] = lin(c.d_model, c.d_ff)
        mods["ff_out"] = lin(c.d_ff, c.d_model)
        return mods

    def _head(self) -> Linear:
        c = self.cfg
        return Linear(c.d_model, c.vocab_size, use_bias=False,
                      param_dtype=c.param_dtype,
                      compute_dtype=c.compute_dtype)

    def _ffn(self, mods, params, h: torch.Tensor) -> torch.Tensor:
        """Classic ``act(h W_in) W_out``, or SwiGLU
        ``(silu(h W_gate) * h W_in) W_out``."""
        if self.cfg.activation == "swiglu":
            gate = torch.nn.functional.silu(
                mods["ff_gate"].apply(params["ff_gate"], h))
            return mods["ff_out"].apply(
                params["ff_out"], gate * mods["ff_in"].apply(params["ff_in"],
                                                             h))
        h = mods["ff_in"].apply(params["ff_in"], h)
        h = ACTIVATIONS[self.cfg.activation](h)
        return mods["ff_out"].apply(params["ff_out"], h)

    def init(self, generator: torch.Generator) -> Params:
        c = self.cfg
        dev = self.device
        blocks = []
        for _ in range(c.n_layers):
            blocks.append({name: m.init(generator, dev)
                           for name, m in self._block_modules().items()})
        out = {
            "embed": Embedding(c.vocab_size, c.d_model,
                               c.param_dtype).init(generator, dev),
            "blocks": blocks,
            "ln_f": LayerNorm(c.d_model,
                              param_dtype=c.param_dtype).init(generator, dev),
            "head": self._head().init(generator, dev),
        }
        if c.pos_encoding != "rope":
            out["pos"] = Embedding(c.max_seq_len, c.d_model,
                                   c.param_dtype).init(generator, dev)
        return out

    def embed(self, params: Params, ids: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        """Token (+ learned position) embedding -> compute dtype."""
        c = self.cfg
        x = params["embed"]["table"][ids]
        if c.pos_encoding != "rope":
            x = x + params["pos"]["table"][positions]
        return x.to(c.compute_dtype)

    def head_logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm + untied head -> f32 logits."""
        c = self.cfg
        x = LayerNorm(c.d_model, param_dtype=c.param_dtype).apply(
            params["ln_f"], x)
        return self._head().apply(params["head"], x).float()

    def block(self, params: Params, x: torch.Tensor, positions: torch.Tensor,
              attend: Callable) -> torch.Tensor:
        """One pre-LN block on ``x`` (B, W, D) whose rows sit at
        ``positions`` ((W,) or (B, W), used by RoPE).  ``attend(q, k, v)``
        (q (B, W, H, hd), k/v (B, W, KV, hd) after RoPE) returns the
        attention output (B, W, H, hd): the dense forward, the KV-cache
        decode and the paged server differ only there."""
        c = self.cfg
        mods = self._block_modules()
        h = mods["ln1"].apply(params["ln1"], x)
        q, k, v = split_qkv(c, mods["qkv"].apply(params["qkv"], h))
        if c.pos_encoding == "rope":
            q = rope_rotate(q, positions, c.rope_theta)
            k = rope_rotate(k, positions, c.rope_theta)
        out = attend(q, k, v).to(x.dtype).reshape(*x.shape[:2], c.d_model)
        x = x + mods["attn_out"].apply(params["attn_out"], out)
        h = mods["ln2"].apply(params["ln2"], x)
        return x + self._ffn(mods, params, h).to(x.dtype)

    def forward(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, T) -> f32 logits (B, T, vocab)."""
        c = self.cfg
        positions = torch.arange(ids.shape[1], device=ids.device)
        x = self.embed(params, ids, positions)

        def attend(q, k, v):
            return attention_reference(q, repeat_kv(c, k), repeat_kv(c, v))

        for layer_params in params["blocks"]:
            x = self.block(layer_params, x, positions, attend)
        return self.head_logits(params, x)

    def n_params(self, params: Params) -> int:
        return sum(t.numel() for t in tensors(params))


def tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor leaf of a parameter tree of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    else:
        for v in tree:
            yield from tensors(v)
