"""Decoder-only Transformer LM: the port of the JAX package's
``models/transformer.py`` for the dense model the serving path runs.

Pre-LN blocks ``x + Attn(LN(x))``, ``x + FFN(LN(x))``; learned positions
or RoPE; GQA through ``n_kv_heads``; an untied head whose logits come out
in f32.  Parameters are the JAX package's tree as dicts and lists of
tensors (``embed/table``, ``pos/table``, ``blocks[i]/{ln1, qkv,
attn_out, ln2, ff_in, ff_gate, ff_out}``, ``ln_f``, ``head/w``), so the
serving path (``models.generate``, ``serve.paged_kv``) and the parity
tests share one layout.

Attention: ``dense`` (plain PyTorch) or ``flash`` (the hand-written CUDA
kernels of ``ops.flash_attention``, forward and backward; K/V repeated to
full heads first, as the JAX package does); ``auto`` means dense until an
H100 crossover is measured.  The sequence-sharded impls ``ring``,
``ring_flash``, ``striped`` and ``striped_flash`` run over the sequence
group the model is built with (``parallel.sequence``), and the tokens sit
at their global positions (``global_positions``) for the position
embedding and RoPE.  Training adds ``fwd_flops`` and the fused
chunked cross-entropy (``ce_chunk``, ``fused_loss_sum``), whose chunks run
under ``torch.utils.checkpoint`` so the (B, T, vocab) logits never exist.

Not ported yet, and refused at construction: MoE FFNs, ``scan_layers``
(a stacked tree; ``interop.params_from_jax`` unstacks one), ``remat``,
``ulysses`` and ``dense_blockwise`` attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..ops import losses as losses_lib
from ..ops.rope import rope_rotate
from ..parallel.sequence import (
    SEQ_SHARDED_IMPLS, UNPORTED_IMPLS, global_positions,
    sequence_sharded_attention,
)
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
    # auto | dense | flash | ring | ring_flash | striped | striped_flash
    # (auto -> dense)
    attention: str = "auto"
    pos_encoding: str = "learned"      # learned | rope
    rope_theta: float = 10000.0
    n_kv_heads: Optional[int] = None
    scan_layers: bool = False
    moe_experts: int = 0
    matmul_dtype: str = "bf16"
    # flash kernel blocks (pallas_kernels._resolve_blocks: T must divide)
    flash_block_q: int = 128
    flash_block_k: int = 128
    remat: bool = False
    # > 0: fused chunked cross-entropy over blocks of this many tokens
    ce_chunk: int = 0

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

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 seq_group=None):
        """``seq_group``: the sequence group (``parallel.sequence``) the
        sequence-sharded attentions run over; they need one."""
        if cfg.moe_experts > 0:
            raise NotImplementedError("MoE FFNs are not ported yet")
        if cfg.scan_layers:
            raise NotImplementedError(
                "scan_layers is not ported; build with scan_layers=False "
                "(interop.params_from_jax unstacks a stacked JAX tree)")
        if cfg.attention in UNPORTED_IMPLS:
            raise NotImplementedError(
                f"attention={cfg.attention!r} is not ported yet; the port "
                "has dense, flash, ring, ring_flash, striped and "
                "striped_flash attention")
        if cfg.attention not in ("auto", "dense", "flash") \
                + SEQ_SHARDED_IMPLS:
            raise ValueError(f"unknown attention {cfg.attention!r}")
        if cfg.attention in SEQ_SHARDED_IMPLS and seq_group is None:
            raise ValueError(
                f"attention={cfg.attention!r} shards the sequence and needs "
                "a sequence group: --sp > 1 under torchrun, or an explicit "
                "LocalSeqGroup; use dense or flash on an unsharded sequence")
        if cfg.remat:
            raise NotImplementedError("remat is not ported yet")
        if cfg.matmul_dtype != "bf16":
            raise NotImplementedError(
                f"matmul_dtype={cfg.matmul_dtype!r} is not ported yet")
        if cfg.pos_encoding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_encoding {cfg.pos_encoding!r}")
        if cfg.activation != "swiglu" and cfg.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {cfg.activation!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seq_group = seq_group

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
        return self._head().apply(params["head"],
                                  self.final_norm(params, x)).float()

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

    def attend(self, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        """Causal attention of the training forward: K/V repeated to full
        heads, then dense, the flash kernels, or a sequence-sharded impl
        over ``seq_group`` (q/k/v already rotated by their global
        positions in :meth:`block`)."""
        c = self.cfg
        k, v = repeat_kv(c, k), repeat_kv(c, v)
        return sequence_sharded_attention(
            c.attention, q, k, v, group=self.seq_group, causal=True,
            block_q=c.flash_block_q, block_k=c.flash_block_k)

    def backbone(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        """Embedding + all blocks -> (B, T, d_model) pre-head hidden
        states: the trunk shared by :meth:`forward` and the fused loss."""
        positions = global_positions(self.cfg.attention, self.seq_group,
                                     ids.shape[1], ids.device)
        x = self.embed(params, ids, positions)
        for layer_params in params["blocks"]:
            x = self.block(layer_params, x, positions, self.attend)
        return x

    def final_norm(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        return LayerNorm(c.d_model, param_dtype=c.param_dtype).apply(
            params["ln_f"], x)

    def forward(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, T) -> f32 logits (B, T, vocab)."""
        return self.head_logits(params, self.backbone(params, ids))

    apply = forward

    def fwd_flops(self, x_shape) -> float:
        """(B, T) token batch: qkv/out/ffn/attention matmuls + LM head."""
        c = self.cfg
        b, t = x_shape
        d, ff, v = c.d_model, c.d_ff, c.vocab_size
        per_layer = 2.0 * b * t * d * c.qkv_dim     # qkv projection
        per_layer += 2.0 * b * t * d * d            # attention out projection
        per_layer += 2.0 * (2.0 * b * t * t * d)    # scores + values
        per_layer += 2.0 * ((3.0 if c.activation == "swiglu" else 2.0)
                            * b * t * d * ff)
        return float(c.n_layers * per_layer + 2.0 * b * t * d * v)

    # ---- fused chunked cross-entropy (cfg.ce_chunk > 0) ----

    def _chunked_ce_sum(self, params: Params, x: torch.Tensor,
                        labels: torch.Tensor, mask: Optional[torch.Tensor],
                        label_smoothing: float):
        """(loss_sum, token_count) of head + softmax CE over ``ce_chunk``
        tokens at a time.  Each chunk runs under ``torch.utils.checkpoint``:
        only its (B, ce_chunk, vocab) logits live at once, and the backward
        recomputes them.  Chunk sums add in order, as the JAX scan does."""
        from torch.utils.checkpoint import checkpoint

        c = self.cfg
        t, k = x.shape[1], c.ce_chunk
        if t % k != 0:
            raise ValueError(
                f"ce_chunk={k} must divide the local sequence length {t}")
        head = self._head()

        def chunk_sum(w, xc, yc):
            logits = head.apply({"w": w}, xc).float()
            return losses_lib.softmax_cross_entropy(
                logits, yc, mask, label_smoothing=label_smoothing)

        s = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        # no RNG state to save and restore: a chunk draws nothing random,
        # and reading or resetting the CUDA generator is not allowed while
        # the step is captured as a CUDA graph (--steps_per_dispatch)
        for i in range(0, t, k):
            cs, cc = checkpoint(chunk_sum, params["head"]["w"],
                                x[:, i:i + k], labels[:, i:i + k],
                                use_reentrant=False,
                                preserve_rng_state=False)
            s, cnt = s + cs, cnt + cc
        return s, cnt

    def fused_loss_sum(self, loss_name: str):
        """(params, batch) -> (loss_sum, count) fusing the LM head into a
        chunked cross-entropy, or None (chunking off, or another loss).
        The hook ``parallel.data_parallel.make_loss_fn`` consumes."""
        if self.cfg.ce_chunk <= 0:
            return None
        base, _, smooth = loss_name.partition("@")
        if base != "cross_entropy":
            return None
        label_smoothing = float(smooth) if smooth else 0.0

        def loss_fn(params, batch):
            x = self.final_norm(params, self.backbone(params, batch["x"]))
            return self._chunked_ce_sum(params, x, batch["y"],
                                        batch.get("mask"), label_smoothing)

        return loss_fn

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
