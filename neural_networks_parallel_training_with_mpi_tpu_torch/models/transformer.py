"""Decoder-only Transformer LM: the port of the JAX package's
``models/transformer.py`` for the dense model the serving path runs.

Pre-LN blocks ``x + Attn(LN(x))``, ``x + FFN(LN(x))``; learned positions
or RoPE; GQA through ``n_kv_heads``; an untied head whose logits come out
in f32.  Parameters are the JAX package's tree as dicts and lists of
tensors (``embed/table``, ``pos/table``, ``blocks[i]/{ln1, qkv,
attn_out, ln2, ff_in, ff_gate, ff_out}``, ``ln_f``, ``head/w``), so the
serving path (``models.generate``, ``serve.paged_kv``) and the parity
tests share one layout.

Attention: ``dense`` (plain PyTorch), ``dense_blockwise`` (the same,
one query block at a time) or ``flash`` (the hand-written CUDA
kernels of ``ops.flash_attention``, forward and backward; K/V repeated to
full heads first, as the JAX package does); ``auto`` is dense or flash by
the device, the compute dtype and the sequence length
(``parallel.sequence.resolve_attention_impl``; a head_dim the kernels do
not take, where auto would pick flash, is refused at construction).  The
sequence-sharded impls ``ring``, ``ring_flash``, ``striped``,
``striped_flash`` and ``ulysses`` run over the sequence
group the model is built with (``parallel.sequence``), and the tokens sit
at their global positions (``global_positions``) for the position
embedding and RoPE.  Training adds ``fwd_flops`` and the fused
chunked cross-entropy (``ce_chunk``, ``fused_loss_sum``), whose chunks run
under ``torch.utils.checkpoint`` so the (B, T, vocab) logits never exist.

``remat`` runs each block under ``models.core.make_remat(remat_policy)``
(recomputed in the backward; fp8 observations come from the first
forward only, the recompute's are dropped).  ``scan_layers`` keeps the JAX package's
stacked tree: ``blocks`` is one dict whose leaves carry a leading
``(n_layers,)`` axis; every path walks it through :func:`layer_params`
(one ``torch.unbind`` per leaf: views, no copy).

Quantized compute (``matmul_dtype`` int8 or fp8, ``ops.qmm``): every
dense projection (qkv, attn_out, ff_in, ff_gate, ff_out, head) runs
through the seam unless its role is in ``matmul_skip``.  Under fp8 the
blocks read the delayed activation amax of their role from ``qscales``
and report this step's observed amax (:meth:`forward` with
``return_qobs``), maxed over the layers.  Params quantized by
``ops.quant.quantize_params`` (int8 ``w`` + f32 ``w_scale``) serve as
they are: dequantized in the product (``matmul_dtype`` bf16) or as an
int8 x int8 product (int8).

MoE (``moe_experts`` > 0, ``models.moe.MoEFFN``): each block's FFN is
the routed mixture of experts, in the block shared by the training
forward, the KV-cache decode and the paged server.  Its routing groups are
the rows of each expert shard an ``expert_group``
(``parallel.expert.LocalExpertGroup`` / ``ProcessExpertGroup``) holds
here times the shards of the sequence group, so each routes alone as a
JAX device does; a decode call routes all its lanes as one group.
``forward(..., return_aux=True)`` returns the load-balance aux summed
over the layers, one per routing group (``parallel.expert``'s steps weight
it into the loss; the plain DP step drops it, as JAX's does).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..ops import losses as losses_lib
from ..ops.rope import rope_rotate
from ..parallel.sequence import (
    SEQ_SHARDED_IMPLS, global_positions,
    resolve_attention_impl, sequence_sharded_attention,
)
from ..utils.platform import DeviceLike, resolve_device
from .core import ACTIVATIONS, Embedding, LayerNorm, Linear, make_remat
from .moe import MoEFFN

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
    # auto | dense | dense_blockwise | flash | ring | ring_flash | striped
    # | striped_flash | ulysses (auto: parallel.sequence.
    # resolve_attention_impl)
    attention: str = "auto"
    pos_encoding: str = "learned"      # learned | rope
    rope_theta: float = 10000.0
    n_kv_heads: Optional[int] = None
    scan_layers: bool = False
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_capacity: Optional[int] = None   # per group and expert; None: factor
    moe_top_k: int = 1                   # 1 = Switch; k > 1 = GShard top-k
    matmul_dtype: str = "bf16"            # bf16 | int8 | fp8 (ops.qmm)
    # projection roles kept on the plain product under int8/fp8
    matmul_skip: Tuple[str, ...] = ()
    # flash kernel blocks (pallas_kernels._resolve_blocks: T must divide)
    flash_block_q: int = 128
    flash_block_k: int = 128
    remat: bool = False
    remat_policy: str = "full"         # full | dots | dots_no_batch
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
                 seq_group=None, expert_group=None):
        """``seq_group``: the sequence group (``parallel.sequence``) the
        sequence-sharded attentions run over; they need one.
        ``expert_group``: the expert group (``parallel.expert``) of an MoE
        model's expert-parallel layouts (None: every expert here, the
        rows routed as one group per sequence shard)."""
        if cfg.attention not in ("auto", "dense", "dense_blockwise", "flash") \
                + SEQ_SHARDED_IMPLS:
            raise ValueError(f"unknown attention {cfg.attention!r}")
        if cfg.attention in SEQ_SHARDED_IMPLS and seq_group is None:
            raise ValueError(
                f"attention={cfg.attention!r} shards the sequence and needs "
                "a sequence group: --sp > 1 under torchrun, or an explicit "
                "LocalSeqGroup; use dense or flash on an unsharded sequence")
        if cfg.matmul_dtype not in ("bf16", "int8", "fp8"):
            raise ValueError(f"unknown matmul_dtype {cfg.matmul_dtype!r} "
                             "(choices: bf16, int8, fp8)")
        if cfg.pos_encoding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_encoding {cfg.pos_encoding!r}")
        if cfg.activation != "swiglu" and cfg.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {cfg.activation!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seq_group = seq_group
        self.expert_group = expert_group
        # the sequence shards this process holds: a LocalSeqGroup's rows
        # quantize shard by shard in the backward, as its ranks would
        self._seq_shards = len(seq_group.ranks) if seq_group else 1
        if cfg.attention == "auto":
            # a head_dim the flash kernels do not take is refused here
            # when auto picks flash for some length the model takes (a
            # length the blocks do not divide: by the trainer, or at the
            # forward)
            resolve_attention_impl("auto", cfg.max_seq_len,
                                   self.device.type, cfg.compute_dtype,
                                   cfg.head_dim, blocks=None)
        if cfg.moe_experts > 0:     # a top-k out of range raises here
            self.moe()
        # the block wrapper of --remat (an unknown policy raises here)
        self._remat = make_remat(cfg.remat_policy) if cfg.remat else None

    # ---- submodules (stateless; parameters live in the tree) ----
    def _mm(self, role: str) -> str:
        """The matmul format of one projection role: the config's, or
        bf16 (the plain product) for a role in ``matmul_skip``."""
        c = self.cfg
        return "bf16" if role in c.matmul_skip else c.matmul_dtype

    def _linear(self, role: str, i: int, o: int, use_bias: bool = True
                ) -> Linear:
        c = self.cfg
        return Linear(i, o, use_bias=use_bias, param_dtype=c.param_dtype,
                      compute_dtype=c.compute_dtype,
                      matmul_dtype=self._mm(role), q_role=role,
                      seq_shards=self._seq_shards)

    def _block_modules(self):
        c = self.cfg
        mods = {
            "ln1": LayerNorm(c.d_model, param_dtype=c.param_dtype),
            "qkv": self._linear("qkv", c.d_model, c.qkv_dim),
            "attn_out": self._linear("attn_out", c.d_model, c.d_model),
            "ln2": LayerNorm(c.d_model, param_dtype=c.param_dtype),
        }
        if c.moe_experts > 0:
            mods["moe"] = self.moe()
            return mods
        mods["ff_in"] = self._linear("ff_in", c.d_model, c.d_ff)
        if c.activation == "swiglu":
            mods["ff_gate"] = self._linear("ff_gate", c.d_model, c.d_ff)
        mods["ff_out"] = self._linear("ff_out", c.d_ff, c.d_model)
        return mods

    def moe(self) -> MoEFFN:
        """The block's MoE FFN (``moe_experts`` > 0)."""
        c = self.cfg
        return MoEFFN(c.d_model, c.d_ff, c.moe_experts,
                      capacity_factor=c.moe_capacity_factor,
                      capacity=c.moe_capacity, activation=c.activation,
                      param_dtype=c.param_dtype,
                      compute_dtype=c.compute_dtype,
                      router_top_k=c.moe_top_k)

    def _head(self) -> Linear:
        c = self.cfg
        return self._linear("head", c.d_model, c.vocab_size, use_bias=False)

    def quant_roles(self) -> Tuple[str, ...]:
        """The fp8 delayed-scaling roles (``ops.qmm``): one activation
        amax history per projection role, shared across the layers;
        skipped roles run the plain product and carry none."""
        c = self.cfg
        roles = ["qkv", "attn_out", "ff_in", "ff_out", "head"]
        if c.moe_experts > 0:   # the expert products are outside the seam
            roles = ["qkv", "attn_out", "head"]
        elif c.activation == "swiglu":
            roles.insert(3, "ff_gate")
        return tuple(r for r in roles if r not in c.matmul_skip)

    def _ffn(self, mods, params, h: torch.Tensor, **qkw) -> torch.Tensor:
        """Classic ``act(h W_in) W_out``, or SwiGLU
        ``(silu(h W_gate) * h W_in) W_out``; ``qkw`` carries the fp8
        context (``qscales``/``qobserved``) to the Linears."""
        if self.cfg.activation == "swiglu":
            gate = torch.nn.functional.silu(
                mods["ff_gate"].apply(params["ff_gate"], h, **qkw))
            return mods["ff_out"].apply(
                params["ff_out"],
                gate * mods["ff_in"].apply(params["ff_in"], h, **qkw), **qkw)
        h = mods["ff_in"].apply(params["ff_in"], h, **qkw)
        h = ACTIVATIONS[self.cfg.activation](h)
        return mods["ff_out"].apply(params["ff_out"], h, **qkw)

    def init(self, generator: torch.Generator) -> Params:
        c = self.cfg
        dev = self.device
        blocks = []
        for _ in range(c.n_layers):
            blocks.append({name: m.init(generator, dev)
                           for name, m in self._block_modules().items()})
        if c.scan_layers:   # stacked layout: leaves (n_layers, ...)
            blocks = _stack(blocks)
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
        return self.add_pos(params, params["embed"]["table"][ids],
                            positions)

    def add_pos(self, params: Params, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        """The learned position rows added to looked-up token rows ``x``,
        then the compute dtype: the part of :meth:`embed` that a
        vocab-parallel lookup (``parallel.megatron``) shares."""
        c = self.cfg
        if c.pos_encoding != "rope":
            x = x + params["pos"]["table"][positions]
        return x.to(c.compute_dtype)

    def head_logits(self, params: Params, x: torch.Tensor,
                    qscales=None, qobserved=None) -> torch.Tensor:
        """Final LayerNorm + untied head -> f32 logits (``qscales``: the
        fp8 delayed amax; ``qobserved``: the dict the head's fp8
        observation, taken on ``final_norm(x)``, lands in)."""
        return self._head().apply(params["head"], self.final_norm(params, x),
                                  qscales=qscales,
                                  qobserved=qobserved).float()

    def block(self, params: Params, x: torch.Tensor, positions: torch.Tensor,
              attend: Callable, qscales=None, qobs=None) -> torch.Tensor:
        """:meth:`block_aux` without the MoE aux: the decode paths'."""
        return self.block_aux(params, x, positions, attend, qscales,
                              qobs)[0]

    def block_aux(self, params: Params, x: torch.Tensor,
                  positions: torch.Tensor, attend: Callable, qscales=None,
                  qobs=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One pre-LN block on ``x`` (B, W, D) whose rows sit at
        ``positions`` ((W,) or (B, W), used by RoPE).  ``attend(q, k, v)``
        (q (B, W, H, hd), k/v (B, W, KV, hd) after RoPE) returns the
        attention output (B, W, H, hd): the dense forward, the KV-cache
        decode and the paged server differ only there.  Under fp8 the
        Linears read ``qscales`` and write their observations into the
        dict ``qobs`` (when given).  Returns (x, the MoE aux per routing
        group, or None for a dense FFN)."""
        c = self.cfg
        mods = self._block_modules()
        qkw = ({"qscales": qscales, "qobserved": qobs}
               if c.matmul_dtype == "fp8" else {})
        h = mods["ln1"].apply(params["ln1"], x)
        q, k, v = split_qkv(c, mods["qkv"].apply(params["qkv"], h, **qkw))
        if c.pos_encoding == "rope":
            q = rope_rotate(q, positions, c.rope_theta)
            k = rope_rotate(k, positions, c.rope_theta)
        out = attend(q, k, v).to(x.dtype).reshape(*x.shape[:2], c.d_model)
        x = x + mods["attn_out"].apply(params["attn_out"], out, **qkw)
        h = mods["ln2"].apply(params["ln2"], x)
        if c.moe_experts > 0:
            ff, aux = mods["moe"].apply(params["moe"], h, self.expert_group,
                                        seq_shards=self._seq_shards)
            return x + ff.to(x.dtype), aux
        return x + self._ffn(mods, params, h, **qkw).to(x.dtype), None

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

    def backbone(self, params: Params, ids: torch.Tensor, qscales=None,
                 qobs: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """:meth:`backbone_aux`'s hidden states."""
        return self.backbone_aux(params, ids, qscales, qobs)[0]

    def backbone_aux(self, params: Params, ids: torch.Tensor, qscales=None,
                     qobs: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Embedding + all blocks -> (B, T, d_model) pre-head hidden
        states: the trunk shared by :meth:`forward` and the fused loss.
        fp8: the blocks read ``qscales``; given a dict ``qobs``, each
        block role's observed amax, maxed over the layers, lands in it.
        Each block observes into a dict of its own, which it returns, so
        the forward that ``--remat`` runs again in the backward observes
        into a dict nobody reads.  Also returns the MoE aux summed over
        the layers, one per routing group (None for dense FFNs)."""
        c = self.cfg
        positions = global_positions(c.attention, self.seq_group,
                                     ids.shape[1], ids.device)
        x = self.embed(params, ids, positions)
        collect = qobs is not None and c.matmul_dtype == "fp8"

        def block_fn(layer, h):
            obs = {} if collect else None
            h, aux = self.block_aux(layer, h, positions, self.attend,
                                    qscales=qscales, qobs=obs)
            return h, obs, aux

        if self._remat is not None:
            block_fn = self._remat(block_fn)
        if collect:
            for r in self.quant_roles():
                if r != "head":
                    qobs[r] = torch.zeros((), dtype=torch.float32,
                                          device=x.device)
        aux_total = None
        for layer in layer_params(params):
            x, obs, aux = block_fn(layer, x)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
            if collect:
                for r in qobs:
                    if r in obs:
                        qobs[r] = torch.maximum(qobs[r], obs[r])
        return x, aux_total

    def final_norm(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        return LayerNorm(c.d_model, param_dtype=c.param_dtype).apply(
            params["ln_f"], x)

    def forward(self, params: Params, ids: torch.Tensor, qscales=None,
                return_qobs: bool = False, return_aux: bool = False):
        """ids (B, T) -> f32 logits (B, T, vocab); with ``return_qobs``,
        (logits, {role: observed amax}): the fp8 step's calibration
        input (empty unless the model is fp8).  ``qscales`` is the
        per-role delayed amax (``ops.qmm.delayed_amax``); None is current
        scaling.  With ``return_aux``, (logits, aux): the MoE
        load-balance aux summed over the layers, (G,) f32 with one entry
        per routing group (zeros (1,) for dense FFNs)."""
        qobs = {} if return_qobs else None
        x, aux = self.backbone_aux(params, ids, qscales=qscales, qobs=qobs)
        logits = self.head_logits(params, x, qscales=qscales, qobserved=qobs)
        if return_aux:
            if aux is None:
                aux = torch.zeros((1,), dtype=torch.float32,
                                  device=logits.device)
            return logits, aux
        return (logits, qobs) if return_qobs else logits

    apply = forward

    def fwd_flops(self, x_shape) -> float:
        """(B, T) token batch: qkv/out/ffn/attention matmuls + LM head;
        with MoE each token runs ``moe_top_k`` expert FFNs plus the
        router."""
        c = self.cfg
        b, t = x_shape
        d, ff, v = c.d_model, c.d_ff, c.vocab_size
        per_layer = 2.0 * b * t * d * c.qkv_dim     # qkv projection
        per_layer += 2.0 * b * t * d * d            # attention out projection
        per_layer += 2.0 * (2.0 * b * t * t * d)    # scores + values
        ffn = 2.0 * ((3.0 if c.activation == "swiglu" else 2.0)
                     * b * t * d * ff)
        if c.moe_experts > 0:
            ffn *= c.moe_top_k
            per_layer += 2.0 * b * t * d * c.moe_experts    # router
        per_layer += ffn
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
        # a quantized head's chunk must lie inside one sequence shard, as
        # in JAX's per-shard scan: its rows are then one rank's
        local = t if self._mm("head") == "bf16" else t // self._seq_shards
        if local % k != 0:
            raise ValueError(
                f"ce_chunk={k} must divide the local sequence length {local}")
        head = dataclasses.replace(self._head(), seq_shards=1)

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


def layer_params(params: Params) -> List[Params]:
    """One dict per layer: ``params["blocks"]`` itself, or views of a
    stacked (``scan_layers``) tree, each leaf unbound once.  Autograd
    then stacks the layers' gradients once per leaf in the backward,
    where indexing the stacked leaf per layer would cost a full-size
    gradient per layer."""
    blocks = params["blocks"]
    if not isinstance(blocks, dict):
        return blocks

    def unbind(node):
        if isinstance(node, dict):
            return {k: unbind(v) for k, v in node.items()}
        return torch.unbind(node, 0)

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    per_leaf = unbind(blocks)
    n = len(blocks["ln1"]["scale"])
    return [take(per_leaf, i) for i in range(n)]


def _stack(layers: List[Params]) -> Params:
    """Per-layer block dicts -> one dict of stacked (n_layers, ...) leaves
    (the ``scan_layers`` tree), nested dicts (an MoE FFN's) included."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return torch.stack(layers)


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
