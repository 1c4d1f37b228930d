"""Tensor-parallel autoregressive decoding: the port of the JAX package's
``models/generate_tp.py``, which serves a seq x tensor, expert x tensor or
pipe x tensor checkpoint in its training layout, never assembling the
dense params.

Where the JAX package binds a ``tensor`` mesh axis inside ``shard_map``,
the port passes a tensor group (``parallel.megatron``):
``LocalTensorGroup(T)`` runs the T shards in this process (one card),
``ProcessTensorGroup`` one shard per rank, each rank holding only its
slices of the params (``tensor_parallel.StateLayout`` of the ``sp_tp``
rules).  The params are the training layout's: per-layer blocks (a
``scan_layers`` stack is unstacked here), the qkv columns permuted
head-aligned for T (``megatron.permute_qkv``), the embedding and head
vocab-split under ``vocab_parallel``.

* **Megatron blocks, incremental.**  Each shard runs its ``n_heads / T``
  query heads against a KV cache of its ``kv_heads / T`` heads (GQA kept
  grouped, RoPE at the chunk's absolute positions, keys cached rotated),
  and the row-parallel products are summed over the group once each (no
  backward, so a plain sum, not the ``f`` / ``g`` pair), their bias added
  after the sum.  An MoE FFN is ``parallel.expert.moe_ffn_fn(cfg, None,
  group)``'s: experts whole, their hidden dim split.
* **Sampling.**  With the head whole (``vocab_parallel=False``) every
  shard samples the same full row with the same random stream, the dense
  decode's ``_sample`` (temperature, top-k, top-p).  With
  ``vocab_parallel=True`` the head gives each shard its ``V / T`` logits
  and the full row never exists: greedy is the global argmax with
  ``megatron.vocab_parallel_accuracy``'s tie-break (the global max, then
  the smallest index attaining it: ``argmax``'s rule), temperature is the
  Gumbel-max trick (each shard draws its own noise; the argmax of
  ``logits / T + g`` is one categorical draw), and top-k restricts the
  candidates by a ``T x k`` gather of the shards' local top-k, masking
  below the global k-th value.  ``top_p`` needs the sorted full row and is
  refused, with JAX's words.
* **Rows over the data ranks** (``data_group``, a process group): each
  rank decodes its block of rows and the tokens are gathered back.

Random streams: torch's generator cannot give JAX's Gumbel noise, so a
sampled token is not JAX's; the streams are seeded from ``generator``
(one draw), folded with the data rank and, for a shard's own Gumbel
noise, its tensor rank, so identical prompts on different data ranks
decode independently and a run is deterministic in its seed.

:func:`pipeline_params_for_decode` flattens a pipeline snapshot's stage
stack into the per-layer list, re-permuting the qkv columns when the
decode's tensor size differs from the snapshot's ``qkv_tp``.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import megatron
from ..utils.platform import DeviceLike, resolve_device
from .core import ACTIVATIONS, LayerNorm
from .generate import _sample, attend_masked
from .transformer import Transformer, layer_params


def init_tp_kv_cache(model: Transformer, batch: int, max_len: int, tp: int,
                     device: DeviceLike = None):
    """Per-layer ``{"k", "v"}`` buffers of ONE tensor shard, (B, max_len,
    kv_heads / tp, hd) in the compute dtype: under GQA the shard's grouped
    heads (the training layout's assignment, ``qkv_tp_permutation``)."""
    c = model.cfg
    dev = model.device if device is None else torch.device(device)
    shape = (batch, max_len, c.kv_heads // tp, c.head_dim)
    return [{"k": torch.zeros(shape, dtype=c.compute_dtype, device=dev),
             "v": torch.zeros(shape, dtype=c.compute_dtype, device=dev)}
            for _ in range(c.n_layers)]


def _psum(group, parts: List[torch.Tensor]) -> torch.Tensor:
    """The sum over the group of the shards' partial products (no
    backward here: a plain sum)."""
    if hasattr(group, "pg"):
        (part,) = parts
        out = part.contiguous().clone()
        dist.all_reduce(out, group=group.pg)
        return out
    return functools.reduce(torch.add, parts)


def _tp_block_chunk(cfg, shards, caches, x: torch.Tensor, pos: int,
                    group, moe_ffn=None) -> torch.Tensor:
    """One Megatron block on a chunk ``x`` (B, S, D) at position ``pos``:
    ``shards`` the per-shard layer trees held here, ``caches`` their KV
    caches (written in place).  The dense decode's block with
    ``megatron.tp_block_apply``'s split."""
    cdt = cfg.compute_dtype
    ln = LayerNorm(cfg.d_model, param_dtype=cfg.param_dtype)
    tp = group.size
    hl, kvl, hd = cfg.n_heads // tp, cfg.kv_heads // tp, cfg.head_dim
    local = SimpleNamespace(n_heads=hl, kv_heads=kvl, head_dim=hd)
    rep = shards[0]
    b, s, _ = x.shape
    positions = pos + torch.arange(s, device=x.device)
    t = caches[0]["k"].shape[1]
    mask = (torch.arange(t, device=x.device)[None, None, :]
            <= positions[None, :, None]).expand(b, s, t)
    h = ln.apply(rep["ln1"], x)
    parts = []
    for lp, cache in zip(shards, caches):
        qkv = h.to(cdt) @ lp["qkv"]["w"].to(cdt) + lp["qkv"]["b"].to(cdt)
        q = qkv[..., :hl * hd].reshape(b, s, hl, hd)
        k = qkv[..., hl * hd:(hl + kvl) * hd].reshape(b, s, kvl, hd)
        v = qkv[..., (hl + kvl) * hd:].reshape(b, s, kvl, hd)
        if cfg.pos_encoding == "rope":
            from ..ops.rope import rope_rotate

            q = rope_rotate(q, positions, cfg.rope_theta)
            k = rope_rotate(k, positions, cfg.rope_theta)
        cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)
        out = attend_masked(local, q, cache["k"], cache["v"], mask)
        out = out.to(x.dtype).reshape(b, s, hl * hd)
        parts.append(out.to(cdt) @ lp["attn_out"]["w"].to(cdt))
    attn = _psum(group, parts) + rep["attn_out"]["b"].to(cdt)
    x = x + attn.to(x.dtype)
    h = ln.apply(rep["ln2"], x)
    if moe_ffn is not None:
        ff, _ = moe_ffn(shards, h)      # the aux is a training signal
        return x + ff.to(x.dtype)
    hc = h.to(cdt)
    parts = []
    for lp in shards:
        hid = hc @ lp["ff_in"]["w"].to(cdt) + lp["ff_in"]["b"].to(cdt)
        if cfg.activation == "swiglu":
            gate = (hc @ lp["ff_gate"]["w"].to(cdt)
                    + lp["ff_gate"]["b"].to(cdt))
            hid = torch.nn.functional.silu(gate) * hid
        else:
            hid = ACTIVATIONS[cfg.activation](hid)
        parts.append(hid @ lp["ff_out"]["w"].to(cdt))
    ff = _psum(group, parts) + rep["ff_out"]["b"].to(cdt)
    return x + ff.to(x.dtype)


def _sharded_sample(logits_local: List[torch.Tensor], temperature: float,
                    generators, group, top_k: int = 0) -> torch.Tensor:
    """One token per row from the vocab-split logits (B, V/T) of the
    shards held here (see the module docstring): greedy, Gumbel-max
    temperature sampling (each shard's noise from its own generator),
    top-k through the ``T x k`` gather of the shards' local top-k."""
    v_local = logits_local[0].shape[-1]
    scores = [lg.float() for lg in logits_local]
    if temperature > 0:
        scores = [sc / temperature for sc in scores]
        if top_k > 0:
            k_eff = min(top_k, v_local)
            tops = [torch.topk(sc, k_eff, dim=-1).values for sc in scores]
            if hasattr(group, "pg"):
                gathered = [torch.empty_like(tops[0])
                            for _ in range(group.size)]
                dist.all_gather(gathered, tops[0].contiguous(),
                                group=group.pg)
                tops = gathered
            kth = torch.topk(torch.cat(tops, -1), top_k,
                             dim=-1).values[..., -1:]
            scores = [torch.where(sc < kth, -torch.inf, sc)
                      for sc in scores]
        noisy = []
        for sc, gen in zip(scores, generators):
            expo = torch.empty(sc.shape, dtype=torch.float32,
                               device=sc.device).exponential_(generator=gen)
            noisy.append(sc - torch.log(expo))      # + Gumbel(0, 1)
        scores = noisy
    local_max = [sc.amax(-1) for sc in scores]
    global_max = group.max(local_max)
    big = torch.iinfo(torch.int64).max
    cands = []
    for sc, lm, off in zip(scores, local_max, megatron._offsets(group, v_local)):
        arg = sc.argmax(-1) + off
        cands.append(torch.where(lm >= global_max, arg,
                                 torch.full_like(arg, big)))
    return group.min(cands)


def _seed(base: int, *fold: int) -> int:
    """A stream's seed: ``base`` folded with the data rank and the
    tensor rank (0 for the replicated-head stream)."""
    return int(np.random.SeedSequence([base, *fold]).generate_state(
        1, dtype=np.uint64)[0] % (2 ** 63))


def generate_tp(model: Transformer, params, prompt, group,
                max_new_tokens: int, *, temperature: float = 0.0,
                top_k: int = 0, top_p: float = 1.0,
                generator: Optional[torch.Generator] = None,
                prompt_lens=None, pad_id: int = 0,
                vocab_parallel: bool = False, data_group=None,
                device: DeviceLike = None) -> torch.Tensor:
    """Decode ``max_new_tokens`` after ``prompt`` (B, P) -> (B, P + N)
    int64, with the global ``params`` in the training layout (per-layer or
    ``scan_layers`` blocks, qkv columns permuted for ``group.size``; the
    embedding and head vocab-split under ``vocab_parallel``) over the
    tensor ``group``: a ``LocalTensorGroup`` runs every shard here, a
    ``ProcessTensorGroup`` rank keeps only its slices.  ``data_group``: a
    process group over the data ranks, each decoding its block of rows.

    Sampling as ``models.generate.generate`` (``generator``: a
    ``torch.Generator`` on the device); under ``vocab_parallel`` greedy,
    temperature and top-k only (see the module docstring)."""
    from ..parallel.tensor_parallel import state_layout

    dev = resolve_device(device)
    c = model.cfg
    tp = group.size
    megatron.validate_tp(c, tp)
    if vocab_parallel and c.vocab_size % tp:
        raise ValueError(f"vocab_size={c.vocab_size} not divisible by "
                         f"tp={tp}")
    if vocab_parallel and 0.0 < top_p < 1.0:
        raise NotImplementedError(
            "top_p needs a sorted cumulative view of the full logits row; "
            "with vocab_parallel the row is never materialized — use "
            "greedy, temperature, or top_k sampling here (top_k works "
            "shard-locally + a tp*k all_gather), or decode with "
            "vocab_parallel=False (replicated head)")
    if vocab_parallel and top_k > c.vocab_size:
        raise ValueError(f"top_k={top_k} > vocab_size={c.vocab_size}")
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, p = prompt.shape
    total = p + max_new_tokens
    if total > c.max_seq_len:
        raise ValueError(f"prompt {p} + {max_new_tokens} new tokens exceeds "
                         f"max_seq_len {c.max_seq_len}")
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    if max_new_tokens == 0:
        return prompt
    n_data, d_rank = 1, 0
    if data_group is not None:
        n_data = dist.get_world_size(data_group)
        d_rank = dist.get_rank(data_group)
    if b % n_data:
        raise ValueError(f"prompt batch {b} not divisible by the ('data',) "
                         f"axes product {n_data}")
    rows = slice(d_rank * (b // n_data), (d_rank + 1) * (b // n_data))
    lens = None
    if prompt_lens is not None:
        lens = torch.as_tensor(prompt_lens, device=dev)[rows]
    prompt = prompt[rows]
    b = prompt.shape[0]
    params = dict(params, blocks=list(layer_params(params)))
    sliced = hasattr(group, "pg") and tp > 1
    if sliced:      # this rank's slices of the sp_tp layout
        params = state_layout(model, params, group, qkv_order="permuted",
                              vocab_parallel=vocab_parallel).local(params)
    held = (group.rank,) if sliced else group.ranks
    layers = []
    for layer in params["blocks"]:
        shards = megatron.shard_layer(layer, 1 if sliced else tp)
        layers.append(shards if sliced else [shards[r] for r in held])

    def chunks(leaf, dim):
        if sliced:
            return [leaf]
        parts = leaf.chunk(tp, dim=dim)
        return [parts[r] for r in held]

    moe_ffn = None
    if c.moe_experts > 0:
        from ..parallel.expert import moe_ffn_fn

        moe_ffn = moe_ffn_fn(c, None, group)
    # the random streams (module docstring)
    full_gen, shard_gens = None, []
    if temperature > 0:
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())
        full_gen = torch.Generator(device=dev).manual_seed(
            _seed(base, d_rank, 0))
        shard_gens = [torch.Generator(device=dev).manual_seed(
            _seed(base, d_rank, 1 + r)) for r in held]
    per_shard = [init_tp_kv_cache(model, b, total, tp, dev) for _ in held]
    caches = [[cache[i] for cache in per_shard] for i in range(c.n_layers)]

    def forward_chunk(ids, pos):
        positions = pos + torch.arange(ids.shape[1], device=dev)
        if vocab_parallel:
            x = model.add_pos(params, megatron.vocab_parallel_embed(
                chunks(params["embed"]["table"], 0), ids, group), positions)
        else:
            x = model.embed(params, ids, positions)
        for shards, cache in zip(layers, caches):
            x = _tp_block_chunk(c, shards, cache, x, pos, group, moe_ffn)
        return x

    def sample(x_last):
        if vocab_parallel:
            logits = megatron.vocab_parallel_logits(
                model.final_norm(params, x_last),
                chunks(params["head"]["w"], 1), group,
                compute_dtype=c.compute_dtype)
            return _sharded_sample(logits, temperature, shard_gens, group,
                                   top_k)
        # the full row: every shard samples it with the same stream, so
        # the token stays replicated
        return _sample(model.head_logits(params, x_last), temperature,
                       full_gen, top_k, top_p)

    tokens = torch.cat([prompt, torch.full((b, max_new_tokens), pad_id,
                                           dtype=torch.long, device=dev)],
                       dim=1)
    with torch.no_grad():
        if lens is not None:
            start = 0
        else:
            x = forward_chunk(tokens[:, :p], 0)
            tokens[:, p] = sample(x[:, -1])
            start = p
        for pos in range(start, total - 1):
            x = forward_chunk(tokens[:, pos:pos + 1], pos)
            nxt = sample(x[:, 0])
            if lens is not None:
                nxt = torch.where(pos + 1 < lens, tokens[:, pos + 1], nxt)
            tokens[:, pos + 1] = nxt
    if n_data > 1:
        parts = [torch.empty_like(tokens) for _ in range(n_data)]
        dist.all_gather(parts, tokens, group=data_group)
        tokens = torch.cat(parts)
    return tokens


def pipeline_params_for_decode(params, model: Transformer,
                               qkv_tp: Optional[int] = None,
                               decode_tp: Optional[int] = None):
    """A pipeline snapshot's params, blocks stage-stacked ``(S, per, ...)``
    or ``(v, S, per, ...)`` (the depth inferred from the leaves), -> the
    per-layer list :func:`generate_tp` reads.  The qkv column permutation
    depends on the tensor size: given the snapshot's ``qkv_tp`` and the
    decode's ``decode_tp`` that differ, the blocks are re-permuted (the
    saved permutation undone by ``parallel.pipeline.dense_layer_blocks``,
    then the decode's applied); otherwise the permutation is kept as it
    is (the caller vouches that the sizes match)."""
    from ..parallel.pipeline import dense_layer_blocks

    c = model.cfg
    out = dict(params)
    if (qkv_tp is not None and decode_tp is not None
            and int(qkv_tp) != int(decode_tp)):
        out["blocks"] = dense_layer_blocks(params["blocks"], c,
                                           saved_tp=int(qkv_tp))
        if int(decode_tp) > 1:
            out["blocks"] = megatron.permute_qkv(
                out["blocks"], c.d_model, c.n_heads, int(decode_tp),
                kv_heads=c.kv_heads)
    else:
        out["blocks"] = dense_layer_blocks(params["blocks"])
    if (not isinstance(out["blocks"], list)
            or len(out["blocks"]) != c.n_layers):
        raise ValueError(
            f"expected a stacked pipeline blocks pytree flattening to "
            f"{c.n_layers} layers; got "
            f"{type(params['blocks']).__name__} -> "
            f"{len(out['blocks']) if isinstance(out['blocks'], list) else 'non-list'}")
    return out
