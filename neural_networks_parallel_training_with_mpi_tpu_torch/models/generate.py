"""Autoregressive decoding with a dense KV cache: the port of the JAX
package's ``models/generate.py`` (``generate`` and the cache helpers the
paged server shares).

``generate`` runs no custom kernel; it is the serving path's token
oracle.  Greedy decoding here and through ``serve.Scheduler`` must give
identical tokens.  The cache is a preallocated ``(B, total, KV, hd)``
buffer per layer written in place at each position (JAX rebuilt it with
``dynamic_update_slice`` inside a ``scan``; eager PyTorch writes the
slice directly).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils.platform import DeviceLike, resolve_device
from .transformer import NEG_INF, Transformer, layer_params


def init_kv_cache(model: Transformer, batch: int, max_len: int,
                  quant: bool = False, device: DeviceLike = None):
    """Per-layer ``{"k", "v"}`` buffers (B, max_len, KV, hd) in the
    compute dtype, or int8 codes plus f32 ``k_scale``/``v_scale``
    (B, max_len, KV) with ``quant``."""
    c = model.cfg
    dev = model.device if device is None else torch.device(device)
    shape = (batch, max_len, c.kv_heads, c.head_dim)
    if quant:
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "k_scale": torch.ones(shape[:-1], device=dev),
                 "v_scale": torch.ones(shape[:-1], device=dev)}
                for _ in range(c.n_layers)]
    return [{"k": torch.zeros(shape, dtype=c.compute_dtype, device=dev),
             "v": torch.zeros(shape, dtype=c.compute_dtype, device=dev)}
            for _ in range(c.n_layers)]


def _quantize_kv(x: torch.Tensor):
    """(..., hd) -> int8 codes + f32 scale over the trailing dim
    (symmetric +-127; an all-zero row gets scale 1)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(x32 / s[..., None]), -127, 127)
    return codes.to(torch.int8), s


def softmax_scale(head_dim: int) -> float:
    """``1/sqrt(head_dim)`` rounded as f32 arithmetic rounds it (the JAX
    package computes it on f32 arrays), as a host float so no device
    tensor is built per call."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def attend_masked(c, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, k_scale=None, v_scale=None
                  ) -> torch.Tensor:
    """Attention of ``q`` (B, W, H, hd) over a key slab ``k``/``v``
    (B, T, KV, hd) under ``mask`` (B, W, T), all in f32, GQA kept
    grouped.  int8 slabs fold their per-(position, head) scales into the
    logits (K) and the probabilities (V).  Shared by the dense-cache
    decode and the paged server's gathered path, as in the JAX package.
    Returns f32 (B, W, H, hd)."""
    b, w = q.shape[:2]
    g = c.n_heads // c.kv_heads
    q5 = q.float().reshape(b, w, c.kv_heads, g, c.head_dim)
    logits = torch.einsum("bqcgd,bkcd->bcgqk", q5,
                          k.float()) * softmax_scale(c.head_dim)
    if k_scale is not None:
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bcgqk,bkcd->bqcgd", probs, v.float())
    return out.reshape(b, w, c.n_heads, c.head_dim)


def _forward_chunk(model: Transformer, params, caches, ids: torch.Tensor,
                   pos: int) -> torch.Tensor:
    """ids (B, S) at start ``pos`` -> f32 logits (B, S, vocab).  Each
    layer writes the chunk's K/V into its cache in place and attends
    causally over positions ``0 .. pos+S-1``."""
    c = model.cfg
    b, s = ids.shape
    positions = pos + torch.arange(s, device=ids.device)
    t = caches[0]["k"].shape[1]
    mask = (torch.arange(t, device=ids.device)[None, None, :]
            <= positions[None, :, None]).expand(b, s, t)
    x = model.embed(params, ids, positions)
    for layer, cache in zip(layer_params(params), caches):

        def attend(q, k, v, cache=cache):
            if "k_scale" in cache:
                k, ks = _quantize_kv(k)
                v, vs = _quantize_kv(v)
                cache["k_scale"][:, pos:pos + s] = ks
                cache["v_scale"][:, pos:pos + s] = vs
            cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
            cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)
            return attend_masked(c, q, cache["k"], cache["v"], mask,
                                 cache.get("k_scale"), cache.get("v_scale"))

        x = model.block(layer, x, positions, attend)
    return model.head_logits(params, x)


def _filter_logits(logits: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus-p candidate sets to the
    dtype's most negative value."""
    neg = torch.finfo(logits.dtype).min
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest prefix with cumulative mass >= top_p; the shifted mask
        # always keeps the most probable token
        keep = torch.roll(cum < top_p, 1, dims=-1)
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_logits,
                             -neg).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator], top_k: int = 0,
            top_p: float = 1.0) -> torch.Tensor:
    """(..., vocab) -> int64 token ids: argmax when ``temperature`` is 0,
    else a draw from ``generator`` after temperature, then top-k/top-p
    filtering (the JAX package's order)."""
    if temperature > 0:
        logits = _filter_logits(logits / temperature, top_k, top_p)
        probs = torch.softmax(logits, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        nxt = torch.multinomial(flat, 1, generator=generator)
        return nxt.reshape(probs.shape[:-1])
    return torch.argmax(logits, dim=-1)


def generate(model: Transformer, params, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None,
             prompt_lens: Optional[List[int]] = None, pad_id: int = 0,
             kv_quant: bool = False, prefill_chunk: int = 0,
             device: DeviceLike = None) -> torch.Tensor:
    """Decode ``max_new_tokens`` after ``prompt`` (B, P) -> (B, P + N)
    int64 on ``device`` (default: cuda).

    ``temperature=0`` is greedy; otherwise sampling needs ``generator``
    (a ``torch.Generator`` on ``device``).  Ragged prompts are right-
    padded with ``pad_id`` and given ``prompt_lens``; every row then
    decodes position by position so short rows' generated tokens, not
    their pads, enter the cache.  ``prefill_chunk > 0`` prefills a
    uniform prompt in chunks of that many positions."""
    dev = resolve_device(device)
    c = model.cfg
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
    caches = init_kv_cache(model, b, total, quant=kv_quant, device=dev)
    tokens = torch.cat([prompt, torch.full((b, max_new_tokens), pad_id,
                                           dtype=torch.long, device=dev)],
                       dim=1)
    ragged = prompt_lens is not None
    with torch.no_grad():
        if ragged:
            lens = torch.as_tensor(prompt_lens, device=dev)
            start = 0
        else:
            logits = None
            width = prefill_chunk if 0 < prefill_chunk < p else p
            for off in range(0, p, width):
                logits = _forward_chunk(model, params, caches,
                                        tokens[:, off:min(off + width, p)],
                                        off)
            first = _sample(logits[:, -1], temperature, generator, top_k,
                            top_p)
            tokens[:, p] = first
            start = p
        for pos in range(start, total - 1):
            logits = _forward_chunk(model, params, caches,
                                    tokens[:, pos:pos + 1], pos)
            nxt = _sample(logits[:, 0], temperature, generator, top_k, top_p)
            if ragged:
                # rows whose prompt extends past pos+1 keep their token
                nxt = torch.where(pos + 1 < lens, tokens[:, pos + 1], nxt)
            tokens[:, pos + 1] = nxt
    return tokens
