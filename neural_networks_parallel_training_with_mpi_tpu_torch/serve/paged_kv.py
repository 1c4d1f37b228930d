"""Paged KV cache: block-allocated pools, block tables, chunked prefill
and batched decode.  The port of the JAX package's ``serve/paged_kv.py``.

* **Pools**: per layer, ``k``/``v`` of shape ``(num_blocks, block_size,
  kv_heads, head_dim)`` (plus f32 scale pools under ``kv_quant``,
  quantised per (position, head) as ``models.generate`` does).  The
  pools are updated in place (``index_put_``/``copy_``) where the JAX
  package donated them to its jitted programs.
* **Block tables**: per slot, ``(max_blocks,)`` int32 indices into the
  pool, owned by the host and copied to the device each call.
  Unallocated entries point at the reserved **sink block 0**, never
  handed to a stream: pad and frozen-lane writes land there and are
  never attended.
* **Attention** (``attn_impl``): ``gathered`` gathers each row's blocks
  ``pool[table]`` and attends over all ``max_blocks * block_size``
  positions under the causal mask, in plain PyTorch (the parity
  reference); ``fused`` calls ``ops.paged_attention``, which on the GPU
  is the CUDA kernel walking only ``ceil(len / block_size)`` blocks per
  stream.  Everything else is shared, so the two are an attention-only
  A/B with identical greedy tokens.
* **Writes** scatter at ``(table[pos // block_size], pos % block_size)``,
  one position per row at decode, a chunk at prefill (chunks may
  straddle blocks).

Every slot flows through the batched decode step, but live blocks are
written only by prefill chunks and active decode lanes: ``step()`` masks
every non-active slot's table row to the sink, and a finished or
evicted slot's table is zeroed before its blocks are freed.

Completion is detected from host-tracked positions (one per active slot
per step), so the decode loop reads nothing back from the device per
token; tokens are fetched once per request, when it finishes.

**Prefix caching + copy-on-write** (``prefix_cache=True``): a host-side
:class:`PrefixIndex` maps hash-chained token chunks at block granularity
to resident blocks; admission longest-matches a prompt and points its
table at the existing blocks (refcounted by :class:`BlockAllocator`).
A stream writes only blocks it owns: when a matched prefix ends inside a
block, the first write past it forks that block into one reserved at
admission (one on-device row copy).

**Block handoff** (disaggregated prefill/decode): :meth:`export_stream`
serializes a prefill-complete stream (per layer and pool tensor, base64
of the raw bytes of its ``blocks_for(p)`` block rows, plus the prompt
and the first sampled token) and :meth:`import_stream` admits it on
another server directly in the decoding state.  The wire format is the
JAX package's (``"v": 1``, numpy dtype names), so a payload crosses
between the two packages in either direction.
"""

from __future__ import annotations

import base64
import collections
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.generate import (_quantize_kv, _sample, attend_masked,
                               init_kv_cache)
from ..models.transformer import Transformer, layer_params, tensors
from ..ops.paged_attention import paged_attention
from ..utils.platform import DeviceLike, h2d, resolve_device

ATTN_IMPLS = ("gathered", "fused")

# block 0 is reserved: pad positions and frozen slots write here
SINK_BLOCK = 0

# pool dtypes by the numpy names the handoff geometry carries (the JAX
# package writes ``str(np.dtype(...))``)
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8"}
# segments of the import's one host buffer start at multiples of this,
# so each byte slice can be viewed as its pool's dtype
_WIRE_ALIGN = 16


def prefill_bucket(width: int) -> int:
    """The power-of-two width (minimum 8) a prefill chunk of ``width``
    tokens pads to, as in the JAX package (whose compiled programs were
    keyed on it; the port keeps the padding so both run the same math)."""
    b = 8
    while b < width:
        b *= 2
    return b


class BlockExhausted(RuntimeError):
    """The pool cannot supply the next block for one or more streams;
    carries the starving request ids so a scheduler can pick a victim."""

    def __init__(self, rids: List[int]):
        super().__init__(f"KV block pool exhausted; streams needing a "
                         f"block: {rids}")
        self.rids = list(rids)


class BlockAllocator:
    """Refcounted free-list allocator over block ids ``1..num_blocks-1``
    (0 is the sink).  A block is **in use** (refcount >= 1), **cached-
    free** (refcount 0 but holding prefix-cache content: allocatable, kept
    in LRU order and evicted under pressure through ``on_cache_evict``)
    or **plain free**.  Releasing a block with no references raises, and
    :meth:`assert_drained` pins every refcount at zero with the free
    balance equal to capacity."""

    def __init__(self, num_blocks: int,
                 on_cache_evict: Optional[Callable[[int], None]] = None):
        if num_blocks < 2:
            raise ValueError(f"num_blocks {num_blocks} < 2: block 0 is "
                             "the reserved sink, so a usable pool needs "
                             "at least one more")
        self.num_blocks = int(num_blocks)
        # pop from the tail -> ascending ids hand out first
        self._free = list(range(self.num_blocks - 1, 0, -1))
        # cached-free in release order: popitem(last=False) is LRU
        self._cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._cached_ids: set = set()   # blocks carrying a cache identity
        self._ref: Dict[int, int] = {}  # in-use refcounts (>= 1)
        self._on_cache_evict = on_cache_evict

    @property
    def capacity(self) -> int:
        """Usable blocks (the sink is not allocatable)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: plain free + cached-free."""
        return len(self._free) + len(self._cached)

    @property
    def used_blocks(self) -> int:
        return len(self._ref)

    @property
    def cached_free_blocks(self) -> int:
        return len(self._cached)

    @property
    def shared_extra(self) -> int:
        """Extra references across all shared blocks: the allocations
        sharing saves right now."""
        return sum(r - 1 for r in self._ref.values() if r > 1)

    def refcount(self, b: int) -> int:
        return self._ref.get(b, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh block ids at refcount 1, or None (all or nothing).
        Plain-free blocks go first, then cached-free ones LRU-first, their
        index entries invalidated through ``on_cache_evict``."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.free_blocks:
            return None
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._cached.popitem(last=False)   # LRU victim
                self._cached_ids.discard(b)
                if self._on_cache_evict is not None:
                    self._on_cache_evict(b)
            self._ref[b] = 1
            out.append(b)
        return out

    def share(self, b: int) -> None:
        """One more reader of an in-use block."""
        if b not in self._ref:
            raise ValueError(f"share of block {b} not in use")
        self._ref[b] += 1

    def reuse_cached(self, b: int) -> None:
        """Revive a cached-free block (refcount 0 -> 1)."""
        if b not in self._cached:
            raise ValueError(f"reuse_cached of block {b} not cached-free")
        del self._cached[b]
        self._ref[b] = 1

    def release(self, blocks: List[int]) -> None:
        """The single release path: drop one reference per listed block.
        At refcount 0 a block returns to the cached-free LRU when it
        carries prefix content, to the plain free list otherwise."""
        for b in blocks:
            r = self._ref.get(b)
            if r is None:
                raise ValueError(f"release of block {b} not in use "
                                 "(double free or foreign id)")
            if r > 1:
                self._ref[b] = r - 1
            else:
                del self._ref[b]
                if b in self._cached_ids:
                    self._cached[b] = None      # MRU end of the LRU queue
                else:
                    self._free.append(b)

    def mark_cached(self, b: int) -> None:
        """Tag a block as carrying prefix-cache content."""
        self._cached_ids.add(b)

    def assert_drained(self) -> None:
        if self._ref:
            raise AssertionError(
                "block leak: refcounts not drained after quiesce: "
                f"{dict(sorted(self._ref.items()))}")
        if len(self._free) + len(self._cached) != self.capacity:
            raise AssertionError(
                f"free-list balance {len(self._free)} plain + "
                f"{len(self._cached)} cached != capacity {self.capacity}")


class PrefixIndex:
    """Host-side prefix-cache index: hash-chained token chunks at block
    granularity -> resident block id.  A key is ``(parent_key,
    tokens_tuple)`` of the exact token ids, so a hit is never a hash
    collision.  One identity per block, at most one block per key (first
    writer wins); entries die when the allocator reclaims their block."""

    def __init__(self):
        self._map: Dict[Tuple, int] = {}
        self._key_of: Dict[int, Tuple] = {}
        # bumped on every mutation, so a lookup can be memoized on
        # (prompt, version)
        self.version = 0

    def __len__(self) -> int:
        return len(self._map)

    def get(self, key: Tuple) -> Optional[int]:
        return self._map.get(key)

    def insert(self, key: Tuple, block: int) -> bool:
        """Register ``block`` under ``key``; False when the key is taken
        or the block already carries another identity."""
        if key in self._map or block in self._key_of:
            return False
        self._map[key] = block
        self._key_of[block] = key
        self.version += 1
        return True

    def invalidate_block(self, block: int) -> None:
        key = self._key_of.pop(block, None)
        if key is not None and self._map.get(key) == block:
            del self._map[key]
            self.version += 1


def init_paged_kv(model: Transformer, num_blocks: int, block_size: int,
                  quant: bool = False, device: DeviceLike = None):
    """Per-layer pools ``(num_blocks, block_size, kv_heads, head_dim)`` in
    the compute dtype, or int8 plus f32 scale pools with ``quant``: the
    dense cache's buffers with blocks in place of batch rows."""
    return init_kv_cache(model, num_blocks, block_size, quant=quant,
                         device=device)


def _check_params_device(params, device: torch.device) -> None:
    for t in tensors(params):
        if t.device.type != device.type:
            raise ValueError(f"parameters on {t.device}, server on "
                             f"{device}")


@dataclass
class _Stream:
    """Host bookkeeping for one in-flight request."""
    rid: int
    prompt: List[int]
    max_new: int
    target: int                       # prompt_len + max_new
    blocks: List[int] = field(default_factory=list)
    prefilled: int = 0                # prompt tokens written so far
    # prefix-cache state: the leading n_shared table entries are borrowed
    # (read-only); fork_pending is the block reserved for the copy-on-
    # write fork of a borrowed partial tail; chain_key/registered_tokens
    # track how far this stream's own blocks are in the index
    n_shared: int = 0
    fork_pending: Optional[int] = None
    chain_key: Any = None
    registered_tokens: int = 0
    shared_at_admit: int = 0          # matched prefix tokens (stats)


class PagedDecodeServer:
    """Slot server over a paged KV pool: submit/step/done/result, plus
    the surface a scheduler drives — chunked prefill, on-demand block
    growth, eviction, and free-block/slot introspection.  Runs on
    ``device`` (default: cuda); ``params`` must already live there."""

    def __init__(self, model: Transformer, params, *, slots: int = 8,
                 num_blocks: int = 64, block_size: int = 16,
                 max_len: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 kv_quant: bool = False, attn_impl: str = "gathered",
                 prefix_cache: bool = False, device: DeviceLike = None):
        c = model.cfg
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.model, self.params = model, params
        # per-layer views of the tree (a stacked scan_layers tree unbinds)
        self.layers = layer_params(params)
        self.slots = int(slots)
        self.block_size = int(block_size)
        self.max_len = int(max_len or c.max_seq_len)
        if self.max_len > c.max_seq_len:
            raise ValueError(f"max_len {self.max_len} exceeds model "
                             f"max_seq_len {c.max_seq_len}")
        self.max_blocks = -(-self.max_len // self.block_size)   # ceil
        self.t_cap = self.max_blocks * self.block_size
        self.num_blocks = int(num_blocks)
        self.prefix_cache = bool(prefix_cache)
        self.prefix = PrefixIndex()
        self.allocator = BlockAllocator(
            self.num_blocks,
            on_cache_evict=self._on_cache_evict if self.prefix_cache
            else None)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens_admitted = 0
        self.cow_forks = 0
        self.cache_evictions = 0
        self.blocks_shared_total = 0
        # forward passes run (each runs attention once per layer)
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.handoffs_exported = 0
        self.handoffs_imported = 0
        self._lookup_memo = None      # (prompt, index-version) -> walk
        self._sampling = (float(temperature), int(top_k), float(top_p))
        self.kv_quant = bool(kv_quant)
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {attn_impl!r}")
        self.attn_impl = attn_impl
        dev = self.device
        self.pools = init_paged_kv(model, self.num_blocks, self.block_size,
                                   quant=self.kv_quant, device=dev)
        self.tokens = torch.zeros((self.slots, self.t_cap), dtype=torch.long,
                                  device=dev)
        self.pos = torch.zeros((self.slots,), dtype=torch.long, device=dev)
        self.tables = np.zeros((self.slots, self.max_blocks), np.int32)
        self.active = np.zeros((self.slots,), bool)     # decoding slots
        self._pos_host = np.zeros((self.slots,), np.int64)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(int(seed))
        self._rid = 0
        self._streams: Dict[int, _Stream] = {}
        self._slot_of: Dict[int, int] = {}
        self._results: Dict[int, List[int]] = {}

    # ---- the forward pass (JAX: _paged_programs) ----------------------
    def _attend(self, pool, q, k, v, tables: torch.Tensor,
                starts: torch.Tensor, positions: torch.Tensor,
                blk: torch.Tensor, off: torch.Tensor, lengths: torch.Tensor):
        """Scatter the chunk's K/V into one layer's pool in place at
        ``(blk, off)``, then attend through ``tables``: the CUDA kernel
        (``fused``) or a gather of every table entry (``gathered``)."""
        c = self.model.cfg
        quant = "k_scale" in pool
        if quant:
            k, ks = _quantize_kv(k)
            v, vs = _quantize_kv(v)
            pool["k_scale"][blk, off] = ks
            pool["v_scale"][blk, off] = vs
        pool["k"][blk, off] = k.to(pool["k"].dtype)
        pool["v"][blk, off] = v.to(pool["v"].dtype)
        if self.attn_impl == "fused":
            return paged_attention(q, pool["k"], pool["v"], tables, lengths,
                                   starts.int(), k_scale=pool.get("k_scale"),
                                   v_scale=pool.get("v_scale"))
        idx = tables.long()
        shape = (q.shape[0], self.t_cap, c.kv_heads)
        mask = (torch.arange(self.t_cap, device=q.device)[None, None, :]
                <= positions[:, :, None])               # (B, W, T_cap)
        return attend_masked(
            c, q, pool["k"][idx].reshape(*shape, c.head_dim),
            pool["v"][idx].reshape(*shape, c.head_dim), mask,
            pool["k_scale"][idx].reshape(shape) if quant else None,
            pool["v_scale"][idx].reshape(shape) if quant else None)

    def _forward(self, ids, tables, starts, valid, lengths) -> torch.Tensor:
        """ids (B, W) whose rows start at per-row ``starts`` -> f32 logits
        (B, W, vocab), pools written in place.  ``valid`` (W,) sends pad
        columns' writes to the sink; ``lengths`` (B,) is each row's
        attendable-key count (0 = inactive lane).  Embedding positions are
        clamped into the table (pad columns past ``max_seq_len`` are
        discarded anyway)."""
        model, bs = self.model, self.block_size
        positions = starts[:, None] + torch.arange(ids.shape[1],
                                                   device=ids.device)
        # each position resolves its own block through the row's table;
        # pad columns (which may run past the table) land in the sink
        blk = torch.gather(tables, 1,
                           (positions // bs).clamp(max=self.max_blocks - 1))
        blk = torch.where(valid[None, :], blk, SINK_BLOCK).long()
        off = torch.where(valid[None, :], positions % bs, 0)
        x = model.embed(self.params, ids,
                        positions.clamp(max=model.cfg.max_seq_len - 1))
        for layer, pool in zip(self.layers, self.pools):

            def attend(q, k, v, pool=pool):
                return self._attend(pool, q, k, v, tables, starts, positions,
                                    blk, off, lengths)

            x = model.block(layer, x, positions, attend)
        return model.head_logits(self.params, x)

    # ---- geometry ------------------------------------------------------
    def blocks_for(self, length: int) -> int:
        """Blocks needed to hold ``length`` cache positions."""
        return -(-int(length) // self.block_size)

    def free_slots(self) -> int:
        return self.slots - len(self._slot_of)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def block_utilization(self) -> float:
        cap = self.allocator.capacity
        return self.allocator.used_blocks / cap if cap else 0.0

    def keys_accounting(self) -> Dict[str, int]:
        """Key positions of the NEXT decode step, from host state:
        ``attended_keys`` is what the math needs (sum of pos+1 over active
        lanes), ``kernel_keys`` what the fused kernel walks (whole
        blocks), ``padded_keys`` what the gathered path reduces over
        (t_cap per active lane)."""
        att = kern = n_active = 0
        for slot in self._slot_of.values():
            if not self.active[slot]:
                continue
            ln = int(self._pos_host[slot]) + 1
            att += ln
            kern += -(-ln // self.block_size) * self.block_size
            n_active += 1
        return {"attended_keys": att,
                "kernel_keys": kern,
                "padded_keys": n_active * self.t_cap,
                "active_streams": n_active}

    # ---- prefix cache --------------------------------------------------
    def _on_cache_evict(self, block: int) -> None:
        """A cached-free block is reclaimed: its identity dies with it."""
        self.prefix.invalidate_block(block)
        self.cache_evictions += 1

    def _prefix_lookup(self, prompt_ids: List[int]
                       ) -> Tuple[List[Tuple[int, int]], Any, int]:
        """Longest prefix match: ``(entries, chain_key, matched_len)``
        with ``entries = [(block, used_tokens), ...]`` and ``matched_len
        <= len(prompt) - 1`` (the last prompt token is always prefilled so
        its logits seed the first sampled token).  Memoized on (prompt,
        index version)."""
        key = (tuple(prompt_ids), self.prefix.version)
        if self._lookup_memo is not None and self._lookup_memo[0] == key:
            return self._lookup_memo[1]
        out = self._prefix_walk(prompt_ids)
        self._lookup_memo = (key, out)
        return out

    def _prefix_walk(self, prompt_ids: List[int]
                     ) -> Tuple[List[Tuple[int, int]], Any, int]:
        p = len(prompt_ids)
        cap = p - 1             # never match the final prompt token
        bs = self.block_size
        entries: List[Tuple[int, int]] = []
        chain: Any = None
        off = 0
        while off + bs <= cap:
            key = (chain, tuple(prompt_ids[off:off + bs]))
            b = self.prefix.get(key)
            if b is None:
                break
            entries.append((b, bs))
            chain = key
            off += bs
        # partial tail: the longest registered chunk prefixing the rest
        for length in range(min(bs, p - off), 0, -1):
            b = self.prefix.get((chain, tuple(prompt_ids[off:off + length])))
            if b is not None:
                usable = min(length, cap - off)
                if usable > 0:
                    entries.append((b, usable))
                    off += usable
                break
        return entries, chain, off

    def admit_need(self, prompt_ids, max_new_tokens: int,
                   full_residency: bool = False) -> int:
        """Free blocks :meth:`try_admit` would consume now: prompt+1 (or
        the full residency with ``full_residency``) minus matched prefix
        blocks in use, plus the reserved CoW fork block for a mid-block
        match."""
        prompt_ids = [int(t) for t in prompt_ids]
        p = len(prompt_ids)
        base = self.blocks_for(p + max_new_tokens if full_residency
                               else p + 1)
        if not self.prefix_cache:
            return base
        entries, _, matched_len = self._prefix_lookup(prompt_ids)
        n_in_use = sum(1 for b, _ in entries
                       if self.allocator.refcount(b) > 0)
        fork = 1 if matched_len % self.block_size else 0
        return max(0, base - n_in_use + fork)

    def prefix_stats(self) -> Dict[str, int]:
        return {
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens_admitted": self.prompt_tokens_admitted,
            "cow_forks": self.cow_forks,
            "cache_evictions": self.cache_evictions,
            "blocks_saved": self.blocks_shared_total,
            "shared_blocks": self.allocator.shared_extra,
            "cached_free_blocks": self.allocator.cached_free_blocks,
        }

    def shared_token_discount(self) -> int:
        """Upper bound on committed tokens double-counted by sharing."""
        return self.allocator.shared_extra * self.block_size

    # ---- admission -----------------------------------------------------
    def check_request(self, prompt_len: int, max_new_tokens: int) -> None:
        """Raise for a request this server could never hold."""
        if prompt_len == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens {max_new_tokens} < 1")
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {prompt_len} + {max_new_tokens} "
                             f"exceeds server max_len {self.max_len}")
        total_need = self.blocks_for(prompt_len + max_new_tokens)
        if total_need > self.allocator.capacity:
            raise ValueError(
                f"request needs {total_need} blocks but the pool only "
                f"has {self.allocator.capacity}: unservable at any load")

    def try_admit(self, prompt_ids, max_new_tokens: int) -> Optional[int]:
        """Reserve a slot + the blocks covering the prompt and the first
        generated token (prefix-matched blocks are shared instead); no
        model compute happens here.  Returns a request id, or None when a
        slot or the blocks are unavailable.  Raises for a request this
        server could never hold."""
        prompt_ids = [int(t) for t in prompt_ids]
        p = len(prompt_ids)
        self.check_request(p, max_new_tokens)
        if not self.free_slots():
            return None
        entries: List[Tuple[int, int]] = []
        chain: Any = None
        matched_len = 0
        if self.prefix_cache:
            entries, chain, matched_len = self._prefix_lookup(prompt_ids)
        partial = matched_len % self.block_size != 0
        need_fresh = (self.blocks_for(p + 1) - len(entries)
                      + (1 if partial else 0))
        n_reuse = sum(1 for b, _ in entries
                      if self.allocator.refcount(b) == 0)
        if need_fresh + n_reuse > self.allocator.free_blocks:
            return None
        # pin the matched blocks first so the fresh allocation's LRU
        # eviction can never reclaim one of them
        self._pin(entries)
        fresh = self.allocator.alloc(need_fresh) if need_fresh else []
        assert fresh is not None    # capacity checked above
        fork_reserve = fresh.pop() if partial else None
        if matched_len:
            self.prefix_hits += 1
            self.prefix_hit_tokens += matched_len
            self.blocks_shared_total += len(entries)
        elif self.prefix_cache:
            self.prefix_misses += 1
        self.prompt_tokens_admitted += p
        blocks = [b for b, _ in entries] + fresh
        n_full = len(entries) - (1 if partial else 0)
        slot = next(s for s in range(self.slots)
                    if s not in self._slot_of.values())
        rid = self._rid
        self._rid += 1
        self._streams[rid] = _Stream(
            rid=rid, prompt=prompt_ids, max_new=int(max_new_tokens),
            target=p + int(max_new_tokens), blocks=blocks,
            prefilled=matched_len, n_shared=len(entries),
            fork_pending=fork_reserve, chain_key=chain,
            registered_tokens=n_full * self.block_size,
            shared_at_admit=matched_len)
        self._slot_of[rid] = slot
        self.tables[slot, :] = SINK_BLOCK
        self.tables[slot, :len(blocks)] = blocks
        row = np.zeros((self.t_cap,), np.int64)
        row[:p] = prompt_ids
        self.tokens[slot] = h2d(row, self.device)
        self.pos[slot] = 0
        self._pos_host[slot] = 0
        self.active[slot] = False
        return rid

    def prefill_remaining(self, rid: int) -> int:
        """Prompt tokens not yet prefilled (0 = the stream is decoding)."""
        st = self._streams[rid]
        return len(st.prompt) - st.prefilled

    @torch.no_grad()
    def prefill_step(self, rid: int, width: int) -> bool:
        """Advance ``rid``'s prefill by up to ``width`` prompt tokens (one
        chunk, padded to :func:`prefill_bucket`).  On the final chunk,
        samples the first output token and activates the stream.  Returns
        True when prefill is complete."""
        st = self._streams[rid]
        slot = self._slot_of[rid]
        p = len(st.prompt)
        # late match: streams admitted in one burst before any of them
        # registered a block retry the index at their first chunk
        if (self.prefix_cache and st.prefilled == 0
                and st.n_shared == 0):
            self._rematch_prefix(st, slot)
        remaining = p - st.prefilled
        if remaining <= 0:
            return True
        w = min(int(width), remaining)
        if w < 1:
            raise ValueError(f"prefill width {width} < 1")
        # copy-on-write: fork the borrowed partial block before the first
        # write past the shared boundary lands in it
        if (st.fork_pending is not None
                and st.prefilled // self.block_size < st.n_shared):
            self._cow_fork(st, slot)
        assert st.prefilled // self.block_size >= st.n_shared, (
            f"prefill would write shared block of rid={rid}: "
            f"pos {st.prefilled} inside the first {st.n_shared} "
            "borrowed table entries")
        bucket = prefill_bucket(w)
        chunk = st.prompt[st.prefilled:st.prefilled + w] + [0] * (bucket - w)
        dev = self.device
        start = st.prefilled
        # attendable keys after this chunk: everything up to start + w
        # (pad columns wrote to the sink)
        logits = self._forward(
            h2d(np.asarray([chunk], np.int64), dev),
            h2d(self.tables[slot:slot + 1], dev),
            h2d(np.asarray([start], np.int64), dev),
            torch.arange(bucket, device=dev) < w,
            h2d(np.asarray([start + w], np.int32), dev))
        self.prefill_chunks += 1
        st.prefilled += w
        self._register_prefix(st, final=st.prefilled >= p)
        if st.prefilled < p:
            return False
        t, tk, tp = self._sampling
        first = _sample(logits[:, w - 1], t, self.generator, tk, tp)
        self.tokens[slot, p] = first[0]
        self.pos[slot] = p
        self._pos_host[slot] = p
        self.active[slot] = st.max_new > 1
        if st.max_new <= 1:
            self._finish(rid)
        return True

    def _cow_fork(self, st: _Stream, slot: int) -> None:
        """Copy the borrowed partial tail block into the reserved block
        (every layer's pools, one row copy each), repoint the table entry
        and drop the share."""
        idx = st.n_shared - 1
        src, dst = st.blocks[idx], st.fork_pending
        for pool in self.pools:
            for t in pool.values():
                t[dst].copy_(t[src])
        st.blocks[idx] = dst
        # repoint before releasing the share: once the table stops naming
        # src, this stream can never touch it again
        self.tables[slot, idx] = dst
        st.fork_pending = None
        st.n_shared = idx
        self.allocator.release([src])
        self.cow_forks += 1

    def _pin(self, entries: List[Tuple[int, int]]) -> None:
        """One more reference on each matched block: a share of an in-use
        block, a revival of a cached-free one."""
        for b, _ in entries:
            if self.allocator.refcount(b) > 0:
                self.allocator.share(b)
            else:
                self.allocator.reuse_cached(b)

    def _rematch_prefix(self, st: _Stream, slot: int) -> None:
        """Retry the prefix lookup for a stream that matched nothing at
        admission: point its leading table entries at the now-indexed
        blocks and release the fresh blocks they displace (keeping one as
        the fork reserve for a mid-block match)."""
        entries, chain, matched_len = self._prefix_lookup(st.prompt)
        if not matched_len:
            return
        partial = matched_len % self.block_size != 0
        n = len(entries)
        self._pin(entries)
        displaced = st.blocks[:n]
        st.blocks[:n] = [b for b, _ in entries]
        st.fork_pending = displaced.pop() if partial else None
        self.allocator.release(displaced)
        self.tables[slot, :len(st.blocks)] = st.blocks
        st.n_shared = n
        st.chain_key = chain
        st.prefilled = matched_len
        st.registered_tokens = (n - (1 if partial else 0)) * self.block_size
        st.shared_at_admit = matched_len
        self.prefix_misses -= 1
        self.prefix_hits += 1
        self.prefix_hit_tokens += matched_len
        self.blocks_shared_total += n

    def _register_prefix(self, st: _Stream, final: bool) -> None:
        """Publish this stream's owned, fully written prompt blocks into
        the index: every full block covered by ``prefilled``, plus the
        partial tail once the prompt is complete."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        p = len(st.prompt)
        while st.registered_tokens + bs <= st.prefilled:
            off = st.registered_tokens
            key = (st.chain_key, tuple(st.prompt[off:off + bs]))
            if off // bs >= st.n_shared:
                b = st.blocks[off // bs]
                if self.prefix.insert(key, b):
                    self.allocator.mark_cached(b)
            st.chain_key = key
            st.registered_tokens = off + bs
        if final and st.registered_tokens < p:
            off = st.registered_tokens
            key = (st.chain_key, tuple(st.prompt[off:p]))
            if off // bs >= st.n_shared:
                b = st.blocks[off // bs]
                if self.prefix.insert(key, b):
                    self.allocator.mark_cached(b)

    # ---- block growth / eviction --------------------------------------
    def needs_block(self) -> List[int]:
        """Rids of active streams whose next decode write crosses into an
        unallocated block."""
        out = []
        for rid, slot in self._slot_of.items():
            if not self.active[slot]:
                continue
            nxt = int(self._pos_host[slot]) + 1
            if nxt < self.t_cap and \
                    nxt // self.block_size >= len(self._streams[rid].blocks):
                out.append(rid)
        return out

    def ensure_blocks(self) -> List[int]:
        """Grow every stream that needs its next block; returns the rids
        the pool could not satisfy."""
        short = []
        for rid in self.needs_block():
            got = self.allocator.alloc(1)
            if got is None:
                short.append(rid)
                continue
            st = self._streams[rid]
            slot = self._slot_of[rid]
            self.tables[slot, len(st.blocks)] = got[0]
            st.blocks.extend(got)
        return short

    def _release_stream(self, st: _Stream, slot: int) -> None:
        """The single stream-release path: zero the table to the sink
        first, then drop one reference per block (and the unused fork
        reserve)."""
        self.tables[slot, :] = SINK_BLOCK
        rel = list(st.blocks)
        if st.fork_pending is not None:
            rel.append(st.fork_pending)
            st.fork_pending = None
        st.blocks = []
        self.allocator.release(rel)
        self.active[slot] = False

    def evict(self, rid: int):
        """Preempt ``rid``: release its blocks and forget the stream.
        Returns ``(prompt_ids, max_new_tokens)`` for the caller to
        requeue; greedy re-runs reproduce the discarded tokens."""
        st = self._streams.pop(rid)
        slot = self._slot_of.pop(rid)
        self._release_stream(st, slot)
        return list(st.prompt), st.max_new

    # ---- block handoff (disaggregated prefill/decode) -----------------
    def _handoff_geometry(self) -> Dict[str, Any]:
        """The pool facts both sides of a handoff must agree on byte for
        byte; static server config, so a mismatch is a deployment error
        (raise), never a transient to retry."""
        return {
            "block_size": self.block_size,
            "n_layers": len(self.pools),
            "kv_heads": int(self.model.cfg.kv_heads),
            "head_dim": int(self.model.cfg.head_dim),
            "kv_quant": self.kv_quant,
            "dtype": _WIRE_DTYPES[self.pools[0]["k"].dtype],
        }

    @torch.no_grad()
    def export_stream(self, rid: int) -> Dict[str, Any]:
        """Serialize a prefill-complete stream for handoff to a decode
        server: per layer and pool tensor (K, V and the int8 scale pools
        alike) base64 of the raw bytes of the ``blocks_for(p)`` block rows
        holding prompt positions ``0..p-1``, the prompt and the first
        sampled token.  The rows and the token cross to the host in one
        transfer.  Read-only: the stream stays here until the caller
        releases it (``evict``).  Raises for a stream whose prefill is not
        complete."""
        st = self._streams[rid]
        slot = self._slot_of[rid]
        p = len(st.prompt)
        if st.prefilled < p:
            raise ValueError(
                f"export of rid={rid} with prefill incomplete "
                f"({st.prefilled}/{p}): handoff happens at the "
                "prefill->decode boundary only")
        n_copy = self.blocks_for(p)
        idx = torch.as_tensor(st.blocks[:n_copy], dtype=torch.long,
                              device=self.device)
        parts = [self.tokens[slot, p:p + 1].view(torch.uint8)]
        for pool in self.pools:
            parts += [t.index_select(0, idx).view(torch.uint8).reshape(-1)
                      for t in pool.values()]
        host = torch.cat(parts).cpu().numpy()
        first_token = int(host[:8].view(np.int64)[0])
        off = 8
        layers = []
        for pool in self.pools:
            rec = {}
            for name, t in pool.items():
                n = n_copy * t[0].numel() * t.element_size()
                rec[name] = base64.b64encode(
                    host[off:off + n].tobytes()).decode("ascii")
                off += n
            layers.append(rec)
        self.handoffs_exported += 1
        return {
            "v": 1,
            "prompt": list(st.prompt),
            "max_new": int(st.max_new),
            "first_token": first_token,
            "n_blocks": n_copy,
            "geom": self._handoff_geometry(),
            "layers": layers,
        }

    @torch.no_grad()
    def import_stream(self, payload: Dict[str, Any]) -> Optional[int]:
        """Admit a handed-off stream directly in the decoding state:
        allocate fresh blocks, write the exported rows into them (one host
        buffer, one transfer, one ``index_copy_`` per pool tensor),
        rebuild the token row (prompt + first sampled token) and register
        the prompt blocks in the local prefix index, so later prompts
        sharing the prefix hit the cache here.  Returns a request id, or
        None when a slot or the blocks are unavailable (nothing used).
        Raises on a geometry mismatch, a malformed payload or a request
        this server could never hold."""
        geom = dict(payload["geom"])
        mine = self._handoff_geometry()
        if geom != mine:
            raise ValueError(f"handoff geometry mismatch: exporter "
                             f"{geom} vs importer {mine}")
        prompt_ids = [int(t) for t in payload["prompt"]]
        max_new = int(payload["max_new"])
        p = len(prompt_ids)
        self.check_request(p, max_new)
        n_copy = int(payload["n_blocks"])
        if n_copy != self.blocks_for(p):
            raise ValueError(f"handoff carries {n_copy} blocks, prompt "
                             f"of {p} needs {self.blocks_for(p)}")
        if len(payload["layers"]) != len(self.pools):
            raise ValueError(f"handoff carries {len(payload['layers'])} "
                             f"layers, the server has {len(self.pools)}")
        if not self.free_slots():
            return None
        # decode every segment into one aligned host buffer, each at its
        # pool's row shape; a short or long buffer is a hard error
        segs, total = [], 0
        for li, rec in enumerate(payload["layers"]):
            pool = self.pools[li]
            if set(rec) != set(pool):
                raise ValueError(f"handoff layer {li} carries "
                                 f"{sorted(rec)}, the pool {sorted(pool)}")
            for name, t in pool.items():
                raw = base64.b64decode(rec[name])
                want = n_copy * t[0].numel() * t.element_size()
                if len(raw) != want:
                    raise ValueError(f"handoff layer {li} {name}: "
                                     f"{len(raw)} bytes, expected {want}")
                segs.append((li, name, total, raw))
                total += -(-want // _WIRE_ALIGN) * _WIRE_ALIGN
        blocks = self.allocator.alloc(self.blocks_for(p + 1))
        if blocks is None:
            return None
        buf = np.zeros((total,), np.uint8)
        for _, _, off, raw in segs:
            buf[off:off + len(raw)] = np.frombuffer(raw, np.uint8)
        dev_buf = h2d(buf, self.device)
        idx = h2d(np.asarray(blocks[:n_copy], np.int64), self.device)
        for li, name, off, raw in segs:
            t = self.pools[li][name]
            rows = dev_buf[off:off + len(raw)].view(t.dtype).view(
                (n_copy,) + tuple(t.shape[1:]))
            t.index_copy_(0, idx, rows)
        rid = self._rid
        self._rid += 1
        st = _Stream(rid=rid, prompt=prompt_ids, max_new=max_new,
                     target=p + max_new, blocks=blocks, prefilled=p)
        slot = next(s for s in range(self.slots)
                    if s not in self._slot_of.values())
        self._streams[rid] = st
        self._slot_of[rid] = slot
        self.tables[slot, :] = SINK_BLOCK
        self.tables[slot, :len(blocks)] = blocks
        row = np.zeros((self.t_cap,), np.int64)
        row[:p] = prompt_ids
        row[p] = int(payload["first_token"])
        self.tokens[slot] = h2d(row, self.device)
        self.pos[slot] = p
        self._pos_host[slot] = p
        self.active[slot] = max_new > 1
        self.prompt_tokens_admitted += p
        self.handoffs_imported += 1
        self._register_prefix(st, final=True)
        if max_new <= 1:
            # a single-token request is already complete (the prefill
            # side normally finishes these without a handoff)
            self._finish(rid)
        return rid

    # ---- decode --------------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[int]:
        """One batched decode step across all slots; returns the rids that
        finished.  Completion comes from host position counters.  Raises
        :class:`BlockExhausted` when a stream's next write has no block."""
        if not self.active.any():
            return []
        short = self.ensure_blocks()
        if short:
            raise BlockExhausted(short)
        for rid, slot in self._slot_of.items():
            if self.active[slot]:
                st = self._streams[rid]
                assert (int(self._pos_host[slot]) // self.block_size
                        >= st.n_shared), (
                    f"decode would write shared block of rid={rid}")
        dev = self.device
        # non-active lanes (free, finished, mid-prefill) see an all-sink
        # table: their writes land in the sink, their reads are discarded
        masked = np.where(self.active[:, None], self.tables, SINK_BLOCK)
        active = h2d(self.active, dev)
        tables = h2d(masked.astype(np.int32), dev)
        pos = self.pos
        ids = torch.gather(self.tokens, 1, pos[:, None])
        # a decode row attends its own fresh write too: pos + 1 keys;
        # inactive lanes carry length 0 (the kernel walks none of their
        # blocks)
        lengths = torch.where(active, pos + 1, 0).int()
        logits = self._forward(ids, tables, pos,
                               torch.ones(1, dtype=torch.bool, device=dev),
                               lengths)
        self.decode_steps += 1
        t, tk, tp = self._sampling
        nxt = _sample(logits[:, 0], t, self.generator, tk, tp)
        write_at = (pos + 1).clamp(max=self.t_cap - 1)
        # frozen slots re-write the token already there and hold position
        nxt = torch.where(active, nxt,
                          torch.gather(self.tokens, 1, write_at[:, None])[:, 0])
        self.tokens[torch.arange(self.slots, device=dev), write_at] = nxt
        self.pos = torch.where(active, write_at, pos)
        finished = []
        for rid, slot in list(self._slot_of.items()):
            if not self.active[slot]:
                continue
            self._pos_host[slot] += 1
            if self._pos_host[slot] + 1 >= self._streams[rid].target:
                self._finish(rid)
                finished.append(rid)
        return finished

    def _finish(self, rid: int) -> None:
        st = self._streams.pop(rid)
        slot = self._slot_of.pop(rid)
        self._results[rid] = self.tokens[slot, :st.target].tolist()
        self._release_stream(st, slot)

    # ---- results -------------------------------------------------------
    def done(self, rid: int) -> bool:
        if rid in self._results:
            return True
        if rid in self._streams:
            return False
        raise KeyError(f"request {rid}: unknown or already consumed")

    def result(self, rid: int) -> List[int]:
        """Prompt + generated ids for a finished request (pops it)."""
        return self._results.pop(rid)

    def live(self) -> int:
        return len(self._streams)

    def any_active(self) -> bool:
        return bool(self.active.any())
