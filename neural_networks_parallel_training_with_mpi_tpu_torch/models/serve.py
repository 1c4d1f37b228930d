"""Continuous-batching decode server over the dense KV cache: the port of
the JAX package's ``models/serve.py`` (``DecodeServer``).

A fixed pool of ``slots`` decodes as one batched step per token while
requests join and leave mid-flight:

* Device state: per-layer KV caches ``(S, max_len, kv_heads, head_dim)``
  (int8 codes plus f32 scales under ``kv_quant``), a token ring
  ``(S, max_len)`` and per-slot ``pos``.
* ``submit()`` prefills the prompt, padded to a power-of-two bucket (in
  chunks of ``prefill_chunk`` when set), on a batch-1 cache, samples the
  first token and copies the cache into a free slot.
* ``step()`` advances every slot one token
  (:func:`models.generate._forward_token_batched`): each row attends at
  its own depth and writes its K/V at its own position.  Free and
  finished slots still flow through the batch (their writes land in
  their own rows and their samples are discarded) and are overwritten by
  the next ``submit``.  Completion is detected from host-tracked
  positions, so ``step()`` reads nothing back from the device per token;
  ``sync_per_step=True`` reads the positions back every step, to measure
  what that costs.
* Greedy decode gives ``generate()``'s tokens per request.

Attention here is the plain dense path, as in the JAX package; the paged
server (``serve.paged_kv``) is the one that runs the paged kernel.

Host API::

    srv = DecodeServer(model, params, slots=4)
    rid = srv.submit([1, 2, 3], max_new_tokens=16)   # None if pool full
    while not srv.done(rid):
        srv.step()
    tokens = srv.result(rid)                          # prompt + decoded
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.platform import DeviceLike, h2d, resolve_device
from .generate import (_forward_chunk, _forward_token_batched, _sample,
                       init_kv_cache)
from .transformer import Transformer, layer_params, tensors


class DecodeServer:
    """Slot-based continuous batching on the dense KV-cache decoder.  Runs
    on ``device`` (default: cuda); ``params`` must already live there."""

    def __init__(self, model: Transformer, params, slots: int = 4,
                 max_len: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 kv_quant: bool = False, prefill_chunk: int = 0,
                 sync_per_step: bool = False, device: DeviceLike = None):
        c = model.cfg
        self.device = dev = resolve_device(device)
        for t in tensors(params):
            if t.device.type != dev.type:
                raise ValueError(f"parameters on {t.device}, server on "
                                 f"{dev}")
        self.model, self.params = model, params
        # per-layer views of the tree (a stacked scan_layers tree unbinds)
        self.layers = layer_params(params)
        self.slots = int(slots)
        self.max_len = int(max_len or c.max_seq_len)
        if self.max_len > c.max_seq_len:
            raise ValueError(f"max_len {self.max_len} exceeds model "
                             f"max_seq_len {c.max_seq_len}")
        self._sampling = (float(temperature), int(top_k), float(top_p))
        self.kv_quant = bool(kv_quant)
        self.prefill_chunk = int(prefill_chunk)
        self.caches = init_kv_cache(model, self.slots, self.max_len,
                                    quant=self.kv_quant, device=dev)
        self.tokens = torch.zeros((self.slots, self.max_len),
                                  dtype=torch.long, device=dev)
        self.pos = torch.zeros((self.slots,), dtype=torch.long, device=dev)
        self.active = np.zeros((self.slots,), bool)      # host-side
        # host shadow of ``pos``: positions advance by one per active slot
        # per step, so completion detection needs no device read
        self._pos_host = np.zeros((self.slots,), np.int64)
        self._sync_per_step = bool(sync_per_step)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(int(seed))
        # slot -> (request id, prompt_len, target total length)
        self._rid = 0
        self._slot_req: Dict[int, tuple] = {}
        self._results: Dict[int, List[int]] = {}

    # ---- admission ----------------------------------------------------
    @torch.no_grad()
    def _prefill(self, prompt: torch.Tensor) -> tuple:
        """(1, P_bucket) ids -> (f32 logits (1, P_bucket, vocab), a batch-1
        cache holding their K/V).  Pad positions' K/V land in the cache but
        are never attended: decode overwrites positions p, p+1, ... before
        each becomes visible."""
        cache = init_kv_cache(self.model, 1, self.max_len,
                              quant=self.kv_quant, device=self.device)
        pb = prompt.shape[1]
        width = self.prefill_chunk if 0 < self.prefill_chunk < pb else pb
        logits = torch.cat([
            _forward_chunk(self.model, self.params, cache,
                           prompt[:, off:off + width], off)
            for off in range(0, pb, width)], dim=1)
        return logits, cache

    @torch.no_grad()
    def submit(self, prompt_ids, max_new_tokens: int) -> Optional[int]:
        """Admit a request into a free slot; returns a request id, or None
        when the pool is full (the caller queues and retries after
        ``step()``s complete requests)."""
        free = [s for s in range(self.slots) if not self.active[s]
                and s not in self._slot_req]
        if not free:
            return None
        p = len(prompt_ids)
        if p == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "token (a bucketed prefill would otherwise "
                             "sample from pad-position logits)")
        if p + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {p} + {max_new_tokens} exceeds "
                             f"server max_len {self.max_len}")
        slot = free[0]
        bucket = 8
        while bucket < p:
            bucket *= 2
        bucket = min(bucket, self.max_len)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :p] = prompt_ids
        logits, slab = self._prefill(h2d(padded, self.device))
        t, tk, tp = self._sampling
        first = _sample(logits[:, p - 1], t, self.generator, tk, tp)
        for pool, one in zip(self.caches, slab):
            for name, buf in pool.items():
                buf[slot] = one[name][0]
        row = np.zeros((self.max_len,), np.int64)
        row[:p] = prompt_ids
        self.tokens[slot] = h2d(row, self.device)
        self.tokens[slot, p] = first[0]
        self.pos[slot] = p                       # last written position
        self._pos_host[slot] = p
        self.active[slot] = max_new_tokens > 1
        rid = self._rid
        self._rid += 1
        self._slot_req[slot] = (rid, p, p + max_new_tokens)
        if not self.active[slot]:                # single-token request
            self._finish(slot)
        return rid

    # ---- decode -------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        """One batched decode step across all slots (no-op when nothing
        is active)."""
        if not self.active.any():
            return
        active = h2d(self.active, self.device)
        pos = self.pos
        ids = torch.gather(self.tokens, 1, pos[:, None])
        logits = _forward_token_batched(self.model, self.params, self.layers,
                                        self.caches, ids, pos)
        t, tk, tp = self._sampling
        nxt = _sample(logits[:, 0], t, self.generator, tk, tp)
        write_at = (pos + 1).clamp(max=self.max_len - 1)
        # only active slots append and advance; frozen slots re-write the
        # token already there and hold position
        nxt = torch.where(active, nxt,
                          torch.gather(self.tokens, 1, write_at[:, None])[:, 0])
        self.tokens[torch.arange(self.slots, device=self.device),
                    write_at] = nxt
        self.pos = torch.where(active, write_at, pos)
        if self._sync_per_step:
            # measurement only: read the positions back every step
            self._pos_host[:] = self.pos.cpu().numpy()
        else:
            # an active slot finishes at target <= max_len before the
            # device's clamp could make the shadow diverge
            self._pos_host[self.active] += 1
        for slot, (rid, p, target) in list(self._slot_req.items()):
            if self.active[slot] and self._pos_host[slot] + 1 >= target:
                self._finish(slot)

    def _finish(self, slot: int) -> None:
        rid, p, target = self._slot_req.pop(slot)
        self._results[rid] = self.tokens[slot, :target].tolist()
        self.active[slot] = False

    # ---- results ------------------------------------------------------
    def done(self, rid: int) -> bool:
        """True once ``rid`` finished; raises KeyError for an id this
        server never issued or whose result was already consumed, so a
        ``while not done(rid)`` loop on a stale id fails instead of
        spinning."""
        if rid in self._results:
            return True
        if any(r == rid for r, _, _ in self._slot_req.values()):
            return False
        raise KeyError(f"request {rid}: unknown or already consumed")

    def result(self, rid: int) -> List[int]:
        """Prompt + generated ids for a finished request (pops it)."""
        return self._results.pop(rid)

    def live(self) -> int:
        """Number of in-flight requests."""
        return len(self._slot_req)
