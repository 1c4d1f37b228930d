"""Sharded batch loader, the port of the JAX package's ``data/loader.py``.

One host-side iterator per rank that

* honors a real ``batch_size`` (``full_batch=True`` is the reference's one
  whole-shard batch per epoch),
* shuffles with the JAX loader's per-epoch order
  (``np.random.default_rng((seed, epoch[, order_salt]))``), so both
  packages walk the same samples in the same order,
* pads the final/uneven global batch to a multiple of the world size with
  a validity mask (or drops it), and
* hands rank ``r`` the contiguous rows ``r*n/W .. (r+1)*n/W`` of the padded
  global batch — the rows dim-0 sharding over the batch axes gives device
  ``r`` in the JAX package (data x fsdp, and x expert on the expert
  layouts, whose shards each carry their own rows: the trainer passes
  ``World.batch_rank`` / ``batch_shards``) — placed on the device through
  ``utils.platform.h2d`` (pinned, no stream sync),
* under sequence parallelism (``sp > 1``) then hands sequence rank ``s``
  the contiguous columns ``s*T/sp .. (s+1)*T/sp`` of every rank >= 2
  array (the per-row ``mask`` stays whole), as the JAX package's
  ``parallel/spmd.py`` ``batch_specs`` shard dim 1 over ``seq``; here
  ``rank``/``world_size`` are the data rank and the data-parallel size,
* applies ``seq_permutation`` (the striped token layout) to dim 1 of
  every rank >= 2 array once, inputs and targets alike.

Multi-step dispatch (``--steps_per_dispatch k``): :meth:`ShardedLoader.
epoch_groups` hands out the same batches in groups of up to k, each
group placed on the device with one copy per leaf.

Batch assembly (index gather) runs ``prefetch`` batches ahead on a thread.
The native (C++) batcher is not ported: ``backend="native"`` raises, and
``auto`` takes the numpy path (as the JAX ``auto`` does where the native
library is absent).
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..parallel import sharding as shd
from ..utils.platform import DeviceLike, h2d, resolve_device

Arrays = Dict[str, np.ndarray]

_DONE = object()

# the JAX loader's refusal of multi-step dispatch across processes
MULTI_PROCESS_DISPATCH = (
    "steps_per_dispatch > 1 is single-host for now: the stacked group "
    "would need a make_global_batch variant assembling per-process rows "
    "under the scan axis")


def _thread_prefetch(gen: Iterator[Arrays], depth: int) -> Iterator[Arrays]:
    """Run ``gen`` (numpy work) on a daemon thread, ``depth`` items ahead.
    Exceptions re-raise on the consumer; closing the iterator stops the
    worker within its put-poll interval."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def work():
        def put(item) -> bool:
            while True:
                if stop.is_set():
                    return False
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue

        try:
            for item in gen:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            put(e)
            return
        put(_DONE)

    threading.Thread(target=work, daemon=True,
                     name="loader-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class ShardedLoader:
    def __init__(self, data: Arrays, batch_size: int, *, rank: int = 0,
                 world_size: int = 1, device: DeviceLike = None,
                 shuffle: bool = True, seed: int = 0,
                 full_batch: bool = False, remainder: str = "pad",
                 backend: str = "numpy", prefetch: int = 2,
                 seq_rank: int = 0, sp: int = 1,
                 seq_permutation: Optional[np.ndarray] = None):
        if remainder not in ("pad", "drop"):
            raise ValueError("remainder must be 'pad' or 'drop'")
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        if backend not in ("numpy", "native", "auto"):
            raise ValueError("backend must be 'numpy', 'native' or 'auto'")
        if backend == "native":
            raise NotImplementedError(
                "--data_backend native (the C++ batcher) is not ported yet")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world of {world_size}")
        if not 0 <= seq_rank < sp:
            raise ValueError(f"seq_rank {seq_rank} outside {sp} shards")
        self.device = resolve_device(device)
        self.rank, self.world_size = rank, world_size
        self.seq_rank, self.sp = seq_rank, sp
        self.data = {k: np.asarray(v) for k, v in data.items()}
        if seq_permutation is not None:
            # once here, not per batch: the layout is static
            perm = np.asarray(seq_permutation)
            self.data = {k: (v[:, perm] if v.ndim >= 2 else v)
                         for k, v in self.data.items()}
        lens = {k: v.shape[0] for k, v in self.data.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged dataset: {lens}")
        self.n = next(iter(lens.values()))
        self.dp = world_size
        self.batch_size = self.n if full_batch else min(batch_size, self.n)
        self.shuffle = shuffle
        self.seed = seed
        # a rollback re-draw bumps this so later epochs take a new order;
        # 0 keeps the (seed, epoch) stream
        self.order_salt = 0
        self.remainder = remainder
        self.prefetch = prefetch

    @property
    def steps_per_epoch(self) -> int:
        if self.remainder == "drop":
            return max(self.n // self.batch_size, 1)
        return math.ceil(self.n / self.batch_size)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.n)
        if self.shuffle:
            key = ((self.seed, epoch) if not self.order_salt
                   else (self.seed, epoch, self.order_salt))
            np.random.default_rng(key).shuffle(order)
        return order

    def batch_rows(self, step: int) -> int:
        """Real (unpadded) rows of the GLOBAL batch ``step`` of any epoch."""
        bs = self.batch_size
        return min(bs, self.n - step * bs)

    def consumed_samples(self, global_step: int) -> int:
        """Order slots consumed after ``global_step`` steps — independent of
        world size and batch size cuts (a full epoch is exactly ``n``)."""
        spe = self.steps_per_epoch
        full_epochs, in_epoch = divmod(global_step, spe)
        return full_epochs * self.n + min(in_epoch * self.batch_size, self.n)

    def start_for_samples(self, samples: int) -> tuple:
        """(epoch, start_step) under THIS loader's batch size for a run
        that has consumed ``samples`` order slots: the inverse of
        :meth:`consumed_samples`, for an elastic resume whose batch size
        changed with the world.  An offset off a batch boundary rounds
        DOWN (retrains up to batch_size - 1 samples, skips none)."""
        epoch, offset = divmod(max(0, int(samples)), self.n)
        if offset >= self.steps_per_epoch * self.batch_size:
            # the old batch size covered an epoch tail this one drops
            return epoch + 1, 0
        return epoch, offset // self.batch_size

    def epoch(self, epoch: int, start_step: int = 0
              ) -> Iterator[Dict[str, torch.Tensor]]:
        """This rank's device batches ``{"x", "y", "mask"}`` of one epoch;
        ``start_step`` skips already-trained batches."""
        host = (self._rank_rows(b)
                for b in self._host_batches(epoch, start_step))
        if self.prefetch > 0:
            host = _thread_prefetch(host, self.prefetch)
        for batch in host:
            yield {k: h2d(v, self.device) for k, v in batch.items()}

    def epoch_groups(self, epoch: int, k: int, start_step: int = 0
                     ) -> Iterator[tuple]:
        """``(stacked, n_steps, rows)`` per group of up to ``k``
        consecutive batches of :meth:`epoch` (the same batches in the same
        order: shuffle, padding, sequence columns and permutation), the
        data side of multi-step dispatch (``--steps_per_dispatch``), as
        the JAX loader's ``epoch_groups``.  The last group of an epoch
        may be shorter.  ``stacked`` is the list of the group's
        ``n_steps`` batches: views into one device tensor per leaf that
        holds the group's batches one after another along the rows, placed
        with ONE host-to-device copy per leaf (an epoch's last batch may
        have fewer rows than the others, so the batches are concatenated,
        not stacked on a new axis).  ``rows`` is the group's real
        (unpadded) global rows.  One process only: a multi-process world
        raises, as the JAX loader does."""
        if k < 1:
            raise ValueError(f"steps per dispatch must be >= 1, got {k}")
        if self.world_size > 1 or self.sp > 1:
            raise NotImplementedError(MULTI_PROCESS_DISPATCH)
        host = (self._rank_rows(b)
                for b in self._host_batches(epoch, start_step))
        if self.prefetch > 0:
            host = _thread_prefetch(host, self.prefetch)
        group, rows, step = [], 0, start_step
        for batch in host:
            group.append(batch)
            rows += self.batch_rows(step)
            step += 1
            if len(group) == k:
                yield self._place_group(group), len(group), rows
                group, rows = [], 0
        if group:
            yield self._place_group(group), len(group), rows

    def _place_group(self, group):
        """Each leaf's batches concatenated on the host, one copy to the
        device, split back into per-batch row views."""
        ends = np.cumsum([b["mask"].shape[0] for b in group])
        starts = np.concatenate([[0], ends[:-1]])
        placed = {k: h2d(np.concatenate([b[k] for b in group]), self.device)
                  for k in group[0]}
        return [{k: v[a:e] for k, v in placed.items()}
                for a, e in zip(starts.tolist(), ends.tolist())]

    def _host_batches(self, epoch: int, start_step: int) -> Iterator[Arrays]:
        order = self._epoch_order(epoch)
        bs = self.batch_size
        for step in range(start_step, self.steps_per_epoch):
            idx = order[step * bs: (step + 1) * bs]
            if self.remainder == "drop" and len(idx) < bs:
                break
            yield {k: v[idx] for k, v in self.data.items()}

    def _pad(self, batch: Arrays) -> Arrays:
        padded = {}
        pad_mask = None
        for k, v in batch.items():
            padded[k], pad_mask = shd.pad_to_multiple(v, self.dp)
        # combine with a caller-provided per-row mask rather than clobber it
        if "mask" in batch:
            padded["mask"] = padded["mask"].astype(np.float32) * pad_mask
        else:
            padded["mask"] = pad_mask
        return padded

    def _rank_rows(self, batch: Arrays) -> Arrays:
        padded = self._pad(batch)
        rows = shd.rank_slice(padded["mask"].shape[0], self.world_size,
                              self.rank)
        out = {}
        for k, v in padded.items():
            v = v[rows]
            if self.sp > 1 and k != "mask" and v.ndim >= 2:
                if v.shape[1] % self.sp:
                    raise ValueError(f"seq len {v.shape[1]} (leaf {k!r}) "
                                     f"not divisible by --sp {self.sp}")
                w = v.shape[1] // self.sp
                v = v[:, self.seq_rank * w:(self.seq_rank + 1) * w]
            out[k] = np.ascontiguousarray(v)
        return out
