"""Sequence parallelism: ring, striped and Ulysses attention over a
sequence group, and dense attention one query block at a time.

The port of the JAX package's ``parallel/sequence.py``.  A sequence
sharded S ways is attended to without one shard ever holding the full
(T, T) scores: each shard keeps its Q block while the K/V blocks travel
round a ring, and partial results merge by an online softmax (plain
``ring_attention``) or by their logsumexp weights (``ring_flash`` /
``striped_flash``, whose block compute is ``ops.flash_attention``'s
``flash_attention_with_lse``: the CUDA kernels B1-B3 on the card).

Where the JAX package runs these functions inside ``shard_map`` with a
``seq`` mesh axis bound, the port passes an explicit *sequence group*:

* ``ProcessSeqGroup(pg)`` — one shard per rank of a ``torch.distributed``
  process group (torchrun: NCCL on cards, gloo on the CPU).  ``shift``
  receives the blocks of rank+1 and sends its own to rank-1 (the JAX perm
  ``[(i, (i - 1) % s)]``) with ``batch_isend_irecv``, inside an autograd
  function whose backward shifts the gradients the other way.
* ``LocalSeqGroup(s)`` — all s shards in one process (the way one card
  runs the ring, as the JAX tests run it on fake CPU devices).  ``shift``
  rotates the list of blocks, so autograd carries gradients back to the
  sender with no communication code.

Both share one per-rank loop (``_ring``), so the same kernel calls run.
Shapes: q/k/v are what this process holds, (B, T_here, H, D): the local
shard under a process group, the whole (permuted) sequence under a local
group, which splits it into S contiguous shards.  Positions are global
(:func:`global_positions`): contiguous layouts give shard r the positions
r*T_local .. (r+1)*T_local - 1, striped layouts (inputs permuted by
:func:`striped_permutation`) give it r, r + S, r + 2S, ...

``ulysses`` (DeepSpeed-Ulysses) trades the sequence split for a head
split with an all-to-all, attends over the full sequence with
``attention_reference`` on H/S heads, and all-to-alls back, both through
``parallel.collectives.all_to_all`` (over a ``ProcessSeqGroup`` an
``all_to_all_single`` whose backward is the inverse exchange, over a
``LocalSeqGroup`` a regrouping of the list of shards).
``dense_blockwise`` is ``attention_reference`` computed one query block
at a time, so the (B, H, T, T) scores never exist at once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.flash_attention import (
    HEAD_DIMS, flash_attention, flash_attention_with_lse,
)
from ..ops.rope import rope_rotate
from . import collectives

NEG_INF = -1e30

SEQ_SHARDED_IMPLS = ("ring", "ring_flash", "striped", "striped_flash",
                     "ulysses")

Block = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# sequence groups
# ---------------------------------------------------------------------------

class LocalSeqGroup:
    """All ``size`` shards of the sequence in this process."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"sequence group size must be >= 1, got {size}")
        self.size = size
        self.ranks = tuple(range(size))

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, T, ...) -> the S contiguous (B, T/S, ...) shards."""
        if x.shape[1] % self.size:
            raise ValueError(f"seq len {x.shape[1]} not divisible by "
                             f"{self.size} shards")
        return list(x.chunk(self.size, dim=1))

    def shift(self, blocks: List[Block]) -> List[Block]:
        """Shard r receives the blocks shard r+1 held."""
        return blocks[1:] + blocks[:1]

    def join(self, outs: List[torch.Tensor],
             blocks: List[Block]) -> torch.Tensor:
        return torch.cat(outs, dim=1)

    def to_heads(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, T, H, D), the S sequence shards side by side -> the S head
        groups (B, T, H/S, D) over the whole sequence: shard d of the
        all-to-all's output is every shard's head group d, joined along
        the sequence."""
        return collectives.all_to_all(self.split(x), self, 2, 1)

    def to_seq(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """The inverse exchange: head groups back to the S sequence
        shards, joined along the sequence."""
        return torch.cat(collectives.all_to_all(outs, self, 1, 2), dim=1)


class _Shift(torch.autograd.Function):
    """Forward: send to rank-1, receive from rank+1.  Backward: each
    gradient goes back to the rank its tensor came from."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(group.exchange(xs, forward=True))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.group.exchange(grads, forward=False))


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with the last received blocks as inputs whose
    gradient is 0.  Under the causal ``ring_flash`` skip a rank may never
    read the last blocks it receives; without this their ``_Shift`` would
    drop out of that rank's backward while its neighbours still run it,
    and the ranks' point-to-point exchanges would no longer pair up."""

    @staticmethod
    def forward(ctx, out, *blocks):
        ctx.metas = [(b.shape, b.dtype, b.device) for b in blocks]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + tuple(torch.zeros(s, dtype=dt, device=dev)
                               for s, dt, dev in ctx.metas)


class ProcessSeqGroup:
    """One shard per rank of the process group ``pg``."""

    def __init__(self, pg):
        self.pg = pg
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.ranks = (self.rank,)
        self._prev = dist.get_global_rank(pg, (self.rank - 1) % self.size)
        self._next = dist.get_global_rank(pg, (self.rank + 1) % self.size)

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x]

    def shift(self, blocks: List[Block]) -> List[Block]:
        (blk,) = blocks
        return [_Shift.apply(self, *blk)]

    def join(self, outs: List[torch.Tensor],
             blocks: List[Block]) -> torch.Tensor:
        return _Tie.apply(outs[0], *blocks[0])

    def to_heads(self, x: torch.Tensor) -> List[torch.Tensor]:
        return collectives.all_to_all([x], self, 2, 1)

    def to_seq(self, outs: List[torch.Tensor]) -> torch.Tensor:
        (x,) = collectives.all_to_all(outs, self, 1, 2)
        return x

    def exchange(self, xs: Sequence[torch.Tensor],
                 forward: bool) -> List[torch.Tensor]:
        """Send ``xs`` one way round the ring and receive the neighbour's
        on the other side; one tag per tensor keeps k and v apart."""
        send_to, recv_from = ((self._prev, self._next) if forward
                              else (self._next, self._prev))
        xs = [x.contiguous() for x in xs]
        bufs = [torch.empty_like(x) for x in xs]
        ops = [dist.P2POp(dist.isend, x, send_to, self.pg, tag)
               for tag, x in enumerate(xs)]
        ops += [dist.P2POp(dist.irecv, b, recv_from, self.pg, tag)
                for tag, b in enumerate(bufs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return bufs


# ---------------------------------------------------------------------------
# layouts and positions
# ---------------------------------------------------------------------------

def striped_permutation(t: int, s: int) -> np.ndarray:
    """Permutation to the STRIPED layout: after ``x[:, perm]`` and
    contiguous sharding into ``s`` shards, shard d holds the original
    positions d, d+s, d+2s, ...  Every causal ring block pair is then
    exactly a triangle (Striped Attention, Brandon et al. 2023).  Apply it
    to inputs and targets alike: per-token losses do not change."""
    if t % s:
        raise ValueError(f"seq len {t} not divisible by {s} shards")
    return np.concatenate([np.arange(d, t, s) for d in range(s)])


def inverse_striped_permutation(t: int, s: int) -> np.ndarray:
    return np.argsort(striped_permutation(t, s))


def _shard_positions(r: int, s: int, t_local: int, striped: bool,
                     device) -> torch.Tensor:
    i = torch.arange(t_local, device=device)
    return r + s * i if striped else r * t_local + i


def global_positions(impl: str, group, t: int,
                     device=None) -> torch.Tensor:
    """Global positions of the ``t`` tokens this process holds under the
    impl's layout: striped shard r holds r + i*S, contiguous ring and
    Ulysses shard r holds r*T_local + i, dense/flash see the full
    sequence.  Under a local
    group ``t`` covers all S shards and the result is their
    concatenation."""
    if impl not in SEQ_SHARDED_IMPLS or group is None:
        return torch.arange(t, device=device)
    t_local = t // len(group.ranks)
    striped = impl in ("striped", "striped_flash")
    return torch.cat([_shard_positions(r, group.size, t_local, striped,
                                       device) for r in group.ranks])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain full-sequence attention (B, T, H, hd): f32 scores, softmax,
    probabilities cast to ``v``'s dtype for the value product."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        pos_q = torch.arange(t_q, device=q.device)
        pos_k = torch.arange(t_k, device=q.device)
        mask = pos_k[None, :] <= pos_q[:, None]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_dense_blockwise(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None,
                              q_chunk: int = 256) -> torch.Tensor:
    """:func:`attention_reference` one query block of ``q_chunk`` rows at
    a time: each row still sees every key before its softmax, so the
    math is the same, but only one block's (B, H, C, T) scores live at
    once.  A ``q_chunk`` that does not divide T becomes the largest
    divisor of T below it (the JAX package's rule)."""
    b, t, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    if t % q_chunk:
        q_chunk = next(c for c in range(min(q_chunk, t), 0, -1)
                       if t % c == 0)
    t_k = k.shape[1]
    kt = k.transpose(1, 2).float()                  # (B, H, Tk, D)
    vt = v.transpose(1, 2)
    pos_k = torch.arange(t_k, device=q.device)
    outs = []
    for i in range(0, t, q_chunk):
        q_blk = q[:, i:i + q_chunk].transpose(1, 2).float()
        scores = torch.einsum("bhqd,bhkd->bhqk", q_blk, kt) * scale
        if causal:
            rows = i + torch.arange(q_chunk, device=q.device)
            mask = pos_k[None, :] <= rows[:, None]
            scores = torch.where(mask[None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs, vt))
    return torch.cat(outs, dim=2).transpose(1, 2)   # (B, T, H, D)


def ulysses_attention(q, k, v, group, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses attention: all-to-all from sequence to head
    sharding, :func:`attention_reference` over the full sequence on H/S
    heads, all-to-all back (the JAX package's ``ulysses_attention``).
    Needs ``n_heads % S == 0``."""
    s, h = group.size, q.shape[2]
    if h % s != 0:
        raise ValueError(f"n_heads={h} not divisible by seq axis size {s}")
    outs = [attention_reference(qh, kh, vh, causal=causal, scale=scale)
            for qh, kh, vh in zip(group.to_heads(q), group.to_heads(k),
                                  group.to_heads(v))]
    return group.to_seq(outs)


def validate_ulysses_under_tp(n_heads: int, tp: int, sp: int,
                              seq_axis: str = "seq") -> None:
    """Under Megatron TP Ulysses spreads this rank's ``n_heads // tp``
    local heads over the ``sp`` sequence shards, which must divide them
    (the JAX package's rule and message)."""
    if (n_heads // tp) % sp:
        raise ValueError(
            f"ulysses under TP redistributes the {n_heads // tp} "
            f"local heads over {seq_axis}={sp}: not divisible")


def _ring(q, k, v, group, block_fn, merge, init):
    """The per-rank loop every ring impl shares: S block computations and
    S-1 shifts (the last block merges after the last shift, so no
    rotate-back hop is made).  ``block_fn(i, r, blk, q_i, k_blk, v_blk)``
    returns a partial result or None (a skipped block);
    ``merge(state, part)`` folds it into rank i's state, which starts as
    ``init(q_i)``."""
    s = group.size
    qs = group.split(q)
    blocks = list(zip(group.split(k), group.split(v)))
    states = [init(qi) for qi in qs]
    for step in range(s):
        if step:
            blocks = group.shift(blocks)
        for i, r in enumerate(group.ranks):
            part = block_fn(i, r, (r + step) % s, qs[i], *blocks[i])
            if part is not None:
                states[i] = merge(states[i], part)
    return states, blocks


def ring_attention(q, k, v, group, causal: bool = True,
                   scale: Optional[float] = None,
                   striped: bool = False) -> torch.Tensor:
    """Plain ring attention: per Q row the running max ``m``, denominator
    ``l`` and accumulator ``o`` in f32, every block computed (masked where
    causal), as ``parallel/sequence.py:ring_attention`` of the JAX package.
    ``striped``: the shards hold round-robin stripes."""
    b, _, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    s = group.size

    def init(qi):
        t = qi.shape[1]
        return (torch.full((b, h, t), NEG_INF, dtype=torch.float32,
                           device=q.device),
                torch.zeros((b, h, t), dtype=torch.float32, device=q.device),
                torch.zeros(qi.shape, dtype=torch.float32, device=q.device))

    def block_fn(i, r, blk, qi, k_blk, v_blk):
        t = qi.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", qi.float(),
                              k_blk.float()) * scale
        if causal:
            q_pos = _shard_positions(r, s, t, striped, q.device)
            k_pos = _shard_positions(blk, s, t, striped, q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            scores = torch.where(mask[None, None], scores, NEG_INF)
        return scores, v_blk

    def merge(state, part):
        m, l, o = state
        scores, v_blk = part
        new_m = torch.maximum(m, scores.amax(-1))
        correction = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[..., None])
        new_l = l * correction + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype).float(),
                          v_blk.float())
        new_o = o * correction.transpose(1, 2)[..., None] + pv
        return new_m, new_l, new_o

    states, blocks = _ring(q, k, v, group, block_fn, merge, init)
    outs = []
    for _, l, o in states:
        l = torch.where(l == 0.0, 1.0, l)
        outs.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return group.join(outs, blocks)


def _lse_merge(state, part):
    """Fold a block's (out, lse) into the running (o f32, lse): weights
    exp(lse_old - lse_new) and exp(lse_b - lse_new), lse_new their
    logaddexp (``parallel/sequence.py:298-307`` of the JAX package).  The
    first block is the state as it is: merging it into (0, -1e30) gives
    it back exactly."""
    out_b, lse_b = part
    if state is None:
        return out_b.float(), lse_b
    o, lse = state
    b, t, h, _ = o.shape
    new_lse = torch.logaddexp(lse, lse_b)
    w_old = torch.exp(lse - new_lse).reshape(b, h, t).transpose(1, 2)
    w_new = torch.exp(lse_b - new_lse).reshape(b, h, t).transpose(1, 2)
    return (o * w_old[..., None] + out_b.float() * w_new[..., None],
            new_lse)


def _check_default_scale(name: str, scale: Optional[float], d: int):
    if scale is not None and abs(scale - d ** -0.5) > 1e-12:
        raise ValueError(f"{name} supports the default 1/sqrt(head_dim) "
                         "scale only")


def _flash_ring(q, k, v, group, mode_of, block_q, block_k):
    def block_fn(i, r, blk, qi, k_blk, v_blk):
        mode = mode_of(r, blk)
        if mode is None:
            return None
        return flash_attention_with_lse(qi, k_blk, v_blk, block_q=block_q,
                                        block_k=block_k, mask_mode=mode)

    states, blocks = _ring(q, k, v, group, block_fn, _lse_merge,
                           lambda qi: None)
    return group.join([o.to(q.dtype) for o, _ in states], blocks)


def ring_flash_attention(q, k, v, group, causal: bool = True,
                         scale: Optional[float] = None, block_q: int = 128,
                         block_k: int = 128) -> torch.Tensor:
    """Ring attention with the flash kernels per block.  Causal: the
    strictly-past blocks run unmasked, the diagonal block causally, the
    strictly-future blocks are skipped and launch nothing (so S(S+1)/2
    block calls per call over all ranks)."""
    _check_default_scale("ring_flash_attention", scale, q.shape[-1])

    def mode_of(r, blk):
        if not causal or blk < r:
            return "none"
        return "causal" if blk == r else None

    return _flash_ring(q, k, v, group, mode_of, block_q, block_k)


def striped_ring_flash_attention(q, k, v, group, causal: bool = True,
                                 scale: Optional[float] = None,
                                 block_q: int = 128,
                                 block_k: int = 128) -> torch.Tensor:
    """Ring attention over round-robin stripes with the flash kernels per
    block.  The pair (this shard r, block from shard b) masks to exactly a
    triangle: ``causal`` (j <= i) when b <= r, ``causal_exclusive``
    (j < i) when b > r, so every block is half the work and none is
    skipped (S^2 block calls per call over all ranks)."""
    _check_default_scale("striped_ring_flash_attention", scale,
                         q.shape[-1])

    def mode_of(r, blk):
        if not causal:
            return "none"
        return "causal" if blk <= r else "causal_exclusive"

    return _flash_ring(q, k, v, group, mode_of, block_q, block_k)


# ``attention="auto"``: the smallest sequence length from which flash (B1
# forward; delta, B2 and B3 backward) trains the flagship LM no slower
# than dense attention, at that length and every longer one, keyed by the
# device type and the compute dtype (bf16 runs the sm90 kernels, f32 the
# simt ones).  The rows are chip_smoke.py phase 17a's measurement on an
# H100 80GB HBM3 at 700 W, whose tables PERF.md keeps: in both dtypes
# flash was no slower at every length measured, 256 to 4096, so each row
# is the shortest length measured.  A pair without a row (the CPU;
# float16, which the kernels do not take) keeps auto dense, as the JAX
# package keeps it dense on backends without a measured row.
AUTO_FLASH_MIN_SEQ = {("cuda", torch.bfloat16): 256,
                      ("cuda", torch.float32): 256}


def _auto_flash_refusal(seq_len: int, head_dim: int,
                        blocks: Optional[Tuple[int, int]],
                        scale: Optional[float]) -> Optional[str]:
    """Why the flash kernels cannot take this shape (None: they can)."""
    if head_dim not in HEAD_DIMS:
        return (f"the flash kernels take head_dim "
                f"{'/'.join(map(str, HEAD_DIMS))}, not {head_dim}")
    if blocks is None:
        return None
    bq, bk = min(blocks[0], seq_len), min(blocks[1], seq_len)
    if seq_len % bq or seq_len % bk:
        return (f"the flash kernels need seq_len divisible by their blocks "
                f"({bq}, {bk}), not {seq_len}")
    if scale is not None and abs(scale - head_dim ** -0.5) > 1e-12:
        return ("the flash kernels take the default 1/sqrt(head_dim) "
                "scale only")
    return None


def resolve_attention_impl(impl: str, seq_len: int, backend: str,
                           dtype: torch.dtype,
                           head_dim: Optional[int] = None,
                           blocks: Optional[Tuple[int, int]] = (128, 128),
                           scale: Optional[float] = None) -> str:
    """Resolve ``"auto"`` for this device type, compute dtype and sequence
    length: the single consult point (:func:`sequence_sharded_attention`
    resolves through it, the model and the trainer check their shapes
    with it).  Any other ``impl`` passes through.  With ``head_dim``, a
    shape that auto sends to flash but the kernels do not take raises,
    naming ``--attention dense``; auto never falls back quietly.
    ``blocks`` None leaves the length's divisibility unchecked (the
    model's check, whose lengths are any up to ``max_seq_len``)."""
    if impl != "auto":
        return impl
    thresh = AUTO_FLASH_MIN_SEQ.get((backend, dtype))
    if thresh is None or seq_len < thresh:
        return "dense"
    why = (None if head_dim is None else
           _auto_flash_refusal(seq_len, head_dim, blocks, scale))
    if why is not None:
        raise ValueError(
            f"attention='auto' picks flash at seq_len {seq_len} in "
            f"{str(dtype).replace('torch.', '')} on {backend} (from "
            f"seq_len {thresh} on, AUTO_FLASH_MIN_SEQ), but {why}: pass "
            "--attention dense (attention='dense')")
    return "flash"


def sequence_sharded_attention(impl: str, q, k, v, *, group=None,
                               causal: bool = True,
                               scale: Optional[float] = None,
                               block_q: int = 128, block_k: int = 128,
                               rope_theta: Optional[float] = None
                               ) -> torch.Tensor:
    """Dispatch by impl name.  With ``rope_theta``, q and k are rotated by
    their GLOBAL positions first (:func:`global_positions`), so the K that
    travels the ring is already rotated correctly."""
    impl = resolve_attention_impl(impl, q.shape[1], q.device.type, q.dtype,
                                  q.shape[-1], (block_q, block_k), scale)
    if impl in SEQ_SHARDED_IMPLS and group is None:
        raise ValueError(f"attention={impl!r} needs a sequence group "
                         "(ProcessSeqGroup or LocalSeqGroup)")
    if rope_theta is not None:
        positions = global_positions(impl, group, q.shape[1], q.device)
        q = rope_rotate(q, positions, rope_theta)
        k = rope_rotate(k, positions, rope_theta)
    if impl == "dense":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    if impl == "dense_blockwise":
        return attention_dense_blockwise(q, k, v, causal=causal, scale=scale)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, group, causal=causal, scale=scale)
    if impl == "flash":
        _check_default_scale("flash_attention", scale, q.shape[-1])
        return flash_attention(q, k, v, causal, block_q, block_k)
    if impl in ("ring", "striped"):
        return ring_attention(q, k, v, group, causal=causal, scale=scale,
                              striped=impl == "striped")
    if impl == "ring_flash":
        return ring_flash_attention(q, k, v, group, causal=causal,
                                    scale=scale, block_q=block_q,
                                    block_k=block_k)
    if impl == "striped_flash":
        return striped_ring_flash_attention(q, k, v, group, causal=causal,
                                            scale=scale, block_q=block_q,
                                            block_k=block_k)
    raise ValueError(f"unknown attention impl {impl!r}")
