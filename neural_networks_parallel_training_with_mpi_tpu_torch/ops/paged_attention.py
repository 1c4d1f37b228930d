"""Paged attention over the serving KV block pool.

``paged_attention`` is the port of the JAX package's
``ops/pallas_kernels.py:paged_attention`` (kernel ``_paged_attn_kernel``).
On CUDA tensors it launches the hand-written kernel
``csrc/paged_attention.cu`` (built for ``sm_90a`` at first use, see
``ops._build``) or raises; on CPU tensors it computes the plain PyTorch
version, ``paged_attention_reference``.  There is no fallback from the
kernel to the plain version.

The kernel splits each lane's context over several blocks (split-K):
:func:`split_plan` sizes the splits from the table's capacity alone, the
wrapper allocates the splits' scratch, and the kernel merges the splits
in split order; :func:`paged_attention_split_reference` is that split
and merge in plain PyTorch.

Shapes, as in the JAX package:

* ``q``: (streams, width, n_heads, head_dim); width 1 is a decode step,
  width > 1 a chunked-prefill bucket whose rows sit at absolute positions
  ``starts .. starts+width-1``.  ``n_heads`` is a multiple of the pool's
  ``kv_heads`` (GQA).
* ``k_pool``/``v_pool``: (num_blocks, block_size, kv_heads, head_dim),
  f32/bf16, or int8 with ``k_scale``/``v_scale`` (num_blocks,
  block_size, kv_heads) f32.
* ``tables``: (streams, max_blocks) int32 pool indices; ``lengths``:
  (streams,) int32 attendable keys (0 = an inactive lane, output 0);
  ``starts``: (streams,) int32 position of each stream's first row.

The kernel trusts ``lengths <= max_blocks * block_size`` and table
entries inside the pool: checking them would read device memory back to
the host on every call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
# keys a kernel block walks at most (per 16-row tile and KV head): short
# splits keep the longest lane's chain of softmax steps short, long ones
# keep the blocks, the scratch and the merge few.  chip_smoke.py phase 3
# times 32 to 512 at the server's decode shape; 256 was the fastest there
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
SPLIT_KEYS = 256
TILE_ROWS = 16          # query rows of a kernel block (csrc: kRows)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# per (device, stream): the kernel's split tickets, zero between launches;
# launches on one stream run one after another, so they can share them
_TICKETS = {}


def split_plan(max_blocks: int, block_size: int) -> Tuple[int, int]:
    """(split_blocks, n_splits): pool blocks per split and splits per
    lane, so that ``n_splits * split_blocks >= max_blocks``.  From the
    table's capacity and the block size only: lengths live on the device
    and reading them here would wait for it, and a plan that does not
    follow them keeps every launch of one table shape the same.  A split
    is a whole number of pool blocks at every block size: 16 blocks of
    16 keys, 2 of 128, or one block when a block holds more than
    :data:`SPLIT_KEYS` keys."""
    split_blocks = max(1, SPLIT_KEYS // block_size)
    return split_blocks, max(1, -(-max_blocks // split_blocks))


def _check_shapes(q, k_pool, v_pool, tables, lengths, starts, k_scale,
                  v_scale):
    s_n, _, n_heads, hd = q.shape
    _, bs, kv_heads, hd_k = k_pool.shape
    if hd_k != hd:
        raise ValueError(f"head_dim mismatch: q {hd} vs pool {hd_k}")
    if n_heads % kv_heads:
        raise ValueError(f"n_heads {n_heads} not a multiple of kv_heads "
                         f"{kv_heads}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"k/v pools differ: {tuple(k_pool.shape)} vs "
                         f"{tuple(v_pool.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools need BOTH k_scale and v_scale")
    if (k_scale is not None) != (k_pool.dtype == torch.int8):
        raise ValueError("scale pools go with int8 pools, and only them")
    if k_scale is not None and (k_scale.shape != k_pool.shape[:3]
                                or v_scale.shape != k_pool.shape[:3]):
        raise ValueError("scale pools must be (num_blocks, block_size, "
                         "kv_heads)")
    if tables.ndim != 2 or tables.shape[0] != s_n:
        raise ValueError(f"tables must be (streams={s_n}, max_blocks)")
    if lengths.shape != (s_n,) or starts.shape != (s_n,):
        raise ValueError(f"lengths and starts must be (streams={s_n},)")


def _masked_scores(q, k_pool, v_pool, tables, lengths, starts, k_scale,
                   v_scale):
    """Each stream's live blocks gathered and truncated to its length:
    (scores (S, kv_heads, G, W, T) of the pre-scaled q in f32, NEG_INF
    where masked; the mask (S, W, T); values (S, T, kv_heads, hd) f32), or
    None when no stream has a key."""
    _check_shapes(q, k_pool, v_pool, tables, lengths, starts, k_scale,
                  v_scale)
    s_n, w, n_heads, hd = q.shape
    _, bs, kv_heads, _ = k_pool.shape
    lengths = lengths.long()
    n_live = -(-int(lengths.max()) // bs) if s_n else 0
    if n_live == 0:
        return None
    blocks = tables[:, :n_live].long()
    t = n_live * bs

    def gather(pool):
        return pool[blocks].reshape(s_n, t, *pool.shape[2:]).float()

    k, v = gather(k_pool), gather(v_pool)
    if k_scale is not None:
        k = k * gather(k_scale)[..., None]
        v = v * gather(v_scale)[..., None]
    k_pos = torch.arange(t, device=q.device)
    q_pos = starts.long()[:, None] + torch.arange(w, device=q.device)
    mask = ((k_pos[None, None, :] < lengths[:, None, None])
            & (k_pos[None, None, :] <= q_pos[:, :, None]))      # (S, W, T)
    # q pre-scaled, as both kernels do
    q5 = (q.float() * (1.0 / hd ** 0.5)).reshape(s_n, w, kv_heads,
                                                 n_heads // kv_heads, hd)
    sc = torch.einsum("swcgd,stcd->scgwt", q5, k)
    return torch.where(mask[:, None, None], sc, NEG_INF), mask, v


def paged_attention_reference(q, k_pool, v_pool, tables, lengths, starts,
                              *, k_scale=None, v_scale=None) -> torch.Tensor:
    """The plain PyTorch version: gather each stream's live blocks,
    truncate them to its length, per-row causal softmax in f32.  Output
    in ``q``'s dtype; a stream of length 0 outputs 0."""
    scored = _masked_scores(q, k_pool, v_pool, tables, lengths, starts,
                            k_scale, v_scale)
    if scored is None:
        return torch.zeros_like(q)
    sc, _, v = scored
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("scgwt,stcd->swcgd", p, v)
    out = torch.where((lengths > 0)[:, None, None, None, None], out, 0.0)
    return out.reshape(q.shape).to(q.dtype)


def paged_attention_split_reference(q, k_pool, v_pool, tables, lengths,
                                    starts, *, split_blocks: int,
                                    k_scale=None,
                                    v_scale=None) -> torch.Tensor:
    """The kernel's split and merge in plain PyTorch: each run of
    ``split_blocks`` table entries gives a partial (max, denominator,
    accumulator) over its keys, and the partials merge in split order.
    The same function as :func:`paged_attention_reference`, summed in
    another order; for the tests, not the serving path."""
    scored = _masked_scores(q, k_pool, v_pool, tables, lengths, starts,
                            k_scale, v_scale)
    if scored is None:
        return torch.zeros_like(q)
    sc, mask, v = scored
    split = split_blocks * k_pool.shape[1]
    m = den = acc = None
    for k0 in range(0, sc.shape[-1], split):
        part = sc[..., k0:k0 + split]
        m_j = part.amax(-1, keepdim=True)                     # (S,c,g,W,1)
        p = torch.where(mask[:, None, None, :, k0:k0 + split],
                        torch.exp(part - m_j), 0.0)
        den_j = p.sum(-1, keepdim=True)
        acc_j = torch.einsum("scgwt,stcd->scgwd", p, v[:, k0:k0 + split])
        if m is None:
            m, den, acc = m_j, den_j, acc_j
            continue
        m_new = torch.maximum(m, m_j)
        c_old, c_j = torch.exp(m - m_new), torch.exp(m_j - m_new)
        den = c_old * den + c_j * den_j
        acc = c_old * acc + c_j * acc_j
        m = m_new
    empty = m < NEG_INF * 0.5                                 # no key
    out = torch.where(empty, 0.0, acc / torch.where(empty, 1.0, den))
    return out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)


def _tickets(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 tickets for launches on ``stream`` of
    ``device``, allocated once (and again when a launch needs more); the
    kernel leaves them zero."""
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[key] = torch.zeros(n, dtype=torch.int32,
                                          device=device)
    return buf


def _launch(q, k_pool, v_pool, tables, lengths, starts, k_scale, v_scale):
    lib, _ = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p]
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    s_n, w, n_heads, hd = q.shape
    _, bs, kv_heads, _ = k_pool.shape
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths),
                    ("starts", starts), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:   # the kernel copies them 16 bytes at a time
            raise ValueError(f"{name} must start 16-byte aligned")
    if q.stride(-1) != 1:
        raise ValueError("q's head_dim must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    quant = k_pool.dtype == torch.int8
    if quant:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise ValueError("scale pools must be float32")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype} must match q dtype "
                         f"{q.dtype} (or be int8 with scales)")
    for name, t in (("tables", tables), ("lengths", lengths),
                    ("starts", starts)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    if not lib.paged_attention_supported(hd, bs):
        raise ValueError(f"the CUDA kernel takes head_dim 16/32/64/128 and a "
                         f"block_size that is a multiple of 16, got "
                         f"{hd}/{bs}")
    out = torch.empty((s_n, w, n_heads, hd), dtype=q.dtype, device=dev)
    max_blocks = tables.shape[1]
    split_blocks, n_splits = split_plan(max_blocks, bs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part_ml = part_acc = tickets = None
    if n_splits > 1:
        n_tiles = -(-w * (n_heads // kv_heads) // TILE_ROWS)
        tickets = _tickets(dev, stream, s_n * kv_heads * n_tiles).data_ptr()
        # each split's (max, denominator) and accumulator per row; freed
        # to the caching allocator on return, whose next user on this
        # stream runs after the kernel
        n_part = s_n * kv_heads * n_tiles * n_splits * TILE_ROWS
        scratch = torch.empty(n_part * (2 + hd), dtype=torch.float32,
                              device=dev)
        part_ml = scratch[:2 * n_part].data_ptr()
        part_acc = scratch[2 * n_part:].data_ptr()
    scale = 1.0 / hd ** 0.5
    err = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], hd, bs,
             q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
             k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             tables.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
             out.data_ptr(), part_ml, part_acc, tickets, s_n, w, n_heads,
             kv_heads, max_blocks, split_blocks * bs, n_splits, scale,
             stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pool, v_pool, tables, lengths, starts, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused paged attention (see the module docstring).  CUDA tensors
    launch the kernel and count one launch in ``paged_attention.launches``;
    CPU tensors take ``paged_attention_reference``."""
    if q.device.type == "cuda":
        _check_shapes(q, k_pool, v_pool, tables, lengths, starts, k_scale,
                      v_scale)
        return _launch(q, k_pool, v_pool, tables, lengths, starts, k_scale,
                       v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                                         starts, k_scale=k_scale,
                                         v_scale=v_scale)
    raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")


paged_attention.launches = 0
