"""Paged attention over the serving KV block pool.

``paged_attention`` is the port of the JAX package's
``ops/pallas_kernels.py:paged_attention`` (kernel ``_paged_attn_kernel``).
On CUDA tensors it launches the hand-written kernel
``csrc/paged_attention.cu`` (built for ``sm_90a`` at first use, see
``ops._build``) or raises; on CPU tensors it computes the plain PyTorch
version, ``paged_attention_reference``.  There is no fallback from the
kernel to the plain version.

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
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def paged_attention_reference(q, k_pool, v_pool, tables, lengths, starts,
                              *, k_scale=None, v_scale=None) -> torch.Tensor:
    """The plain PyTorch version: gather each stream's live blocks,
    truncate them to its length, per-row causal softmax in f32.  Output
    in ``q``'s dtype; a stream of length 0 outputs 0."""
    _check_shapes(q, k_pool, v_pool, tables, lengths, starts, k_scale,
                  v_scale)
    s_n, w, n_heads, hd = q.shape
    _, bs, kv_heads, _ = k_pool.shape
    g = n_heads // kv_heads
    lengths = lengths.long()
    n_live = -(-int(lengths.max()) // bs) if s_n else 0
    if n_live == 0:
        return torch.zeros_like(q)
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
    q5 = (q.float() * (1.0 / hd ** 0.5)).reshape(s_n, w, kv_heads, g, hd)
    sc = torch.einsum("swcgd,stcd->scgwt", q5, k)
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("scgwt,stcd->swcgd", p, v)
    out = torch.where((lengths > 0)[:, None, None, None, None], out, 0.0)
    return out.reshape(s_n, w, n_heads, hd).to(q.dtype)


def _launch(q, k_pool, v_pool, tables, lengths, starts, k_scale, v_scale):
    lib, _ = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p]
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5
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
        raise ValueError(f"the CUDA kernel takes head_dim 64/128 and "
                         f"block_size 16/32, got {hd}/{bs}")
    out = torch.empty((s_n, w, n_heads, hd), dtype=q.dtype, device=dev)
    scale = 1.0 / hd ** 0.5
    err = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], hd, bs,
             q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
             k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             tables.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
             out.data_ptr(), s_n, w, n_heads, kv_heads, tables.shape[1],
             scale, torch.cuda.current_stream(dev).cuda_stream)
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
