"""Serving: paged KV cache + continuous batching.

* :mod:`serve.paged_kv` — block-allocated KV pools with per-stream block
  tables, chunked prefill, batched decode, prefix caching with
  copy-on-write; attention behind the ``attn_impl`` seam (``gathered``:
  plain PyTorch, ``fused``: the CUDA paged-attention kernel).
* :mod:`serve.scheduler` — bounded queue, per-tick admit/prefill/decode/
  retire, SLO-aware eviction.
"""

from .paged_kv import (
    ATTN_IMPLS,
    BlockAllocator,
    BlockExhausted,
    PagedDecodeServer,
    PrefixIndex,
    init_paged_kv,
    prefill_bucket,
)
from .scheduler import Request, Scheduler, ServeConfig

__all__ = ["ATTN_IMPLS", "BlockAllocator", "BlockExhausted",
           "PagedDecodeServer", "PrefixIndex", "Request", "Scheduler",
           "ServeConfig", "init_paged_kv", "prefill_bucket"]
