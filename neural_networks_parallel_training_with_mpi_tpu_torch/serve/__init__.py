"""Serving: paged KV cache + continuous batching.

* :mod:`serve.paged_kv` — block-allocated KV pools with per-stream block
  tables, chunked prefill, batched decode, prefix caching with
  copy-on-write, and the prefill -> decode block handoff; attention
  behind the ``attn_impl`` seam (``gathered``: plain PyTorch, ``fused``:
  the CUDA paged-attention kernel).
* :mod:`serve.scheduler` — bounded queue, per-tick admit/prefill/decode/
  retire, SLO-aware eviction, the prefill/decode roles, serving
  telemetry and tracing, and the fleet surface (load report, drain).
* :mod:`serve.loadgen` — a closed-loop load generator measuring tokens/s
  and TTFT/ITL percentiles against offered load.
"""

from .loadgen import (
    MIXES,
    make_requests,
    prewarm,
    resolve_mix,
    run_closed_loop,
    sweep_loads,
)
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

__all__ = ["ATTN_IMPLS", "BlockAllocator", "BlockExhausted", "MIXES",
           "PagedDecodeServer", "PrefixIndex", "Request", "Scheduler",
           "ServeConfig", "init_paged_kv", "make_requests", "prefill_bucket",
           "prewarm", "resolve_mix", "run_closed_loop", "sweep_loads"]
