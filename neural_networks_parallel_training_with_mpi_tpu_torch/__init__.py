"""PyTorch/CUDA port of ``neural_networks_parallel_training_with_mpi_tpu``.

The JAX package beside this one is the reference; this package carries
its paths to an NVIDIA H100, slice by slice:

* serving: the Transformer LM behind the paged-KV continuous-batching
  scheduler (``serve.Scheduler`` -> ``serve.PagedDecodeServer``), whose
  fused attention is a hand-written CUDA kernel (``ops.paged_attention``),
  unified or split into prefill and decode roles joined by a block
  handoff, with its telemetry and load generator (``serve.loadgen``), and
  the dense ``models.DecodeServer``;
* training: synchronous data parallelism (``train.Trainer``, the CLI
  ``python -m neural_networks_parallel_training_with_mpi_tpu_torch``),
  with flash attention forward and backward as hand-written CUDA kernels
  (``ops.flash_attention``).

Importing the package imports ``torch`` only: no JAX, and no module of
the JAX package.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``utils.platform.resolve_device``).
"""

__version__ = "0.2.0"
