"""PyTorch/CUDA port of ``neural_networks_parallel_training_with_mpi_tpu``.

The JAX package beside this one is the reference; this package carries
its paths to an NVIDIA H100, slice by slice.  The first slice is serving:
the Transformer LM behind the paged-KV continuous-batching scheduler
(``serve.Scheduler`` -> ``serve.PagedDecodeServer``), whose fused
attention is a hand-written CUDA kernel (``ops.paged_attention``).

Importing the package imports ``torch`` only: no trainer, no JAX, and no
module of the JAX package.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (``utils.platform.resolve_device``).
"""

__version__ = "0.1.0"
