"""The fleet's replica worker process.

``python -m neural_networks_parallel_training_with_mpi_tpu_torch.serve.\
_fleet_worker --worker ...``: a runnable module of its own (not exported
by ``serve/__init__``), so runpy never finds the target already imported
by the package's init.  The logic is :func:`serve.fleet.worker_main`.
"""

from __future__ import annotations

import sys

from .fleet import worker_main

if __name__ == "__main__":
    sys.exit(worker_main())
