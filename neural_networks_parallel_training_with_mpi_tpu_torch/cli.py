"""CLI entry point: training, with the JAX package's flags.

    python -m neural_networks_parallel_training_with_mpi_tpu_torch \\
        --lr 0.001 --momentum 0.9 --batch_size 4 --nepochs 3

runs the reference job on the CUDA device (``--platform auto`` or ``gpu``;
raises without one) or, with ``--platform cpu``, on the host.  Several
GPUs of one host: ``torchrun --nproc_per_node N -m
neural_networks_parallel_training_with_mpi_tpu_torch ...`` (one process
per card; ``parallel.distributed.world_setup`` forms the group).
Sequence parallelism: ``torchrun --nproc_per_node N -m ... --sp S
--attention ring|ring_flash|striped|striped_flash`` trains on a
``data x seq`` world of N = ``--dp`` x S ranks; ``--sp S`` in a world of
fewer ranks raises.

Decoding (``--generate``), the supervisor (``--supervise``) and the JAX
platform knobs (``--num_devices``, ``--probe_timeout``) are not ported and
raise when set.
"""

from __future__ import annotations

import sys

from .config import build_argparser, config_from_args
from .utils.logging import log

# CLI-only flags of paths the port lacks -> their defaults
_UNPORTED_CLI = {"generate": None, "supervise": 0, "num_devices": None,
                 "probe_timeout": 60.0, "max_new_tokens": 32,
                 "temperature": 0.0, "top_k": 0, "top_p": 1.0,
                 "quantize": "none", "kv_quant": "none", "prefill_chunk": 0,
                 "supervise_backoff": 1.0, "supervise_backoff_max": 60.0}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    for name, default in _UNPORTED_CLI.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name} is not ported to the PyTorch/CUDA package yet")
    from .train.trainer import Trainer

    device = "cpu" if args.platform == "cpu" else "cuda"
    cfg = config_from_args(args)
    result = Trainer(cfg, device=device).fit()
    log(f"done: final loss {result['final_loss']:.6f}, "
        f"{result['samples_per_sec']:.1f} samples/sec")
    val = {k: v for k, v in result.items() if k.startswith("val_")}
    if val:
        log("validation: " + ", ".join(f"{k[4:]} {v:.6f}"
                                       for k, v in sorted(val.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
