"""CLI entry point: training and decoding, with the JAX package's flags.

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

Decoding: ``--generate "1,2,3"`` restores the params of the newest
verified snapshot under ``--checkpoint_dir`` (any optimizer's, no
training flags needed; a fresh init without one) and prints the prompt
and ``--max_new_tokens`` decoded ids, comma-separated, as the JAX CLI
does.  Greedy by default; ``--temperature`` (with ``--top_k``/``--top_p``)
samples from a ``torch.Generator`` seeded by ``--seed``, so sampled ids
differ from the JAX package's while greedy ids agree.  ``--kv_quant int8``
and ``--prefill_chunk`` as in ``models.generate``.

Not ported, and raising when set: ``--quantize`` (int8 weights), the
supervisor (``--supervise``) and the JAX platform knobs
(``--num_devices``, ``--probe_timeout``).
"""

from __future__ import annotations

import sys

from .config import build_argparser, config_from_args
from .utils.logging import log

# CLI-only flags of paths the port lacks -> their defaults
_UNPORTED_CLI = {"supervise": 0, "num_devices": None, "probe_timeout": 60.0,
                 "quantize": "none", "supervise_backoff": 1.0,
                 "supervise_backoff_max": 60.0}


def _generate(args) -> int:
    """Decode from a trained LM snapshot (the JAX CLI's ``_generate``):
    rc 2 on a bad prompt, a non-transformer model or a snapshot that does
    not restore."""
    import torch

    from .models.generate import generate
    from .models.registry import build_model
    from .utils import checkpoint as ckpt
    from .utils import prng

    cfg = config_from_args(args)
    if cfg.model.arch != "transformer":
        log("ERROR: --generate needs a transformer model (--dataset lm "
            "or --arch transformer)")
        return 2
    # cheap input validation first, before any model init or restore
    try:
        ids = [int(t) for t in args.generate.replace(" ", "").split(",") if t]
    except ValueError:
        log(f"ERROR: --generate expects comma-separated token ids, got "
            f"{args.generate!r}")
        return 2
    if not ids or any(t < 0 or t >= cfg.model.vocab_size for t in ids):
        log(f"ERROR: prompt ids must be in [0, {cfg.model.vocab_size}), "
            f"got {args.generate!r}")
        return 2
    if len(ids) + args.max_new_tokens > cfg.model.max_seq_len:
        log(f"ERROR: prompt ({len(ids)}) + max_new_tokens "
            f"({args.max_new_tokens}) exceeds max_seq_len "
            f"{cfg.model.max_seq_len} (raise --seq_len)")
        return 2
    if args.top_k > cfg.model.vocab_size:
        log(f"ERROR: --top_k {args.top_k} > vocab_size "
            f"{cfg.model.vocab_size}")
        return 2

    device = torch.device("cpu" if args.platform == "cpu" else "cuda")
    model = build_model(cfg.model, device=device)
    # the fresh init is also the restore's template (shapes, dtypes,
    # device): the model config alone, no training-time optimizer flags
    params = model.init(prng.init_generator(cfg.seed))
    if cfg.checkpoint_dir:
        try:
            restored = ckpt.restore_params(cfg.checkpoint_dir, params)
        except ValueError as e:
            log(f"ERROR: cannot restore {cfg.checkpoint_dir}: {e}")
            return 2
        if restored is None:
            log(f"ERROR: no checkpoint under {cfg.checkpoint_dir}")
            return 2
        step, params = restored
        log(f"restored step {step} from {cfg.checkpoint_dir}")
    else:
        log("note: no --checkpoint_dir; generating from a fresh init")
    generator = None
    if args.temperature > 0:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    out = generate(model, params, [ids], args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, generator=generator,
                   kv_quant=args.kv_quant == "int8",
                   prefill_chunk=args.prefill_chunk, device=device)
    print(",".join(str(int(t)) for t in out[0].tolist()), flush=True)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    for name, default in _UNPORTED_CLI.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name} is not ported to the PyTorch/CUDA package yet")
    if args.generate is not None:
        return _generate(args)
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
