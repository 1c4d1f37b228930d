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
and ``--prefill_chunk`` as in ``models.generate``.  ``--quantize int8``
quantizes the restored weights (``ops.quant``; ``--quantize_skip head``
keeps named sites in full precision) and decodes through the dequant
product, or with ``--matmul_dtype int8`` through int8 x int8 products
(``ops.qmm``); ``--matmul_dtype fp8`` over them is refused with rc 2.
Training ignores ``--quantize``, as the JAX CLI does.

Resilience (``train.resilience``): ``--supervise N`` runs this same
command as a child under the crash-restart supervisor (backoff
``--supervise_backoff``, capped at ``--supervise_backoff_max``), adding
``--resume`` when a checkpoint dir is set.  Training maps its failures to
the exit-code contract: an anomaly abort exits 44, a lost peer (a
collective that raised or timed out, a world that did not form) 43, a
preemption notice answered with a final snapshot 47, and the hang
watchdog 42 (after the flight recorder's postmortem, with
``--telemetry_dir``).  ``--probe_timeout`` bounds the formation of a
multi-process world (``parallel.distributed.preflight``).  An SDC abort
(a replica divergence the replay reproduced, or a device over its
``--sdc_strikes``) exits 45 and a world below ``--min_devices`` 46, which
the supervisor does not retry; under ``--supervise N --elastic`` a streak
of peer-loss exits probes the world (``parallel.distributed.probe_world``
with its local fallback) and relaunches at the one that answers.

MoE: ``--moe_experts N`` (``--moe_top_k``, ``--moe_capacity_factor``)
gives every block a routed expert FFN; ``--ep E`` splits the experts (and
the batch rows) over E expert shards, with ``--sp`` and / or ``--tp``
(``train.trainer``), in one process as a ``LocalExpertGroup`` or over
torchrun ranks; ``--ep E`` without ``--moe_experts`` means 2E experts.
``--generate`` decodes an MoE snapshot of any of these layouts.

Not ported, and raising when set: the JAX platform knob
``--num_devices``.
"""

from __future__ import annotations

import os
import sys

from .config import build_argparser, config_from_args
from .utils.logging import log

# CLI-only flags of paths the port lacks -> their defaults
_UNPORTED_CLI = {"num_devices": None}


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
    # as the JAX CLI: the mesh flags (--tp, --fsdp, ...) do not apply, a
    # snapshot of any layout is reconciled into dense params below and
    # decoded on one device
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
            # a pipeline snapshot's blocks are stage-stacked: the template
            # takes the stack the snapshot holds
            stack = ckpt.block_stack(cfg.checkpoint_dir, params)
            if len(stack) >= 2:
                from .parallel.pipeline import stack_blocks

                params = dict(params, blocks=stack_blocks(
                    params["blocks"], stack[-2],
                    stack[0] if len(stack) == 3 else 1))
            restored = ckpt.restore_params(cfg.checkpoint_dir, params)
        except ValueError as e:
            log(f"ERROR: cannot restore {cfg.checkpoint_dir}: {e}")
            return 2
        if restored is None:
            log(f"ERROR: no checkpoint under {cfg.checkpoint_dir}")
            return 2
        step, params = restored
        # a seq x tensor, expert x tensor or pipeline snapshot holds its
        # qkv columns
        # permuted (its meta's qkv_tp), a pipeline's blocks stage-stacked:
        # the decoder reads the dense per-layer order (JAX's
        # _dense_decode_params)
        saved_tp = int((ckpt.read_meta(cfg.checkpoint_dir, step=step)
                        or {}).get("qkv_tp", 1))
        from .parallel.pipeline import dense_layer_blocks

        params = dict(params, blocks=dense_layer_blocks(
            params["blocks"], model.cfg, saved_tp))
        log(f"restored step {step} from {cfg.checkpoint_dir}")
    else:
        log("note: no --checkpoint_dir; generating from a fresh init")
    if args.quantize == "int8" and cfg.model.matmul_dtype == "fp8":
        # Linear's fp8 branch needs float kernels: over PTQ weights the
        # flag would do nothing
        log("ERROR: --matmul_dtype fp8 cannot run over --quantize int8 "
            "PTQ kernels; use --matmul_dtype int8 (true int8 compute) "
            "or bf16 (dequant) with PTQ weights")
        return 2
    if args.quantize == "int8":
        from .ops.quant import quantize_params, quantized_bytes

        skip = tuple(s for s in (args.quantize_skip or "").split(",") if s)
        full_b = quantized_bytes(params)
        params = quantize_params(params, skip=skip)
        log(f"int8 weights-only PTQ: param bytes {full_b/2**20:.1f} -> "
            f"{quantized_bytes(params)/2**20:.1f} MiB"
            + (f" (kept {','.join(skip)} full-precision)" if skip else ""))
        if cfg.model.matmul_dtype == "int8":
            log("int8 COMPUTE decode: true int8 activation x weight dot "
                "(ops.qmm) over the PTQ kernels")
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


def _supervise(args, argv) -> int:
    """``--supervise N``: this command, minus the supervisor flags and
    plus ``--resume`` when a checkpoint dir is set, as the child of
    ``train.resilience.supervise``; SIGUSR1 is forwarded to it.

    With ``--telemetry_dir`` the supervisor also watches the child's own
    heartbeat (``heartbeat-train-p<P>.json``) when ``--hang_timeout`` is
    set, at max(4 x that timeout, 60 s), so the in-process watchdog fires
    first; points the relaunch log at the child's ``postmortem.json``;
    summarizes the child's ``kind="alert"`` records; and appends its
    lifecycle records to ``supervisor-events.jsonl`` (in the trace
    directory under ``--trace``/``--trace_dir``)."""
    from .train.resilience import strip_supervisor_flags, supervise

    child = strip_supervisor_flags(argv)
    if args.checkpoint_dir and "--resume" not in child:
        child.append("--resume")
    heartbeat = postmortem = alerts = events = None
    heartbeat_timeout = 0.0
    if args.telemetry_dir:
        # watch exactly THIS child's heartbeat, the role-qualified file
        # its telemetry writes (never a co-resident process's)
        from .train import trace as trace_lib
        from .train.resilience import heartbeat_filename

        heartbeat = os.path.join(args.telemetry_dir,
                                 heartbeat_filename("train"))
        postmortem = os.path.join(args.telemetry_dir, "postmortem.json")
        alerts = os.path.join(args.telemetry_dir, "metrics.jsonl")
        # the lifecycle JSONL beside the trace files (the goodput join),
        # else directly under the telemetry dir
        events_dir = (trace_lib.dir_from_config(args)
                      if args.trace or args.trace_dir
                      else args.telemetry_dir)
        os.makedirs(events_dir, exist_ok=True)
        events = os.path.join(events_dir, "supervisor-events.jsonl")
        if args.hang_timeout > 0:
            # 4x the in-process timeout: the child's own watchdog (and
            # its postmortem) fires first
            heartbeat_timeout = max(4.0 * args.hang_timeout, 60.0)
    probe = None
    if args.elastic:
        def probe():
            # the probe's rendezvous runs in a subprocess: this process
            # never joins a world
            from .parallel.distributed import probe_world

            return probe_world(timeout_s=args.probe_timeout,
                               log=lambda m: print(m, file=sys.stderr,
                                                   flush=True))
    pkg = __name__.rsplit(".", 1)[0]
    return supervise([sys.executable, "-m", pkg, *child],
                     max_restarts=args.supervise,
                     backoff=args.supervise_backoff,
                     backoff_cap=args.supervise_backoff_max,
                     heartbeat_path=heartbeat,
                     heartbeat_timeout=heartbeat_timeout,
                     postmortem_path=postmortem, alerts_path=alerts,
                     ckpt_dir=args.checkpoint_dir, elastic=args.elastic,
                     min_devices=args.min_devices, probe=probe,
                     events_path=events, forward_preempt=True,
                     model_ranks=args.sp * args.tp * args.fsdp)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    for name, default in _UNPORTED_CLI.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name} is not ported to the PyTorch/CUDA package yet")
    if args.supervise > 0:
        return _supervise(args, argv)   # before any device or world
    if args.generate is not None:
        return _generate(args)
    from .parallel.distributed import WORLD_TIMEOUT_ENV
    from .train.resilience import (EXIT_ANOMALY, EXIT_CAPACITY,
                                   EXIT_DECOMMISSION, EXIT_PEER, EXIT_SDC,
                                   AnomalyAbort, CapacityAbort, SDCAbort,
                                   is_peer_error)
    from .train.trainer import Trainer

    os.environ[WORLD_TIMEOUT_ENV] = str(args.probe_timeout)
    device = "cpu" if args.platform == "cpu" else "cuda"
    cfg = config_from_args(args)
    try:
        result = Trainer(cfg, device=device).fit()
    except AnomalyAbort as e:
        # the last good snapshot is kept (no final save); no relaunch
        log(f"ERROR: anomaly abort: {e} (exit {EXIT_ANOMALY})")
        return EXIT_ANOMALY
    except SDCAbort as e:
        # no final save (it would snapshot corrupt state); no relaunch
        # (it would replay the bug, or reuse the failing device)
        log(f"ERROR: SDC abort: {e} (exit {EXIT_SDC})")
        return EXIT_SDC
    except CapacityAbort as e:
        # a relaunch cannot create devices
        log(f"ERROR: capacity abort: {e} (exit {EXIT_CAPACITY})")
        return EXIT_CAPACITY
    except Exception as e:
        if not is_peer_error(e):
            raise
        import traceback

        traceback.print_exc()
        log(f"ERROR: peer loss: {type(e).__name__}: {e} (exit {EXIT_PEER})")
        # a hard exit: the process group's threads may still hold the
        # lost peer's sockets, and an ordinary teardown could block or
        # abort over them
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_PEER)
    log(f"done: final loss {result['final_loss']:.6f}, "
        f"{result['samples_per_sec']:.1f} samples/sec")
    val = {k: v for k, v in result.items() if k.startswith("val_")}
    if val:
        log("validation: " + ", ".join(f"{k[4:]} {v:.6f}"
                                       for k, v in sorted(val.items())))
    if result.get("preempt_notice"):
        return EXIT_DECOMMISSION
    return 0


if __name__ == "__main__":
    sys.exit(main())
