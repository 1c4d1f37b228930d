"""Trainer: the port of the JAX package's ``train/trainer.py`` for its
plain data-parallel branch and its ``data x seq`` branch (sequence
parallelism, ``--sp``).

World formation, dataset build, seeded replicated init, the sharded
loader, the epoch/step loop with per-epoch loss lines, structured metrics
and held-out evaluation.  The loop keeps the JAX loop's lag-1 loss
logging: the host reads a step's loss only after the next step has been
queued, and only at ``log_every`` boundaries, so the device is never
drained per step for logging.

Every flag of a path the port has not taken over yet (model-parallel
axes, checkpointing, telemetry, tracing, resilience, SDC checks, multi-step
dispatch, elastic, RL, ...) raises ``NotImplementedError`` naming the flag
when it is set to anything but its default; none is ignored.

Sequence parallelism: ``--sp S`` with a sequence-sharded attention
(``ring``, ``ring_flash``, ``striped``, ``striped_flash``) trains on a
``data x seq`` world of ``--dp`` x S torchrun ranks, each holding T/S
columns of its data rows (``parallel.sequence.ProcessSeqGroup``); it
raises in a world too small for it.  ``Trainer(cfg, device,
seq_group=LocalSeqGroup(S))`` instead runs all S shards in this process,
as the JAX Trainer takes an explicit ``mesh=``.  Either way the step's
gradient is the global-batch mean over every token (``global_mean``), as
the JAX package's seq path computes it whatever ``--grad_reduction``
says.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig, RLConfig, TrainConfig
from ..data.datasets import build_dataset, train_val_split
from ..data.loader import ShardedLoader
from ..models.registry import build_model
from ..ops import optim as optim_lib
from ..ops import schedules
from ..parallel import data_parallel as dp
from ..parallel.distributed import describe, world_setup
from ..parallel.sequence import (
    SEQ_SHARDED_IMPLS, UNPORTED_IMPLS, ProcessSeqGroup, striped_permutation,
)
from ..utils import prng
from ..utils.logging import MetricsLogger, Throughput, log
from ..utils.platform import DeviceLike
from ..utils.tree import leaves
from .state import TrainState

# TrainConfig fields of paths not ported yet -> the flag that sets them
_UNPORTED = {
    "workload": "--workload", "steps_per_dispatch": "--steps_per_dispatch",
    "pp_interleave": "--pp_interleave",
    "update_sharding": "--update_sharding",
    "master_weights": "--master-weights",
    "vocab_parallel": "--vocab_parallel",
    "checkpoint_dir": "--checkpoint_dir",
    "checkpoint_every": "--checkpoint_every",
    "checkpoint_keep": "--checkpoint_keep", "resume": "--resume",
    "async_checkpoint": "--async-checkpoint",
    "profile_dir": "--profile_dir", "telemetry_dir": "--telemetry_dir",
    "metrics_every": "--metrics_every",
    "flight_recorder": "--flight_recorder",
    "rollup_every": "--rollup_every", "alerts": "--no-alerts",
    "trace": "--trace", "trace_dir": "--trace_dir",
    "goodput": "--no-goodput", "goodput_target": "--goodput_target",
    "xla_trace_dir": "--xla_trace_dir",
    "check_replicas_every": "--check_replicas_every",
    "sdc_check_every": "--sdc_check_every", "sdc_heal": "--no-sdc-heal",
    "sdc_strikes": "--sdc_strikes", "hang_timeout": "--hang_timeout",
    "skip_nonfinite": "--skip-nonfinite",
    "skip_threshold": "--skip_threshold",
    "rollback_after": "--rollback_after",
    "max_rollbacks": "--max_rollbacks",
    "loss_spike_factor": "--loss_spike_factor", "faults": "--faults",
    "elastic": "--elastic", "min_devices": "--min_devices",
    "elastic_batch": "--elastic_batch",
    "collective_timeout": "--collective_timeout",
}
_UNPORTED_MESH = {"fsdp": "--fsdp", "tensor": "--tp", "pipe": "--pp",
                  "expert": "--ep"}
_UNPORTED_MODEL = {"remat": "--remat", "remat_policy": "--remat_policy",
                   "scan_layers": "--scan-layers",
                   "moe_experts": "--moe_experts",
                   "moe_expert_axis": "--ep",
                   "moe_capacity_factor": "--moe_capacity_factor",
                   "moe_top_k": "--moe_top_k",
                   "matmul_dtype": "--matmul_dtype",
                   "matmul_skip": "--quantize_skip"}


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` naming the first flag of a path the
    port lacks that ``cfg`` sets to a non-default value."""
    base = TrainConfig()
    checks = [(cfg, base, _UNPORTED)]
    checks.append((cfg.mesh, base.mesh, _UNPORTED_MESH))
    checks.append((cfg.model, ModelConfig(), _UNPORTED_MODEL))
    for obj, default, names in checks:
        for field, flag in names.items():
            if getattr(obj, field) != getattr(default, field):
                raise NotImplementedError(
                    f"{flag} (= {getattr(obj, field)!r}) is not ported to "
                    "the PyTorch/CUDA package yet")
    if cfg.rl != RLConfig():
        raise NotImplementedError("the RL flags (--rl_*, --rollout_steps, "
                                  "--gamma, ...) are not ported yet")
    if cfg.data.backend == "native":
        raise NotImplementedError("--data_backend native is not ported yet")
    if cfg.model.attention in UNPORTED_IMPLS:
        raise NotImplementedError(
            f"--attention {cfg.model.attention} is not ported to the "
            "PyTorch/CUDA package yet")


class Trainer:
    def __init__(self, cfg: TrainConfig, device: DeviceLike = None,
                 seq_group=None):
        """``seq_group``: an explicit sequence group (``LocalSeqGroup``)
        for the sequence-sharded attentions; by default ``--sp > 1`` forms
        a ``ProcessSeqGroup`` from the torchrun world."""
        if cfg.param_dtype:
            if cfg.param_dtype not in ("float32", "bfloat16", "float16"):
                raise ValueError(f"unknown --param_dtype {cfg.param_dtype!r}")
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, dtype=cfg.param_dtype))
        refuse_unported(cfg)
        self.cfg = cfg
        attention = (cfg.model.attention if cfg.model.arch == "transformer"
                     else None)
        sp = cfg.mesh.seq
        if seq_group is not None:
            if sp not in (1, seq_group.size):
                raise ValueError(f"--sp {sp} != the sequence group's "
                                 f"{seq_group.size} shards")
            self.world = world_setup(device, dp=cfg.mesh.data)
        else:
            if sp > 1 and attention not in SEQ_SHARDED_IMPLS:
                raise ValueError(
                    f"--sp {sp} needs a sequence-sharded attention (ring, "
                    f"ring_flash, striped, striped_flash), not "
                    f"{attention!r}")
            self.world = world_setup(device, sp=sp, dp=cfg.mesh.data)
            if sp > 1:
                seq_group = ProcessSeqGroup(self.world.seq_pg)
        if attention in SEQ_SHARDED_IMPLS and seq_group is None:
            raise ValueError(
                f"attention={attention!r} needs the sequence split over "
                "--sp > 1 ranks (torchrun) or an explicit LocalSeqGroup; "
                "use dense or flash on an unsharded sequence")
        self.seq_group = seq_group
        self.device = self.world.device
        # striped attention: tokens reorder round-robin over the shards
        # (balanced causal blocks); the loaders permute inputs AND targets
        # alike, so per-token losses are those of the contiguous layout
        self.seq_permutation = None
        if seq_group is not None and attention in ("striped",
                                                   "striped_flash"):
            self.seq_permutation = striped_permutation(cfg.data.seq_len,
                                                       seq_group.size)
        if cfg.grad_reduction not in ("global_mean", "per_shard_mean"):
            raise ValueError(
                f"grad_reduction={cfg.grad_reduction!r} is not a training "
                "semantic (choices: global_mean, per_shard_mean)")
        if cfg.model.ce_chunk > 0 and (
                cfg.model.arch != "transformer"
                or cfg.loss.partition("@")[0] != "cross_entropy"):
            raise ValueError(
                "--ce_chunk fuses the transformer LM head into "
                f"cross-entropy; it does nothing for arch={cfg.model.arch!r} "
                f"loss={cfg.loss!r} — drop it")
        if cfg.label_smoothing and cfg.loss != "cross_entropy":
            raise ValueError("--label_smoothing applies to cross_entropy "
                             f"only, not {cfg.loss!r}")
        if not 0.0 <= cfg.label_smoothing < 1.0:
            raise ValueError(f"label_smoothing must be in [0, 1), got "
                             f"{cfg.label_smoothing}")
        self.model = build_model(cfg.model, device=self.device,
                                 seq_group=seq_group)
        self.data = build_dataset(cfg.data)
        self.val_data = None
        if cfg.data.val_fraction > 0:
            self.data, val = train_val_split(self.data,
                                             cfg.data.val_fraction, cfg.seed)
            self.val_data = val or None
        self.loader = self._loader(self.data, shuffle=cfg.shuffle)
        lr = schedules.make(
            cfg.lr_schedule, cfg.lr,
            total_steps=cfg.nepochs * max(self.loader.steps_per_epoch, 1),
            warmup_steps=cfg.warmup_steps, min_lr=cfg.min_lr)
        self.optimizer = optim_lib.make(cfg.optimizer, lr, cfg.momentum,
                                        cfg.weight_decay,
                                        grad_clip=cfg.grad_clip)
        # smoothing applies to the TRAIN loss only; eval reports the
        # unsmoothed loss
        train_loss = (f"{cfg.loss}@{cfg.label_smoothing}"
                      if cfg.label_smoothing else cfg.loss)
        # the JAX seq path passes no grad_reduction: always global_mean
        self.train_step = dp.make_train_step(
            self.model, self.optimizer, self.world, loss_name=train_loss,
            grad_reduction=(cfg.grad_reduction if seq_group is None
                            else "global_mean"),
            accum_steps=cfg.accum_steps)
        self.eval_step = dp.make_eval_step(
            self.model, self.world, loss_name=cfg.loss,
            with_accuracy=(cfg.loss == "cross_entropy"))
        self.metrics = MetricsLogger(cfg.metrics_jsonl)
        self.state: Optional[TrainState] = None

    def _loader(self, data, shuffle: bool) -> ShardedLoader:
        cfg = self.cfg
        w = self.world
        return ShardedLoader(
            data, cfg.batch_size, rank=w.data_rank, world_size=w.dp,
            device=self.device, shuffle=shuffle, seed=cfg.seed,
            full_batch=cfg.full_batch, remainder=cfg.data.remainder,
            backend=cfg.data.backend, seq_rank=w.seq_rank, sp=w.sp,
            seq_permutation=self.seq_permutation)

    def init_state(self) -> TrainState:
        """Seeded init, identical on every rank (no broadcast needed), drawn
        on the host so the CPU and the GPU start from the same params."""
        params = self.model.init(prng.init_generator(self.cfg.seed))
        self.state = TrainState.from_params(params, self.optimizer)
        return self.state

    def fit(self) -> Dict[str, Any]:
        cfg = self.cfg
        if self.state is None:
            self.init_state()
        cuda = self.device.type == "cuda"
        log(f"mesh: {describe(self.world)} | model: {cfg.model.arch} "
            f"({sum(p.numel() for p in leaves(self.state.params)):,} params) | "
            f"{self.loader.n} samples, {self.loader.steps_per_epoch} "
            "steps/epoch")
        thr = Throughput()
        last_loss = float("nan")
        step = 0
        prev: Optional[tuple] = None   # (step, epoch, loss, step before)
        # one CUDA event after each step: device time per step without a
        # host sync in the loop
        events = []
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        for epoch in range(cfg.nepochs):
            log(f"Starting epoch {epoch + 1}")
            epoch_t0 = time.perf_counter()
            loss = None
            for i, batch in enumerate(self.loader.epoch(epoch)):
                # lag-1 logging: the previous step's loss is ready (or
                # nearly) by the time this step's batch is here
                if prev is not None and cfg.log_every and \
                        prev[0] // cfg.log_every > prev[3] // cfg.log_every:
                    last_loss = float(prev[2])
                    self.metrics.write({
                        "step": prev[0], "epoch": prev[1], "loss": last_loss,
                        "samples_per_sec": thr.samples_per_sec})
                self.state, loss = self.train_step(self.state, batch)
                if cuda:
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                thr.add(self.loader.batch_rows(i))
                prev = (step + 1, epoch, loss, step)
                step += 1
            if loss is not None:
                last_loss = float(loss)
            log(f"epoch {epoch + 1}: loss {last_loss:.6f} "
                f"({time.perf_counter() - epoch_t0:.3f}s)")
            if (self.val_data is not None and cfg.eval_every
                    and (epoch + 1) % cfg.eval_every == 0):
                ev = self.evaluate(self.val_data)
                log("validation: " + ", ".join(
                    f"{k} {v:.6f}" for k, v in sorted(ev.items())))
                self.metrics.write({"step": step, "epoch": epoch,
                                    **{f"val_{k}": v for k, v in ev.items()}})
        if prev is not None and cfg.log_every and \
                prev[0] // cfg.log_every > prev[3] // cfg.log_every:
            self.metrics.write({"step": prev[0], "epoch": prev[1],
                                "loss": last_loss,
                                "samples_per_sec": thr.samples_per_sec})
        result = {"final_loss": last_loss, "steps": step,
                  "samples_per_sec": thr.samples_per_sec}
        fwd = getattr(self.model, "fwd_flops", None)
        if fwd is not None:
            sample = (1,) + tuple(self.data["x"].shape[1:])
            # fwd + ~2x for the backward per sample
            result["model_flops_per_sec"] = (3.0 * fwd(sample)
                                             * thr.samples_per_sec)
        if cuda:
            events[-1].synchronize()
            result["step_ms"] = [a.elapsed_time(b)
                                 for a, b in zip(events, events[1:])]
            result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        if self.val_data is not None:
            ev = self.evaluate(self.val_data)
            self.metrics.write({"step": step, "final": True,
                                **{f"val_{k}": v for k, v in ev.items()}})
            result.update({f"val_{k}": v for k, v in ev.items()})
        self.metrics.close()
        return result

    def evaluate(self, data=None) -> Dict[str, float]:
        loader = self.loader if data is None else self._loader(
            data, shuffle=False)
        sums: Dict[str, float] = {}
        totals: Dict[str, float] = {}
        for batch in loader.epoch(0):
            m = {k: float(v) for k, v in
                 self.eval_step(self.state.params, batch).items()}
            c = m.pop("count")
            ec = m.pop("example_count", c)
            for k, v in m.items():
                w = ec if k == "accuracy" else c   # per-example vs per-token
                sums[k] = sums.get(k, 0.0) + v * w
                totals[k] = totals.get(k, 0.0) + w
        out = {k: v / totals[k] for k, v in sums.items()}
        if self.cfg.loss == "cross_entropy" and "loss" in out:
            out["ppl"] = (float(np.exp(min(out["loss"], 30.0)))
                          if not math.isnan(out["loss"]) else float("nan"))
        return out
