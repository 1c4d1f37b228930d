"""Trainer: the port of the JAX package's ``train/trainer.py`` for its
plain data-parallel branch and its ``data x seq`` branch (sequence
parallelism, ``--sp``).

World formation, dataset build, seeded replicated init, the sharded
loader, the epoch/step loop with per-epoch loss lines, structured metrics,
held-out evaluation, and checkpoint/resume (``--checkpoint_dir``,
``--checkpoint_every``, ``--checkpoint_keep``, ``--resume``,
``--async-checkpoint``; ``utils.checkpoint``, npz layout): a snapshot at
each ``checkpoint_every`` boundary and one at the end; ``--resume``
restores the newest verified snapshot and continues at its exact step,
mid-epoch included, so no step is replayed.  Rank 0 writes, every rank
restores.  The loop keeps the JAX loop's lag-1 loss logging: the host
reads a step's loss only after the next step has been queued, and only at
``log_every`` boundaries, so the device is never drained per step for
logging.

Multi-step dispatch (``--steps_per_dispatch k``, the JAX loop's
``lax.scan`` over k staged batches): the epoch runs in groups of up to k
consecutive batches (``ShardedLoader.epoch_groups``; the same batches in
the same order, the last group of an epoch may be shorter).  On the card
each group is one dispatch of ``parallel.data_parallel.GraphedTrainStep``
(the step captured once as a CUDA graph, replayed per step); on the CPU
it is k eager steps.  Each dispatch logs its LAST step's loss, the step
count advances by the group's steps, a ``checkpoint_every`` multiple that
a dispatch crosses saves at its end, and one CUDA event per dispatch gives
each of its steps the dispatch's ms / n.  One process only, as in JAX: a
multi-process world raises.

Weight-update sharding (``--update_sharding zero1|sharded``, the JAX
trainer's rules and messages): the optimizer state is 1/N per data rank
(``parallel.update_sharding``, ``parallel.data_parallel.zero1_*``),
``--grad_clip`` is applied inside the step by the global norm, and
``--master_weights`` (``sharded`` only) keeps the f32 master copy in that
state.  A snapshot holds the global padded opt-state arrays, as the JAX
package writes them: every rank joins the leaf-by-leaf gather to rank 0's
host, rank 0 writes, and a restore reads into host tensors from which
every rank copies its own slice to its card.

Quantized compute (``--matmul_dtype int8|fp8``, ``--quantize_skip``;
``ops.qmm``): the JAX trainer's rules and messages (transformer only; MoE
refused; fp8 with ``--ce_chunk`` refused; the pipe, expert, seq x tensor
and expert x tensor layouts refused), the fp8 calibration state created
with the params and restored with them (``TrainState.qstate``), and
``+matmul_dtype=...`` in :attr:`Trainer.layout_tag`.

Every flag of a path the port has not taken over yet (model-parallel
axes, telemetry, tracing, resilience, SDC checks, elastic, RL, ...)
raises ``NotImplementedError`` naming the flag when it is set to anything
but its default; none is ignored.

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
from ..data.loader import MULTI_PROCESS_DISPATCH, ShardedLoader
from ..models.registry import build_model
from ..ops import optim as optim_lib
from ..ops import qmm
from ..ops import schedules
from ..parallel import data_parallel as dp
from ..parallel import update_sharding as us
from ..parallel.distributed import describe, world_setup
from ..parallel.sequence import (
    SEQ_SHARDED_IMPLS, UNPORTED_IMPLS, ProcessSeqGroup, resolve_attention_impl,
    striped_permutation,
)
from ..utils import checkpoint as ckpt
from ..utils import prng
from ..utils.logging import MetricsLogger, Throughput, log
from ..utils.platform import DeviceLike
from ..utils.tree import leaves
from .state import TrainState

# TrainConfig fields of paths not ported yet -> the flag that sets them
_UNPORTED = {
    "workload": "--workload", "pp_interleave": "--pp_interleave",
    "vocab_parallel": "--vocab_parallel",
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
_UNPORTED_MODEL = {"moe_experts": "--moe_experts",
                   "moe_expert_axis": "--ep",
                   "moe_capacity_factor": "--moe_capacity_factor",
                   "moe_top_k": "--moe_top_k"}


def check_matmul_dtype(cfg: TrainConfig) -> None:
    """The JAX trainer's rules for ``--matmul_dtype``, with its messages
    and exception types: a transformer only; not under the layouts that
    run their own sliced matmuls (pipe, expert, seq x tensor, expert x
    tensor); not with MoE FFNs; fp8 not with ``--ce_chunk``."""
    mm = cfg.model.matmul_dtype
    if mm not in ("bf16", "int8", "fp8"):
        raise ValueError(f"unknown --matmul_dtype {mm!r} "
                         "(choices: bf16, int8, fp8)")
    if mm != "bf16":
        mesh, moe = cfg.mesh, cfg.model.moe_experts > 0
        pipeline, expert = mesh.pipe > 1, mesh.expert > 1
        seq, tensor, fsdp = mesh.seq > 1, mesh.tensor > 1, mesh.fsdp > 1
        sp_tp = seq and tensor and not (pipeline or expert or fsdp or moe)
        ep_tp = tensor and not (pipeline or fsdp) and (expert
                                                        or (seq and moe))
        if cfg.model.arch != "transformer":
            raise ValueError(
                f"--matmul_dtype {mm} is the transformer's quantized "
                "dense-projection seam; it does nothing for "
                f"arch={cfg.model.arch!r}")
        if pipeline or expert or sp_tp or ep_tp:
            raise NotImplementedError(
                f"--matmul_dtype {mm} is wired on the DP, DP x seq "
                "and GSPMD (tensor/fsdp) layouts; the pipe/expert/"
                "seq-x-tensor layouts run their own sliced matmuls "
                "outside the ops.qmm seam")
        if moe:
            raise ValueError(
                f"--matmul_dtype {mm} covers the dense projections "
                "(qkv/attn_out/ffn/head); the MoE expert einsums are "
                "not routed through the seam — drop --moe_experts")
    if mm == "fp8" and cfg.model.ce_chunk > 0:
        raise ValueError(
            "--matmul_dtype fp8 needs the delayed-scaling amax "
            "observations, which do not thread the --ce_chunk fused "
            "scan; use int8/bf16 with --ce_chunk, or drop it")


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
        check_matmul_dtype(cfg)
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
        self.zero1 = cfg.update_sharding == "zero1"
        self.sharded = cfg.update_sharding == "sharded"
        # the JAX trainer's name of the step's program
        self.layout_tag = "sp" if seq_group is not None else "dp"
        if cfg.update_sharding != "replicated":
            self.layout_tag += f"+{cfg.update_sharding}"
        if cfg.model.matmul_dtype != "bf16":
            self.layout_tag += f"+matmul_dtype={cfg.model.matmul_dtype}"
        if (self.zero1 or self.sharded) and \
                cfg.grad_reduction != "global_mean":
            raise ValueError(f"update_sharding={cfg.update_sharding!r} "
                             "implies global_mean gradient semantics")
        if cfg.master_weights and not self.sharded:
            raise ValueError(
                "--master_weights keeps the f32 master copy in the SHARDED "
                "optimizer state (1/N per replica); it requires "
                "update_sharding='sharded' — a replicated master would "
                "duplicate param memory instead of saving it")
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
        if attention == "auto":     # refuse a length flash cannot take
            m = self.model.cfg
            resolve_attention_impl(
                "auto", cfg.data.seq_len, self.device.type, m.compute_dtype,
                m.head_dim, (m.flash_block_q, m.flash_block_k))
        self.data = build_dataset(cfg.data)
        self.val_data = None
        if cfg.data.val_fraction > 0:
            self.data, val = train_val_split(self.data,
                                             cfg.data.val_fraction, cfg.seed)
            self.val_data = val or None
        self.loader = self._loader(self.data, shuffle=cfg.shuffle)
        self.k_dispatch = int(cfg.steps_per_dispatch)
        if self.k_dispatch < 1:
            raise ValueError(f"--steps_per_dispatch must be >= 1, got "
                             f"{self.k_dispatch}")
        if self.k_dispatch > 1 and self.world.world_size > 1:
            # fail here, not at the first epoch_groups call
            raise NotImplementedError(MULTI_PROCESS_DISPATCH)
        lr = schedules.make(
            cfg.lr_schedule, cfg.lr,
            total_steps=cfg.nepochs * max(self.loader.steps_per_epoch, 1),
            warmup_steps=cfg.warmup_steps, min_lr=cfg.min_lr)
        # the sharded updates clip inside the step, by the global norm
        step_clips = self.zero1 or self.sharded
        self.optimizer = optim_lib.make(
            cfg.optimizer, lr, cfg.momentum, cfg.weight_decay,
            grad_clip=0.0 if step_clips else cfg.grad_clip)
        if cfg.master_weights:
            self.optimizer = optim_lib.with_master_weights(self.optimizer)
        # smoothing applies to the TRAIN loss only; eval reports the
        # unsmoothed loss
        train_loss = (f"{cfg.loss}@{cfg.label_smoothing}"
                      if cfg.label_smoothing else cfg.loss)
        # the JAX seq path passes no grad_reduction: always global_mean
        self.train_step = dp.make_train_step(
            self.model, self.optimizer, self.world, loss_name=train_loss,
            grad_reduction=(cfg.grad_reduction if seq_group is None
                            else "global_mean"),
            accum_steps=cfg.accum_steps,
            update_sharding=cfg.update_sharding,
            grad_clip=cfg.grad_clip if step_clips else 0.0)
        # k > 1: (state, group) -> (state, last loss), a group's steps
        self.multi_step = None
        if self.k_dispatch > 1:
            self.multi_step = (
                dp.GraphedTrainStep(self.train_step, self.optimizer,
                                    self.device)
                if self.device.type == "cuda" else self._eager_group)
        self.eval_step = dp.make_eval_step(
            self.model, self.world, loss_name=cfg.loss,
            with_accuracy=(cfg.loss == "cross_entropy"))
        self.metrics = MetricsLogger(cfg.metrics_jsonl)
        self.state: Optional[TrainState] = None
        # the sharded opt state's place in the global snapshot arrays
        self.layout: Optional[us.ShardedLayout] = None
        self._last_saved_step: Optional[int] = None
        # host seconds of each save call (an async one: its host copy) and
        # of the resume's restore
        self.save_seconds: list = []
        self.restore_seconds: Optional[float] = None

    def _loader(self, data, shuffle: bool) -> ShardedLoader:
        cfg = self.cfg
        w = self.world
        return ShardedLoader(
            data, cfg.batch_size, rank=w.data_rank, world_size=w.dp,
            device=self.device, shuffle=shuffle, seed=cfg.seed,
            full_batch=cfg.full_batch, remainder=cfg.data.remainder,
            backend=cfg.data.backend, seq_rank=w.seq_rank, sp=w.sp,
            seq_permutation=self.seq_permutation)

    def _eager_group(self, state: TrainState, batches):
        """A dispatch's steps one by one: the CPU's multi-step path."""
        loss = None
        for batch in batches:
            state, loss = self.train_step(state, batch)
        return state, loss

    def init_state(self) -> TrainState:
        """Seeded init, identical on every rank (no broadcast needed), drawn
        on the host so the CPU and the GPU start from the same params."""
        params = self.model.init(prng.init_generator(self.cfg.seed))
        if not (self.zero1 or self.sharded):
            self.state = TrainState.from_params(params, self.optimizer,
                                                self.model)
            return self.state
        w = self.world
        params = TrainState.from_params(params, None).params
        if self.zero1:
            opt_state, self.layout = dp.zero1_opt_state(self.optimizer,
                                                        params, w)
        else:
            opt_state, self.layout = us.init_opt_state(
                self.optimizer, params, us.plan_updates(params, w.dp), w.dp,
                w.data_rank, w.data_pg)
        self.state = TrainState(0, params, opt_state,
                                qmm.init_qstate(self.model))
        return self.state

    def snapshot_state(self) -> TrainState:
        """The state a snapshot holds: under update sharding, the global
        padded opt-state arrays on rank 0's host (every rank joins the
        leaf-by-leaf gather; the others hold nothing and write nothing)."""
        s = self.state
        if self.layout is None:
            return s
        return s._replace(opt_state=self.layout.gather_to_host(s.opt_state))

    def maybe_resume(self) -> int:
        """Restore the newest verified snapshot of ``--checkpoint_dir``
        under ``--resume`` and return its step (0 when there is none):
        the loop continues at exactly that step, mid-epoch included.
        Under update sharding the opt state restores into host tensors of
        the global padded shapes, and each rank copies its own slice to
        its card."""
        cfg = self.cfg
        if not (cfg.resume and cfg.checkpoint_dir):
            return 0
        t0 = time.perf_counter()
        s = self.state
        template = s if self.layout is None else s._replace(
            opt_state=self.layout.host_template(s.opt_state))
        # the fp8 histories restore with the rest: a resume continues the
        # delayed scaling where the snapshot left it
        restored = ckpt.restore(cfg.checkpoint_dir, template)
        if restored is None:
            return 0
        if self.layout is not None:     # every rank keeps its own slice
            restored = restored._replace(opt_state=self.layout.scatter(
                restored.opt_state, self.device))
        # the meta of the generation actually restored (the fallback chain
        # may land below a corrupt newest one)
        meta = ckpt.read_meta(cfg.checkpoint_dir, step=restored.step) or {}
        self.state = restored
        # a relaunch keeps a rollback's re-drawn data order
        self.loader.order_salt = int(meta.get("order_salt", 0))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.restore_seconds = time.perf_counter() - t0
        log(f"resumed from {cfg.checkpoint_dir} at step {restored.step} "
            f"({self.restore_seconds:.3f}s)")
        return restored.step

    def save(self, final: bool = False) -> None:
        """Snapshot the state into ``--checkpoint_dir`` (rank 0 writes).
        ``meta.json`` carries the JAX trainer's keys; the final save is
        skipped when that step was just saved."""
        cfg = self.cfg
        if not cfg.checkpoint_dir:
            return
        step = self.state.step
        if final and self._last_saved_step == step:
            ckpt.wait_pending()
            return
        self._last_saved_step = step
        w = self.world
        extra = {"qkv_tp": 1, "order_salt": int(self.loader.order_salt),
                 "saved_world": {
                     "dp": int(self.loader.dp),
                     "mesh": {"data": w.dp, "fsdp": 1, "pipe": 1,
                              "expert": 1, "seq": w.sp, "tensor": 1},
                     "update_sharding": cfg.update_sharding},
                 "consumed_samples": self.loader.consumed_samples(step)}
        t0 = time.perf_counter()
        state = self.snapshot_state()
        if cfg.async_checkpoint and not final:
            ckpt.save_async(cfg.checkpoint_dir, state,
                            keep=cfg.checkpoint_keep, extra_meta=extra)
        else:
            if final:   # drain in-flight writes before the last
                ckpt.wait_pending()
            ckpt.save(cfg.checkpoint_dir, state,
                      keep=cfg.checkpoint_keep, extra_meta=extra)
        self.save_seconds.append(time.perf_counter() - t0)

    def fit(self) -> Dict[str, Any]:
        cfg = self.cfg
        if self.state is None:
            self.init_state()
        spe = max(self.loader.steps_per_epoch, 1)
        start_step = self.maybe_resume()
        cuda = self.device.type == "cuda"
        log(f"mesh: {describe(self.world)} | layout: {self.layout_tag} | "
            f"model: {cfg.model.arch} "
            f"({sum(p.numel() for p in leaves(self.state.params)):,} params) | "
            f"{self.loader.n} samples, {self.loader.steps_per_epoch} "
            "steps/epoch")
        thr = Throughput()
        last_loss = float("nan")
        step = start_step
        prev: Optional[tuple] = None   # (step, epoch, loss, step before)
        # one CUDA event after each dispatch (a step at k = 1): device time
        # per step without a host sync in the loop
        events, event_steps = [], []
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        # in-epoch offset, taken by the first epoch of a resumed run only
        mid_epoch_start = start_step % spe
        for epoch in range(start_step // spe, cfg.nepochs):
            log(f"Starting epoch {epoch + 1}")
            epoch_t0 = time.perf_counter()
            loss = None
            first, mid_epoch_start = mid_epoch_start, 0
            if self.k_dispatch > 1:
                dispatches = self.loader.epoch_groups(
                    epoch, self.k_dispatch, start_step=first)
            else:
                dispatches = ((b, 1, self.loader.batch_rows(first + i))
                              for i, b in enumerate(self.loader.epoch(
                                  epoch, start_step=first)))
            for batch, n_steps, rows in dispatches:
                # lag-1 logging: the previous dispatch's loss is ready (or
                # nearly) by the time this one's batch is here; a dispatch
                # logs when it crossed a log_every boundary
                if prev is not None and cfg.log_every and \
                        prev[0] // cfg.log_every > prev[3] // cfg.log_every:
                    last_loss = float(prev[2])
                    self.metrics.write({
                        "step": prev[0], "epoch": prev[1], "loss": last_loss,
                        "samples_per_sec": thr.samples_per_sec})
                if self.k_dispatch > 1:
                    self.state, loss = self.multi_step(self.state, batch)
                else:
                    self.state, loss = self.train_step(self.state, batch)
                if cuda:
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                    event_steps.append(n_steps)
                thr.add(rows)
                prev = (step + n_steps, epoch, loss, step)
                step += n_steps
                if cfg.checkpoint_every and (step // cfg.checkpoint_every >
                                             prev[3] // cfg.checkpoint_every):
                    self.save()
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
        self.save(final=True)
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
            # a dispatch's ms shared equally by its steps
            result["step_ms"] = [a.elapsed_time(b) / n
                                 for a, b, n in zip(events, events[1:],
                                                    event_steps)
                                 for _ in range(n)]
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
