"""Typed configuration for training jobs.

The reference exposes four untyped argparse flags
(dataParallelTraining_NN_MPI.py:244-253): ``--lr`` (default 0.001),
``--momentum`` (default 0.9), ``--batch_size`` (default 4, parsed but never
used — bug B1 in SURVEY.md §2.5) and ``--nepochs`` (default 3).  Here every
knob is a typed dataclass field (fixing bug B3: the reference's flags lack
``type=`` so CLI-passed values arrive as ``str``), ``batch_size`` is honored
for real, and the config is serializable for logging/checkpoint metadata.

The port's own copy of the JAX package's ``config.py``: the same
dataclasses, flag names and defaults, so one command line means the same
job in both packages.  The one difference is ``--platform`` (auto | cpu |
gpu), where auto means the CUDA device and never falls back to the CPU.
Flags of paths the port has not taken over yet parse as before; the
Trainer and the CLI refuse them when they are set (``train.trainer``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class MeshConfig:
    """Logical device mesh axes.

    Replaces the reference's world discovery (``MPI.COMM_WORLD`` /
    ``Get_rank`` / ``Get_size``, dataParallelTraining_NN_MPI.py:61-63): on
    TPU the "world" is a named mesh over the chips, and parallelism styles
    are axis assignments rather than process topologies.

    ``data=-1`` means "all devices not consumed by other axes" (the common
    pure-DP case, mirroring the reference where every process is a data
    worker).
    """

    data: int = -1      # data parallelism (the reference's only axis)
    fsdp: int = 1       # parameter/optimizer sharding (ZeRO-style)
    tensor: int = 1     # tensor (model) parallelism
    pipe: int = 1       # pipeline parallelism
    seq: int = 1        # sequence/context parallelism (ring attention)
    expert: int = 1     # expert parallelism (MoE)

    def axis_sizes(self, n_devices: int) -> Dict[str, int]:
        sizes = {
            "data": self.data,
            "fsdp": self.fsdp,
            "tensor": self.tensor,
            "pipe": self.pipe,
            "seq": self.seq,
            "expert": self.expert,
        }
        fixed = 1
        wild = None
        for name, s in sizes.items():
            if s == -1:
                if wild is not None:
                    raise ValueError("at most one mesh axis may be -1")
                wild = name
            else:
                if s < 1:
                    raise ValueError(f"mesh axis {name} must be >=1 or -1, got {s}")
                fixed *= s
        if wild is not None:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise ValueError(
                    f"mesh axes product {fixed} != device count {n_devices}"
                )
        return sizes


@dataclass
class DataConfig:
    """Dataset generation/loading knobs.

    Defaults reproduce the reference workload: sklearn ``make_regression``
    with 16 samples x 2 features, noise=1, random_state=42
    (dataParallelTraining_NN_MPI.py:72), globally standardized (fixing bug
    B4: the reference standardizes per-shard at :21-22 so workers see
    differently-normalized data).
    """

    dataset: str = "regression"  # regression | wide_regression | digits | mnist | cifar10 | lm | text
    # dataset='text': byte-level LM over this local file (zero-egress real
    # text; data.datasets.text_dataset)
    text_file: str = ""
    n_samples: Optional[int] = None  # None = per-dataset default (16 for regression)
    n_features: int = 2
    noise: float = 1.0
    seed: int = 42
    standardize: bool = True
    # sequence datasets (lm)
    seq_len: int = 128
    vocab_size: int = 256
    # classification datasets
    n_classes: int = 10
    # how to make the global batch divisible by the data-axis size:
    #   pad  - zero-pad + mask (exact global gradient; SURVEY.md §7 "hard parts")
    #   drop - drop the remainder samples
    remainder: str = "pad"
    # held-out validation fraction (0 = train on everything, the reference
    # default; its own validation/test blocks are dead code — SURVEY.md C10)
    val_fraction: float = 0.0
    # batch assembly backend: numpy (in-process), native (C++ threaded
    # shuffle/gather/prefetch runtime, data.native_loader), or auto
    backend: str = "numpy"


@dataclass
class ModelConfig:
    """Model selection.  ``mlp`` with default sizes is the reference MLP
    Linear(2,3)->ReLU->Linear(3,1) (dataParallelTraining_NN_MPI.py:41-45)."""

    arch: str = "mlp"  # mlp | convnet | transformer
    in_features: int = 2
    hidden: Tuple[int, ...] = (3,)
    out_features: int = 1
    activation: str = "relu"
    # convnet
    channels: Tuple[int, ...] = (32, 64)
    image_hw: Tuple[int, int] = (32, 32)
    in_channels: int = 3
    # transformer
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    # 0 = classic multi-head; >0 = grouped-query attention (GQA): that
    # many K/V heads shared across n_heads query heads — the KV cache
    # (decode bandwidth/HBM) shrinks by n_heads/n_kv_heads
    n_kv_heads: int = 0
    d_ff: int = 512
    vocab_size: int = 256
    max_seq_len: int = 512
    # auto (default) = per-backend shape dispatch: dense below the
    # measured crossover, flash above (parallel.sequence.AUTO_FLASH_MIN_SEQ,
    # seeded from BENCH_ATTENTION.json); explicit impls pin the choice
    attention: str = "auto"  # auto | dense | flash (pallas) | ring | ulysses
    # "learned" position table (default) or "rope" rotary q/k (no
    # position parameters; relative-distance attention)
    pos_encoding: str = "learned"
    # transformer FFN activation; "swiglu" = gated FFN with a third
    # (d, ff) projection (pick ~2/3 d_ff for iso-params)
    ffn_activation: str = "gelu"
    dtype: str = "float32"  # param dtype; activations may use bfloat16 on TPU
    compute_dtype: str = "float32"
    # quantized-matmul seam (ops.qmm, DESIGN.md §14): run the dense
    # projections in this format.  bf16 = the plain compute-dtype matmul
    # (byte-identical no-op); int8 = dynamic int8 x int8 -> int32
    # (training custom_vjp / serving against --quantize int8 PTQ
    # weights); fp8 = e4m3 fwd / e5m2 bwd with delayed-scaling amax
    # state in TrainState.qstate.  Transformer only; DP / DP x seq /
    # GSPMD step builders (+ zero1/'sharded' update sharding).
    matmul_dtype: str = "bf16"
    # projection sites excluded from the quantized-compute seam (kept on
    # the plain compute-dtype matmul): the CLI folds --quantize_skip in
    # here so a layer kept full-precision in storage is never
    # dynamically quantized in compute either
    matmul_skip: Tuple[str, ...] = ()
    remat: bool = False  # jax.checkpoint the forward to trade FLOPs for HBM
    # what jax.checkpoint may SAVE under --remat (models.core.make_remat):
    #   full          save nothing, recompute everything (max HBM saving)
    #   dots          save matmul outputs (skip recomputing MXU work)
    #   dots_no_batch save only batch-free matmul outputs (weights-side)
    remat_policy: str = "full"
    # transformer: lax.scan over stacked blocks — compile time stops
    # growing with n_layers (DP / DP x seq / seq x tensor paths; the
    # pipeline/GSPMD/expert layouts own their stacking)
    scan_layers: bool = False
    # MoE FFN (transformer only): 0 = dense.  moe_expert_axis is set to
    # 'expert' when the mesh's expert axis is >1 (parallel.expert wires the
    # all_to_all dispatch)
    moe_experts: int = 0
    moe_expert_axis: Optional[str] = None
    # per-expert slot count = ceil(factor * group_tokens / n_experts);
    # tokens over capacity fall through the residual (models/moe.py)
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1  # 1 = Switch; 2 = GShard-style top-2 routing
    # transformer: fused chunked cross-entropy — evaluate LM head + CE
    # ce_chunk tokens at a time under jax.checkpoint so the (B, T, vocab)
    # f32 logits tensor is never materialized (0 = off).  Loss math is
    # unchanged; peak HBM for large vocabularies drops ~T/ce_chunk-fold.
    ce_chunk: int = 0


@dataclass
class RLConfig:
    """Anakin actor–learner RL knobs (``--workload rl``; rl/ package,
    DESIGN.md §13).  Environments are dim-0-sharded over the data axes
    and the whole rollout+GAE+PPO cycle is ONE jitted step on the mesh
    (arXiv 2104.06272); the shared training knobs — optimizer, lr
    schedule, grad clip, skip guard, checkpointing, telemetry,
    supervisor — come from the enclosing TrainConfig unchanged."""

    env: str = "gridworld"      # gridworld | cartpole (rl.envs)
    n_envs: int = 64            # GLOBAL env count (must divide by dp)
    rollout_steps: int = 32     # T: env steps per Anakin step
    total_updates: int = 200    # Anakin steps (rollout + PPO update cycles)
    gamma: float = 0.99         # discount
    gae_lambda: float = 0.95    # GAE lambda (arXiv 1506.02438)
    clip_eps: float = 0.2       # PPO clipped-surrogate epsilon
    entropy_coef: float = 0.01  # entropy bonus weight
    value_coef: float = 0.5     # value-loss weight
    # full-batch clipped-surrogate passes per rollout (each one optimizer
    # update; the lr schedule's domain is total_updates * ppo_epochs)
    ppo_epochs: int = 4
    # policy/value MLP torso widths (head: n_actions + 1 outputs)
    hidden: Tuple[int, ...] = (64, 64)


@dataclass
class TrainConfig:
    """Full job config.  The four reference knobs keep their reference
    defaults (dataParallelTraining_NN_MPI.py:245-252)."""

    # which learner the CLI runs: "train" = the supervised Trainer,
    # "rl" = the Anakin actor–learner (rl.runner.RLRunner); both share
    # the optimizer/checkpoint/telemetry/resilience knobs below
    workload: str = "train"

    lr: float = 1e-3
    momentum: float = 0.9
    batch_size: int = 4        # honored (reference parses but ignores it — bug B1)
    nepochs: int = 3
    full_batch: bool = True    # reference behavior: one full-shard batch per epoch (:146)
    optimizer: str = "sgd"     # sgd | adam | adamw | lion | adafactor
    weight_decay: float = 0.0
    # lr schedule over optimizer steps (ops.schedules); "constant" = the
    # reference's fixed lr.  total_steps is derived from nepochs x
    # steps-per-epoch by the Trainer.
    lr_schedule: str = "constant"  # constant | cosine | linear
    warmup_steps: int = 0
    min_lr: float = 0.0
    grad_clip: float = 0.0     # global-norm clip; 0 = off
    # microbatch gradient accumulation inside the jitted step (DP path);
    # 1 = off.  One accumulated update = one optimizer step.
    accum_steps: int = 1
    # multi-step dispatch (--steps_per_dispatch k): the epoch in groups of
    # up to k consecutive batches (data.loader.ShardedLoader.epoch_groups:
    # the same batches in the same order), each group one dispatch; on the
    # card the train step is captured once as a CUDA graph and replayed
    # per step (parallel.data_parallel.GraphedTrainStep).  One process
    # only, as in the JAX package.  1 = off.
    steps_per_dispatch: int = 1
    # virtual stage-slices per pipeline device (interleaved schedule,
    # parallel.pipeline): bubble fraction (pp-1)/(v*M + pp-1) instead of
    # (pp-1)/(M + pp-1) at constant microbatch count; costs v ppermute
    # hops per microbatch.  Requires n_layers % (v * pp) == 0; composes
    # with the pipeline's Megatron tensor axis (DP x TP x PP).
    pp_interleave: int = 1
    loss: str = "mse"          # mse | cross_entropy
    # mix the one-hot CE target with uniform: (1-s)*onehot + s/C.  Applies
    # to the TRAIN loss only (validation reports the unsmoothed loss)
    label_smoothing: float = 0.0
    # how gradients are reduced across the data axis:
    #   global_mean    - exact gradient of the global-batch mean loss (default;
    #                    correct even with uneven/padded shards)
    #   per_shard_mean - mean of per-shard mean-gradients, the reference's
    #                    semantics (:188-197); equals global_mean when shards
    #                    are even
    grad_reduction: str = "global_mean"
    # cross-replica weight-update sharding (arXiv 2004.13336):
    #   zero1   - flat-buffer form: ravel the whole tree into one padded
    #             f32 buffer sharded over the data axes (shard_map DP /
    #             DP x seq paths)
    #   sharded - automatic PER-LEAF form (parallel.update_sharding):
    #             each leaf's update scatters along its largest dim (tiny
    #             leaves stay replicated) — reduce-scatter grads, update
    #             the 1/N slice with 1/N optimizer state, all-gather
    #             params; one reduce-scatter per leaf, schedulable
    #             against the backward (comm/compute overlap).  Works on
    #             the shard_map DP / DP x seq paths AND the GSPMD path
    #             (expressed there as opt-state NamedShardings).
    update_sharding: str = "replicated"  # replicated | zero1 | sharded
    # param storage dtype override for the training job ("" = the model
    # config's --dtype): bfloat16 halves param HBM and the sharded
    # update's all-gather bytes; pair with master_weights for f32 update
    # math
    param_dtype: str = ""  # "" | float32 | bfloat16 | float16
    # mixed-precision master weights (ops.optim.with_master_weights):
    # keep an f32 master copy of the params INSIDE the sharded optimizer
    # state (1/N per replica — the arXiv 2004.13336 memory trick) and
    # re-cast into param_dtype each step, so bf16 storage never
    # accumulates rounding drift.  Requires update_sharding='sharded'.
    master_weights: bool = False
    # Megatron vocab parallelism on the seq x tensor path: embedding table
    # and LM head sharded on the vocab dim, cross-entropy computed over the
    # sharded logits (never materialized full) — parallel.megatron
    vocab_parallel: bool = False
    seed: int = 0
    log_every: int = 1
    shuffle: bool = True
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    rl: RLConfig = field(default_factory=RLConfig)
    # checkpointing (extension beyond reference parity, SURVEY.md §5.4)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # steps; 0 = only at end
    # retain the newest K committed snapshots (0 = keep all); pruning
    # never deletes the last VERIFIED snapshot (utils.checkpoint,
    # DESIGN.md §8)
    checkpoint_keep: int = 3
    resume: bool = False
    # overlap periodic checkpoint writes with compute (background writer;
    # the final save is always synchronous)
    async_checkpoint: bool = False
    # observability (SURVEY.md §5.1/5.5)
    profile_dir: Optional[str] = None
    metrics_jsonl: Optional[str] = None
    # ---- telemetry (train.telemetry; DESIGN.md §7; all off by default) --
    # directory for the telemetry artifacts: metrics.jsonl (per-step
    # grad/param norms, update ratio, loss, mfu, step time), heartbeat.json
    # (run-health snapshot, refreshed per dispatch), postmortem.json
    # (flight-recorder dump on crash/rollback/abort/hang/SIGTERM).
    # None = telemetry off (zero cost).
    telemetry_dir: Optional[str] = None
    # fetch + record the on-device metrics every N steps (boundary-crossing
    # rule, like log_every/checkpoint_every); 0 disables the metrics stream
    # while keeping heartbeat + flight-recorder events
    metrics_every: int = 1
    # flight-recorder ring size (last N step records + events kept for the
    # postmortem dump); 0 disables the recorder
    flight_recorder: int = 64
    # fleet-plane rollups (utils/sketches.py, DESIGN.md §7): every N steps
    # emit a kind="rollup" record into metrics.jsonl carrying SERIALIZED
    # quantile-sketch state (loss/grad_norm/step_time/samples-per-sec/mfu)
    # + counters, stamped with the (process, run, incarnation) identity —
    # the snapshots tools/obs_agg.py merges into fleet percentiles.
    # 0 = off (a final rollup still writes at flush when a cadence is set)
    rollup_every: int = 0
    # kind="alert" records (EMA z-score anomalies on loss/grad_norm/
    # samples-per-sec + immediate non-finite alerts) into metrics.jsonl;
    # observe-and-annotate only — the rollback/abort policy stays
    # ResilienceMonitor's.  On whenever telemetry is on.
    alerts: bool = True
    # ---- distributed tracing + compile ledger (train/trace.py,
    # utils/compile_ledger.py; off by default, zero cost when off) ----
    # host-side span timeline (load/dispatch/fetch/eval/ckpt/rollback and
    # the serving tick phases) + compile-event ledger, written per
    # process as trace-p{P}-i{I}.jsonl / compiles-p{P}-i{I}.jsonl and
    # merged by tools/trace_report.py into one Perfetto trace.json.
    # trace=True rides --telemetry_dir (a trace/ subdir); trace_dir
    # names an explicit directory (and implies trace on).
    trace: bool = False
    trace_dir: Optional[str] = None
    # goodput accounting (utils/goodput.py): an online taxonomy meter on
    # the trace span-listener seam, emitting kind="goodput" records on
    # the rollup cadence (categories provably sum to covered wall-clock;
    # step anatomy joined from the compile ledger's XLA cost analysis).
    # On whenever telemetry is on; priced by bench.py --goodput.
    goodput: bool = True
    # goodput-fraction floor for the ErrorBudget burn alert: a rollup
    # window whose productive-step share is below this misses the SLO
    goodput_target: float = 0.5
    # leader-gated jax.profiler capture (utils.profiling.trace): the
    # DEVICE-side complement to the host spans — per-op XLA timelines
    # for TensorBoard/XProf.  Alias of the legacy profile_dir knob with
    # the documented two-trace relationship (README "Observability").
    xla_trace_dir: Optional[str] = None
    # evaluate on the validation split every N epochs (0 = only after
    # training); needs data.val_fraction > 0
    eval_every: int = 0
    # verify replicated state stays bit-identical across device shards
    # every N steps (0 = off) — the SPMD analogue of a race detector
    # (utils.consistency; SURVEY.md §5.2: the reference has none).
    # Since the SDC layer (DESIGN.md §9) this routes through the same
    # O(1) on-device fingerprint as sdc_check_every, fetched at the lag-2
    # discipline (it no longer drains the async pipeline), but stays
    # DETECT-ONLY: a divergence localizes, triages and then raises
    # instead of healing.
    check_replicas_every: int = 0
    # ---- silent-data-corruption defense (utils.consistency, DESIGN.md
    # §9; all defaults = off) ----
    # fingerprint the replicated train state every N steps (0 = off): a
    # jitted per-device (uint32 digest, float fold) pair — O(1) host
    # traffic per check, fetched at the monitor's lag-2 discipline.  On
    # mismatch: localize the diverged leaves/shards (majority vote),
    # replay the last step from a consistency-restored state to triage
    # deterministic-bug vs transient-fault, then heal or abort (exit 45)
    sdc_check_every: int = 0
    # heal transient divergence in place (restore replication from the
    # majority shard; cross-host divergence rolls back to the newest
    # verified checkpoint instead) and keep training.  False = detect,
    # localize, triage, then raise — the pre-SDC assert contract
    sdc_heal: bool = True
    # abort with exit 45 once any single device has caused this many
    # transient (healed) divergences — repeated strikes mean failing
    # hardware, not weather
    sdc_strikes: int = 3
    # fail fast if no step completes within this many seconds (0 = off);
    # the reference hangs forever on a lost rank (utils.watchdog, §5.3)
    hang_timeout: float = 0.0
    # ---- resilience (train.resilience; all defaults = off) ----
    # guarded update: reject a step whose global gradient norm is
    # non-finite (the update becomes a bitwise no-op on params/opt-state
    # on every replica — ops.optim.with_skip_guard).  DP / DP x SP
    # shard_map and GSPMD layouts.
    skip_nonfinite: bool = False
    # additionally reject steps whose global grad norm exceeds this
    # (0 = off; > 0 implies skip_nonfinite — measured before clipping)
    skip_threshold: float = 0.0
    # roll back to the last checkpoint after this many CONSECUTIVE bad
    # steps (non-finite or spiking loss); 0 = off.  Without a
    # checkpoint_dir (or before the first snapshot) rolls back to the
    # deterministic init.  With shuffle on, the post-rollback data order
    # is re-drawn (ShardedLoader.order_salt) so a poisonous batch window
    # is not replayed verbatim.
    rollback_after: int = 0
    # abort with exit code 44 (train.resilience.EXIT_ANOMALY) after this
    # many rollbacks — a deterministic divergence the supervisor must NOT
    # retry
    max_rollbacks: int = 2
    # loss-spike detector: a finite loss counts as bad when it exceeds
    # this factor times the EMA of recent good losses (0 = off; only
    # meaningful with rollback_after > 0)
    loss_spike_factor: float = 0.0
    # deterministic fault injection spec (utils.faults; falls back to the
    # NNPT_FAULTS env var), e.g. "nan@5-8?max=4,crash@12?once=/tmp/m";
    # I/O kinds torn_ckpt/corrupt_ckpt/ckpt_ioerr target the checkpoint
    # durability layer (DESIGN.md §8); capacity kinds peer_kill/peer_hang/
    # device_loss target the elastic restart layer (DESIGN.md §10)
    faults: str = ""
    # ---- elastic degraded-capacity restart (DESIGN.md §10; off by
    # default) ----
    # allow this run to CONTINUE SMALLER after permanent capacity loss:
    # resume accepts a checkpoint saved by a different world size (the
    # cross-world reshard path), and the supervisor reacts to repeated
    # peer-loss exits by probing the surviving topology and relaunching
    # at the shrunken world instead of looping through a world_setup that
    # can never re-form
    elastic: bool = False
    # refuse to run below this many healthy global devices: the trainer
    # exits 46 (EXIT_CAPACITY, no-retry) at startup, and the elastic
    # supervisor parks/polls then exits 46 when a probe can never meet
    # the floor (0 = no floor)
    min_devices: int = 0
    # what an elastic resume onto a DIFFERENT dp width preserves:
    #   global     - keep the global batch (loss trajectory comparable);
    #                per-device rows grow by old_dp/new_dp, and grad
    #                accumulation is raised by the same factor to bound
    #                per-device microbatch memory
    #   per_device - keep per-device rows (memory profile comparable);
    #                the global batch shrinks — the effective-batch
    #                change is logged to telemetry (kind=topology)
    elastic_batch: str = "global"
    # bound host-level collectives (barrier/broadcast/allgather — the
    # transport under consistency/SDC verdicts): a peer dying
    # mid-collective converts an indefinite DCN stall into postmortem +
    # exit 43 after this many seconds (0 = unbounded, the historical
    # behavior; NNPT_COLLECTIVE_TIMEOUT_S is the env form a supervisor
    # hands its children)
    collective_timeout: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TrainConfig":
        d = dict(d)
        for key, cls in (("mesh", MeshConfig), ("data", DataConfig),
                         ("model", ModelConfig), ("rl", RLConfig)):
            if key in d and isinstance(d[key], dict):
                sub = dict(d[key])
                for f in dataclasses.fields(cls):
                    if f.name in sub and isinstance(sub[f.name], list):
                        sub[f.name] = tuple(sub[f.name])
                d[key] = cls(**sub)
        return TrainConfig(**d)


def _add_bool_flag(p: argparse.ArgumentParser, name: str, default: bool, help: str) -> None:
    p.add_argument(f"--{name}", dest=name.replace("-", "_"), action="store_true",
                   default=default, help=help)
    p.add_argument(f"--no-{name}", dest=name.replace("-", "_"), action="store_false")


def build_argparser() -> argparse.ArgumentParser:
    """CLI mirroring the reference's entrypoint (:242-253), typed (fixes B3),
    with framework extensions behind additional flags."""
    p = argparse.ArgumentParser(
        description="TPU-native synchronous data-parallel training"
    )
    # the reference's four knobs, same defaults, now typed
    p.add_argument("--lr", type=float, default=1e-3, help="learning rate")
    p.add_argument("--momentum", type=float, default=0.9, help="SGD momentum")
    p.add_argument("--batch_size", type=int, default=None,
                   help="global batch size; passing it switches off full-batch "
                        "mode so it is actually honored (the reference parses "
                        "but ignores it — bug B1)")
    p.add_argument("--nepochs", type=int, default=3, help="number of epochs")
    # framework knobs; default (neither flag) = full-batch iff --batch_size
    # was not given, preserving reference behavior (:146) without silently
    # ignoring an explicit --batch_size
    _add_bool_flag(p, "full-batch", None,
                   "one full-dataset batch per epoch (reference behavior)")
    p.add_argument("--optimizer",
                   choices=["sgd", "adam", "adamw", "lion", "adafactor"],
                   default="sgd")
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_schedule", choices=["constant", "cosine", "linear"],
                   default="constant")
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="microbatch gradient-accumulation factor (DP path)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="k optimizer steps per host dispatch: the same "
                        "batches in the same order, in groups of up to k; "
                        "on the GPU the train step is captured once as a "
                        "CUDA graph and replayed per step (a few copies "
                        "and one graph launch per step instead of every "
                        "kernel launch), on the CPU k eager steps; one "
                        "process only")
    p.add_argument("--pp_interleave", type=int, default=1,
                   help="virtual stage-slices per pipeline device "
                        "(interleaved schedule: bubble / v at constant "
                        "microbatch count; needs n_layers %% (v*pp) == 0)")
    p.add_argument("--loss", choices=["mse", "cross_entropy"], default="mse")
    # ---- RL workload (rl/ package, DESIGN.md §13) ----------------------
    p.add_argument("--workload", choices=["train", "rl"], default="train",
                   help="rl = Anakin actor-learner PPO on the data mesh "
                        "(envs sharded over dp, rollout + GAE + update "
                        "in one jitted step); optimizer/checkpoint/"
                        "telemetry/supervisor flags apply unchanged")
    p.add_argument("--rl_env", choices=["gridworld", "cartpole"],
                   default="gridworld",
                   help="pure-JAX vectorized environment (rl.envs)")
    p.add_argument("--rl_envs", type=int, default=64,
                   help="GLOBAL env count, dim-0-sharded over the data "
                        "axes (must divide by the dp size)")
    p.add_argument("--rollout_steps", type=int, default=32,
                   help="T: env steps per Anakin step (frames per update "
                        "= T * rl_envs)")
    p.add_argument("--rl_updates", type=int, default=200,
                   help="Anakin steps to run (the RL analogue of epochs)")
    p.add_argument("--gamma", type=float, default=0.99,
                   help="RL discount factor")
    p.add_argument("--gae_lambda", type=float, default=0.95,
                   help="GAE lambda (arXiv 1506.02438)")
    p.add_argument("--clip_eps", type=float, default=0.2,
                   help="PPO clipped-surrogate epsilon")
    p.add_argument("--entropy_coef", type=float, default=0.01,
                   help="PPO entropy-bonus weight")
    p.add_argument("--value_coef", type=float, default=0.5,
                   help="PPO value-loss weight")
    p.add_argument("--ppo_epochs", type=int, default=4,
                   help="full-batch clipped-surrogate passes per rollout "
                        "(each is one optimizer update)")
    p.add_argument("--rl_hidden", type=str, default="64,64",
                   help="policy/value MLP hidden widths, comma-separated")
    p.add_argument("--label_smoothing", type=float, default=0.0,
                   help="CE target smoothing s: (1-s)*onehot + s/C "
                        "(train loss only)")
    # inference entrypoint (cli._generate): decode instead of training
    p.add_argument("--generate", type=str, default=None, metavar="IDS",
                   help="comma-separated prompt token ids; decode "
                        "--max_new_tokens from the checkpoint (or a fresh "
                        "init) instead of training")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 = sampled")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="weights-only PTQ for decode (ops.quant): int8 "
                        "kernels + per-output-channel f32 scales halve "
                        "the HBM bytes streamed per generated token")
    p.add_argument("--kv_quant", choices=["none", "int8"], default="none",
                   help="int8 KV cache for decode: per-(batch, position, "
                        "head) scales; ~4x fewer cache bytes re-streamed "
                        "per step vs the f32 cache (long-context lever, "
                        "stacks with --quantize and --n_kv_heads)")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="prefill the prompt in chunks of this many "
                        "positions (0 = one pass): bounds peak prefill "
                        "attention memory for long prompts; tokens are "
                        "identical")
    p.add_argument("--quantize_skip", type=str, default="",
                   help="comma-separated param-tree names kept in full "
                        "precision under --quantize (e.g. 'head')")
    p.add_argument("--grad_reduction", choices=["global_mean", "per_shard_mean"],
                   default="global_mean")
    p.add_argument("--seed", type=int, default=0)
    _add_bool_flag(p, "shuffle", True, "shuffle batches each epoch")
    p.add_argument("--update_sharding",
                   choices=["replicated", "zero1", "sharded"],
                   default="replicated",
                   help="shard optimizer state + weight update across the "
                        "data axes (reduce-scatter/all-gather): zero1 = "
                        "flat-buffer form (shard_map DP/DP x seq); "
                        "sharded = automatic per-leaf form, largest-dim "
                        "scatter with replicated fallback for tiny "
                        "leaves, wired on DP, DP x seq AND the GSPMD "
                        "(tp/fsdp) path — opt-state memory ~1/dp, "
                        "per-leaf reduce-scatters overlap the backward")
    p.add_argument("--param_dtype",
                   choices=["float32", "bfloat16", "float16"], default="",
                   help="param storage dtype for the training job "
                        "(default: --dtype); bfloat16 halves param HBM "
                        "and the sharded update's all-gather bytes — "
                        "pair with --master_weights for f32 update math")
    _add_bool_flag(p, "master-weights", False,
                   "keep an f32 master copy of the params inside the "
                   "SHARDED optimizer state (1/dp per replica) and "
                   "re-cast to --param_dtype each step; requires "
                   "--update_sharding sharded")
    p.add_argument("--vocab_parallel", action="store_true",
                   help="shard the embedding table + LM head on the vocab "
                        "dim with sharded-softmax cross-entropy (seq x "
                        "tensor meshes: --sp > 1 and --tp > 1)")
    p.add_argument("--dataset",
                   choices=["regression", "wide_regression", "digits",
                            "mnist", "cifar10", "lm", "text"],
                   default="regression")
    p.add_argument("--n_samples", type=int, default=None,
                   help="dataset size (default: per-dataset)")
    p.add_argument("--n_features", type=int, default=2)
    p.add_argument("--data_backend", choices=["numpy", "native", "auto"],
                   default="numpy",
                   help="batch assembly: in-process numpy or the C++ "
                        "threaded prefetch runtime (native/)")
    p.add_argument("--val_fraction", type=float, default=0.0,
                   help="held-out validation fraction (makes the reference's "
                        "dead validation code a real feature)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="evaluate on the validation split every N epochs "
                        "(0 = only after training)")
    p.add_argument("--arch", choices=["mlp", "convnet", "transformer"], default="mlp")
    # precision / memory (TPU knobs: bfloat16 feeds the MXU at 2x the f32
    # rate; remat trades recompute FLOPs for HBM)
    p.add_argument("--dtype", choices=["float32", "bfloat16", "float16"],
                   default="float32", help="parameter dtype")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16", "float16"],
                   default=None,
                   help="matmul/activation dtype (default: same as --dtype)")
    p.add_argument("--matmul_dtype", choices=["bf16", "int8", "fp8"],
                   default="bf16",
                   help="quantized-matmul seam (ops.qmm): run the dense "
                        "projections in this format — int8 = dynamic "
                        "int8 x int8 -> int32 (training AND the "
                        "--quantize int8 decode path), fp8 = e4m3 fwd / "
                        "e5m2 bwd with delayed-scaling amax state "
                        "carried in the train state; bf16 = the plain "
                        "compute-dtype matmul (exact no-op).  "
                        "Transformer on the DP / DP x seq / GSPMD "
                        "layouts")
    _add_bool_flag(p, "remat", False,
                   "rematerialize transformer blocks (jax.checkpoint)")
    p.add_argument("--remat_policy",
                   choices=["full", "dots", "dots_no_batch"],
                   default="full",
                   help="what --remat may save: full = recompute all, "
                        "dots = keep matmul outputs, dots_no_batch = keep "
                        "batch-free matmul outputs")
    # transformer size knobs (BASELINE.json config #5 sweeps)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--n_kv_heads", type=int, default=0,
                   help="grouped-query attention: K/V heads shared "
                        "across the query heads (0 = multi-head); the "
                        "KV cache shrinks by n_heads/n_kv_heads")
    p.add_argument("--pos_encoding", choices=["learned", "rope"],
                   default="learned",
                   help="rope = rotary q/k position encoding (no "
                        "position-embedding parameters)")
    p.add_argument("--ffn_activation",
                   choices=["gelu", "relu", "silu", "tanh", "swiglu"],
                   default="gelu",
                   help="transformer FFN activation; swiglu = gated FFN "
                        "(third (d, ff) projection)")
    p.add_argument("--d_ff", type=int, default=512)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--text_file", default="",
                   help="dataset=text: local file for byte-level LM "
                        "training (zero-egress real text)")
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--attention",
                   choices=["auto", "dense", "dense_blockwise", "flash",
                            "ring", "ring_flash",
                            "striped", "striped_flash", "ulysses"],
                   default=None,
                   help="attention impl (default: auto = dense below the "
                        "measured per-backend crossover, flash above; "
                        "ring when --sp > 1; "
                        "flash = blocked pallas kernel; ring_flash = ring "
                        "with the pallas kernel per block; striped[_flash] "
                        "= round-robin token stripes — balanced causal "
                        "blocks, ~2x causal ring throughput at scale)")
    p.add_argument("--ce_chunk", type=int, default=0,
                   help="transformer: fuse LM head + cross-entropy over "
                        "sequence blocks of this many tokens (jax.checkpoint "
                        "per block) so the (B, T, vocab) logits tensor is "
                        "never materialized; 0 = off; must divide the "
                        "local (per-seq-shard) sequence length; wired on "
                        "the data-parallel/ZeRO-1, sequence-parallel, and "
                        "pipeline layouts (the trainer rejects it "
                        "elsewhere — non-pipeline TP layouts shard the "
                        "head via --vocab_parallel instead)")
    p.add_argument("--dp", type=int, default=-1, help="data-parallel axis size (-1 = rest)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel axis size")
    p.add_argument("--pp", type=int, default=1, help="pipeline-parallel axis size")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel axis size")
    p.add_argument("--fsdp", type=int, default=1, help="fsdp axis size")
    p.add_argument("--ep", type=int, default=1, help="expert-parallel axis size")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="MoE experts per FFN (transformer only; 0 = dense)")
    _add_bool_flag(p, "scan-layers", False,
                   "lax.scan over stacked transformer blocks (compile time "
                   "independent of depth; plain DP/SP paths)")
    p.add_argument("--moe_top_k", type=int, default=1,
                   help="experts per token: 1 = Switch, 2 = GShard top-2")
    p.add_argument("--moe_capacity_factor", type=float, default=None,
                   help="per-expert slot count = ceil(factor * group_tokens "
                        "/ n_experts); overflow tokens fall through residual "
                        "(default 1.25)")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--checkpoint_keep", type=int, default=3, metavar="K",
                   help="retain the newest K committed snapshots (0 = keep "
                        "all); pruning never deletes the last VERIFIED "
                        "snapshot (tools/ckpt_fsck.py audits a dir)")
    _add_bool_flag(p, "resume", False, "resume from checkpoint_dir "
                   "(newest VERIFIED snapshot; corrupt/torn generations "
                   "are quarantined and fallen back past)")
    _add_bool_flag(p, "async-checkpoint", False,
                   "write periodic checkpoints on a background thread")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--metrics_jsonl", type=str, default=None)
    p.add_argument("--telemetry_dir", type=str, default=None,
                   help="telemetry subsystem (train.telemetry): writes "
                        "metrics.jsonl (per-step grad/param norms, "
                        "update ratio, loss, mfu), heartbeat.json "
                        "(run-health, per dispatch) and postmortem.json "
                        "(flight-recorder dump on crash/rollback/abort/"
                        "SIGTERM) under this directory")
    p.add_argument("--metrics_every", type=int, default=1,
                   help="fetch + record on-device metrics every N steps "
                        "(needs --telemetry_dir; 0 keeps heartbeat/"
                        "postmortem but no metrics stream)")
    p.add_argument("--flight_recorder", type=int, default=64, metavar="N",
                   help="flight-recorder ring size: last N step records/"
                        "events dumped to postmortem.json on abnormal "
                        "exit (0 = off)")
    p.add_argument("--rollup_every", type=int, default=0, metavar="N",
                   help="fleet-plane rollups: every N steps write a "
                        "kind=rollup record (serialized quantile-sketch "
                        "state + counters, utils/sketches.py) into "
                        "metrics.jsonl for tools/obs_agg.py to merge "
                        "into fleet percentiles (needs --telemetry_dir; "
                        "0 = off)")
    _add_bool_flag(p, "alerts", True,
                   "kind=alert records in metrics.jsonl: EMA z-score "
                   "anomalies on loss/grad_norm/samples-per-sec and "
                   "SLO burn rate on the serving side (observe-and-"
                   "annotate; tools/metrics_summary.py renders them and "
                   "the supervisor logs them next to relaunch decisions)")
    _add_bool_flag(p, "trace", False,
                   "host-side span tracing + compile-event ledger "
                   "(train/trace.py): per-process trace-p{P}-i{I}.jsonl "
                   "/ compiles-p{P}-i{I}.jsonl under --telemetry_dir's "
                   "trace/ subdir (or --trace_dir), merged by "
                   "tools/trace_report.py into one Perfetto trace.json "
                   "across processes AND supervisor relaunches")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="explicit directory for the span trace + compile "
                        "ledger (implies --trace); share one dir across "
                        "the processes of a world — files are per-"
                        "(process, incarnation)")
    p.add_argument("--xla_trace_dir", type=str, default=None,
                   help="leader-gated jax.profiler capture "
                        "(TensorBoard/XProf device timeline) — the "
                        "DEVICE complement to --trace's host spans; "
                        "equivalent to the legacy --profile_dir")
    _add_bool_flag(p, "goodput", True,
                   "goodput accounting (utils/goodput.py): classify "
                   "wall-clock into the fixed taxonomy from the live "
                   "span stream and emit kind=goodput records on the "
                   "rollup cadence (tools/goodput_report.py renders the "
                   "ledger; tools/obs_agg.py merges the fleet fraction)")
    p.add_argument("--goodput_target", type=float, default=0.5,
                   metavar="FRAC",
                   help="goodput-fraction floor for the ErrorBudget burn "
                        "alert (share of covered wall-clock in the "
                        "productive 'step' category)")
    p.add_argument("--check_replicas_every", type=int, default=0,
                   help="verify replicated state is bit-identical across "
                        "device shards every N steps (0 = off); detect-"
                        "only — on divergence the run localizes, triages "
                        "and raises (use --sdc_check_every to heal)")
    p.add_argument("--sdc_check_every", type=int, default=0,
                   help="silent-data-corruption defense: fingerprint the "
                        "replicated state every N steps (O(1) on-device "
                        "check, lag-2 fetch); on mismatch localize the "
                        "diverged leaf/shard, replay-triage deterministic "
                        "vs transient, and heal (or abort, exit 45)")
    _add_bool_flag(p, "sdc-heal", True,
                   "heal transient divergence from the majority shard "
                   "(cross-host: roll back to the newest verified "
                   "checkpoint) and keep training; --no-sdc-heal = "
                   "detect + triage, then raise")
    p.add_argument("--sdc_strikes", type=int, default=3,
                   help="abort with exit 45 after this many transient "
                        "(healed) divergences localized to the same "
                        "device — failing hardware, not weather")
    p.add_argument("--hang_timeout", type=float, default=0.0,
                   help="abort with thread stacks if no step completes "
                        "within this many seconds (0 = off)")
    # resilience (train.resilience; DESIGN.md §6)
    _add_bool_flag(p, "skip-nonfinite", False,
                   "guarded update: a step with a non-finite global grad "
                   "norm is a bitwise no-op on params/opt-state (DP, "
                   "DP x SP, GSPMD layouts)")
    p.add_argument("--skip_threshold", type=float, default=0.0,
                   help="also skip steps whose global grad norm exceeds "
                        "this (0 = off; implies --skip-nonfinite)")
    p.add_argument("--rollback_after", type=int, default=0,
                   help="roll back to the last checkpoint after this many "
                        "consecutive bad (non-finite/spiking-loss) steps "
                        "(0 = off)")
    p.add_argument("--max_rollbacks", type=int, default=2,
                   help="abort with exit code 44 after this many "
                        "rollbacks (the supervisor does not retry 44)")
    p.add_argument("--loss_spike_factor", type=float, default=0.0,
                   help="count a finite loss as bad when it exceeds this "
                        "factor times the EMA of recent losses (0 = off)")
    p.add_argument("--faults", type=str, default="",
                   help="deterministic fault injection spec (utils.faults: "
                        "'nan@5-8?max=4,crash@12?once=PATH,sigterm@9'; "
                        "I/O kinds torn_ckpt/corrupt_ckpt/ckpt_ioerr hit "
                        "the checkpoint durability layer; NNPT_FAULTS env "
                        "var is the fallback)")
    p.add_argument("--supervise", type=int, default=0, metavar="N",
                   help="run under the crash-restart supervisor: relaunch "
                        "this same command on crash/hang (exit 42/43/any "
                        "crash) up to N times with exponential backoff; "
                        "exit 0, exit 44 (anomaly abort) and exit 45 (SDC "
                        "abort) stop.  With --checkpoint_dir each relaunch "
                        "resumes from the newest snapshot (--resume is "
                        "appended)")
    p.add_argument("--supervise_backoff", type=float, default=1.0,
                   help="initial supervisor backoff in seconds (doubles "
                        "per restart, jittered -50%% downward, hard-capped "
                        "at --supervise_backoff_max)")
    p.add_argument("--supervise_backoff_max", type=float, default=60.0,
                   help="supervisor backoff cap in seconds — a HARD bound "
                        "on the relaunch delay (jitter only shortens); "
                        "combined with the jitter it keeps a pod's worth "
                        "of supervisors from relaunching against a "
                        "recovering coordinator in lockstep")
    # elastic degraded-capacity restart (DESIGN.md §10)
    _add_bool_flag(p, "elastic", False,
                   "survive permanent capacity loss by continuing "
                   "smaller: resume accepts checkpoints from a different "
                   "world size (cross-world reshard), and --supervise "
                   "probes + relaunches at the shrunken world after "
                   "repeated peer-loss exits")
    p.add_argument("--min_devices", type=int, default=0, metavar="N",
                   help="capacity floor: refuse to train below N healthy "
                        "global devices — the trainer exits 46 "
                        "(EXIT_CAPACITY, no-retry) and the elastic "
                        "supervisor parks/polls then exits 46 when a "
                        "probe can never meet the floor (0 = no floor)")
    p.add_argument("--elastic_batch", choices=["global", "per_device"],
                   default="global",
                   help="elastic resume onto a different dp width: keep "
                        "the global batch (raising grad accumulation to "
                        "bound per-device memory) or keep the per-device "
                        "batch (shrinking the global batch; the change "
                        "is logged to telemetry)")
    p.add_argument("--collective_timeout", type=float, default=0.0,
                   metavar="S",
                   help="bound host-level collectives: a peer dying "
                        "mid-barrier/allgather converts the stall into "
                        "postmortem + exit 43 after S seconds (0 = "
                        "unbounded)")
    # launch-path flags (consumed by cli.main; not part of TrainConfig).
    # The reference's launcher is mpiexec (README.md:12); the port's is
    # torchrun plus this device choice.
    p.add_argument("--platform", choices=["auto", "cpu", "gpu"],
                   default="auto",
                   help="auto and gpu run on the CUDA device and raise "
                        "without one (no fallback to the CPU); cpu runs "
                        "the plain PyTorch path on the host")
    p.add_argument("--num_devices", type=int, default=None,
                   help="virtual CPU device count for SPMD runs without an "
                        "accelerator (the role mpiexec -n N plays for the "
                        "reference); only meaningful with --platform cpu")
    p.add_argument("--probe_timeout", type=float, default=60.0,
                   help="accelerator probe timeout in seconds for "
                        "--platform auto/tpu")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    full_batch = (args.full_batch if args.full_batch is not None
                  else args.batch_size is None)
    cfg = TrainConfig(
        workload=getattr(args, "workload", "train"),
        lr=args.lr,
        momentum=args.momentum,
        batch_size=args.batch_size if args.batch_size is not None else 4,
        nepochs=args.nepochs,
        full_batch=full_batch,
        optimizer=args.optimizer,
        weight_decay=args.weight_decay,
        lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps,
        min_lr=args.min_lr,
        grad_clip=args.grad_clip,
        accum_steps=args.accum_steps,
        steps_per_dispatch=args.steps_per_dispatch,
        pp_interleave=args.pp_interleave,
        loss=args.loss, label_smoothing=args.label_smoothing,
        grad_reduction=args.grad_reduction,
        update_sharding=args.update_sharding,
        param_dtype=args.param_dtype,
        master_weights=args.master_weights,
        vocab_parallel=args.vocab_parallel,
        seed=args.seed,
        shuffle=args.shuffle,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        checkpoint_keep=args.checkpoint_keep,
        resume=args.resume,
        async_checkpoint=args.async_checkpoint,
        profile_dir=args.profile_dir,
        metrics_jsonl=args.metrics_jsonl,
        telemetry_dir=args.telemetry_dir,
        metrics_every=args.metrics_every,
        flight_recorder=args.flight_recorder,
        rollup_every=args.rollup_every,
        alerts=args.alerts,
        trace=args.trace or args.trace_dir is not None,
        trace_dir=args.trace_dir,
        xla_trace_dir=args.xla_trace_dir,
        goodput=args.goodput,
        goodput_target=args.goodput_target,
        eval_every=args.eval_every,
        check_replicas_every=args.check_replicas_every,
        sdc_check_every=args.sdc_check_every,
        sdc_heal=args.sdc_heal,
        sdc_strikes=args.sdc_strikes,
        hang_timeout=args.hang_timeout,
        skip_nonfinite=args.skip_nonfinite or args.skip_threshold > 0,
        skip_threshold=args.skip_threshold,
        rollback_after=args.rollback_after,
        max_rollbacks=args.max_rollbacks,
        loss_spike_factor=args.loss_spike_factor,
        faults=args.faults,
        elastic=args.elastic,
        min_devices=args.min_devices,
        elastic_batch=args.elastic_batch,
        collective_timeout=args.collective_timeout,
    )
    cfg.mesh = MeshConfig(data=args.dp, tensor=args.tp, pipe=args.pp,
                          seq=args.sp, fsdp=args.fsdp, expert=args.ep)
    cfg.data = DataConfig(dataset=args.dataset, n_samples=args.n_samples,
                          n_features=args.n_features,
                          val_fraction=args.val_fraction,
                          seq_len=args.seq_len, vocab_size=args.vocab_size,
                          text_file=args.text_file,
                          backend=args.data_backend)
    # --param_dtype overrides the model's param storage dtype HERE (not
    # only in the Trainer) so every CLI consumer — training, --generate
    # decode, template-building — derives the same model dtype; the
    # compute dtype still defaults from --dtype alone
    cfg.model = ModelConfig(arch=args.arch, in_features=args.n_features,
                            dtype=args.param_dtype or args.dtype,
                            compute_dtype=args.compute_dtype or args.dtype,
                            remat=args.remat,
                            remat_policy=args.remat_policy,
                            matmul_dtype=args.matmul_dtype,
                            # a site the user kept full-precision in
                            # STORAGE (--quantize_skip) stays out of the
                            # quantized COMPUTE seam too
                            matmul_skip=tuple(
                                s for s in (args.quantize_skip or ""
                                            ).split(",") if s),
                            scan_layers=args.scan_layers,
                            n_layers=args.n_layers, d_model=args.d_model,
                            n_heads=args.n_heads,
                            n_kv_heads=args.n_kv_heads,
                            pos_encoding=args.pos_encoding,
                            ffn_activation=args.ffn_activation,
                            d_ff=args.d_ff,
                            vocab_size=args.vocab_size,
                            ce_chunk=args.ce_chunk,
                            max_seq_len=max(args.seq_len, 512))
    if args.dataset in ("mnist", "cifar10", "digits"):
        cfg.loss = "cross_entropy"
    if args.dataset == "digits":
        # real 8x8 sklearn digits (the zero-egress real-data quality run)
        cfg.model = dataclasses.replace(
            cfg.model, arch="mlp", in_features=64, hidden=(64, 32),
            out_features=10)
    if args.dataset == "mnist":
        cfg.model = dataclasses.replace(
            cfg.model, arch="mlp", in_features=784, hidden=(256, 128),
            out_features=10)
    if args.dataset == "cifar10":
        cfg.model = dataclasses.replace(cfg.model, arch="convnet",
                                        out_features=10)
    if args.dataset in ("lm", "text"):
        cfg.loss = "cross_entropy"
        cfg.model.arch = "transformer"
    if args.sp > 1:
        # sequence parallelism needs a seq-sharded attention impl
        cfg.model.attention = "ring"
    if args.attention:
        if args.sp > 1 and args.attention not in ("ring", "ring_flash",
                                                  "striped", "striped_flash",
                                                  "ulysses"):
            raise SystemExit(
                f"--attention {args.attention} cannot shard the sequence "
                "axis; --sp > 1 needs ring, ring_flash, striped, "
                "striped_flash, or ulysses")
        if args.sp <= 1 and args.attention in ("ring", "ring_flash",
                                               "striped", "striped_flash",
                                               "ulysses"):
            raise SystemExit(
                f"--attention {args.attention} needs a sequence-sharded "
                "mesh; pass --sp > 1 (or use dense/flash)")
        cfg.model.attention = args.attention
    if cfg.workload == "rl":
        try:
            hidden = tuple(int(h) for h in args.rl_hidden.split(",") if h)
        except ValueError:
            raise SystemExit(f"--rl_hidden expects comma-separated ints, "
                             f"got {args.rl_hidden!r}")
        if not hidden:
            raise SystemExit("--rl_hidden needs at least one width")
        cfg.rl = RLConfig(env=args.rl_env, n_envs=args.rl_envs,
                          rollout_steps=args.rollout_steps,
                          total_updates=args.rl_updates,
                          gamma=args.gamma, gae_lambda=args.gae_lambda,
                          clip_eps=args.clip_eps,
                          entropy_coef=args.entropy_coef,
                          value_coef=args.value_coef,
                          ppo_epochs=args.ppo_epochs,
                          hidden=hidden)
    if args.moe_experts:
        cfg.model.moe_experts = args.moe_experts
    if args.moe_capacity_factor is not None:
        cfg.model.moe_capacity_factor = args.moe_capacity_factor
    cfg.model.moe_top_k = args.moe_top_k
    if args.ep > 1:
        # expert-sharded MoE: route token slots over the 'expert' axis
        cfg.model.moe_expert_axis = "expert"
        if not cfg.model.moe_experts:
            cfg.model.moe_experts = 2 * args.ep
    return cfg
