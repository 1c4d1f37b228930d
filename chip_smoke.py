#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device   — a CUDA device must be present; prints its name and power
              limit as ``nvidia-smi`` reports them.
2. build    — builds the CUDA kernels from ``csrc/`` with ``nvcc`` for
              sm_90a (one ``nvcc`` per source, all started together).
3. kernels  — each kernel against its plain PyTorch version on the card,
              in bf16 and f32: paged attention (split over the context)
              for decode at the 218M LM's head geometry (ragged lengths
              up to 1024, a stream straddling blocks, a length-0 lane),
              prefill chunks of width 16 and 256 at non-zero starts, GQA
              (16 query heads over 4 KV heads), int8 pools with scales,
              short lanes in a table at full capacity and lanes ending
              inside a split; head_dim 32 (f32, bf16 and int8 pools,
              GQA) and pool blocks of 64 and 128 keys at head_dim 32,
              64 and 128.  Times the kernel at 32-512 keys per split,
              its plain version and a library yardstick (gather +
              ``F.scaled_dot_product_attention``) at the decode shape,
              medians of single calls, beside the bound (bytes or
              operations at the card's peak); then the same at head_dim
              32 (blocks of 16 keys) and head_dim 64 (blocks of 64 and
              128 keys) at the shipped split size.
4. serve    — the 218M-parameter LM (vocab 32768, 12 layers, d_model
              1024, 16 heads, d_ff 4096; random weights from a seed, bf16)
              behind ``Scheduler`` -> ``PagedDecodeServer`` with
              ``attn_impl="fused"``: 16 seeded greedy requests (prompts
              64-768 tokens, 32-128 new tokens).  Every request must
              finish, the allocator must drain, and the kernel's launch
              count must equal n_layers x (prefill chunks + decode
              steps).  Prints tokens/s, TTFT and ITL percentiles.
5. tokens   — f32 with TF32 off, the same LM at 2 layers: the fused
              scheduler, the gathered scheduler and ``generate()`` give
              identical greedy tokens; then fused == gathered again with
              int8 KV pools and the prefix cache on.  The same for the
              flagship geometry of ``__graft_entry__.py`` (d_model 128, 4
              heads of 32: paged attention at head_dim 32) with pool
              blocks of 16 and of 64 keys.
6. flash    — the flash-attention forward kernel and the backward's one
              C call (the delta kernel, then dq and dkv: in bf16 under
              both schedules, one shared launch and two launches, whose
              results must be equal bitwise) against their plain
              versions at the training shape (8, 1024, 16, 64) in bf16
              and f32 and all three mask modes, plus T 256 with blocks
              64 x 128, head_dim 128 and 32, T 320 (a multiple of 64, not
              of 128) with blocks 64 x 64, and the tail tiles: T 32 and
              T 96 with the default blocks and T 288 with blocks 96 x 96,
              in bf16 and f32 and all three mask modes; head_dim 8 and 16
              at (4, 512, 8, d) in both dtypes and all three mask modes,
              and at a tail T 96 (bf16 there runs the simt kernels: f32
              products, one schedule); q/k/v are the
              strided views of a fused qkv tensor.  The bf16 kernels run
              the sm90 design (wgmma, cp.async) and are held against both
              plain versions: the one that rounds P and dS to bf16 as
              they do (tighter tolerance) and the unrounded one.  Each
              case's launches by design, read from the counters.  Times
              the forward (CUDA events), dq, dkv and delta (their
              durations under the profiler in the serial backward), the
              plain versions and the library yardstick
              (``F.scaled_dot_product_attention``, forward and
              forward+backward) beside the bound; then bf16 at head_dim 8
              and 16 (the simt kernels) at (8, 1024, 16, d): forward and
              backward by events beside their plain versions, SDPA and
              the bound.
7. train    — the 219M LM trained at full width through the port's
              ``Trainer`` (CLI flags, a 1-rank NCCL group so the gradient
              all-reduce runs): bytes of DESIGN.md, batch 8 x 1024, bf16
              compute, f32 params, flash attention, ce_chunk 256, 2 epochs
              of Adam (26 steps).  Every loss finite, the last 3 steps'
              mean 1 nat below the first, each flash launch count (fwd,
              delta, dq, dkv) equal to 12 x steps, all on the sm90
              kernels.  Prints step time, tokens/s, MFU, peak memory
              (above what the card held before the run; phases 11, 16
              and 17 the same) and
              a profile of 3 more steps with the flash wrappers' host ms
              per call.
8. identity — f32, TF32 off, 2 layers: 3 SGD-momentum steps with flash
              and with dense attention from the same params and batches
              agree.
9. with_lse — ``flash_attention_with_lse`` (B5: the forward kernel,
              then one C call for the backward: the delta kernel with the
              lse cotangent folded in, then dq and dk/dv, shared in one
              launch or in turn) against its plain version at the ring's
              shard shape (8, 256, 16, 64), at the tails T 32 and T 96 and
              at head_dim 16 (T 256 and T 96),
              in bf16 and f32 and all three mask modes: out, lse, delta,
              and dq/dk/dv of sum(out * w) + sum(lse * u).  bf16 dq/dk/dv
              also against the rounding plain versions; each case's
              launches by design (fwd, delta, dq, dkv one each) and CUDA
              launches per backward.  Times it (device ms, and wall ms
              per call with the host's time in) beside its bound, its
              plain version and SDPA forward+backward, each of its
              kernels' device ms per launch, and both backward
              schedules (shared, serial) at
              the shard shape, T 512 and the training shape, held equal
              bitwise.
10. ring    — ``ring_flash_attention`` and ``striped_ring_flash_attention``
              over a ``LocalSeqGroup(4)`` at (8, 1024, 16, 64) bf16 (the
              striped one on permuted inputs) against full-sequence flash
              attention: output and q/k/v gradients, launches per call
              (striped 16 of each kernel, ring 10: future blocks skipped),
              and the time of each beside full flash; then both at T 128
              (T_local 32: tail tiles), untimed.
11. seqtrain — the 219M LM trained as in phase 7 but with
              ``striped_flash`` over ``LocalSeqGroup(4)`` (T_local 256):
              finite losses falling 1 nat, 12 x 16 launches per step of
              each flash kernel (fwd, delta, dq, dkv; by design as in
              phase 7) and of ``flash_attention_with_lse``; step
              time, tokens/s, MFU, peak memory and a profile with the
              flash wrappers' host ms per call.  Then the same at 2
              layers, one epoch, under ``--matmul_dtype int8`` (ce_chunk
              256) and ``fp8`` (ce_chunk 0): B5 under quantized compute,
              each Linear quantizing its 4 sequence shards as 4 ranks
              would; the same checks, step ms and peak memory beside
              bf16's.
12. seqidentity — f32, TF32 off, 2 layers: 3 SGD steps with ring_flash
              and with striped_flash over ``LocalSeqGroup(4)`` agree with
              flash (losses 1e-5 relative, params 1e-6).
13. layernorm — ``fused_layernorm`` called once as an op, then against its
              plain version at (8192, 1024) in bf16 and f32 and a ragged
              (1000, 768); timed against ``F.layer_norm`` and its byte
              bound.
14. reference — the reference's job as its README runs it,
              ``python -m neural_networks_parallel_training_with_mpi_tpu_torch
              --lr 0.001 --momentum 0.9 --batch_size 4 --nepochs 3``, as a
              subprocess on the card and again with ``--platform cpu``:
              rc 0, three ``epoch n: loss`` lines, the same losses (1e-5
              relative).  Then ``quality.py``'s four configurations
              trained on the card to their bars (the port's ``quality``
              module): the toy regression against the plain-torch
              reference loop, digits >= 0.95, both byte LMs under the
              unigram perplexity; prints each value.
15. resume   — first phase 7's job cut to 2 layers (full width), eager:
              the reference of 15, 16, 17 (b)-(e) and 19 (d).  Its flags
              with ``--checkpoint_dir``: one epoch (13
              steps) and its snapshot, then a new ``Trainer`` with
              ``--nepochs 2 --resume --async-checkpoint
              --checkpoint_every 13``: steps 14-26's losses and the final
              params against the uninterrupted 2-layer run, bitwise (the
              largest differences are printed);
              the async snapshot of step 26 restored and equal to the
              state, leaf for leaf; ``--generate`` of 32 tokens from it as
              a subprocess equal to the in-process ``generate()``, greedy
              and sampled (temperature 1, the same seed).  Prints the
              snapshot's bytes and the save and restore seconds.
16. dispatch — ``--steps_per_dispatch 13``: phase 7's job at 2 layers,
              then phase 11's striped_flash job over ``LocalSeqGroup(4)``,
              each train step captured once as a CUDA graph and replayed
              (one dispatch per epoch).  Losses at the dispatch ends and
              the final params against phase 15's 2-layer and phase 11's
              eager runs (bitwise, or phase 8's f32 tolerance); each flash
              kernel's launches by design (the warm-up step's counters +
              replays x the launches captured) equal to layers (x 16
              striped) x steps; step ms, tokens/s, MFU and peak memory
              beside the eager run's; for the 2-layer job also the host's
              launch calls per step under the profiler (one more
              dispatch, 3 eager steps) and one replay's device time
              (events) over the step: the device's busy share.  Then an
              f32, TF32-off, 2-layer identity: 3 SGD steps through the
              graph against the eager steps.
17. slice   — (a) the ``attention="auto"`` rows, in bf16 and in f32:
              dense (the plain path, f32 scores) against flash, forward
              + backward of the op alone at T 256-8192 and the full train
              step of phase 7's model cut to 4 layers at T 256-4096 (B x
              T = 8192 tokens, causal, 16 heads of 64; dense training at
              T 8192 would not fit) beside the step with no layers, a
              table on one line each; the measured row beside the port's
              ``AUTO_FLASH_MIN_SEQ[('cuda', dtype)]`` (the phase fails
              where they disagree beyond a 5% tie of the two steps
              carried to 12 layers: the time above the no-layer step
              times 3), and ``auto`` through
              the model launching flash at a row and not under it.  Then
              the 2-layer job (b) with ``--remat`` under ``full``,
              ``dots`` and ``dots_no_batch`` (the forward kernel launches
              twice per layer and step: the block's forward runs again in
              the backward), each also under ``--steps_per_dispatch 13``
              (bitwise equal to its eager run); (c) with
              ``--scan-layers``, its snapshot decoded by ``--generate``
              (greedy) against ``generate()``; (d) with
              ``--update_sharding sharded`` and ``zero1`` (bitwise: one
              card shards nothing); (e) with bf16 params,
              ``--update_sharding sharded --master-weights``, eager and
              graphed (every param the bf16 cast of its master, bitwise;
              the loss falls 1 nat); each against the 2-layer run: losses
              and final params (bitwise, or phase 8's f32 tolerance:
              printed which), step time, tokens/s, MFU and peak memory.
              (f) f32, 2 layers: remat + scan_layers with striped_flash
              over ``LocalSeqGroup(4)`` against flash without either
              (phase 12's bars).
18. quant   — quantized compute (``ops.qmm``, ``ops.quant``): (a) the
              three products of a quantized Linear (forward, dx, dw)
              at phase 7's projection shapes (8192 rows; 1024->3072,
              1024->4096, 4096->1024, 1024->32768), int8
              (``torch._int_mm``) and fp8 (``torch._scaled_mm``), against
              the plain product of the same codes on 256 output rows
              (int8 equal, fp8 within 1e-3 of the products' absolute
              sum: the tensor cores' accumulator is narrower than f32),
              each timed
              beside its bound at the 1979 TFLOP/s peak, qdot's forward
              and forward + backward beside the bf16 ``torch.matmul``'s;
              qdot on the card against the host at (256, 1024->3072):
              the same codes, int8 outputs bitwise, fp8 within that
              bound (dx also one bf16 rounding).  (b)-(c) phase 7's job
              at phase 15's 2 layers (full width; phase 15's bf16 run the
              reference) under ``--matmul_dtype int8`` (ce_chunk 256) and
              ``fp8`` (ce_chunk 0): losses finite and falling 1 nat, flash
              launches by design, the quantized products counted against
              the design (3 per block Linear and the head's: 40 and 27
              per step), one step under the profiler (that many
              ``aten::_int_mm`` / ``aten::_scaled_mm``, no f32 or bf16
              product, every GEMM kernel one of theirs), then
              ``--steps_per_dispatch 13`` bitwise equal to eager; step
              ms, tokens/s and peak memory beside bf16 and the largest
              |loss - bf16 loss|; two more eager int8 runs (one epoch)
              witness where int8's early gap to bf16 comes from:
              ce_chunk 0 (no
              chunked head, no recompute) and the head left unquantized
              (``--quantize_skip head``).  (d) f32, 2 layers, T 128: int8
              and fp8 on the card against the host (losses 1e-4 int8,
              5e-4 fp8 relative; the params' change 1e-2 relative L2).
              (e) phase 4's serving traffic (16 of its requests on 16 slots)
              with bf16 weights, int8 PTQ weights (dequant) and PTQ with
              int8 compute, each arm twice in the order A B C C B A:
              tokens/s, TTFT, ITL, param bytes; at the flagship f32
              geometry with PTQ weights, fused == gathered ==
              ``generate()`` greedy ids for both.  A ``quant:`` JSON
              line holds the phase's numbers.

19. resilience — phase 7's job (graphed, k 13, unless a part says
              otherwise), cut to 2 layers (full width).  (a)
              ``--skip-nonfinite`` against the same run without it, 2
              epochs, graphed and eager: losses and final state bitwise
              equal; step ms, the guard's overhead and peak memory.
              (b) ``--skip-nonfinite --faults
              nan@5,nan@18``, constant lr and a cosine schedule with 10
              warm-up steps: the graphed run through ``Trainer.fit``
              against an eager run driven step by step: NaN losses at
              steps 5 and 18 only, 2 skipped, the state (params, Adam's mu
              and nu) bitwise unchanged across each faulted step and the
              count that picks the lr row not advanced, graphed == eager
              bitwise.  (c) a rollback (see ``guard_rollback``): one, to
              the step-8 snapshot, order_salt 1, no re-capture (traced:
              one train_step event in the compile ledger); its
              restore s.  (d) the CLI as subprocesses: SIGTERM at step 7
              -> exit 0 with the step-13 snapshot, then ``--resume`` ends
              bitwise at the 2-layer eager run's final params;
              ``--supervise 2`` with
              a crash at step 20 (and ``--telemetry_dir --trace``, read
              by phase 20 (d)) relaunches once, resumes from step 13,
              ends bitwise there too; ``--rollback_after 1
              --max_rollbacks 0`` with a NaN at step 5 exits 44, not
              retried (run beside (e)); seconds from the signal to the
              snapshot and the exit, and from a (re)launch to its first
              step.  (e) 2
              layers, ``--hang_timeout 10 --faults peer_hang@4``: exit 42
              with the threads' stacks, 10-30 s after the hang.  (d)'s
              and (e)'s processes start at the phase's head and run
              beside (a)-(c).  A
              ``resilience:`` JSON line holds the phase's numbers; the
              flash kernels' launches count phase 19's in-process runs.
              (e)'s run has ``--telemetry_dir``: its flight recorder
              writes ``postmortem.json`` (reason ``hang``) before exit 42.

20. observability — phase 7's job with ``--telemetry_dir --trace
              --metrics_every 1 --rollup_every 13``.  (a) against the
              same run without them, graphed (k 13, 3 epochs) and eager
              (2 epochs), each as the alternating pairs on, off, off,
              on: final params, mu and nu of all four bitwise equal;
              each run's step ms, the medians and the overhead between
              them, peak memory, the host's launch calls per step, the
              busy share graphed; ``metrics.jsonl``
              holds one record per dispatch with every metric, the
              records' MFU (989 TFLOP/s row, host wall) within 10% of
              this script's (CUDA events), a rollup and a goodput record
              (graphed: with its step anatomy) every 13 steps, a
              heartbeat, exactly one capture event in the ledger;
              ``tools/metrics_summary.py``, ``trace_report.py`` and
              ``goodput_report.py`` read the directory; then graphed with
              ``--skip-nonfinite --faults nan@5``: skipped reads 1 at both
              dispatch ends and the flight recorder holds one skip.  (b)
              f32, 2 layers, T 128: the card's metrics against the
              host's within 1e-4 relative, flash and striped_flash over
              ``LocalSeqGroup(4)`` (B5).  (c) ``--profile_dir``: a Chrome
              trace of 3 steps at 2 layers naming B1-B3's and Adam's
              ``_foreach`` kernels; the profiler's cost per step.  (d) phase 19 (e)'s
              hang postmortem, and phase 19 (d)'s supervised crash (run
              with ``--telemetry_dir --trace``): the postmortem pointer,
              and ``tools/trace_report.py`` merging the two
              incarnations.  An
              ``observability:`` JSON line holds the phase's numbers; the
              flash kernels' launches count phase 20's in-process runs.

21. consistency + elastic — (a) the fingerprint kernel
              (``csrc/fingerprint.cu``) on phase 7's final training state
              (params, Adam's mu and nu, the count: 657,942,529 values,
              2.63 GB, uploaded from a host copy): its per-leaf and
              chained digests equal the plain version's on the card and
              on the host, bitwise; one flipped bit changes the digest
              (an f32 leaf, the count, a bf16 copy of a param); its
              time (CUDA events, median of 20) beside the bytes bound
              and the plain version's.  (b) Two replicas of that state
              on the card, bit 9 of one element of replica 1 flipped:
              the per-leaf digest matrix through
              ``utils.consistency.localize`` names that leaf, replica 1
              and one element; ``heal_replication`` restores replica 1
              bitwise; ``digest_report`` of the (1, 2) matrix reads
              ``local: [0]`` before and ``{}`` after.  (c) Phase 7's job
              cut to 2 layers (full width), 2 rows a step, zero1: 2 gloo
              ranks of the CLI on the host write a snapshot after one
              step (started first, run beside (a)-(b)); ``--elastic
              --elastic_batch global`` resumes it at dp=1 on the card
              under ``--steps_per_dispatch 2 --sdc_check_every 1`` (the
              replica floor at 1): params and moments equal the
              snapshot's arrays bitwise (zero1's padding cut off), the
              topology record reads dp 2 -> 1 and accumulation 1 -> 2,
              two more steps finite with one capture, and the fingerprint
              and flash kernels launched in that run (counters set to 0
              just before it).  (d) ``--min_devices 2`` on one card:
              ``CapacityAbort`` naming exit 46.  An ``sdc_elastic:`` JSON
              line holds the phase's numbers.

22. tensor parallelism — (a) Megatron's f / g on the flagship FFN pair
              (column- then row-split) over ``LocalTensorGroup(4)`` and
              through the NCCL autograd functions of a 1-rank
              ``ProcessTensorGroup``, and the vocab-parallel
              cross-entropy over 4 shards of the (8, 1024, 32768)
              logits, f32 and bf16, against their dense forms (outputs
              and gradients).  (b) Phase 7's job, DP x TP over
              ``LocalTensorGroup(4)`` at full depth and width (ce_chunk
              0, refused with ``--tp``): 2 epochs eager (the 1-nat loss
              check, step ms, tokens/s, peak memory, a profile), B1-B3
              launched 12 x 4 times a step, all on the sm90 design; then
              2 epochs at ``--steps_per_dispatch 13``, bitwise to them.
              (c) f32: 3 SGD steps of DP x TP == the dense step at 2
              layers (params within 1e-6).  (d) sp 2 x tp 2 with
              ``striped_flash`` and ``--vocab_parallel`` at 2 layers: 26
              bf16 steps (B5 2 x 2^2 x 2 launches a step) and its f32
              identity with ``striped_flash`` alone.  (e) ulysses over
              ``LocalSeqGroup(4)`` and dense_blockwise against dense
              attention, f32 at (8, 1024, 16, 64), outputs and
              gradients; each trained 26 bf16 steps at 2 layers.  A
              ``tensor_parallel:`` JSON line holds the phase's numbers.

23. the GSPMD layout's memory half — (a) phase 7's job at 2 layers
              (full width; phase 15's bf16 run the loss reference), DP x
              TP over ``LocalTensorGroup(4)`` under ``--matmul_dtype
              int8`` and ``fp8`` (ce_chunk 0): one epoch eager (products
              counted
              against 4 x the dense step's design, one step profiled: no
              unquantized product) and one graphed (k 13, bitwise), and
              each one's 2-layer f32 identity to the dense quantized
              step within the code-flip bounds.  (b) ``--fsdp 4`` over
              ``LocalFsdpGroup(4)`` at 2 layers: the split leaves held as
              4 stacked slices, f32 params within 1e-6 of DP, bf16 eager
              and graphed (bitwise).  (c) Tensor rank 0's ``--tp 4``
              state built on the card from phase 22's params: its values
              and ``memory_allocated`` growth against the worked-out
              bytes; the 4 ranks' slices joined bitwise.  (d)
              ``--update_sharding sharded`` under ``--tp 4`` bitwise to
              the replicated update, and a ``qkv_tp`` 2 snapshot resumed
              under it bitwise.  (e) The replica check under ``--tp 4``:
              a flip in a whole leaf seen, localized and healed, one in a
              sliced leaf unchecked (as in JAX).  (f) ``--generate --tp
              4`` through the CLI from (d)'s snapshot: the same 16
              sampled tokens as without ``--tp`` and as a decode of the
              saver's live params.  A ``gspmd_memory_half:`` JSON line.

24. pipeline parallelism — ``parallel.pipeline`` over local pipe groups
              (one card runs the stages in turn: no bubble shows).  (f)'s
              snapshot first: 2 layers, ``--pp 2 --tp 2``, 3 Adam steps
              at lr 1e-5, and its ``--generate`` process beside the rest.
              (a) f32, TF32 off: 3 SGD steps of ``--pp 2`` at 2 layers and
              of ``--pp 2 --pp_interleave 2`` at 4 layers, full width,
              params within 1e-6 of the dense DP step's; B1-B3 (simt)
              launched once per layer, microbatch and step.  (b) Phase
              7's job at 12 layers under ``--pp 4`` over
              ``LocalPipeGroup(4)``, one epoch eager (the 1-nat check,
              step ms, tokens/s, peak memory, a profile), B1-B3 12 x 4
              times a step (4 microbatches of 2 rows), all on the sm90
              design; then one epoch at ``--steps_per_dispatch 13``,
              bitwise to it.  (c) The same job under ``--pp 4
              --pp_interleave 3``.  (d) ``--pp 2`` x ``LocalTensorGroup(2)``
              at 2 layers.  (e) ``--pp 2`` x ``LocalSeqGroup(2)`` with
              ``striped_flash`` at 2 layers (B5 2 x 2^2 x 2 a step) and
              its f32 identity to the dense striped_flash step.  (f) The
              CLI's 16 sampled tokens equal a decode of the saver's live
              params, unstacked and de-permuted in this process, at least
              8 distinct.  A ``pipeline:`` JSON line; phase 24's B1-B3
              and B5 launches join the kernels line's counts.

25. MoE and expert parallelism — (a) one MoE layer at the flagship
              shape (d_model 1024, d_ff 4096, 8 experts, 8 x 1024
              tokens), forward and backward: the index dispatch and
              combine against the one-hot einsum form (f32 and bf16 top-1
              outputs bitwise, f32 top-2 within 1e-6 of their largest
              magnitude, f32 gradients within 1e-5 relative), each form's
              time beside the expert FFN's.
              (b) The flagship LM with 8 Switch top-1 experts (924.5M
              params) under ``--ep 4`` over ``LocalExpertGroup(4)``
              (ce_chunk 0, as JAX requires there): one epoch eager (the
              1-nat check, step ms, tokens/s, peak memory, a profile with
              the dispatch/combine class, the final snapshot), B1-B3 12 a
              step (one launch over the 4 shards' rows), all sm90; then
              one epoch at ``--steps_per_dispatch 13``, bitwise to it.
              (c) ``--moe_top_k 2`` on the plain DP step (ce_chunk 256)
              at full depth, eager (with a profile) and graphed,
              bitwise.  (d) f32, TF32 off, 2
              layers: ``--ep 4`` with aux weight 0 and a capacity of its
              groups' tokens == the dense MoE DP step within 1e-6 (whose
              first loss is the forward's cross-entropy: no aux); ``--sp
              2 --ep 2`` striped_flash (B5) and ``--ep 2 --tp 2`` at T 128
              on the card == the host's (a subprocess of this script, run
              beside the rest) within 1e-5.  (e) ``--generate`` through
              the CLI from (b)'s snapshot: 16 sampled tokens equal the
              decode of (b)'s final params.  (f) The MoE
              LM in bf16 behind the fused paged scheduler (8 requests; B4
              n_layers x passes), then f32 at 2 layers with a drop-free
              capacity: fused == gathered == ``generate()`` and the card's
              tokens == the host's.  A ``moe:`` JSON line; phase 25's B1-B3,
              B4 and B5 launches join the kernels line's counts.
26. moe layouts — MoE on the pipe and GSPMD layouts, and
              ``models.generate_tp``: (a) the MoE LM under ``--pp 2 --ep
              2`` over ``LocalPipeGroup(2)`` x ``LocalExpertGroup(2)`` at
              full width (ce_chunk 256), one epoch eager (1 nat, B1-B3 24
              a step all sm90, a profile with the dispatch/combine
              class) and graphed (k 13, bitwise); (c) the MoE LM on the
              GSPMD layout under ``--tp 4`` over ``LocalTensorGroup(4)``
              (one routing group of the 8192 tokens; ce_chunk 0), eager
              (profiled; B1-B3 48 a step) and graphed (bitwise), and
              ``--fsdp 4`` over ``LocalFsdpGroup(4)`` at 2 layers, eager;
              (b), (c) f32, TF32 off, 2 layers (4 for the interleave), 3
              SGD steps from one seed: pp 2 x ep 2, pp 2 x ep 2 x tp 2
              and ``--pp_interleave 2`` x ep 2 == the expert steps with
              ``--accum_steps 2``, ``--tp 4`` and ``--fsdp 4`` == the DP
              MoE step, all within 1e-6 (losses 1e-5 relative), each
              run's flash launches by design; pp 2 x sp 2 x ep 2
              striped_flash (B5) at T 128 on the card == the host's (a
              subprocess started at the phase's head) within 1e-5;
              ``--generate`` through the CLI from a pp 2 x ep 2 snapshot
              (2 layers) == the decode of the saver's params; (d)
              ``generate_tp`` over ``LocalTensorGroup(4)``: the flagship
              and the MoE LM in f32, greedy tokens == ``generate()``'s
              with the head whole and vocab-parallel; bf16 tokens/s of
              both beside ``generate()``'s; a pp 2 x tp 2 snapshot's
              params through ``pipeline_params_for_decode`` at tensor
              size 4 (qkv re-permuted) == ``generate()`` over the
              saver's params.  A ``moe_layouts:`` JSON line; phase 26's
              B1-B3 and B5 launches join the kernels line's counts.
27. disagg  — disaggregated serving on phase 4's LM, params, geometry
              and 16 requests: (a) a ``role="prefill"`` and a
              ``role="decode"`` scheduler on the one card, each with
              ``telemetry_dir``, ``trace_dir`` and rollups, a pump moving
              ``take_handoffs()`` into ``inject()``: every request
              finishes, both allocators drain, 16 handoffs each way, B4
              launched n_layers x (prefill chunks + decode steps), fewer
              syncs than decode steps in the decode loop; export and
              import ms per handoff, payload bytes against the K/V
              bytes, the decode side's tokens/s and ITL beside phase 4's
              unified run, the prefill side's TTFT; the unified run again
              with telemetry and tracing on (ms a tick on vs off).  (d)
              Both roles' records: ``serve_req`` per request finished,
              rollup and goodput records and heartbeats stamped with the
              role, the handoff and inject flows, the load reports'
              roles, ``tools/metrics_summary.py`` and ``obs_agg.py``
              reading both directories.  (e) ``loadgen.sweep_loads`` at 4
              and 16 clients (2 requests each, ``mix="long_prefill"``).
              (b) f32, TF32 off, phase 5's LM at 2 layers: disaggregated
              == unified == ``generate()`` with plain pools, int8 KV pools
              and the prefix cache; payloads exported on the card decode
              on the host (a CPU server of the port) to the same tokens,
              and the other way.  (c) ``quiesce()`` with streams in
              flight on both roles: both allocators drain, readmission
              reproduces the tokens.  A ``disagg:`` JSON line; (a)'s B4
              launches join the kernels line's count.

The last lines are the kernels JSON line (each kernel with the head_dims
and blocks it takes; ``fingerprint`` has no Pallas counterpart), the
``nvidia-smi`` line and ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

SEED = 0
BIG = dict(vocab_size=32768, max_seq_len=1024, n_layers=12, d_model=1024,
           n_heads=16, d_ff=4096)
# the card's peaks (NVIDIA H100 SXM data sheet, dense): bytes/s and
# flops/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# kernel vs its plain version: f32 differs in summation order only;
# bf16 outputs round once on each side (1 ulp = 2^-8 relative)
TOL = {"torch.float32": (1e-4, 1e-4), "torch.bfloat16": (2e-2, 1e-2)}


_T0 = time.perf_counter()


def phase(name):
    print(f"== phase {name} (at {time.perf_counter() - _T0:.1f} s)",
          flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def build_kernels():
    """One ``nvcc`` per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        _build,
    )

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as ex:
        records = dict(zip(names, ex.map(lambda n: _build.load(n)[1],
                                         names)))
    for name, rec in records.items():
        print(f"built {name}: {rec['seconds']:.1f} s (fresh build: "
              f"{rec['built']})", flush=True)
        for line in ptxas_summary(rec["log"]):
            print(f"  ptxas {line}", flush=True)
    return records


def ptxas_summary(log):
    """One line per compiled kernel from ``nvcc -Xptxas -v``: kernel name
    and template arguments (as mangled), registers, spills."""
    import re

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"([a-z0-9_]+_kernel)I(.*?)EEv", m.group(1))
            name = (re.sub(r"^_?\d+", "", t.group(1)) + " " + t.group(2)
                    if t else m.group(1))
            spill = ""
        elif "spill stores" in line:
            spill = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.append(f"{name}: {m.group(1)} registers; {spill}")
                name = None
    return out


# ---------------------------------------------------------------------------
# phase 3: paged attention against its plain version
# ---------------------------------------------------------------------------

def make_case(torch, device, dtype, lengths, starts, width, n_heads,
              kv_heads, head_dim=64, block_size=16, quant=False, seed=0,
              max_blocks=None):
    """Random pools and a random block table per stream, q as the strided
    view the fused qkv projection gives (columns [q | k | v]).  The table
    has ``max_blocks`` columns (default: the longest lane's blocks); the
    entries past a lane's blocks point at the sink block 0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    s_n = len(lengths)
    needs = [-(-max(ln, 1) // block_size) for ln in lengths]
    max_blocks = max_blocks or max(needs)
    num_blocks = sum(needs) + 1 + 7
    perm = torch.randperm(num_blocks - 1, generator=g) + 1
    tables = torch.zeros((s_n, max_blocks), dtype=torch.int32)
    off = 0
    for s, n in enumerate(needs):
        tables[s, :n] = perm[off:off + n]
        off += n
    shape = (num_blocks, block_size, kv_heads, head_dim)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=g) * 0.09 + 0.01
        vs = torch.rand(shape[:3], generator=g) * 0.09 + 0.01
    else:
        kp = torch.randn(shape, generator=g).to(dtype)
        vp = torch.randn(shape, generator=g).to(dtype)
        ks = vs = None
    qkv = torch.randn((s_n, width, (n_heads + 2 * kv_heads) * head_dim),
                      generator=g).to(dtype)
    to = lambda t: None if t is None else t.to(device)  # noqa: E731
    qkv = to(qkv)
    q = qkv[..., :n_heads * head_dim].reshape(s_n, width, n_heads, head_dim)
    return dict(q=q, k_pool=to(kp), v_pool=to(vp), tables=to(tables),
                lengths=to(torch.tensor(lengths, dtype=torch.int32)),
                starts=to(torch.tensor(starts, dtype=torch.int32)),
                k_scale=to(ks), v_scale=to(vs))


def decode_lengths():
    """16 ragged decode lanes up to the full 1024: block-straddling
    lengths, exact block multiples and one inactive (length 0) lane."""
    return [1024, 1, 17, 16, 0, 33, 500, 777, 64, 129, 1000, 2, 255, 256,
            257, 900]


def kernel_cases():
    """(name, make_case kwargs) for every phase-3 case, both dtypes."""
    dec = decode_lengths()
    dec_starts = [max(ln - 1, 0) for ln in dec]
    short = [1, 0, 16, 17, 5, 63, 64, 65]
    short_starts = [max(ln - 1, 0) for ln in short]
    mid = [70, 300, 600, 1000, 257, 511, 513, 6]
    mid_starts = [ln - 1 for ln in mid]
    cases = []
    for dt in ("bfloat16", "float32"):
        cases += [
            (f"decode_mha_{dt}", dict(dtype=dt, lengths=dec,
                                      starts=dec_starts, width=1,
                                      n_heads=16, kv_heads=16)),
            (f"prefill_w16_{dt}", dict(dtype=dt, lengths=[316, 28],
                                       starts=[300, 17], width=16,
                                       n_heads=16, kv_heads=16)),
            (f"prefill_w256_{dt}", dict(dtype=dt, lengths=[712, 256],
                                        starts=[512, 0], width=256,
                                        n_heads=16, kv_heads=16)),
            (f"decode_gqa_{dt}", dict(dtype=dt, lengths=dec,
                                      starts=dec_starts, width=1,
                                      n_heads=16, kv_heads=4)),
            (f"prefill_w16_gqa_{dt}", dict(dtype=dt, lengths=[316, 28],
                                           starts=[300, 17], width=16,
                                           n_heads=16, kv_heads=4)),
            (f"decode_int8_{dt}", dict(dtype=dt, lengths=dec,
                                       starts=dec_starts, width=1,
                                       n_heads=16, kv_heads=16, quant=True)),
            (f"prefill_w16_int8_{dt}", dict(dtype=dt, lengths=[316, 28],
                                            starts=[300, 17], width=16,
                                            n_heads=16, kv_heads=16,
                                            quant=True)),
            # short lanes in a table at full capacity (64 blocks, as the
            # server's): most splits lie past the live keys
            (f"decode_short_full_table_{dt}",
             dict(dtype=dt, lengths=short, starts=short_starts, width=1,
                  n_heads=16, kv_heads=16, max_blocks=64)),
            # lanes ending inside a split (of 256 keys), int8 scales
            # across split boundaries, a prefill row tile whose keys
            # cross a split boundary
            (f"decode_mid_split_int8_{dt}",
             dict(dtype=dt, lengths=mid, starts=mid_starts, width=1,
                  n_heads=16, kv_heads=4, quant=True, max_blocks=64)),
            (f"prefill_w16_mid_split_{dt}",
             dict(dtype=dt, lengths=[300, 37], starts=[284, 21], width=16,
                  n_heads=16, kv_heads=4, max_blocks=64)),
            # head_dim 32 (the flagship's 4 heads of 32): f32/bf16 and
            # int8 pools (2 chunks of 16 values per key), GQA prefill
            (f"decode_d32_{dt}", dict(dtype=dt, lengths=dec,
                                      starts=dec_starts, width=1, n_heads=4,
                                      kv_heads=4, head_dim=32)),
            (f"decode_d32_int8_{dt}", dict(dtype=dt, lengths=dec,
                                           starts=dec_starts, width=1,
                                           n_heads=4, kv_heads=4,
                                           head_dim=32, quant=True)),
            (f"prefill_w16_d32_gqa_int8_{dt}",
             dict(dtype=dt, lengths=[316, 28], starts=[300, 17], width=16,
                  n_heads=4, kv_heads=2, head_dim=32, quant=True)),
        ]
        # pool blocks of 64 and 128 keys at every head_dim (1024 keys: 16
        # or 8 blocks, splits of 4 or 2 blocks), int8 at head_dim 32
        for hd in (32, 64, 128):
            for bs in (64, 128):
                cases.append((f"decode_d{hd}_b{bs}_{dt}",
                              dict(dtype=dt, lengths=dec, starts=dec_starts,
                                   width=1, n_heads=4, kv_heads=4,
                                   head_dim=hd, block_size=bs)))
        cases += [
            (f"decode_d32_b128_int8_{dt}",
             dict(dtype=dt, lengths=dec, starts=dec_starts, width=1,
                  n_heads=4, kv_heads=4, head_dim=32, block_size=128,
                  quant=True)),
            (f"prefill_w16_d64_b64_gqa_{dt}",
             dict(dtype=dt, lengths=[316, 28], starts=[300, 17], width=16,
                  n_heads=16, kv_heads=4, block_size=64, max_blocks=16)),
        ]
    return cases


def check_kernels(torch, device):
    """Every phase-3 case: kernel vs plain version on the same inputs.
    Returns the largest absolute error seen."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention, paged_attention_reference,
    )

    worst = 0.0
    for i, (name, kw) in enumerate(kernel_cases()):
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]))
        case = make_case(torch, device, seed=i, **kw)
        args = [case[k] for k in ("q", "k_pool", "v_pool", "tables",
                                  "lengths", "starts")]
        scales = dict(k_scale=case["k_scale"], v_scale=case["v_scale"])
        got = paged_attention(*args, **scales)
        want = paged_attention_reference(*args, **scales)
        if device.type == "cuda":
            torch.cuda.synchronize()
        atol, rtol = TOL[str(kw["dtype"])]
        err = (got.float() - want.float()).abs()
        limit = atol + rtol * want.float().abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= limit).all())
        idle = [s for s, ln in enumerate(kw["lengths"]) if ln == 0]
        ok = ok and all(bool((got[s] == 0).all()) for s in idle)
        max_err = float(err.max())
        worst = max(worst, max_err)
        print(f"kernel {name}: max_abs_err {max_err:.3e} (tolerance "
              f"atol {atol} + rtol {rtol}): {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"paged_attention disagrees with its plain "
                                 f"version in case {name}")
    return worst


# device clock cycles per second of torch.cuda._sleep's spin (at or above
# the H100's 1.98 GHz boost clock, so the sleep lasts at least as long as
# asked)
SLEEP_CYCLES_PER_S = 2.0e9


def time_ms(torch, fn, iters):
    """Mean device ms per call from CUDA events around ``iters`` calls,
    after a warm-up call.  A GPU sleep queued first holds the device while
    the host enqueues every call, so the host's per-call overhead (Python,
    the launch itself) does not count; a call that makes more launches
    than the device queue holds is partly host-bound all the same (use
    ``wall_ms`` for such a composite)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    torch.cuda._sleep(int(min(1.5 * iters * one_s + 1e-3, 5.0)
                          * SLEEP_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def wall_ms(torch, fn, iters):
    """Mean ms per call from CUDA events around ``iters`` back-to-back
    calls with no head start: the rate at which host and device together
    get through them (the host's launch time counts where it is longer)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _profiled_kernels(torch, fn, calls):
    """(name, ms) of every kernel launch ``torch.profiler`` recorded over
    ``calls`` calls.  A one-element marker kernel (~µs, recorded) opens
    the window, whose first kernel the profiler can drop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(ev.name, ev.device_time_total / 1e3) for ev in prof.events()
            if ev.device_type == DeviceType.CUDA]


def kernel_launch_ms(torch, fn, want, calls=10, tries=8):
    """Device ms per launch of each kernel of ``fn`` whose name holds one
    of the substrings ``want``: the mean duration of its launches that
    ``torch.profiler`` recorded.  The profiler can record only some of a
    window's kernel launches (on an H100 host: a third, or none, in some
    windows), so a mean per recorded launch, not a sum over the calls; a
    window missing a wanted kernel is profiled again, up to ``tries``
    times."""
    for _ in range(tries):
        launches = {}
        for name, ms in _profiled_kernels(torch, fn, calls):
            launches.setdefault(name, []).append(ms)
        found = {w: [ms for name, ts in launches.items() if w in name
                     for ms in ts] for w in want}
        if all(found.values()):
            return {w: sum(ts) / len(ts) for w, ts in found.items()}
    raise AssertionError(f"the profiler recorded no launch of "
                         f"{[w for w, ts in found.items() if not ts]} in "
                         f"{tries} windows")


def device_busy_ms(torch, fn, calls=3):
    """Device time of one call: the sum of its kernels' durations under
    ``torch.profiler`` (gaps between them excluded), over ``calls``
    calls; a lower bound where the profiler drops launches (see
    ``kernel_launch_ms``)."""
    return sum(ms for _, ms in _profiled_kernels(torch, fn, calls)) / calls


def median_ms(torch, fn, runs=25, warmup=3):
    """Median device ms of ``runs`` single calls, each between its own
    CUDA events after a GPU sleep long enough for the host to enqueue the
    whole call (so the host's launch time does not count), after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    head_start = int((2.0 * (time.perf_counter() - t0) + 1e-3)
                     * SLEEP_CYCLES_PER_S)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(head_start)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def paged_bound(case):
    """Least time for one paged-attention call on these inputs: each
    live K/V element (and scale), q, out and the walked table entries
    moved once, or 4 flops per (row, key, dim) at the input type's peak,
    whichever is larger."""
    q, kp = case["q"], case["k_pool"]
    s_n, w, n_heads, hd = q.shape
    _, bs, kv_heads, _ = kp.shape
    lengths = case["lengths"].tolist()
    starts = case["starts"].tolist()
    keys = sum(lengths)
    bytes_kv = 2 * keys * kv_heads * hd * kp.element_size()
    if case["k_scale"] is not None:
        bytes_kv += 2 * keys * kv_heads * 4
    bytes_q = 2 * s_n * w * n_heads * hd * q.element_size()   # q + out
    bytes_idx = 4 * (sum(-(-ln // bs) for ln in lengths) + 2 * s_n)
    attended = sum(max(0, min(ln, st + col + 1))
                   for ln, st in zip(lengths, starts) for col in range(w))
    flops = 4.0 * attended * n_heads * hd
    t_bytes = (bytes_kv + bytes_q + bytes_idx) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_paged_attention(torch, device, head_dim=64, block_size=16,
                         sweep=True):
    """Kernel, plain version and library yardstick at the decode shape
    of phase 4 (16 lanes, 16 heads of 64, block 16, bf16; the table at
    the server's capacity of 1024 keys: 64 blocks), each the median of
    single calls behind a GPU sleep.  With ``sweep`` the kernel is also
    timed at several split sizes (``SPLIT_KEYS``); the row's time is
    that of the size the port ships.  ``head_dim`` and ``block_size``
    time the other shapes the kernel takes (16 heads of ``head_dim``,
    pool blocks of ``block_size`` keys)."""
    import torch.nn.functional as F

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        paged_attention as pa,
    )

    lengths = decode_lengths()
    case = make_case(torch, device, torch.bfloat16, lengths,
                     [max(ln - 1, 0) for ln in lengths], 1, 16, 16,
                     head_dim=head_dim, block_size=block_size,
                     max_blocks=1024 // block_size)
    args = [case[k] for k in ("q", "k_pool", "v_pool", "tables", "lengths",
                              "starts")]
    q, kp, vp, tables, lens = args[:5]
    s_n, _, n_heads, hd = q.shape
    bs = kp.shape[1]
    n_live = -(-max(lengths) // bs)
    t_cap = n_live * bs

    def library():
        # yardstick only: gather the live blocks, mask by length, SDPA
        blocks = tables[:, :n_live].long()
        k = kp[blocks].reshape(s_n, t_cap, n_heads, hd).transpose(1, 2)
        v = vp[blocks].reshape(s_n, t_cap, n_heads, hd).transpose(1, 2)
        keep = (torch.arange(t_cap, device=device)[None, :]
                < lens[:, None].long())[:, None, None, :]
        return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                              attn_mask=keep)

    before = pa.paged_attention.launches
    shipped = pa.SPLIT_KEYS
    swept = {}
    try:
        for keys in sorted({32, 64, 128, 256, 512, shipped} if sweep
                           else {shipped}):
            pa.SPLIT_KEYS = keys
            swept[keys] = median_ms(torch, lambda: pa.paged_attention(*args))
    finally:
        pa.SPLIT_KEYS = shipped
    pa.paged_attention.launches = before   # timing launches do not count
    kernel_ms = swept[shipped]
    split_blocks, n_splits = pa.split_plan(tables.shape[1], bs)
    plain_ms = median_ms(torch, lambda: pa.paged_attention_reference(*args))
    library_ms = median_ms(torch, library)
    bound_ms, bound_by = paged_bound(case)
    print(f"paged_attention decode (16 lanes, sum(len)={sum(lengths)}, "
          f"bf16, head_dim {hd}, blocks of {bs} keys, table of "
          f"{tables.shape[1]} blocks): split_blocks "
          f"{split_blocks} ({split_blocks * bs} keys), {n_splits} splits; "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"medians of 25", flush=True)
    if sweep:
        print("paged_attention split sweep (keys per split: kernel ms): "
              + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(swept.items())),
              flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                split_blocks=split_blocks, n_splits=n_splits)


# ---------------------------------------------------------------------------
# phase 6: flash attention against its plain versions
# ---------------------------------------------------------------------------

# the training path's attention shape: batch 8, T 1024, 16 heads of 64
FLASH_SHAPE = (8, 1024, 16, 64)
# gradients sum up to T products per element and round once to the output
# type; their scale grows with T, so the absolute part of the tolerance is
# relative to the largest reference value: err <= atol * max|ref| + rtol *
# |ref|.  bf16: one output rounding (2^-8) on each side; f32: summation
# order only.
GRAD_TOL = {"torch.float32": (1e-4, 1e-4), "torch.bfloat16": (1e-2, 1e-2)}
# the sm90 (bf16) kernels against the plain versions that round P and dS
# to bf16 as they do: left are the f32 summation order, exp2 of prescaled
# scores, a rare P or dS that rounds the other way, and the one rounding
# of the output (1 bf16 ulp = 2^-7 relative at most): out atol + rtol *
# |ref|, gradients atol * max|ref| + rtol * |ref|
ROUND_TOL = (1e-2, 8e-3)
ROUND_GRAD_TOL = (2e-3, 8e-3)


MASKS = ("causal", "none", "causal_exclusive")
# the head_dims under the sm90 kernels' 32 (bf16 runs on the simt kernels)
SMALL_HEAD_DIMS = (8, 16)
# the tail tiles: T not a multiple of the kernels' 64-row tile, with the
# default blocks (clipped to T) and with blocks 96 x 96
TAIL_CASES = ((32, (4, 32, 8, 64), {}), (96, (4, 96, 8, 64), {}),
              (288, (2, 288, 8, 64), dict(block_q=96, block_k=96)))


def flash_cases():
    """(name, kwargs) for every flash case: the training shape in both
    dtypes and all three mask modes, then T 256 with blocks 64 x 128,
    head_dim 128, and in bf16 head_dim 32 and T 320 (a multiple of 64 but
    not of 128) with blocks 64 x 64 in two mask modes; then the tails in
    both dtypes and all three mask modes."""
    cases = []
    for dt in ("bfloat16", "float32"):
        for mask in ("causal", "none", "causal_exclusive"):
            cases.append((f"{mask}_{dt}", dict(dtype=dt, shape=FLASH_SHAPE,
                                               mask=mask)))
        cases.append((f"t256_blocks64x128_{dt}",
                      dict(dtype=dt, shape=(4, 256, 8, 64), mask="causal",
                           block_q=64, block_k=128)))
        cases.append((f"d128_{dt}", dict(dtype=dt, shape=(2, 512, 8, 128),
                                         mask="causal")))
    cases.append(("d32_bfloat16", dict(dtype="bfloat16", shape=(4, 512, 8, 32),
                                       mask="causal")))
    for mask in ("causal", "causal_exclusive"):
        cases.append((f"t320_blocks64x64_{mask}_bfloat16",
                      dict(dtype="bfloat16", shape=(2, 320, 8, 64), mask=mask,
                           block_q=64, block_k=64)))
    for dt in ("bfloat16", "float32"):
        for t, shape, blocks in TAIL_CASES:
            for mask in MASKS:
                cases.append((f"tail_t{t}_{mask}_{dt}",
                              dict(dtype=dt, shape=shape, mask=mask,
                                   **blocks)))
    # head_dim 8 and 16 (bf16 too on the simt kernels), every mask, and a
    # tail T 96 at each
    for dt in ("bfloat16", "float32"):
        for d in SMALL_HEAD_DIMS:
            for mask in MASKS:
                cases.append((f"d{d}_{mask}_{dt}",
                              dict(dtype=dt, shape=(4, 512, 8, d),
                                   mask=mask)))
            cases.append((f"d{d}_tail_t96_{dt}",
                          dict(dtype=dt, shape=(4, 96, 8, d),
                               mask="causal")))
    return cases


def make_flash_case(torch, device, dtype, shape, seed=0):
    """q/k/v as the strided views a fused (B, T, 3*H*D) projection gives
    (as in the model), and a random output cotangent."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b, t, h, d = shape
    qkv = torch.randn((b, t, 3 * h * d), generator=g).to(dtype).to(device)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d)
               for i in range(3))
    dout = torch.randn(shape, generator=g).to(dtype).to(device)
    return q, k, v, dout


def _close(torch, got, want, atol, rtol, scaled=False):
    """(ok, max_abs_err): finite, and within atol (times max|want| when
    ``scaled``) + rtol * |want| elementwise."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    base = float(want.abs().max()) if scaled else 1.0
    ok = (bool(torch.isfinite(got).all())
          and bool((err <= atol * base + rtol * want.abs()).all()))
    return ok, float(err.max())


def check_flash(torch, device, cases=None):
    """Every flash case: the forward kernel, then the backward's one C call
    (delta, dq, dkv) under each schedule the dtype takes (bf16: shared and
    serial, their results equal bitwise; f32: serial), against the plain
    versions on the same inputs (the plain dq and dkv fed the kernels'
    out, lse and delta, so each kernel meets its own plain version on
    identical inputs), the sm90 ones (bf16) also against the plain
    versions that round as they do; each call launches each kernel once,
    on the design ``kernel_design`` routes it to, as the by-design
    counters show.  Returns {kernel: largest abs error against the
    unrounded plain version}."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    worst = dict.fromkeys(fa.COUNTERS, 0.0)
    for i, (name, kw) in enumerate(cases or flash_cases()):
        dtype = getattr(torch, kw["dtype"])
        q, k, v, dout = make_flash_case(torch, device, dtype, kw["shape"],
                                        seed=100 + i)
        mask = kw["mask"]
        blocks = (kw.get("block_q", 128), kw.get("block_k", 128))
        design = fa.kernel_design("fwd", dtype, kw["shape"][-1])
        schedules = fa.SCHEDULES if design == "sm90" else ("serial",)
        before = fa.launch_counts()
        out, lse = fa.flash_forward(q, k, v, mask, *blocks)
        runs = {sch: fa.flash_backward(q, k, v, out, lse, dout, mask,
                                       *blocks, schedule=sch,
                                       return_delta=True)
                for sch in schedules}
        if device.type == "cuda":
            torch.cuda.synchronize()
        after = fa.launch_counts()
        # launches by design (none on the CPU): the forward once, each
        # backward kernel once per schedule
        n = int(device.type == "cuda")
        calls = dict.fromkeys(fa.COUNTERS, len(schedules))
        calls["fwd"] = 1
        want = {d: {w: n * calls[w] if d == design else 0
                    for w in fa.COUNTERS} for d in ("sm90", "simt")}
        got = {d: {w: after[d][w] - before[d][w] for w in fa.COUNTERS}
               for d in ("sm90", "simt")}
        launched_ok = got == want
        dq, dk, dv, delta = runs["serial"]
        same = all(torch.equal(a, b) for a, b in
                   zip(runs.get("shared", runs["serial"]), runs["serial"]))
        r_out, r_lse = fa.flash_forward_reference(q, k, v, mask, blocks[1])
        r_delta = fa.flash_delta(out, dout)
        r_dq = fa.flash_dq_reference(q, k, v, dout, lse, delta, mask)
        r_dk, r_dv = fa.flash_dkv_reference(q, k, v, dout, lse, delta, mask)
        atol, rtol = TOL[str(dtype)]
        gatol, grtol = GRAD_TOL[str(dtype)]
        f32 = TOL["torch.float32"]
        results = {
            "fwd": [_close(torch, out, r_out, atol, rtol),
                    _close(torch, lse, r_lse, *f32)],
            # delta sums D f32 products: f32 rounding, scaled by its largest
            "delta": [_close(torch, delta, r_delta, *f32, scaled=True)],
            "dq": [_close(torch, dq, r_dq, gatol, grtol, scaled=True)],
            "dkv": [_close(torch, dk, r_dk, gatol, grtol, scaled=True),
                    _close(torch, dv, r_dv, gatol, grtol, scaled=True)],
        }
        if mask == "causal_exclusive":
            # row 0 of every head attends no key: output 0, lse -1e30,
            # and its gradient 0 (dq row 0; no key gets dk/dv from it)
            results["fwd"].append((bool((out[:, 0] == 0).all())
                                   and bool((lse[:, 0] <= -1e29).all()),
                                   0.0))
            results["dq"].append((bool((dq[:, 0] == 0).all()), 0.0))
        rounded = {}
        if design == "sm90":
            # 64-key blocks: the running max the kernel rounds P under
            g_out, _ = fa.flash_forward_reference(q, k, v, mask, 64,
                                                  round_p=True)
            rounded["fwd"] = [_close(torch, out, g_out, *ROUND_TOL)]
            g_dq = fa.flash_dq_reference(q, k, v, dout, lse, delta, mask,
                                         round_p=True)
            rounded["dq"] = [_close(torch, dq, g_dq, *ROUND_GRAD_TOL,
                                    scaled=True)]
            g_dk, g_dv = fa.flash_dkv_reference(q, k, v, dout, lse, delta,
                                                mask, round_p=True)
            rounded["dkv"] = [_close(torch, dk, g_dk, *ROUND_GRAD_TOL,
                                     scaled=True),
                              _close(torch, dv, g_dv, *ROUND_GRAD_TOL,
                                     scaled=True)]
        parts = []
        ok_all = launched_ok and same
        for kern, res in results.items():
            ok = all(r[0] for r in res + rounded.get(kern, []))
            err = max(r[1] for r in res)
            worst[kern] = max(worst[kern], err)
            ok_all = ok_all and ok
            part = f"{kern} {err:.3e}"
            if kern in rounded:
                part += (" (rounding plain version "
                         f"{max(r[1] for r in rounded[kern]):.3e})")
            parts.append(part + ("" if ok else " FAIL"))
        print(f"flash {name} {tuple(kw['shape'])} blocks {blocks} "
              f"[{design if n else 'plain'}]: " + ", ".join(parts)
              + f"; backward {'/'.join(schedules)}"
              + (f", equal bitwise: {same}" if len(schedules) > 1 else "")
              + f" (tolerance out atol {atol} + rtol {rtol}; lse and delta "
              f"{f32}; grads {gatol}*max|ref| + {grtol}*|ref|; against the "
              f"rounding plain version out {ROUND_TOL}, grads "
              f"{ROUND_GRAD_TOL}); launches "
              f"{'ok' if launched_ok else f'FAIL ({got}, expected {want})'}",
              flush=True)
        if not ok_all:
            raise AssertionError(f"flash attention disagrees with its plain "
                                 f"version, or ran another design, or its "
                                 f"schedules differ, in case {name}")
    return worst


def flash_bound(torch, which, shape, dtype, mask="causal"):
    """Least time for one kernel call at ``shape``: each input read once
    and each output written once, or its products (2 flops per attended
    (query, key, dim) and product) at the input type's peak."""
    b, t, h, d = shape
    pairs = {"none": t * t, "causal": t * (t + 1) // 2,
             "causal_exclusive": t * (t - 1) // 2}[mask] * b * h
    products = {"fwd": 2, "dq": 3, "dkv": 4}[which]
    flops = 2.0 * products * pairs * d
    n = b * t * h * d * torch.tensor([], dtype=dtype).element_size()
    rows = 4 * b * h * t                     # one f32 per row: lse, delta
    moved = {"fwd": 3 * n + n + rows,        # q k v -> out, lse
             "dq": 4 * n + 2 * rows + n,     # q k v dO lse delta -> dq
             "dkv": 4 * n + 2 * rows + 2 * n}[which]
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_flash(torch, device):
    """Kernels, plain versions and the library yardstick at the training
    shape (bf16, causal): the forward by CUDA events around 50 calls; dq
    and dkv (and the delta kernel) by their mean durations per launch
    under the profiler (``kernel_launch_ms``) in the backward's serial
    schedule, the one the rule takes at this T, whose whole call is also
    timed by events.  Returns {kernel: timing
    dict}."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype = torch.bfloat16
    q, k, v, dout = make_flash_case(torch, device, dtype, FLASH_SHAPE)
    out, lse = fa.flash_forward(q, k, v, "causal")
    delta = fa.flash_delta(out, dout)

    def backward():
        return fa.flash_backward(q, k, v, out, lse, dout, "causal",
                                 schedule="serial")

    before = fa.launch_counts()
    kernel = {"fwd": time_ms(torch, lambda: fa.flash_forward(q, k, v), 50)}
    backward_ms = time_ms(torch, backward, 20)
    by_kernel = kernel_launch_ms(torch, backward, [
        f"flash_{w}_" for w in ("delta", "dq", "dkv")])
    for which in ("delta", "dq", "dkv"):
        kernel[which] = by_kernel[f"flash_{which}_"]
    after = fa.launch_counts()
    ran = {w: "/".join(d for d in ("sm90", "simt")
                       if after[d].get(w, 0) > before[d].get(w, 0))
           for w in kernel}
    fa.set_launch_counts(before)   # timing does not count
    plain = {
        "fwd": time_ms(torch, lambda: fa.flash_forward_reference(
            q, k, v, "causal"), 3),
        "dq": time_ms(torch, lambda: fa.flash_dq_reference(
            q, k, v, dout, lse, delta), 3),
        "dkv": time_ms(torch, lambda: fa.flash_dkv_reference(
            q, k, v, dout, lse, delta), 3),
    }
    # yardstick only: PyTorch's fused attention on (B, H, T, D) copies;
    # device-time medians of single calls (a loop's mean, host launch time
    # included, did not settle between runs); its backward alone
    # (forward+backward - forward) stands beside dq and dkv, which
    # together are that backward
    sdpa_fwd, sdpa_both = sdpa_yardstick(torch, q, k, v, dout, True)
    sdpa_bwd = sdpa_both - sdpa_fwd
    out_t = {}
    for which in ("fwd", "dq", "dkv"):
        bound_ms, bound_by = flash_bound(torch, which, FLASH_SHAPE, dtype)
        out_t[which] = dict(ms=kernel[which], plain_ms=plain[which],
                            library_ms=sdpa_fwd if which == "fwd"
                            else sdpa_bwd,
                            bound_ms=bound_ms, bound_by=bound_by)
        print(f"flash {which} {FLASH_SHAPE} bf16 causal: kernel "
              f"[{ran[which]}] "
              f"{kernel[which]:.4f} ms, plain {plain[which]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    print(f"flash backward (serial) {FLASH_SHAPE} bf16 causal: "
          f"{backward_ms:.4f} ms per call (events), of which the delta "
          f"kernel [{ran['delta']}] {kernel['delta']:.4f} ms (profiler)",
          flush=True)
    print(f"flash library yardstick (F.scaled_dot_product_attention, "
          f"is_causal, median of 25): forward {sdpa_fwd:.4f} ms, "
          f"forward+backward {sdpa_both:.4f} ms, backward alone "
          f"{sdpa_bwd:.4f} ms; kernels fwd+dq+dkv "
          f"{kernel['fwd'] + kernel['dq'] + kernel['dkv']:.4f} ms",
          flush=True)
    return out_t


def time_flash_small(torch, device):
    """bf16 at head_dim 8 and 16 (the simt kernels), causal, at the
    training shape's (B, T, H) = (8, 1024, 16): the forward and the
    backward's one C call (delta, dq, dkv in turn) by CUDA events, their
    plain versions, SDPA's forward and forward+backward, and the bound of
    forward and of dq + dkv.  Returns {head_dim: numbers}."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype, out_t = torch.bfloat16, {}
    for d in SMALL_HEAD_DIMS:
        shape = FLASH_SHAPE[:3] + (d,)
        q, k, v, dout = make_flash_case(torch, device, dtype, shape)
        out, lse = fa.flash_forward(q, k, v, "causal")
        delta = fa.flash_delta(out, dout)
        before = fa.launch_counts()
        fwd = time_ms(torch, lambda: fa.flash_forward(q, k, v), 20)
        bwd = time_ms(torch, lambda: fa.flash_backward(
            q, k, v, out, lse, dout, "causal"), 10)
        design = "/".join(dd for dd in ("sm90", "simt")
                          if fa.launch_counts()[dd]["fwd"] > before[dd]["fwd"])
        fa.set_launch_counts(before)   # timing does not count
        plain_fwd = time_ms(torch, lambda: fa.flash_forward_reference(
            q, k, v, "causal"), 3)
        plain_bwd = time_ms(torch, lambda: (
            fa.flash_dq_reference(q, k, v, dout, lse, delta),
            fa.flash_dkv_reference(q, k, v, dout, lse, delta)), 3)
        sdpa_fwd, sdpa_both = sdpa_yardstick(torch, q, k, v, dout, True)
        b_fwd, by_fwd = flash_bound(torch, "fwd", shape, dtype)
        b_dq, _ = flash_bound(torch, "dq", shape, dtype)
        b_dkv, by_bwd = flash_bound(torch, "dkv", shape, dtype)
        out_t[d] = dict(design=design, fwd_ms=fwd, backward_ms=bwd,
                        plain_fwd_ms=plain_fwd, plain_backward_ms=plain_bwd,
                        sdpa_fwd_ms=sdpa_fwd,
                        sdpa_backward_ms=sdpa_both - sdpa_fwd,
                        bound_fwd_ms=b_fwd, bound_fwd_by=by_fwd,
                        bound_backward_ms=b_dq + b_dkv, bound_backward_by=by_bwd)
        print(f"flash head_dim {d} {shape} bf16 causal [{design}]: forward "
              f"{fwd:.4f} ms (plain {plain_fwd:.4f}, SDPA {sdpa_fwd:.4f}, "
              f"bound {b_fwd:.4f} {by_fwd}); backward (delta + dq + dkv) "
              f"{bwd:.4f} ms (plain dq + dkv {plain_bwd:.4f}, SDPA backward "
              f"{sdpa_both - sdpa_fwd:.4f}, bound dq + dkv "
              f"{b_dq + b_dkv:.4f} {by_bwd})", flush=True)
    return out_t


def sdpa_yardstick(torch, q, k, v, dout, causal):
    """(forward ms, forward+backward ms) of one
    ``F.scaled_dot_product_attention`` on (B, H, T, D) copies of the
    inputs, each the median of 25 single calls after a warm-up."""
    import torch.nn.functional as F

    qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, dout))
    fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        torch.autograd.grad(o, (qg, kg, vg), dot)

    return fwd, median_ms(torch, fwd_bwd)


# ---------------------------------------------------------------------------
# phase 4: the serving path at full width
# ---------------------------------------------------------------------------

def flagship_config(torch):
    """``__graft_entry__.py``'s flagship LM (vocab 256, max_seq_len 128, 2
    layers, d_model 128, 4 heads of 32, d_ff 512), f32."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        TransformerConfig,
    )

    return TransformerConfig(vocab_size=256, max_seq_len=128, n_layers=2,
                             d_model=128, n_heads=4, d_ff=512,
                             attention="dense", param_dtype=torch.float32,
                             compute_dtype=torch.float32)


def big_config(torch, n_layers=None, dtype=None):
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        TransformerConfig,
    )

    dtype = dtype or torch.bfloat16
    kw = dict(BIG)
    if n_layers is not None:
        kw["n_layers"] = n_layers
    return TransformerConfig(**kw, activation="gelu", pos_encoding="learned",
                             param_dtype=dtype, compute_dtype=dtype)


def serve_requests(np, n, vocab, seed, p_lo=64, p_hi=768, n_lo=32, n_hi=128):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = int(rng.integers(p_lo, p_hi + 1))
        out.append((rng.integers(0, vocab, p).tolist(),
                    int(rng.integers(n_lo, n_hi + 1))))
    return out


def synced_clock(torch, device):
    """Host clock read after the device catches up: the host runs ahead
    of the kernels it queues, so TTFT/ITL need the device's time."""
    def now():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.monotonic()
    return now


def drive(sched, requests):
    rids = [sched.submit(p, n) for p, n in requests]
    assert all(r is not None for r in rids), "a request was rejected"
    sched.run_until_drained()
    results = [sched.result(r) for r in rids]
    for (p, n), toks in zip(requests, results):
        assert len(toks) == len(p) + n, "a request came back short"
        assert toks[:len(p)] == p, "a prompt came back altered"
    sched.server.allocator.assert_drained()
    return rids, results


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


def serve_setup(torch, np, device, cfg=None, n_requests=32, slots=16,
                warmup=2, quantize=False, **req_kw):
    """Phase 4's LM (``cfg``) behind the fused scheduler: the model, its
    seeded params (``quantize``: int8 PTQ weights, ``ops.quant``), the
    scheduler's config and ``n_requests`` seeded requests, after
    ``warmup`` more on a scheduler of their own (first-call costs, cuBLAS
    handles and allocator growth, stay out of a measured run)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops.quant import (  # noqa: E501
        quantize_params, quantized_bytes,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig,
    )

    cfg = cfg or big_config(torch)
    model = Transformer(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    if quantize:
        params = quantize_params(params)
    print(f"model: {model.n_params(params) / 1e6:.1f}M parameters "
          f"({quantized_bytes(params) / 2 ** 20:.1f} MiB), {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.compute_dtype}, matmul "
          f"{cfg.matmul_dtype}{', int8 PTQ weights' if quantize else ''}",
          flush=True)
    with torch.no_grad():
        logits = model.forward(params, torch.arange(
            64, device=device)[None] % cfg.vocab_size)
    assert logits.shape == (1, 64, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    max_len = cfg.max_seq_len
    blocks_per_stream = -(-max_len // 16)
    sconf = dict(attn_impl="fused", slots=slots, block_size=16,
                 max_len=max_len, prefill_chunk=256,
                 num_blocks=slots * blocks_per_stream + 1)
    requests = serve_requests(np, n_requests + warmup, cfg.vocab_size, SEED,
                              **req_kw)
    drive(Scheduler(model, params, ServeConfig(**sconf), device=device),
          requests[:warmup])
    return model, params, sconf, requests[warmup:]


def serve_measure(torch, device, model, params, sconf, requests, tag):
    """One measured drain of ``requests`` on a fresh scheduler: check
    completion, the drained allocator and paged attention's launches;
    print and return tokens/s, TTFT and ITL percentiles and the param
    bytes."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops.quant import (  # noqa: E501
        quantized_bytes,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig,
    )

    sched = Scheduler(model, params, ServeConfig(**sconf),
                      now_fn=synced_clock(torch, device), device=device)
    paged_attention.launches = 0
    t0 = sched.now()
    rids, _ = drive(sched, requests)
    wall = sched.now() - t0
    launches = paged_attention.launches
    snap = sched.snapshot()
    passes = snap["prefill_chunks"] + snap["decode_steps"]
    # one launch per layer per forward pass; CPU tensors (a rehearsal of
    # this script's control flow) take the plain version and launch none
    expect = model.cfg.n_layers * passes if device.type == "cuda" else 0
    if launches != expect:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected n_layers x passes = {expect}")
    sched.close()
    stats = [sched.stats(r) for r in rids]
    ttft = [s.ttft_ms for s in stats]
    itl = [s.itl_ms for s in stats]
    out = dict(requests=len(rids), tokens_out=snap["tokens_out"],
               wall_s=wall, tokens_per_s=snap["tokens_out"] / wall,
               ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
               itl_p50_ms=pct(itl, 50), itl_p99_ms=pct(itl, 99),
               prefill_chunks=snap["prefill_chunks"],
               decode_steps=snap["decode_steps"], ticks=sched.tick_no,
               launches=launches,
               attended_ratio=snap["attended_ratio"],
               evicted=snap["evicted"], param_bytes=quantized_bytes(params))
    print(f"{tag}: " + json.dumps(out), flush=True)
    return out


def serve_full_width(torch, np, device, checks=True, tag="serve", keep=None,
                     **kw):
    """``serve_setup`` and one ``serve_measure``; ``checks``: also count
    the host's syncs and profile one drain; ``keep``: a dict that receives
    the setup (phase 27 serves the same model and requests)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig,
    )

    model, params, sconf, requests = serve_setup(torch, np, device, **kw)
    if keep is not None:
        keep.update(model=model, params=params, sconf=sconf,
                    requests=requests)
    out = serve_measure(torch, device, model, params, sconf, requests, tag)
    if device.type == "cuda" and checks:
        make = lambda: Scheduler(model, params,  # noqa: E731
                                 ServeConfig(**sconf), device=device)
        slots = sconf["slots"]
        count_host_syncs(torch, make, requests[:slots])
        profile_serving(torch, make, requests[:slots])
    return out


def count_host_syncs(torch, make_scheduler, requests):
    """The decode loop must not wait for the device per token: count the
    synchronising calls PyTorch flags (``set_sync_debug_mode``) over one
    drain and require fewer than one per decode step.  Finishing a
    request reads its tokens back once, so about one per request is
    expected."""
    import warnings

    sched = make_scheduler()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            drive(sched, requests)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    steps = sched.snapshot()["decode_steps"]
    print(f"host syncs: {syncs} over {len(requests)} requests and {steps} "
          f"decode steps", flush=True)
    if syncs >= steps:
        raise AssertionError(f"{syncs} device syncs in {steps} decode "
                             "steps: the decode loop waits per token")


def profile_serving(torch, make_scheduler, requests, window=40):
    """Where the serving time goes: one drain of ``requests`` (a fresh
    scheduler, so every request is admitted at once), its first
    ``window`` ticks under the profiler (prefill chunks and decode steps
    together; the profiler's processing costs ~0.1 s a tick).  Prints the
    device's busy share of the window, device kernels per forward pass,
    and the top kernels by device time.  The profiler's own cost
    lengthens the window, so the busy share is a lower bound.  Only the
    device's activity is recorded: the host's operators, which nothing
    here reads, cost most of the profiler's processing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sched = make_scheduler()
    rids = [sched.submit(p, n) for p, n in requests]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            sched.tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    snap = sched.snapshot()
    sched.run_until_drained()
    for (p, n), rid in zip(requests, rids):
        toks = sched.result(rid)
        assert len(toks) == len(p) + n and toks[:len(p)] == p, \
            "profiled drain: a request came back altered"
    sched.server.allocator.assert_drained()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.device_time_total, cnt + 1)
    busy_us = sum(t for t, _ in by_name.values())
    n_dev = sum(c for _, c in by_name.values())
    passes = snap["prefill_chunks"] + snap["decode_steps"]
    print(f"profile: {len(requests)} requests, {window} ticks, {passes} "
          f"forward passes, "
          f"wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {n_dev} device ops "
          f"({n_dev / max(passes, 1):.0f} per pass)", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (tot, cnt) in top:
        print(f"  {100 * tot / max(busy_us, 1e-9):5.1f}% {tot / 1e3:8.2f} ms "
              f"x{cnt:6d}  {name[:90]}", flush=True)


# ---------------------------------------------------------------------------
# phase 5: token identity in f32
# ---------------------------------------------------------------------------

def token_identity(torch, np, device, cfg=None, block_size=16, tag=""):
    """f32 greedy tokens: the fused scheduler (paged attention's kernel),
    the gathered one and ``generate()`` agree on ragged requests (prompts
    that fit ``cfg.max_seq_len`` with their new tokens), then fused ==
    gathered with int8 KV pools and the prefix cache, at pool blocks of
    ``block_size`` keys."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, generate,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig,
    )

    # f32 matmuls in full f32: argmax ties are easy in bf16, and TF32
    # keeps about three digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or big_config(torch, n_layers=2, dtype=torch.float32)
    model = Transformer(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 1))
    rng = np.random.default_rng(SEED + 1)
    vocab = cfg.vocab_size
    ragged = [(rng.integers(0, vocab, p).tolist(), 16)
              for p in (5, 40, 100, 300) if p + 16 <= cfg.max_seq_len]
    base = rng.integers(0, vocab, 100).tolist()
    shared = [(base + [1], 12), (base + [2, 3], 12), (base[:37] + [4], 10),
              (base, 12), (base + [1], 8)]
    geom = dict(slots=4, block_size=block_size, max_len=cfg.max_seq_len,
                prefill_chunk=256,
                num_blocks=4 * -(-cfg.max_seq_len // block_size) + 1)

    def run(requests, **kw):
        sched = Scheduler(model, params, ServeConfig(**geom, **kw),
                          device=device)
        return drive(sched, requests)[1], sched

    fused, _ = run(ragged, attn_impl="fused")
    gathered, _ = run(ragged, attn_impl="gathered")
    oracle = [generate(model, params, [p], n, device=device)[0].tolist()
              for p, n in ragged]
    if not fused == gathered == oracle:
        raise AssertionError("f32 greedy tokens differ: fused vs gathered "
                             "vs generate()")
    print(f"tokens f32{tag}: fused == gathered == generate() for "
          f"{len(ragged)} ragged requests", flush=True)
    fq, sched = run(shared, attn_impl="fused", kv_quant=True,
                    prefix_cache=True)
    gq, _ = run(shared, attn_impl="gathered", kv_quant=True,
                prefix_cache=True)
    hits = sched.snapshot()["prefix_hits"]
    if fq != gq or hits == 0:
        raise AssertionError(f"int8 + prefix cache: fused == gathered is "
                             f"{fq == gq}, prefix hits {hits}")
    print(f"tokens f32{tag} int8-KV + prefix cache: fused == gathered for "
          f"{len(shared)} requests ({hits} prefix hits)", flush=True)


# ---------------------------------------------------------------------------
# phase 7: train the 219M LM at full width through the flash kernels
# ---------------------------------------------------------------------------

TEXT_FILE = str(__import__("pathlib").Path(__file__).resolve().parent
                / "DESIGN.md")


def train_flags(**over):
    """The flagship training job (bench.py's big_lm: vocab 32768, T 1024,
    12 layers, d_model 1024, 16 heads, d_ff 4096, GELU, learned positions,
    f32 params, bf16 compute, flash attention, ce_chunk 256, batch 8) on
    the bytes of DESIGN.md, 2 epochs of Adam at lr 1e-3."""
    flags = dict(dataset="text", text_file=TEXT_FILE, seq_len=1024,
                 vocab_size=32768, n_layers=12, d_model=1024, n_heads=16,
                 d_ff=4096, ffn_activation="gelu", dtype="float32",
                 compute_dtype="bfloat16", attention="flash", ce_chunk=256,
                 batch_size=8, nepochs=2, optimizer="adam", lr=1e-3)
    flags.update(over)
    # True: a switch (--remat, --scan-layers, --master-weights)
    return [f"--{k}" if v is True else f"--{k}={v}" for k, v in flags.items()]


def one_rank_group(torch, device):
    """A process group of one (NCCL for the card's tensors, gloo for the
    host's: phase 18 trains on both), so the train step's gradient
    all-reduce runs as it would in a larger world."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("cuda:nccl,cpu:gloo" if device.type == "cuda"
                            else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)


def ring_blocks(attention, s, tp=1):
    """Block calls per layer and step of each flash kernel: 1 for flash,
    S^2 for striped_flash, S(S+1)/2 for causal ring_flash, none for the
    plain attentions; each of ``tp`` tensor shards makes its own."""
    return tp * {"flash": 1, "striped_flash": s * s,
                 "ring_flash": s * (s + 1) // 2, "ulysses": 0,
                 "dense_blockwise": 0, "dense": 0}[attention]


def flat_params(params):
    """The param leaves in the per-layer tree's order (a stacked
    ``scan_layers`` tree walked layer by layer), so runs of either layout
    compare leaf for leaf."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (  # noqa: E501
        layer_params,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    return leaves(dict(params, blocks=layer_params(params)))


def memory_before(torch, device):
    """Bytes the card holds before a run, garbage collected first: what
    earlier phases still hold.  A run's peak memory is its
    ``max_memory_allocated`` less this, so runs late in the script compare
    with phase 7's."""
    import gc

    if device.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(device)


def microbatches(cfg):
    """Microbatches of a step: the pipeline's S x accum_steps (each one
    launches every kernel of a layer), else 1."""
    return cfg.mesh.pipe * cfg.accum_steps if cfg.mesh.pipe > 1 else 1


def fwd_launches_per_layer(model_cfg):
    """Forward kernel launches per layer and step: under --remat the
    block's forward runs again in the backward, and no policy saves an
    autograd.Function's output, so B1 launches twice."""
    return 2 if model_cfg.remat else 1


def train_full_width(torch, np, device, seq_group=None, keep_final=False,
                     profile=True, inspect=None, tag=None, tensor_group=None,
                     fsdp_group=None, expert_group=None, keep_init=False,
                     **over):
    """Train through the port's own Trainer and CLI config (over
    ``seq_group`` for a sequence-sharded attention, ``tensor_group`` for
    tensor parallelism; under ``pp=S`` the pipeline's every microbatch
    launches the flash kernels); check finite, falling
    losses and the flash launch counts; print step time, tokens/s, MFU,
    peak memory and (``profile``) a profile of 3 more steps.  Returns the
    printed numbers and every step's loss; with ``keep_final``, also a
    host copy of the params after the last step (taken before the
    profile's steps); with ``keep_init``, a host copy of the seeded
    init (``init_params``: :func:`dispatch_full_width` starts from it
    rather than draw it again); ``inspect(trainer)`` returns more numbers
    to print, read after the last step."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
        qmm,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves, tree_map,
    )

    one_rank_group(torch, device)
    with tempfile.TemporaryDirectory() as tmp:
        metrics = f"{tmp}/metrics.jsonl"
        args = build_argparser().parse_args(
            train_flags(metrics_jsonl=metrics, **over))
        cfg = config_from_args(args)
        before = memory_before(torch, device)
        trainer = Trainer(cfg, device=device, seq_group=seq_group,
                          tensor_group=tensor_group, fsdp_group=fsdp_group,
                          expert_group=expert_group)
        trainer.init_state()
        n_params = sum(p.numel() for p in leaves(trainer.state.params))
        init = (tree_map(lambda p: p.detach().to("cpu", copy=True),
                         trainer.state.params) if keep_init else None)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        fa.set_launch_counts()
        qmm.library_gemm.launches.update(int8=0, fp8=0)
        result = trainer.fit()
        counts = fa.launch_counts()
        gemms = dict(qmm.library_gemm.launches)
        final = ([p.detach().cpu() for p in flat_params(trainer.state.params)]
                 if keep_final else None)
        # keep_final="tree": the host tree too (phase 23 (c) slices it)
        final_tree = (tree_map(lambda p: p.detach().cpu(),
                               trainer.state.params)
                      if keep_final == "tree" else None)
        inspected = inspect(trainer) if inspect is not None else {}
        launches, with_lse = counts["all"], counts["with_lse"]
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in sorted(records, key=lambda r: r["step"])
              if "loss" in r]
    steps = result["steps"]
    m = cfg.model
    tag = tag or ("train" if seq_group is None else f"train {m.attention}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: {len(losses)} losses for {steps} "
                             f"steps, finite: "
                             f"{all(math.isfinite(x) for x in losses)}")
    tail = sum(losses[-3:]) / 3
    print(f"{tag}: losses first {losses[0]:.4f}, last-3 mean {tail:.4f} "
          f"over {steps} steps: {[round(x, 4) for x in losses]}", flush=True)
    if tail > losses[0] - 1.0:
        raise AssertionError(f"{tag}: the last 3 steps' mean loss "
                             f"{tail:.4f} is not 1 nat below the first "
                             f"{losses[0]:.4f}")
    s_n = 1 if seq_group is None else seq_group.size
    t_n = 1 if tensor_group is None else tensor_group.size
    per_step = (m.n_layers * ring_blocks(m.attention, s_n, t_n)
                * microbatches(cfg))
    expect = per_step * steps if device.type == "cuda" else 0
    want = dict.fromkeys(fa.COUNTERS, expect)
    want["fwd"] = expect * fwd_launches_per_layer(m)
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want} "
                             f"({per_step} per step x {steps} each, the "
                             "forward twice under --remat)")
    # bf16: every kernel on the sm90 design, none on the simt one
    by_design = {"sm90": counts["sm90"], "simt": counts["simt"]}
    want_design = {"sm90": want, "simt": dict.fromkeys(fa.COUNTERS, 0)}
    if by_design != want_design:
        raise AssertionError(f"flash launches by design {by_design}, "
                             f"expected {want_design}")
    if seq_group is not None and with_lse != expect:
        raise AssertionError(f"flash_attention_with_lse launched {with_lse} "
                             f"times, expected {expect}")
    out = dict(steps=steps, launches=launches, with_lse_launches=with_lse,
               launches_by_design=by_design, gemm_launches=gemms,
               first_loss=losses[0],
               last3_loss=tail, n_params=n_params, **inspected)
    if device.type == "cuda":
        step_ms = sorted(result["step_ms"][3:])
        med = step_ms[len(step_ms) // 2]
        tokens = cfg.batch_size * cfg.data.seq_len
        flops = 3.0 * trainer.model.fwd_flops((cfg.batch_size,
                                               cfg.data.seq_len))
        out.update(step_ms_median=med, tokens_per_s=tokens / med * 1e3,
                   step_tflop=flops / 1e12,
                   mfu=flops / (med / 1e3 * PEAK_FLOPS["torch.bfloat16"]),
                   peak_memory_gib=(result["peak_memory_bytes"] - before)
                   / 2 ** 30, memory_before_gib=before / 2 ** 30,
                   step_ms_all=[round(x, 3) for x in result["step_ms"]])
        if profile:
            out.update(profile_training(torch, trainer,
                                        moe=m.moe_experts > 0))
    print(f"{tag}: " + json.dumps(out), flush=True)
    return dict(out, losses=losses, final_params=final, final_tree=final_tree,
                init_params=init)


def _kernel_class(name, moe=False):
    n = name.lower()
    if "flash_" in n:
        return "flash"
    if any(s in n for s in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
        return "gemm"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer"
    # an MoE step: the index kernels of the dispatch (index_copy and its
    # backward's gather) and the combine (index_select and its backward's
    # index_add), beside the embedding's and the loss's few
    if moe and "index" in n:
        return "dispatch/combine"
    return "other"


def profile_training(torch, trainer, n_steps=1, moe=False):
    """Where the step's device time goes: ``n_steps`` more steps of the
    same trainer under ``torch.profiler``.  Device busy share of the
    window, and the flash / GEMM / optimizer / other shares of device
    time and their ms per step ("other" holds the elementwise work: casts,
    LayerNorm, GELU, residuals and, under a sequence group, the ring's
    lse merges).  The profiler's own cost lengthens the window, so the
    busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = trainer.loader.epoch(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            trainer.state, loss = trainer.train_step(trainer.state,
                                                     next(batches))
        float(loss)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    batches.close()
    by_name, by_class = {}, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time_total
            c = _kernel_class(ev.name, moe)
            by_class[c] = by_class.get(c, 0.0) + ev.device_time_total
    busy = sum(by_name.values())
    print(f"profile: {n_steps} steps, wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%)",
          flush=True)
    shares = {c: us / max(busy, 1e-9) for c, us in sorted(by_class.items())}
    per_step = {c: us / 1e3 / n_steps for c, us in sorted(by_class.items())}
    print("profile shares of device time: " + ", ".join(
        f"{c} {100 * v:.1f}% ({per_step[c]:.2f} ms/step)"
        for c, v in shares.items()), flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {100 * us / max(busy, 1e-9):5.1f}% {us / 1e3:8.2f} ms  "
              f"[{_kernel_class(name, moe)}] {name[:100]}", flush=True)
    # the host side: operators by their own CPU time (the Python between
    # them is not in any operator)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host_us = sum(e.self_cpu_time_total for e in host)
    print(f"profile host: operators' own CPU time {host_us / 1e3:.1f} ms "
          f"of the {wall_us / 1e3:.1f} ms window; top by own CPU time:",
          flush=True)
    for e in host[:12]:
        print(f"  {e.self_cpu_time_total / 1e3 / n_steps:8.2f} ms/step "
              f"x{e.count // n_steps:6d}/step  {e.key[:90]}", flush=True)
    # the flash wrappers (the autograd functions' forward and backward):
    # host ms per call, their own and with the ops they call
    flash_host = {}
    for e in host:
        if "FlashAttention" in e.key and e.count:
            flash_host[e.key] = dict(
                calls_per_step=e.count / n_steps,
                own_ms_per_call=e.self_cpu_time_total / 1e3 / e.count,
                total_ms_per_call=e.cpu_time_total / 1e3 / e.count)
            print(f"profile host flash wrapper {e.key}: "
                  f"{e.count / n_steps:.0f} calls/step, own "
                  f"{e.self_cpu_time_total / 1e3 / e.count:.4f} ms/call, "
                  f"with its ops {e.cpu_time_total / 1e3 / e.count:.4f} "
                  f"ms/call", flush=True)
    return dict(profile_busy_share=busy / wall_us, profile_shares=shares,
                profile_ms_per_step=per_step,
                profile_host_op_ms_per_step=host_us / 1e3 / n_steps,
                profile_flash_host=flash_host)


# ---------------------------------------------------------------------------
# phases 8 and 12: f32 training identities through the train step
# ---------------------------------------------------------------------------

def sgd_runs(torch, device, attentions, n_layers=2, steps=3, batch=8,
             seq_size=4, **over):
    """Full width at ``n_layers`` layers, f32 with TF32 off,
    SGD-momentum: ``steps`` train steps from the same params and batches
    for each attention (the sequence-sharded ones over a
    ``LocalSeqGroup(seq_size)``, the striped one on permuted tokens).
    Returns {attention: (losses, params)}."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.datasets import (  # noqa: E501
        text_dataset,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (  # noqa: E501
        ShardedLoader,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        data_parallel as dp,
        sequence as sq,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        world_setup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(BIG, n_layers=n_layers, activation="gelu",
              pos_encoding="learned", ce_chunk=256)
    kw.update(over)
    data = text_dataset(TEXT_FILE, kw["max_seq_len"], kw["vocab_size"])
    world = world_setup(device)
    runs = {}
    for attention in attentions:
        group = perm = None
        if attention in sq.SEQ_SHARDED_IMPLS:
            group = sq.LocalSeqGroup(seq_size)
            if attention.startswith("striped"):
                perm = sq.striped_permutation(kw["max_seq_len"], seq_size)
        model = Transformer(TransformerConfig(**kw, attention=attention),
                            device=device, seq_group=group)
        params = model.init(torch.Generator().manual_seed(SEED + 2))
        opt = optim.sgd(1e-2, 0.9, steps=steps)
        state = TrainState.from_params(params, opt)
        step = dp.make_train_step(model, opt, world,
                                  loss_name="cross_entropy")
        losses = []
        loader = ShardedLoader(data, batch, device=device, shuffle=False,
                               seq_permutation=perm)
        for i, b in zip(range(steps), loader.epoch(0)):
            state, loss = step(state, b)
            losses.append(float(loss))
        runs[attention] = (losses, [p.detach() for p in
                                    flat_params(state.params)])
    return runs


def train_identity(torch, np, device, n_layers=2, steps=3, batch=8, **over):
    """Flash and dense attention: losses must agree to rtol 1e-5 and
    params to 1e-5 + 1e-4 * |p| (f32 on both sides; the attention sums
    run in another order, ~1e-6 relative, and 3 small SGD steps carry
    that into the params scaled by lr)."""
    runs = sgd_runs(torch, device, ("flash", "dense"), n_layers, steps,
                    batch, **over)
    (lf, pf), (ld, pd) = runs["flash"], runs["dense"]
    loss_ok = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(lf, ld))
    worst = max(float((a - b).abs().max()) for a, b in zip(pf, pd))
    params_ok = all(bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs()).all())
                    for a, b in zip(pf, pd))
    print(f"train f32 identity ({n_layers} layers, {steps} steps): losses "
          f"flash {lf} dense {ld}; params max |diff| {worst:.3e}", flush=True)
    if not (loss_ok and params_ok):
        raise AssertionError("f32 training with flash attention differs "
                             "from dense attention")


def train_identity_seq(torch, np, device, n_layers=2, steps=3, batch=8,
                       seq_size=4, **over):
    """ring_flash and striped_flash over a local group of ``seq_size``
    against flash: losses to rtol 1e-5 and params within 1e-6 (f32 on
    every side; the lse merges and the stripe order change summation
    order only, and lr 1e-2 scales that into the params)."""
    runs = sgd_runs(torch, device, ("flash", "ring_flash", "striped_flash"),
                    n_layers, steps, batch, seq_size=seq_size, **over)
    lf, pf = runs["flash"]
    for attention in ("ring_flash", "striped_flash"):
        ls, ps = runs[attention]
        loss_ok = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(ls, lf))
        worst = max(float((a - b).abs().max()) for a, b in zip(ps, pf))
        print(f"train f32 identity {attention} over {seq_size} shards "
              f"({n_layers} layers, {steps} steps): losses {ls} vs flash "
              f"{lf}; params max |diff| {worst:.3e}", flush=True)
        if not (loss_ok and worst <= 1e-6):
            raise AssertionError(f"f32 training with {attention} differs "
                                 "from flash attention")


# ---------------------------------------------------------------------------
# phase 9: flash_attention_with_lse against its plain version
# ---------------------------------------------------------------------------

# one ring shard of the training shape: T 1024 over 4 shards
SHARD_SHAPE = (8, 256, 16, 64)


def lse_cases():
    """The shard shape in both dtypes and all three mask modes, then the
    tails T 32 and T 96 (shards under and past one 64-row tile), then
    head_dim 16 (bf16 on the simt kernels) at the shard's T and at T 96."""
    shapes = (("", SHARD_SHAPE), ("t32_", (8, 32, 16, 64)),
              ("t96_", (8, 96, 16, 64)), ("d16_", (8, 256, 16, 16)),
              ("d16_t96_", (8, 96, 16, 16)))
    return [(f"{tag}{mask}_{dt}", dict(dtype=dt, shape=shape, mask=mask))
            for tag, shape in shapes
            for dt in ("bfloat16", "float32")
            for mask in MASKS]


def _lse_cotangents(torch, q, lse, seed):
    """A random output cotangent w (q's type) and a random lse cotangent u
    (f32), zero on empty rows (lse -1e30, where P = 0 anyway)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.randn(q.shape, generator=g).to(q.dtype).to(q.device)
    u = torch.randn(lse.shape, generator=g).to(lse.device)
    return w, torch.where(lse > -1e29, u, 0.0)


def check_flash_lse(torch, device, cases=None):
    """Every case: ``flash_attention_with_lse`` (the kernels) against its
    plain version on the same inputs: out and lse of the forward, and
    dq/dk/dv of sum(out * w) + sum(lse * u), the plain backward fed the
    kernel's out/lse as in phase 6; then the delta the backward's C call
    computes against ``flash_delta``.  One launch of each kernel (fwd,
    delta, dq, dkv) per call, each on its design.  Returns the largest
    abs error."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    worst = 0.0
    for i, (name, kw) in enumerate(cases or lse_cases()):
        dtype = getattr(torch, kw["dtype"])
        mask = kw["mask"]
        q, k, v, _ = make_flash_case(torch, device, dtype, kw["shape"],
                                     seed=200 + i)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        before = fa.launch_counts()
        out, lse = fa.flash_attention_with_lse(qg, kg, vg, mask_mode=mask)
        w, u = _lse_cotangents(torch, q, lse.detach(), seed=300 + i)
        grads = torch.autograd.grad((out, lse), (qg, kg, vg), (w, u))
        out, lse = out.detach(), lse.detach()
        if device.type == "cuda":
            torch.cuda.synchronize()
        after = fa.launch_counts()
        # one launch of each kernel, each on its design
        n = int(device.type == "cuda")
        by_design = {d: {kk: after[d][kk] - before[d][kk] for kk in after[d]}
                     for d in ("sm90", "simt")}
        design = fa.kernel_design("fwd", dtype, q.shape[-1])
        want = {d: dict.fromkeys(fa.COUNTERS, n if d == design else 0)
                for d in ("sm90", "simt")}
        schedule = fa.backward_schedule(dtype, q.shape[1],
                                        head_dim=q.shape[-1])
        cuda_launches = 1 + (1 if schedule == "shared" else 2)
        # the delta of the backward's own C call (not counted: a check)
        saved = fa.launch_counts()
        k_delta = fa.flash_backward(q, k, v, out, lse, w, mask, g_lse=u,
                                    return_delta=True)[3]
        fa.set_launch_counts(saved)
        r_out, r_lse = fa.flash_forward_reference(q, k, v, mask)
        r_grads = fa.flash_backward_reference(q, k, v, out, lse, w, mask,
                                              g_lse=u)
        delta = fa.flash_delta(out, w, u)
        atol, rtol = TOL[str(dtype)]
        gatol, grtol = GRAD_TOL[str(dtype)]
        f32 = TOL["torch.float32"]
        res = [_close(torch, out, r_out, atol, rtol),
               _close(torch, lse, r_lse, *f32)]
        res += [_close(torch, g, r, gatol, grtol, scaled=True)
                for g, r in zip(grads, r_grads)]
        # delta sums D f32 products: f32 rounding, scaled by its largest
        res.append(_close(torch, k_delta, delta, *f32, scaled=True))
        rounded = []
        if design == "sm90":
            r_dq = fa.flash_dq_reference(q, k, v, w, lse, delta, mask,
                                         round_p=True)
            r_dkv = fa.flash_dkv_reference(q, k, v, w, lse, delta, mask,
                                           round_p=True)
            rounded = [_close(torch, g, r, *ROUND_GRAD_TOL, scaled=True)
                       for g, r in zip(grads, (r_dq,) + r_dkv)]
        ok = all(r[0] for r in res + rounded) and by_design == want
        err = max(r[1] for r in res)
        worst = max(worst, err)
        extra = (f"; dq/dk/dv against the rounding plain versions "
                 f"{'/'.join(f'{r[1]:.3e}' for r in rounded)}"
                 if rounded else "")
        print(f"with_lse {name} {tuple(kw['shape'])}: out {res[0][1]:.3e}, "
              f"lse {res[1][1]:.3e}, dq/dk/dv "
              f"{'/'.join(f'{r[1]:.3e}' for r in res[2:5])}, delta "
              f"{res[5][1]:.3e}{extra}; launches {by_design}, backward "
              f"{schedule}: {cuda_launches * n} CUDA launches "
              f"{'ok' if ok else 'FAIL'} (tolerance "
              f"out atol {atol} + rtol {rtol}; lse {f32}; delta "
              f"{f32[0]}*max|ref| + {f32[1]}*|ref|; grads {gatol}*max|ref| "
              f"+ {grtol}*|ref|; rounding {ROUND_GRAD_TOL})", flush=True)
        if not ok:
            raise AssertionError(f"flash_attention_with_lse disagrees with "
                                 f"its plain version in case {name}")
    return worst


def lse_bound(torch, shape, dtype):
    """Least time for one forward+backward of flash_attention_with_lse
    (causal) at ``shape``: q, k, v, w and u read once, out, lse, dq, dk,
    dv written once, or 7 products (2 forward; S again, dP, dV, dQ, dK
    backward) of 2 flops per attended (query, key, dim) at the type's
    peak."""
    b, t, h, d = shape
    pairs = t * (t + 1) // 2 * b * h
    flops = 2.0 * 7 * pairs * d
    n = b * t * h * d * torch.tensor([], dtype=dtype).element_size()
    rows = 4 * b * h * t
    moved = 4 * n + rows + n + rows + 3 * n
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_flash_lse(torch, device):
    """Forward+backward of flash_attention_with_lse at the shard shape
    (bf16, causal): the kernels (device ms with the host's launch time
    hidden, and wall ms per call with it in), each kernel's device ms per
    launch, the plain version, SDPA forward+backward on the same inputs
    (which returns no lse: a yardstick only) and the bound; then the
    backward alone under both schedules at the shard shape, T 512 and the
    training shape, their results held equal bitwise."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype = torch.bfloat16
    q, k, v, _ = make_flash_case(torch, device, dtype, SHARD_SHAPE, seed=7)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    _, lse0 = fa.flash_forward(q, k, v, "causal")
    w, u = _lse_cotangents(torch, q, lse0, seed=8)

    def kernel():
        out, lse = fa.flash_attention_with_lse(qg, kg, vg)
        torch.autograd.grad((out, lse), (qg, kg, vg), (w, u))

    def plain():
        out, lse = fa.flash_forward_reference(q, k, v, "causal")
        fa.flash_backward_reference(q, k, v, out, lse, w, "causal", g_lse=u)

    before = fa.launch_counts()
    b5_ms = time_ms(torch, kernel, 20)
    b5_wall_ms = wall_ms(torch, kernel, 50)
    by_kernel = kernel_launch_ms(torch, kernel, (
        "flash_fwd_", "flash_delta_", "flash_bwd_"))
    fa.set_launch_counts(before)   # timing does not count
    plain_ms = time_ms(torch, plain, 3)
    _, library_ms = sdpa_yardstick(torch, q, k, v, w, True)
    bound_ms, bound_by = lse_bound(torch, SHARD_SHAPE, dtype)
    print(f"with_lse {SHARD_SHAPE} bf16 causal, forward+backward: kernels "
          f"{b5_ms:.4f} ms (wall {b5_wall_ms:.4f} ms per call with "
          f"the host's time), plain {plain_ms:.4f} ms, SDPA fwd+bwd "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    print("with_lse device ms per launch by kernel (profiler): " + ", ".join(
        f"{name.strip('_')} {ms:.4f}" for name, ms in by_kernel.items()),
          flush=True)
    backward = {}
    for shape in (SHARD_SHAPE, (8, 512, 16, 64), FLASH_SHAPE):
        bq, bk, bv, bdo = make_flash_case(torch, device, dtype, shape,
                                          seed=9)
        bout, blse = fa.flash_forward(bq, bk, bv, "causal")
        g_lse = _lse_cotangents(torch, bq, blse, seed=10)[1]
        runs = {sch: (lambda sch=sch: fa.flash_backward(
            bq, bk, bv, bout, blse, bdo, "causal", g_lse=g_lse,
            schedule=sch, return_delta=True)) for sch in fa.SCHEDULES}
        results = {sch: fn() for sch, fn in runs.items()}
        same = all(torch.equal(a, b) for a, b in
                   zip(results["shared"], results["serial"]))
        ms = {sch: time_ms(torch, fn, 20) for sch, fn in runs.items()}
        ms.update({f"{sch}_again": time_ms(torch, runs[sch], 20)
                   for sch in reversed(fa.SCHEDULES)})
        chosen = fa.backward_schedule(dtype, shape[1])
        backward[f"t{shape[1]}"] = dict(ms, chosen=chosen)
        print(f"flash backward (delta + dq + dkv) {shape} bf16 causal: "
              f"shared {ms['shared']:.4f} / {ms['shared_again']:.4f} ms, "
              f"serial {ms['serial']:.4f} / {ms['serial_again']:.4f} ms "
              f"(shared, serial, serial, shared); the rule picks {chosen}; "
              f"results bitwise equal: {same}", flush=True)
        if not same:
            raise AssertionError(f"the shared and serial backward differ "
                                 f"at {shape}")
    fa.set_launch_counts(before)
    return dict(ms=b5_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, wall_ms=b5_wall_ms,
                kernel_ms=by_kernel, backward_ms=backward)


# ---------------------------------------------------------------------------
# phase 10: ring composition at the training shape
# ---------------------------------------------------------------------------

def check_ring(torch, device, shape=FLASH_SHAPE, seq_size=4, iters=10,
               timed=True):
    """ring_flash and striped_flash over a LocalSeqGroup against
    full-sequence flash attention (the kernels) on the same bf16 inputs:
    output and q/k/v gradients, the launches of one call (each kernel,
    delta too, once per block call), and, when ``timed``, the time of
    forward+backward beside full flash."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        sequence as sq,
    )

    dtype = torch.bfloat16
    q, k, v, dout = make_flash_case(torch, device, dtype, shape, seed=11)
    group = sq.LocalSeqGroup(seq_size)
    perm = torch.as_tensor(sq.striped_permutation(shape[1], seq_size),
                           device=device)

    def full(q_, k_, v_):
        return fa.flash_attention(q_, k_, v_, True)

    def ring(q_, k_, v_):
        return sq.ring_flash_attention(q_, k_, v_, group)

    def striped(q_, k_, v_):
        return sq.striped_ring_flash_attention(q_, k_, v_, group)

    def fwd_bwd(fn, inputs, g):
        leaves_ = [x.detach().requires_grad_() for x in inputs]
        out = fn(*leaves_)
        return (out.detach(),) + torch.autograd.grad(out, leaves_, g)

    want = fwd_bwd(full, (q, k, v), dout)
    atol, rtol = TOL[str(dtype)]
    gatol, grtol = GRAD_TOL[str(dtype)]
    out_t = {}
    for name, fn, idx in (("ring_flash", ring, None),
                          ("striped_flash", striped, perm)):
        inputs = (q, k, v) if idx is None else tuple(
            x.index_select(1, idx) for x in (q, k, v))
        g = dout if idx is None else dout.index_select(1, idx)
        ref = want if idx is None else tuple(
            x.index_select(1, idx) for x in want)
        before = dict(fa.flash_attention.launches)
        got = fwd_bwd(fn, inputs, g)
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = {kk: fa.flash_attention.launches[kk] - before[kk]
                    for kk in before}
        res = [_close(torch, got[0], ref[0], atol, rtol)]
        res += [_close(torch, a, b, gatol, grtol, scaled=True)
                for a, b in zip(got[1:], ref[1:])]
        want_n = ring_blocks(name, seq_size) if device.type == "cuda" else 0
        ok = all(r[0] for r in res) and all(n == want_n
                                            for n in launches.values())
        print(f"ring {name} over {seq_size} shards {tuple(shape)} bf16: out "
              f"{res[0][1]:.3e}, dq/dk/dv "
              f"{'/'.join(f'{r[1]:.3e}' for r in res[1:])} vs full flash; "
              f"launches per call {launches} (expected {want_n} each) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} over a LocalSeqGroup disagrees "
                                 "with full-sequence flash attention")
        out_t[name] = dict(max_abs_err=max(r[1] for r in res))
        if device.type == "cuda" and timed:
            saved = fa.launch_counts()
            t = out_t[name]
            t["wall_ms"] = wall_ms(torch, lambda: fwd_bwd(fn, inputs, g),
                                   iters)
            t["device_ms"] = device_busy_ms(
                torch, lambda: fwd_bwd(fn, inputs, g))
            t["full_wall_ms"] = wall_ms(
                torch, lambda: fwd_bwd(full, (q, k, v), dout), iters)
            t["full_device_ms"] = device_busy_ms(
                torch, lambda: fwd_bwd(full, (q, k, v), dout))
            fa.set_launch_counts(saved)
            print(f"ring {name} forward+backward: wall {t['wall_ms']:.4f} "
                  f"ms, device busy {t['device_ms']:.4f} ms; full flash wall "
                  f"{t['full_wall_ms']:.4f} ms, device busy "
                  f"{t['full_device_ms']:.4f} ms", flush=True)
    return out_t


# ---------------------------------------------------------------------------
# phase 13: fused LayerNorm against its plain version
# ---------------------------------------------------------------------------

LN_SHAPE = (8192, 1024)


def ln_cases():
    return [("8192x1024_bfloat16", dict(dtype="bfloat16", shape=LN_SHAPE)),
            ("8192x1024_float32", dict(dtype="float32", shape=LN_SHAPE)),
            ("1000x768_bfloat16", dict(dtype="bfloat16", shape=(1000, 768)))]


def make_ln_case(torch, device, dtype, shape, seed):
    """x with a large common offset (where E[x^2] - mean^2 would
    cancel), scale and bias near 1 and 0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    d = shape[-1]
    x = (40.0 + 3.0 * torch.randn(shape, generator=g)).to(dtype).to(device)
    scale = (1.0 + 0.1 * torch.randn(d, generator=g)).to(device)
    bias = (0.1 * torch.randn(d, generator=g)).to(device)
    return x, scale, bias


def check_layernorm(torch, device, cases=None):
    """One op-level call (its launch count is the kernel's count for the
    kernels line: no model path calls it), then every case against the
    plain version.  Returns (largest abs error, launches of the op call)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        layernorm as ln,
    )

    cases = cases or ln_cases()
    dt0 = getattr(torch, cases[0][1]["dtype"])
    x, scale, bias = make_ln_case(torch, device, dt0, cases[0][1]["shape"],
                                  seed=0)
    ln.fused_layernorm.launches = 0
    y = ln.fused_layernorm(x, scale, bias)
    launches = ln.fused_layernorm.launches
    if y.shape != x.shape or y.dtype != x.dtype or \
            not bool(torch.isfinite(y).all()):
        raise AssertionError("fused_layernorm returned a wrong or non-finite "
                             "result")
    worst = 0.0
    for i, (name, kw) in enumerate(cases):
        dtype = getattr(torch, kw["dtype"])
        x, scale, bias = make_ln_case(torch, device, dtype, kw["shape"],
                                      seed=1 + i)
        got = ln.fused_layernorm(x, scale, bias)
        want = ln.fused_layernorm_reference(x, scale, bias)
        if device.type == "cuda":
            torch.cuda.synchronize()
        atol, rtol = TOL[str(dtype)]
        ok, err = _close(torch, got, want, atol, rtol)
        ok = ok and got.dtype == x.dtype
        worst = max(worst, err)
        print(f"layernorm {name}: max_abs_err {err:.3e} (tolerance atol "
              f"{atol} + rtol {rtol}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"fused_layernorm disagrees with its plain "
                                 f"version in case {name}")
    return worst, launches


def time_layernorm(torch, device):
    """Kernel, plain version and ``F.layer_norm`` at (8192, 1024) bf16,
    beside the bound: x read once, y written once (+ scale and bias), or
    ~8 flops per element at the f32 peak."""
    import torch.nn.functional as F

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        layernorm as ln,
    )

    x, scale, bias = make_ln_case(torch, device, torch.bfloat16, LN_SHAPE,
                                  seed=9)
    before = ln.fused_layernorm.launches
    kernel_ms = time_ms(torch, lambda: ln.fused_layernorm(x, scale, bias),
                        200)
    ln.fused_layernorm.launches = before       # timing does not count
    plain_ms = time_ms(torch, lambda: ln.fused_layernorm_reference(
        x, scale, bias), 50)
    sb, bb = scale.to(x.dtype), bias.to(x.dtype)
    library_ms = time_ms(torch, lambda: F.layer_norm(
        x, (x.shape[-1],), sb, bb, 1e-5), 200)
    n = x.numel()
    t_bytes = (2 * n * x.element_size() + 2 * 4 * x.shape[-1]) \
        / HBM_BYTES_PER_S
    t_ops = 8.0 * n / PEAK_FLOPS["torch.float32"]
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"layernorm {LN_SHAPE} bf16: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, F.layer_norm {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phase 14: the reference job through the CLI, and the quality bars
# ---------------------------------------------------------------------------

REPO_ROOT = __import__("pathlib").Path(__file__).resolve().parent
PKG = "neural_networks_parallel_training_with_mpi_tpu_torch"
REFERENCE_JOB = ["--lr", "0.001", "--momentum", "0.9", "--batch_size", "4",
                 "--nepochs", "3"]
# the card's f32 against the host's: the same job, summation order only
REFERENCE_RTOL = 1e-5


def run_cli(args, timeout=600):
    """``python -m <port> args`` from the repo root; returns the
    completed process (stdout and stderr captured)."""
    return subprocess.run([sys.executable, "-m", PKG, *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(REPO_ROOT))


def epoch_losses(text):
    import re

    return [float(x) for x in re.findall(r"^epoch \d+: loss ([-\d.e+naif]+)",
                                         text, re.M)]


def reference_job(card="auto"):
    """The reference's job as its README runs it, on the card
    (``--platform auto``) and on the host (``--platform cpu``): rc 0,
    three ``epoch n: loss`` lines, the same losses."""
    from concurrent.futures import ThreadPoolExecutor

    def run(platform):
        t0 = time.perf_counter()
        proc = run_cli(REFERENCE_JOB + ["--platform", platform])
        return proc, time.perf_counter() - t0

    # the two processes run side by side (their seconds overlap)
    with ThreadPoolExecutor(2) as pool:
        runs = list(pool.map(run, (card, "cpu")))
    losses = {}
    for platform, (proc, secs) in zip((card, "cpu"), runs):
        got = epoch_losses(proc.stdout)
        print(f"reference job --platform {platform}: rc {proc.returncode}, "
              f"{secs:.1f} s, epoch losses {got}", flush=True)
        if proc.returncode != 0 or len(got) != 3:
            raise AssertionError(
                f"reference job --platform {platform}: rc "
                f"{proc.returncode}, {len(got)} epoch lines\n"
                f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        losses[platform] = got
    card, host = losses[card], losses["cpu"]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(card, host))
    print(f"reference job: card vs host losses, largest relative "
          f"difference {rel:.3g} (tolerance {REFERENCE_RTOL})", flush=True)
    if rel > REFERENCE_RTOL:
        raise AssertionError(f"reference job losses on the card {card} != "
                             f"on the host {host}")
    return dict(card=card, host=host, max_rel_diff=rel)


def _quietly(fn, *args):
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def quality_bars(device):
    """The four configurations of ``quality.py`` trained on the card to
    their bars (``quality`` module of the port)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch import quality

    records = []
    # the toy's 2000 epoch lines stay off the log
    quiet_toy = lambda d: _quietly(quality.run_toy, d)  # noqa: E731
    for name, run in (("toy", quiet_toy),
                      ("digits", quality.run_digits),
                      ("docs_lm", lambda d: quality.run_docs_lm(d)),
                      ("docs_lm_modern",
                       lambda d: quality.run_docs_lm(d, modern=True))):
        t0 = time.perf_counter()
        rec = run(device)
        rec["seconds"] = time.perf_counter() - t0
        print(f"quality {name}: " + json.dumps(rec), flush=True)
        records.append(rec)
    failed = [r["config"] for r in records if not r["pass"]]
    if failed:
        raise AssertionError(f"quality bars missed on the card: {failed}")
    return records


# ---------------------------------------------------------------------------
# phase 15: checkpoint, resume and --generate at full width
# ---------------------------------------------------------------------------

PROMPT = list(b"Synchronous data-parallel training ")[:16]


def snapshot_bytes(path):
    return sum(p.stat().st_size for p in path.iterdir() if p.is_file())


def resume_full_width(torch, np, device, straight, **over):
    """Phase 7's flags (with ``over``) and ``--checkpoint_dir``: one epoch
    (13 steps) and a snapshot; a new Trainer with ``--nepochs 2
    --resume`` (and an async snapshot at the last step) against
    ``straight``, phase 7's uninterrupted run; the async snapshot restored
    against the live state; ``--generate`` from the first snapshot as
    subprocesses (run beside the resume) against the in-process
    ``generate()`` over the first run's live params."""
    import shutil
    import tempfile
    from pathlib import Path

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate import (  # noqa: E501
        generate,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        checkpoint as ckpt,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    def trainer(*switches, **kw):
        args = build_argparser().parse_args(train_flags(**over, **kw)
                                            + list(switches))
        return Trainer(config_from_args(args), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step_losses(path):
        with open(path) as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f)
                    if "loss" in r}

    out = {}
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Path(tmp) / "ck"
        first = trainer(nepochs=1, checkpoint_dir=ck)
        r1 = first.fit()
        n_params = sum(p.numel() for p in leaves(first.state.params))
        save_s = first.save_seconds[-1]
        spe = r1["steps"]     # 13 at full width
        out.update(first_steps=spe, save_s=save_s,
                   snapshot_bytes=snapshot_bytes(ck / f"ckpt-{spe}"),
                   expected_bytes=n_params * 12)
        if ckpt.latest_step(str(ck)) != spe:
            raise AssertionError(f"resume: {spe} steps, newest snapshot "
                                 f"{ckpt.latest_step(str(ck))}")
        # --generate from this snapshot, as a user runs it: greedy, then
        # sampled (a near-constant greedy continuation of a barely trained
        # LM says little; the draws follow the whole distribution).  The
        # processes read a hard-linked copy (the resume's snapshots and
        # pruning leave it as it is) and run beside the resume
        gen_ck = Path(tmp) / "gen"
        shutil.copytree(ck, gen_ck, copy_function=os.link)
        for temperature in (0.0, 1.0):
            procs[temperature] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", PKG,
                 *train_flags(checkpoint_dir=gen_ck, **over),
                 "--generate", ",".join(map(str, PROMPT)),
                 "--max_new_tokens", "32", "--temperature", str(temperature),
                 "--seed", "7"], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, cwd=str(REPO_ROOT)))
        reference = (first.model, first.state.params)
        del first
        try:
            metrics = Path(tmp) / "resumed.jsonl"
            second = trainer("--resume", "--async-checkpoint", nepochs=2,
                             checkpoint_dir=ck, checkpoint_every=spe,
                             metrics_jsonl=metrics)
            r2 = second.fit()
            out.update(restore_s=second.restore_seconds,
                       async_save_host_s=second.save_seconds[0])
            losses = step_losses(metrics)
            steps = list(range(spe + 1, 2 * spe + 1))
            if sorted(losses) != steps or r2["steps"] != 2 * spe:
                raise AssertionError(f"resume: steps {sorted(losses)}, "
                                     f"{r2['steps']} in all")
            want = straight["losses"][spe:2 * spe]
            got = [losses[s] for s in steps]
            loss_diff = max(abs(a - b) for a, b in zip(got, want))
            param_diff = max(
                float((a.detach().cpu() - b).abs().max())
                for a, b in zip(leaves(second.state.params),
                                straight["final_params"]))
            out.update(loss_max_abs_diff=loss_diff,
                       param_max_abs_diff=param_diff,
                       bitwise=loss_diff == 0 and param_diff == 0)
            print(f"resume: steps {spe + 1}-{2 * spe} losses "
                  f"{[round(x, 4) for x in got]}; "
                  f"against the uninterrupted run: largest loss difference "
                  f"{loss_diff:.3g}, largest param difference "
                  f"{param_diff:.3g} (bitwise: {out['bitwise']})", flush=True)
            # every op on this path is deterministic (same kernels, inputs
            # and order), so anything short of bitwise is a resume fault
            if not out["bitwise"]:
                raise AssertionError(
                    f"resume: not bitwise: losses differ by {loss_diff}, "
                    f"params by {param_diff}")
            # the async snapshot of the last step against the state it holds
            if ckpt.latest_step(str(ck)) != 2 * spe:
                raise AssertionError(f"resume: newest snapshot "
                                     f"{ckpt.latest_step(str(ck))}, expected "
                                     f"{2 * spe}")
            sync()
            t0 = time.perf_counter()
            restored = ckpt.restore(str(ck), second.state)
            sync()
            out["restore_again_s"] = time.perf_counter() - t0
            mismatched = [i for i, (a, b) in enumerate(zip(
                ckpt.flatten(restored), ckpt.flatten(second.state)))
                if not (torch.equal(a[1], b[1])
                        if isinstance(a[1], torch.Tensor) else a[1] == b[1])]
            if mismatched:
                raise AssertionError(f"resume: the async snapshot differs "
                                     f"from the state at step {2 * spe} in "
                                     f"leaves {mismatched[:8]}")
            out["async_snapshot_bytes"] = snapshot_bytes(
                ck / f"ckpt-{2 * spe}")
            del restored, second
            model, params = reference
            for temperature, (t0, proc) in procs.items():
                stdout, stderr = proc.communicate(timeout=600)
                out[f"generate_s_t{temperature}"] = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise AssertionError(f"--generate: rc {proc.returncode}\n"
                                         f"{stdout[-2000:]}\n{stderr[-2000:]}")
                cli_ids = [int(t) for t in
                           stdout.strip().splitlines()[-1].split(",")]
                ids = generate(
                    model, params, [PROMPT], 32, temperature=temperature,
                    generator=torch.Generator(device).manual_seed(7),
                    device=device)[0].tolist()
                print(f"generate (temperature {temperature}): --generate "
                      f"printed {cli_ids[len(PROMPT):]}; in-process "
                      f"{ids[len(PROMPT):]}", flush=True)
                if cli_ids != ids or len(ids) != len(PROMPT) + 32:
                    raise AssertionError(
                        f"--generate's ids (temperature {temperature}) differ "
                        "from the in-process generate()'s")
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    print(f"resume: snapshot {out['snapshot_bytes']:,} bytes (params + Adam "
          f"mu and nu: {out['expected_bytes']:,}); save {save_s:.2f} s, "
          f"resume restore "
          f"{out['restore_s']:.2f} s, second restore "
          f"{out['restore_again_s']:.2f} s, async save's host copy "
          f"{out['async_save_host_s']:.2f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: multi-step dispatch (--steps_per_dispatch) as CUDA-graph replay
# ---------------------------------------------------------------------------

DISPATCH_K = 13   # one dispatch per epoch of the 219M LM's 13 steps
# the depth phases 17 (c) and 19 (b)-(d) cut phase 7's job to (full
# width): their checks hold runs to a reference of the same depth, and
# their cost is processes, snapshots and restores, which the depth sets
CUT_LAYERS = 2
# the host's launch APIs counted per step under the profiler
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
               "cudaMemcpyAsync", "cudaMemsetAsync")


def launch_profile(torch, run, n_steps):
    """``run()`` (``n_steps`` train steps) under ``torch.profiler``: the
    host's launch API calls per step by name, the wall ms per step, and
    the device time the profiler recorded (a lower bound: it can drop
    launches, see ``kernel_launch_ms``), with the flash kernels it
    recorded per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    apis, device_us, flash = {}, 0.0, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            device_us += ev.device_time_total
            flash += "flash_" in ev.name
        elif ev.name in LAUNCH_APIS:
            apis[ev.name] = apis.get(ev.name, 0) + 1
    return dict(launches_per_step={k: v / n_steps for k, v in apis.items()},
                launch_calls_per_step=sum(apis.values()) / n_steps,
                wall_ms_per_step=wall_ms / n_steps,
                profiled_device_ms_per_step=device_us / 1e3 / n_steps,
                profiled_flash_kernels_per_step=flash / n_steps)


@__import__("contextlib").contextmanager
def eager_init(torch, init):
    """Trainers built inside start from ``init`` (a host copy of the
    eager run's seeded init, the same seed and layout: the same values)
    instead of drawing it again on the host, which takes ~10 s for the
    924.5M-param MoE LM; ``None``: they draw it."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        tree_map,
    )

    draw = Trainer._global_init
    if init is not None:
        Trainer._global_init = lambda self: tree_map(
            lambda t: t.to(self.device, copy=True), init)
    try:
        yield
    finally:
        Trainer._global_init = draw


def dispatch_full_width(torch, np, device, eager, seq_group=None,
                        k=DISPATCH_K, exact=False, tag=None, inspect=None,
                        profile=True, tensor_group=None, fsdp_group=None,
                        expert_group=None, **over):
    """Phase 7's job (phase 11's with ``seq_group``) with
    ``--steps_per_dispatch k`` through the Trainer: on the card each
    dispatch replays the train step's CUDA graph.  Its losses at the
    dispatch ends and its final params against ``eager`` (that phase's
    run, the same seed, data and steps), bitwise or within phase 8's f32
    tolerance; the flash launches by design (the warm-up's, counted by
    the wrappers, plus replays x the launches captured in the graph)
    equal to 12 x ring blocks x steps; step ms (one CUDA event per
    dispatch), tokens/s, MFU and peak memory against the eager run's;
    the host's launch calls per step of one more dispatch and of 3 eager
    steps under the profiler; and the device time of one replay (events,
    the host held back by a GPU sleep) over the loop's step time: the
    device's busy share."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
        qmm,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    one_rank_group(torch, device)
    with tempfile.TemporaryDirectory() as tmp:
        metrics = f"{tmp}/metrics.jsonl"
        cfg = config_from_args(build_argparser().parse_args(train_flags(
            metrics_jsonl=metrics, steps_per_dispatch=k, **over)))
        before = memory_before(torch, device)
        with eager_init(torch, eager.get("init_params")):
            trainer = Trainer(cfg, device=device, seq_group=seq_group,
                              tensor_group=tensor_group,
                              fsdp_group=fsdp_group,
                              expert_group=expert_group)
            trainer.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        fa.set_launch_counts()
        qmm.library_gemm.launches.update(int8=0, fp8=0)
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        counts = fa.launch_counts()
        gemms = dict(qmm.library_gemm.launches)
        # compared on the card, leaf by leaf, with the eager run's host copy
        final = [p.detach() for p in flat_params(trainer.state.params)]
        inspected = inspect(trainer) if inspect is not None else {}
        with open(metrics) as f:
            losses = {r["step"]: r["loss"] for r in map(json.loads, f)
                      if "loss" in r}
    graphed = trainer.multi_step
    m, steps = cfg.model, result["steps"]
    tag = tag or ("dispatch" if seq_group is None
                  else f"dispatch {m.attention}")
    ends = list(range(k, steps + 1, k))
    if sorted(losses) != ends or steps != len(eager["losses"]):
        raise AssertionError(f"{tag}: losses logged at {sorted(losses)}, "
                             f"expected the dispatch ends {ends}; {steps} "
                             f"steps")
    loss_diff = max(abs(losses[s] - eager["losses"][s - 1]) for s in ends)
    loss_rel = max(abs(losses[s] - eager["losses"][s - 1])
                   / abs(eager["losses"][s - 1]) for s in ends)
    pairs = [(a, b.to(a.device)) for a, b in zip(final,
                                                   eager["final_params"])]
    param_diff = max(float((a - b).abs().max()) for a, b in pairs)
    bitwise = loss_diff == 0 and param_diff == 0
    # phase 8's f32 tolerance, the bar should graph and eager not be equal
    within = bitwise or (loss_rel <= 1e-5 and all(
        bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs()).all())
        for a, b in pairs))
    del pairs, final
    print(f"{tag}: k {k}, {steps} steps, losses at the dispatch ends "
          f"{[round(losses[s], 4) for s in ends]}; against the eager run: "
          f"largest loss difference {loss_diff:.3g} ({loss_rel:.3g} "
          f"relative), largest param difference {param_diff:.3g} "
          f"(bitwise: {bitwise})", flush=True)
    if not (bitwise or within) or (exact and not bitwise):
        raise AssertionError(f"{tag}: the graphed run differs from the "
                             "eager one: " + ("not bitwise" if exact else
                                              "beyond phase 8's f32 "
                                              "tolerance"))
    # flash launches by design: eager (warm-up) + replays x captured
    s_n = 1 if seq_group is None else seq_group.size
    t_n = 1 if tensor_group is None else tensor_group.size
    expect = (m.n_layers * ring_blocks(m.attention, s_n, t_n) * steps
              * microbatches(cfg))
    want = dict.fromkeys(fa.COUNTERS, expect)
    want["fwd"] = expect * fwd_launches_per_layer(m)
    per_replay = graphed.launches_per_replay
    total = {w: counts["all"][w] + graphed.replays * per_replay["all"][w]
             for w in fa.COUNTERS}
    with_lse = counts["with_lse"] + graphed.replays * per_replay["with_lse"]
    print(f"{tag}: {graphed.eager_steps} eager step(s) (the warm-up), "
          f"{graphed.replays} replays; flash launches by design: eager "
          f"{counts['all']} + {graphed.replays} x {per_replay['all']} "
          f"captured = {total} (expected {want})"
          + (f"; with_lse {with_lse}" if seq_group is not None else ""),
          flush=True)
    if total != want or (seq_group is not None and with_lse != expect):
        raise AssertionError(f"{tag}: flash launches {total}, with_lse "
                             f"{with_lse}, expected {want}")
    # the loop's numbers: every dispatch after the first (warm-up, capture);
    # a run of one dispatch: the device time of one replay (10 timed, the
    # host held back)
    step_ms = sorted(result["step_ms"][k:])
    if step_ms:
        med, med_from = step_ms[len(step_ms) // 2], "loop"
    else:
        med, med_from = time_ms(torch, graphed.graph.replay, 10), "replay"
    tokens = cfg.batch_size * cfg.data.seq_len
    flops = 3.0 * trainer.model.fwd_flops((cfg.batch_size, cfg.data.seq_len))
    # the quantized products: eager (warm-up) + replays x captured
    gemm_total = {f: gemms[f] + graphed.replays * per_replay["gemm"][f]
                  for f in gemms}
    out = dict(k=k, steps=steps, bitwise=bitwise, loss_max_abs_diff=loss_diff,
               param_max_abs_diff=param_diff, launches=total,
               gemm_launches=gemm_total,
               with_lse_launches=with_lse,
               launches_per_replay=per_replay, replays=graphed.replays,
               eager_steps=graphed.eager_steps, step_ms_median=med,
               step_ms_from=med_from,
               first_dispatch_ms_per_step=result["step_ms"][0],
               tokens_per_s=tokens / med * 1e3,
               mfu=flops / (med / 1e3 * PEAK_FLOPS["torch.bfloat16"]),
               peak_memory_gib=(result["peak_memory_bytes"] - before)
               / 2 ** 30, memory_before_gib=before / 2 ** 30,
               eager_step_ms_median=eager["step_ms_median"],
               eager_peak_memory_gib=eager["peak_memory_gib"], fit_s=fit_s,
               **inspected)
    if not profile:
        print(f"{tag}: step {med:.2f} ms graphed vs "
              f"{eager['step_ms_median']:.2f} ms eager, "
              f"{out['tokens_per_s']:.0f} tokens/s, MFU "
              f"{100 * out['mfu']:.1f}%, peak memory "
              f"{out['peak_memory_gib']:.2f} GiB graphed vs "
              f"{eager['peak_memory_gib']:.2f} GiB eager", flush=True)
        print(f"{tag}: " + json.dumps(out), flush=True)
        del trainer, graphed
        torch.cuda.empty_cache()
        return out

    # the host's launches per step: one more dispatch, and 3 eager steps
    groups = trainer.loader.epoch_groups(0, k)
    group = next(groups)[0]
    groups.close()

    def dispatch():
        trainer.state, _ = graphed(trainer.state, group)

    def eager_steps():
        for b in group[:3]:
            trainer.state, _ = trainer.train_step(trainer.state, b)

    out["profile_graphed"] = launch_profile(torch, dispatch, len(group))
    out["profile_eager"] = launch_profile(torch, eager_steps, 3)
    # device time of one replay, the host held back: the busy share
    replay_ms = time_ms(torch, graphed.graph.replay, 10)
    out.update(replay_device_ms=replay_ms, busy_share=replay_ms / med)
    pg, pe = out["profile_graphed"], out["profile_eager"]
    print(f"{tag}: step {med:.2f} ms graphed vs {eager['step_ms_median']:.2f}"
          f" ms eager (first dispatch {result['step_ms'][0]:.2f} ms/step: "
          f"warm-up and capture), {out['tokens_per_s']:.0f} tokens/s, MFU "
          f"{100 * out['mfu']:.1f}%, peak memory "
          f"{out['peak_memory_gib']:.2f} GiB graphed vs "
          f"{eager['peak_memory_gib']:.2f} GiB eager; device time of one "
          f"replay {replay_ms:.2f} ms: busy {100 * out['busy_share']:.1f}% "
          f"of the step", flush=True)
    print(f"{tag}: host launch calls per step: graphed "
          f"{pg['launch_calls_per_step']:.1f} {pg['launches_per_step']}, "
          f"eager {pe['launch_calls_per_step']:.1f} "
          f"{pe['launches_per_step']}; under the profiler: wall "
          f"{pg['wall_ms_per_step']:.2f} vs {pe['wall_ms_per_step']:.2f} "
          f"ms/step, recorded device time {pg['profiled_device_ms_per_step']:.2f}"
          f" vs {pe['profiled_device_ms_per_step']:.2f} ms/step, flash "
          f"kernels recorded {pg['profiled_flash_kernels_per_step']:.1f} vs "
          f"{pe['profiled_flash_kernels_per_step']:.1f} per step", flush=True)
    print(f"{tag}: " + json.dumps(out), flush=True)
    del trainer, graphed, group
    torch.cuda.empty_cache()
    return out


def dispatch_identity(torch, np, device, n_layers=2, steps=3, batch=8,
                      **over):
    """f32, TF32 off (phase 8 set it), flash attention at full width and
    ``n_layers`` layers: ``steps`` SGD-momentum steps eagerly and through
    ``GraphedTrainStep`` (one dispatch per step: the warm-up, then
    replays) from the same params and batches; bitwise, or losses to rtol
    1e-5 and params within 1e-5 + 1e-4 |p| (phase 8's bars)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.datasets import (  # noqa: E501
        text_dataset,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (  # noqa: E501
        ShardedLoader,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        data_parallel as dp,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        world_setup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(BIG, n_layers=n_layers, activation="gelu",
              pos_encoding="learned", ce_chunk=256, attention="flash")
    kw.update(over)
    data = text_dataset(TEXT_FILE, kw["max_seq_len"], kw["vocab_size"])
    world = world_setup(device)
    model = Transformer(TransformerConfig(**kw), device=device)
    params = model.init(torch.Generator().manual_seed(SEED + 2))
    batches = [b for _, b in zip(range(steps), ShardedLoader(
        data, batch, device=device, shuffle=False).epoch(0))]
    runs = {}
    for mode in ("eager", "graph"):
        opt = optim.sgd(1e-2, 0.9, steps=len(batches))
        state = TrainState.from_params(_clone_tree(torch, params), opt)
        step = dp.make_train_step(model, opt, world,
                                  loss_name="cross_entropy")
        run = (step if mode == "eager"
               else dp.GraphedTrainStep(step, device))
        losses = []
        for b in batches:
            state, loss = run(state, b if mode == "eager" else [b])
            losses.append(float(loss))
        runs[mode] = (losses, [p.detach().clone()
                               for p in leaves(state.params)])
        del run, state
    (le, pe), (lg, pg) = runs["eager"], runs["graph"]
    worst = max(float((a - b).abs().max()) for a, b in zip(pg, pe))
    bitwise = le == lg and worst == 0
    ok = bitwise or (
        all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(lg, le))
        and all(bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs()).all())
                for a, b in zip(pg, pe)))
    print(f"dispatch f32 identity ({n_layers} layers, {steps} SGD steps): "
          f"losses graph {lg} eager {le}; params max |diff| {worst:.3e} "
          f"(bitwise: {bitwise})", flush=True)
    if not ok:
        raise AssertionError("f32 training through the CUDA graph differs "
                             "from the eager steps")
    return dict(bitwise=bitwise, param_max_abs_diff=worst)


# ---------------------------------------------------------------------------
# phase 17: the auto row, --remat, --scan-layers, update sharding and
# master weights on phase 7's job
# ---------------------------------------------------------------------------

# the auto measurement: the flagship geometry (16 heads of 64), causal,
# B x T = 8192 tokens, in each compute dtype the flash kernels take (bf16
# on the sm90 kernels, f32 on the simt ones).  Dense training at T 8192
# would keep 12 layers x 6 bytes (bf16; 4 in f32) x B x H x T^2 = 77 GiB
# of scores and probabilities for the backward, more than the card holds
# beside the rest: the full step is measured up to T 4096 (38.6 GiB of
# them in bf16)
AUTO_TOKENS = 8192
# the full step's model: phase 7's cut to 4 layers (full width), so the
# 160 steps of the two dtypes' sweeps fit the script's time limit
AUTO_LAYERS = 4
AUTO_OP_T = (256, 512, 1024, 2048, 4096, 8192)
AUTO_STEP_T = (256, 512, 1024, 2048, 4096)
# a row that disagrees with the measurement only where the two full steps
# are within this share of each other is a tie, not a stale row
AUTO_TIE = 0.05


def auto_op_ms(torch, device, dtype, op_t):
    """Dense against flash, forward + backward of the op alone (CUDA
    events, the host held back), at each T of ``op_t``."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        sequence as sq,
    )

    impls = {"dense": lambda q, k, v: sq.attention_reference(q, k, v, True),
             "flash": lambda q, k, v: fa.flash_attention(q, k, v, True)}
    op = {}
    for t in op_t:
        b = AUTO_TOKENS // t
        g = torch.Generator(device="cpu").manual_seed(SEED + t)
        q, k, v, dout = [torch.randn((b, t, 16, 64), generator=g).to(
            device, dtype) for _ in range(4)]
        for x in (q, k, v):
            x.requires_grad_()
        op[t] = {}
        for name, fn in impls.items():
            def fwd_bwd(fn=fn):
                torch.autograd.grad(fn(q, k, v), (q, k, v), dout)
            op[t][name] = time_ms(torch, fwd_bwd, 5)
        del q, k, v, dout
        torch.cuda.empty_cache()
    return op


def auto_step_ms(torch, device, kw, step_t, steps):
    """Dense against flash in the full train step of phase 7's model
    (``kw``), at each T of ``step_t``: ``max_seq_len`` = T (the positions
    are learned), Adam, the median of ``steps`` steps after 2, one event
    after each step as phase 7 times them.  ``base``: the same step with
    no layers (embedding, head, loss, Adam), what the layers' time sits
    on."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        data_parallel as dp,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        world_setup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )

    world = world_setup(device)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    params0 = Transformer(TransformerConfig(
        **dict(kw, max_seq_len=max(step_t))), device=device).init(gen)
    step_ms = {}
    for t in step_t:
        b = AUTO_TOKENS // t
        g = torch.Generator(device="cpu").manual_seed(SEED + t)
        ids = torch.randint(0, kw["vocab_size"], (b, t + 1),
                            generator=g).to(device)
        batch = {"x": ids[:, :-1], "y": ids[:, 1:]}
        step_ms[t] = {}
        for name in ("dense", "flash", "base"):
            layers = 0 if name == "base" else kw["n_layers"]
            model = Transformer(TransformerConfig(
                **dict(kw, max_seq_len=t, n_layers=layers),
                attention="dense" if name == "base" else name),
                device=device)
            params = dict(params0, pos={"table": params0["pos"]["table"][:t]},
                          blocks=params0["blocks"][:layers])
            opt = optim.adam(1e-4, steps=steps + 2)
            state = TrainState.from_params(params, opt)
            step = dp.make_train_step(model, opt, world,
                                      loss_name="cross_entropy")
            events = []
            for i in range(steps + 2):
                state, loss = step(state, batch)
                if i >= 1:
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
            events[-1].synchronize()
            if not math.isfinite(float(loss)):
                raise AssertionError(f"auto: {name} at T {t}: loss {loss}")
            ms = sorted(a.elapsed_time(z) for a, z in zip(events, events[1:]))
            step_ms[t][name] = ms[len(ms) // 2]
            del state, opt, step, model, params
            torch.cuda.empty_cache()
    del params0, batch, ids
    torch.cuda.empty_cache()
    return step_ms


def measure_auto(torch, np, device, op_t=AUTO_OP_T, step_t=AUTO_STEP_T,
                 steps=6, **over):
    """Phase 17a, in bf16 and in f32: dense attention (the port's plain
    path, f32 scores) against flash (B1 forward; delta, B2 and B3
    backward), as forward + backward of the op alone and as the full train
    step of phase 7's model (:func:`auto_op_ms`, :func:`auto_step_ms`).
    A dtype's row is the smallest T from which flash is no slower in the
    full step at that T and every longer one (None: at no T).  The phase
    fails when the port's ``AUTO_FLASH_MIN_SEQ`` row disagrees with the
    measurement at a T where the two steps, carried to phase 7's full
    depth, are further apart than ``AUTO_TIE``: each step's time above
    the no-layer ``base`` is the layers', scaled by ``BIG["n_layers"] /
    AUTO_LAYERS``, so the cut depth dilutes no gap.  Then ``attention="auto"`` through the model: flash
    launches at a row and not just under it, nor at any T for a dtype
    without a row."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        sequence as sq,
    )

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        kw = dict(BIG, activation="gelu", pos_encoding="learned",
                  ce_chunk=256, compute_dtype=dtype, n_layers=AUTO_LAYERS)
        kw.update(over)
        op = auto_op_ms(torch, device, dtype, op_t)
        print(f"auto op {name} (fwd+bwd ms, 16 heads of 64, B x T = "
              f"8192): " + "; ".join(
                  f"T {t}: dense {r['dense']:.3f} flash {r['flash']:.3f}"
                  for t, r in op.items()), flush=True)
        step_ms = auto_step_ms(torch, device, kw, step_t, steps)
        depth = BIG["n_layers"] / kw["n_layers"]
        full = {t: {k: r["base"] + (r[k] - r["base"]) * depth
                    for k in ("dense", "flash")}
                for t, r in step_ms.items()}
        print(f"auto step {name} (ms, phase 7's model at "
              f"{kw['n_layers']} layers, B x T = 8192, Adam; no layers; "
              f"carried to {BIG['n_layers']} layers): " + "; ".join(
                  f"T {t}: dense {r['dense']:.2f} flash {r['flash']:.2f} "
                  f"base {r['base']:.2f} ({full[t]['dense']:.2f} / "
                  f"{full[t]['flash']:.2f})"
                  for t, r in step_ms.items()), flush=True)
        row = None
        for t in sorted(step_ms, reverse=True):
            if step_ms[t]["flash"] > step_ms[t]["dense"]:
                break
            row = t
        shipped = sq.AUTO_FLASH_MIN_SEQ.get(("cuda", dtype))
        # the shipped row's pick at each T, and how much slower it is
        stale = {}
        for t, r in full.items():
            pick = "flash" if shipped is not None and t >= shipped \
                else "dense"
            other = "dense" if pick == "flash" else "flash"
            if r[pick] > (1 + AUTO_TIE) * r[other]:
                stale[t] = r[pick] / r[other]
        print(f"auto row {name}: measured {row} (flash no slower in the "
              f"full step from there on), the port's "
              f"AUTO_FLASH_MIN_SEQ[('cuda', {name})] {shipped}; the "
              f"shipped pick slower by more than {AUTO_TIE:.0%} at "
              f"{ {t: round(x, 3) for t, x in stale.items()} }", flush=True)
        if stale:
            raise AssertionError(
                f"auto: the {name} row {shipped} is stale: measured {row}, "
                f"the shipped pick slower at {sorted(stale)}")
        # the consult point on the card: auto at the row and under it (no
        # row: at the longest T measured)
        ts = (shipped, shipped // 2) if shipped else (max(step_t),)
        routed = {}
        for t in ts:
            model = Transformer(TransformerConfig(**dict(
                kw, max_seq_len=t, n_layers=2), attention="auto"),
                device=device)
            params = model.init(torch.Generator().manual_seed(SEED))
            ids = torch.zeros((1, t), dtype=torch.long, device=device)
            fa.set_launch_counts()
            with torch.no_grad():
                model.forward(params, ids)
            routed[t] = fa.launch_counts()["all"]["fwd"]
            del model, params, ids
        torch.cuda.empty_cache()
        want = {t: 2 if shipped and t >= shipped else 0 for t in ts}
        print(f"auto {name} through the model (2 layers): flash forward "
              f"launches by T {routed} (expected {want})", flush=True)
        if routed != want:
            raise AssertionError(f"auto {name} routed {routed}, expected "
                                 f"{want}")
        out[name] = dict(op_ms=op, step_ms=step_ms, full_depth_ms=full,
                         measured_row=row, shipped_row=shipped)
    return out


def against(torch, tag, run, ref, exact=False, ref_name="phase 7"):
    """``run``'s losses and final params against ``ref``'s (phase 7's, or
    ``ref_name``'s): bitwise, or within phase 8's f32 tolerance
    (``exact``: bitwise only); prints which."""
    loss_diff = max(abs(a - b) for a, b in zip(run["losses"], ref["losses"]))
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(run["losses"], ref["losses"]))
    pairs = list(zip(run["final_params"], ref["final_params"]))
    param_diff = max(float((a.float() - b.float()).abs().max())
                     for a, b in pairs)
    bitwise = loss_diff == 0 and param_diff == 0
    within = loss_rel <= 1e-5 and all(
        bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs()).all())
        for a, b in pairs)
    print(f"{tag} against {ref_name}: largest loss difference "
          f"{loss_diff:.3g} "
          f"({loss_rel:.3g} relative), largest param difference "
          f"{param_diff:.3g}: " + ("bitwise" if bitwise else
                                  "within phase 8's f32 tolerance" if within
                                  else "DIFFERENT"), flush=True)
    if len(pairs) != len(ref["final_params"]) or not (
            bitwise or (within and not exact)):
        raise AssertionError(f"{tag} differs from {ref_name}'s run"
                             + (" (bitwise required)" if exact else ""))
    return dict(bitwise=bitwise, loss_max_abs_diff=loss_diff,
                param_max_abs_diff=param_diff)


def master_check(trainer):
    """Every param equals the bf16 cast of its f32 master, bitwise."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    ps = leaves(trainer.state.params)
    ms = leaves(trainer.state.opt_state.master)
    equal = len(ps) == len(ms) and all(
        str(p.dtype) == "torch.bfloat16" and p.equal(m.to(p.dtype))
        for p, m in zip(ps, ms))
    if not equal:
        raise AssertionError("master weights: a param differs from the "
                             "bf16 cast of its master")
    return dict(params_equal_bf16_master=equal,
                param_dtype=str(ps[0].dtype).replace("torch.", ""),
                master_dtype=str(ms[0].dtype).replace("torch.", ""))


def start_scan_generate(ck, **over):
    """``--generate`` (greedy, 32 tokens) from a ``--scan-layers``
    snapshot as a subprocess, started here to run beside other work."""
    flags = train_flags(checkpoint_dir=ck, **over)
    return subprocess.Popen([sys.executable, "-m", PKG, *flags,
                             "--generate", ",".join(map(str, PROMPT)),
                             "--max_new_tokens", "32", "--temperature", "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(REPO_ROOT))


def scan_generate(torch, device, ck, proc, **over):
    """:func:`start_scan_generate`'s process against the in-process
    ``generate()`` over the restored stacked tree."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate import (  # noqa: E501
        generate,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.registry import (  # noqa: E501
        build_model,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        checkpoint as ckpt,
    )

    flags = train_flags(checkpoint_dir=ck, **over)
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"--generate (scan_layers): rc "
                             f"{proc.returncode}\n{stdout[-2000:]}\n"
                             f"{stderr[-2000:]}")
    cli_ids = [int(t) for t in stdout.strip().splitlines()[-1].split(",")]
    model = build_model(config_from_args(
        build_argparser().parse_args(flags)).model, device=device)
    _, params = ckpt.restore_params(ck, model.init(
        torch.Generator().manual_seed(SEED)))
    if not isinstance(params["blocks"], dict):
        raise AssertionError("scan_layers: the restored blocks are not "
                             "stacked")
    ids = generate(model, params, [PROMPT], 32, temperature=0.0,
                   device=device)[0].tolist()
    print(f"scan_layers generate (greedy): --generate printed "
          f"{cli_ids[len(PROMPT):]}; in-process {ids[len(PROMPT):]}",
          flush=True)
    if cli_ids != ids or len(ids) != len(PROMPT) + 32:
        raise AssertionError("--generate from a scan_layers snapshot "
                             "differs from generate()")
    return dict(greedy_equal=True)


def remat_scan_identity(torch, np, device, n_layers=2, steps=3, batch=8,
                        seq_size=4, **over):
    """f32, TF32 off, ``n_layers`` layers: 3 SGD steps with remat +
    scan_layers and striped_flash over ``LocalSeqGroup(seq_size)``
    against plain flash without either: losses to rtol 1e-5 and params
    within 1e-6 (phase 12's bars)."""
    lf, pf = sgd_runs(torch, device, ("flash",), n_layers, steps, batch,
                      **over)["flash"]
    ls, ps = sgd_runs(torch, device, ("striped_flash",), n_layers, steps,
                      batch, seq_size=seq_size, remat=True,
                      scan_layers=True, **over)["striped_flash"]
    loss_ok = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(ls, lf))
    worst = max(float((a - b).abs().max()) for a, b in zip(ps, pf))
    print(f"remat + scan_layers striped_flash over {seq_size} shards "
          f"({n_layers} layers, {steps} steps, f32): losses {ls} vs flash "
          f"{lf}; params max |diff| {worst:.3e}", flush=True)
    if not (loss_ok and worst <= 1e-6 and len(ps) == len(pf)):
        raise AssertionError("remat + scan_layers with striped_flash "
                             "differs from flash")
    return dict(param_max_abs_diff=worst)


def slice_full_width(torch, np, device, short, **over):
    """Phase 17 (b)-(f) on phase 7's job cut to ``CUT_LAYERS`` layers at
    full width (``over``: its flags changed, as a CPU rehearsal shrinks
    it); ``short`` is that job's eager run (its losses and final params),
    which every run here is held against.  The graphed runs need the
    card."""
    import tempfile

    cuda = device.type == "cuda"
    keep = ("step_ms_median", "peak_memory_gib", "memory_before_gib", "mfu",
            "tokens_per_s", "launches", "first_loss", "last3_loss")
    cut = dict(over, n_layers=CUT_LAYERS)
    ref = f"the {CUT_LAYERS}-layer run"

    def train(tag, **flags):
        run = train_full_width(torch, np, device, keep_final=True,
                               profile=False, tag=tag, **cut, **flags)
        numbers = {k: run[k] for k in keep if k in run}
        if cuda:
            print(f"{tag}: step {run['step_ms_median']:.2f} ms vs "
                  f"{short['step_ms_median']:.2f} ms, peak memory "
                  f"{run['peak_memory_gib']:.2f} GiB vs "
                  f"{short['peak_memory_gib']:.2f} GiB ({ref}); flash "
                  f"launches {run['launches']}", flush=True)
        return run, numbers

    out = {}
    # (b) remat: the forward kernel runs again in the backward; each
    # policy (dots and dots_no_batch: a selective-checkpoint dispatch
    # mode) also captured in the step's CUDA graph
    for policy in ("full", "dots", "dots_no_batch"):
        run, out[f"remat_{policy}"] = train(f"remat {policy}", remat=True,
                                            remat_policy=policy)
        out[f"remat_{policy}"].update(
            against(torch, f"remat {policy}", run, short, ref_name=ref))
        if cuda:
            graphed = dispatch_full_width(
                torch, np, device, run, exact=True, profile=False,
                tag=f"remat {policy} dispatch", remat=True,
                remat_policy=policy, **cut)
            out[f"remat_{policy}"].update(
                graphed_step_ms_median=graphed["step_ms_median"],
                graphed_peak_memory_gib=graphed["peak_memory_gib"],
                graphed_bitwise=graphed["bitwise"])
        del run
    # (c) scan_layers, then --generate from its snapshot: the process
    # runs beside (d)-(f)
    scan = dict(cut, **{"scan-layers": True})
    with tempfile.TemporaryDirectory() as ck:
        run, out["scan_layers"] = train("scan_layers", checkpoint_dir=ck,
                                        **{"scan-layers": True})
        out["scan_layers"].update(against(torch, "scan_layers", run, short,
                                          ref_name=ref))
        del run
        proc = start_scan_generate(ck, **scan)
        try:
            # (d) the sharded updates: N = 1 shards nothing, so bitwise
            for how in ("sharded", "zero1"):
                run, out[f"update_sharding_{how}"] = train(
                    f"update_sharding {how}", update_sharding=how)
                out[f"update_sharding_{how}"].update(against(
                    torch, f"update_sharding {how}", run, short, exact=True,
                    ref_name=ref))
                del run
            # (e) bf16 params, the f32 master in the sharded state; eager,
            # graphed
            flags = dict(param_dtype="bfloat16", update_sharding="sharded",
                         **{"master-weights": True})
            run, out["master_weights"] = train("master weights",
                                               inspect=master_check, **flags)
            if cuda:
                graphed = dispatch_full_width(
                    torch, np, device, run, profile=False,
                    tag="master weights dispatch", inspect=master_check,
                    **cut, **flags)
                out["master_weights"].update(
                    graphed_step_ms_median=graphed["step_ms_median"],
                    graphed_peak_memory_gib=graphed["peak_memory_gib"],
                    graphed_bitwise=graphed["bitwise"])
            del run
            # (f) the f32 identity of remat + scan_layers on the striped
            # ring
            out["identity"] = remat_scan_identity(torch, np, device)
            out["scan_layers"].update(scan_generate(torch, device, ck, proc,
                                                    **scan))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print("slice: " + json.dumps(out), flush=True)
    return out

# ---------------------------------------------------------------------------
# phase 18: quantized compute (--matmul_dtype int8|fp8, --quantize int8)
# ---------------------------------------------------------------------------

# phase 7's projections at its 8192 rows (batch 8 x T 1024), (in, out):
# qkv, ff_in, ff_out and the head
QMM_ROWS = 8192
QMM_SHAPES = ((1024, 3072), (1024, 4096), (4096, 1024), (1024, 32768))
# the dense int8 and fp8 tensor-core peaks (NVIDIA H100 SXM data sheet)
PEAK_QUANT = 1979e12
# the library fp8 product against the plain f32 product of the same
# codes: the H100's fp8 tensor cores add products in an accumulator
# narrower than f32 (about 14 mantissa bits), which cuBLAS promotes to
# f32 at intervals of its choosing (use_fast_accum=False); measured up to
# 2.5e-4 of an element's products' absolute sum at contractions of 256
# to 8192 on an H100 80GB HBM3 at 700 W.  Bound: 4x that reading
FP8_ACCUM_TOL = 1e-3
# the 2-layer job on the card against the host: the unquantized ops sum
# in another order (fp8: the tensor cores' accumulator too), and a value
# that lands on the far side of a rounding boundary moves its code one
# step.  Losses relative, per format, and the params' change (p - p0) in
# relative L2 norm, per format; on an H100 80GB HBM3 at 700 W the card
# read 8.6e-6 / 1.5e-4 in the losses and 2.5e-3 / 1.1e-2 in the change
# (int8 / fp8), and the host's unquantized run against its quantized
# one (the control, measured in every run and required to exceed the
# change's bound) 5.1e-5 / 3.1e-4 and 1.4e-2 / 2.9e-2
QTRAIN_LOSS_RTOL = {"int8": 1e-4, "fp8": 5e-4}
QTRAIN_UPDATE_RL2 = {"int8": 1e-2, "fp8": 2e-2}


def _qmm_operands(torch, qmm, fmt, x, w, dy):
    """The three products of one quantized Linear (forward, dx, dw) as
    ``qdot``'s autograd functions form them: {name: (a, b, scale_a,
    scale_b)}, the scales the quantization scales (None for int8)."""
    if fmt == "int8":
        qx, _ = qmm._q8_rowwise(x)
        qw, _ = qmm._q8_colwise(w)
        qdy, _ = qmm._q8_rowwise(dy)
        qwr, _ = qmm._q8_rowwise(w)
        qxc, _ = qmm._q8_colwise(x)
        qdyc, _ = qmm._q8_colwise(dy)
        return {"fwd": (qx, qw, None, None), "dx": (qdy, qwr.t(), None, None),
                "dw": (qxc.t(), qdyc, None, None)}
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    qx, sx = qmm._cast_fp8(x, qmm.tensor_amax(x), qmm.E4M3_MAX, e4)
    qw, sw = qmm._cast_fp8(w, qmm.tensor_amax(w), qmm.E4M3_MAX, e4)
    qdy, sdy = qmm._cast_fp8(dy, qmm.tensor_amax(dy), qmm.E5M2_MAX, e5)
    return {"fwd": (qx, qw, sx, sw), "dx": (qdy, qw.t(), sdy, sw),
            "dw": (qx.t(), qdy, sx, sdy)}


def _library(qmm, torch, a, b, sa, sb):
    if sa is None:
        return qmm.library_gemm(a, b)
    return qmm.library_gemm(a, b, torch.reciprocal(sa), torch.reciprocal(sb))


def check_qmm(torch, device, rows=QMM_ROWS, shapes=QMM_SHAPES,
              slice_rows=256):
    """(a) Each quantized product of each projection shape, int8 and fp8,
    forward and backward, against the plain product of the same codes on
    the card (int8: the exact integer sum, equal; fp8: within
    ``FP8_ACCUM_TOL`` of the products' absolute sum) on ``slice_rows``
    output rows; then timed (CUDA events)
    beside its bound at the int8/fp8 peak: the library product alone,
    qdot's forward and forward + backward (the quantization passes
    included), against the bf16 ``torch.matmul`` forward and forward +
    backward at the same shape."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import qmm

    cuda = device.type == "cuda"
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    out = {}
    for k, n in shapes:
        x = torch.randn(rows, k, generator=g, device=device).bfloat16()
        w = torch.randn(k, n, generator=g, device=device) * k ** -0.5
        dy = (torch.randn(rows, n, generator=g, device=device)
              * 1e-3).bfloat16().float()
        flops = 2.0 * rows * k * n
        wb = w.bfloat16()
        for fmt in ("int8", "fp8"):
            res = {}
            for which, (a, b, sa, sb) in _qmm_operands(
                    torch, qmm, fmt, x, w, dy).items():
                got = (_library(qmm, torch, a, b, sa, sb) if cuda
                       else qmm._dot_int8(a, b) if sa is None
                       else qmm._dot_fp8(a, b, sa, sb))
                ref = qmm.reference_dot(a[:slice_rows], b)
                diff = (got[:slice_rows].double() - ref.double()).abs()
                err = float(diff.max())
                if sa is None:
                    ok, rel = err == 0, 0.0
                else:
                    ref = ref / (sa * sb)
                    diff = (got[:slice_rows].double()
                            - ref.double()).abs()
                    err = float(diff.max())
                    mass = (a[:slice_rows].float().abs()
                            @ b.float().abs()) / (sa * sb)
                    rel = float((diff / mass.double().clamp_min(
                        1e-30)).max())
                    ok = rel <= FP8_ACCUM_TOL
                if not ok:
                    raise AssertionError(
                        f"qmm {fmt} {which} ({rows}, {k}) x ({k}, {n}): "
                        f"max |library - plain| {err:.3g}, {rel:.3g} of "
                        f"the products' absolute sum (tolerance "
                        f"{FP8_ACCUM_TOL:.3g})")
                m_, k_ = a.shape
                n_ = b.shape[1]
                bound = max(2.0 * m_ * k_ * n_ / PEAK_QUANT,
                            (m_ * k_ + k_ * n_ + 4 * m_ * n_)
                            / HBM_BYTES_PER_S) * 1e3
                res[which] = dict(max_abs_err=err, max_rel_to_mass=rel,
                                  bound_ms=bound)
                if cuda:
                    ms = time_ms(torch, lambda: _library(qmm, torch, a, b,
                                                         sa, sb), 10)
                    res[which].update(ms=ms, tflops=2.0 * m_ * k_ * n_
                                      / ms / 1e9)
            if cuda:
                xr = x.detach().requires_grad_()
                wr = w.detach().requires_grad_()

                def fwd():
                    return qmm.qdot(x, w, fmt=fmt)

                def fwd_bwd():
                    y = qmm.qdot(xr, wr, fmt=fmt)
                    torch.autograd.grad(y, (xr, wr), dy)

                res["qdot_fwd_ms"] = time_ms(torch, fwd, 5)
                res["qdot_fwd_bwd_ms"] = time_ms(torch, fwd_bwd, 5)
                gemm_ms = sum(res[w_]["ms"] for w_ in ("fwd", "dx", "dw"))
                # the quantize, transpose and scale passes around the
                # three products
                res["elementwise_ms"] = res["qdot_fwd_bwd_ms"] - gemm_ms
            out[f"{fmt} {k}x{n}"] = res
        if cuda:
            xb = x.detach().requires_grad_()
            wbr = wb.detach().requires_grad_()
            dyb = dy.bfloat16()

            def bf16_fwd_bwd():
                y = torch.matmul(xb, wbr)
                torch.autograd.grad(y, (xb, wbr), dyb)

            bf = dict(fwd_ms=time_ms(torch, lambda: torch.matmul(x, wb), 10),
                      fwd_bwd_ms=time_ms(torch, bf16_fwd_bwd, 5))
            bf["tflops"] = flops / bf["fwd_ms"] / 1e9
            out[f"bf16 {k}x{n}"] = bf
            line = ", ".join(
                f"{fmt} gemm fwd {out[f'{fmt} {k}x{n}']['fwd']['ms']:.3f} ms "
                f"({out[f'{fmt} {k}x{n}']['fwd']['tflops']:.0f} TFLOP/s, "
                f"bound {out[f'{fmt} {k}x{n}']['fwd']['bound_ms']:.3f}), "
                f"qdot fwd {out[f'{fmt} {k}x{n}']['qdot_fwd_ms']:.3f} / "
                f"fwd+bwd {out[f'{fmt} {k}x{n}']['qdot_fwd_bwd_ms']:.3f} ms"
                for fmt in ("int8", "fp8"))
            print(f"qmm ({rows}, {k}) x ({k}, {n}): {line}; bf16 matmul "
                  f"fwd {bf['fwd_ms']:.3f} ms ({bf['tflops']:.0f} TFLOP/s) "
                  f"/ fwd+bwd {bf['fwd_bwd_ms']:.3f} ms", flush=True)
        del x, w, dy, wb
    print("qmm products against the plain products: int8 equal, fp8 within "
          f"{FP8_ACCUM_TOL:g} of the products' absolute sum (largest share "
          "measured), "
          f"at {len(shapes)} shapes: " + ", ".join(
              f"{key} {which} {res[which]['max_rel_to_mass']:.3g}"
              for key, res in out.items() if key.startswith("fp8")
              for which in ("fwd", "dx", "dw")), flush=True)
    return out


def qdot_card_vs_host(torch, device, rows=256, k=1024, n=3072):
    """qdot forward and backward on the card against the host (the plain
    products) from the same bf16 activations, f32 weights and gradient:
    the codes of all three operands equal; int8 outputs equal bitwise
    (exact integer sums, the same scaling order), fp8 within
    ``FP8_ACCUM_TOL`` of each element's products' absolute sum."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import qmm

    g = torch.Generator().manual_seed(SEED + 6)
    x = torch.randn(rows, k, generator=g).bfloat16()
    w = torch.randn(k, n, generator=g) * k ** -0.5
    dy = (torch.randn(rows, n, generator=g) * 1e-3).bfloat16().float()
    out = {}
    for fmt in ("int8", "fp8"):
        res, codes = [], []
        for dev in (device, torch.device("cpu")):
            xr = x.to(dev).detach().requires_grad_()
            wr = w.to(dev).detach().requires_grad_()
            y = qmm.qdot(xr, wr, fmt=fmt)
            gx, gw = torch.autograd.grad(y, (xr, wr), dy.to(dev))
            res.append([t.detach().float().cpu() for t in (y, gx, gw)])
            ops = _qmm_operands(torch, qmm, fmt, x.to(dev), w.to(dev),
                                dy.to(dev))
            codes.append({name: [t.cpu() for t in v if t is not None]
                          for name, v in ops.items()})
        same_codes = all(
            torch.equal(a.view(torch.uint8) if a.element_size() == 1
                        else a, b.view(torch.uint8) if b.element_size() == 1
                        else b)
            for name in codes[0] for a, b in zip(codes[0][name],
                                                 codes[1][name]))
        errs = [float((a - b).abs().max()) for a, b in zip(*res)]
        if fmt == "int8":
            rels = [0.0, 0.0, 0.0]
            ok = not any(errs)
        else:
            rels = []
            for (a, b, sa, sb), (got, ref), half in zip(
                    codes[1].values(), zip(*res), (0.0, 2.0 ** -8, 0.0)):
                # dx comes back in x's bf16: one rounding on each side,
                # half an ulp each (2^-8 of the value in all)
                mass = (a.float().abs() @ b.float().abs()) / (sa * sb)
                rels.append(float((((got - ref).abs() - half * ref.abs())
                                   .clamp_min(0) / mass.clamp_min(1e-30))
                                  .max()))
            ok = all(r <= FP8_ACCUM_TOL for r in rels)
        print(f"qdot {fmt} card vs host ({rows}, {k}) x ({k}, {n}): codes "
              f"{'equal' if same_codes else 'DIFFERENT'}; max |diff| y "
              f"{errs[0]:.3g}, dx {errs[1]:.3g}, dw {errs[2]:.3g} "
              f"({'bitwise' if not any(errs) else 'of the absolute sums: '}"
              + ("" if not any(errs) else
                 ", ".join(f"{r:.3g}" for r in rels)) + ")", flush=True)
        if not (ok and same_codes):
            raise AssertionError(f"qdot {fmt}: the card differs from the "
                                 "host")
        out[fmt] = dict(max_abs_diff=errs, rel_to_mass=rels)
    return out


def quant_step_design(cfg):
    """Quantized products per train step by design: 3 per quantized
    Linear of the blocks (forward, dx, dw), and the head's: 3, or under
    --ce_chunk 4 per chunk (its forward runs again in the backward);
    none for a role in --quantize_skip."""
    m = cfg.model
    roles = ["qkv", "attn_out", "ff_in", "ff_out"]
    if m.ffn_activation == "swiglu":
        roles.append("ff_gate")
    per_block = sum(r not in m.matmul_skip for r in roles)
    chunks = cfg.data.seq_len // m.ce_chunk if m.ce_chunk else 0
    head = 0 if "head" in m.matmul_skip else (4 * chunks if chunks else 3)
    return 3 * per_block * m.n_layers + head


def profile_quant_step(torch, trainer, fmt, per_step=None):
    """(b) One more eager step of ``trainer`` under ``torch.profiler``:
    the quantized products it runs (``aten::_int_mm`` /
    ``aten::_scaled_mm``) must number ``quant_step_design``, no f32 or
    bf16 product (``aten::mm``, ``addmm``, ``bmm``, ``baddbmm``) may run,
    and every GEMM kernel the profiler recorded must belong to one of the
    quantized products.  Prints their kernels' names and device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q_op = {"int8": "aten::_int_mm", "fp8": "aten::_scaled_mm"}[fmt]
    plain_ops = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
    batches = trainer.loader.epoch(0)
    batch = next(batches)
    batches.close()
    trainer.state, _ = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.state, loss = trainer.train_step(trainer.state, batch)
        float(loss)
        torch.cuda.synchronize()
    n_q, n_plain, q_kernels, gemm_kernels = 0, 0, {}, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            if _kernel_class(ev.name) == "gemm":
                gemm_kernels[ev.name] = (gemm_kernels.get(ev.name, 0.0)
                                         + ev.device_time_total / 1e3)
        elif ev.name == q_op:
            n_q += 1
            for kern in getattr(ev, "kernels", None) or []:
                q_kernels[kern.name] = q_kernels.get(kern.name, 0) + 1
        elif ev.name in plain_ops:
            n_plain += 1
    want = per_step or quant_step_design(trainer.cfg)
    print(f"profile {fmt} step: {n_q} {q_op} (by design {want}), {n_plain} "
          f"f32/bf16 products; GEMM kernels recorded: " + ", ".join(
              f"{name[:80]} {ms:.2f} ms" for name, ms in sorted(
                  gemm_kernels.items(), key=lambda kv: -kv[1])[:6]),
          flush=True)
    print(f"profile {fmt} step: kernels under {q_op}: "
          + (", ".join(f"{name[:80]} x{c}" for name, c in q_kernels.items())
             or "(the profiler linked none)"), flush=True)
    if n_q != want or n_plain:
        raise AssertionError(f"{fmt} step: {n_q} quantized products "
                             f"(expected {want}), {n_plain} unquantized")
    strays = [nm for nm in gemm_kernels if q_kernels and nm not in q_kernels]
    if strays:
        raise AssertionError(f"{fmt} step: GEMM kernels outside the "
                             f"quantized products: {strays}")
    if not gemm_kernels:
        raise AssertionError(f"{fmt} step: the profiler recorded no GEMM "
                             "kernel")
    return dict(profiled_products=n_q, profiled_plain_products=n_plain,
                gemm_kernels={k: round(v, 3) for k, v in gemm_kernels.items()},
                linked_kernels=q_kernels)


def quant_train_full_width(torch, np, device, trained, **over):
    """(b)-(c) Phase 7's job (``over``: its flags changed; the script cuts
    it to phase 15's 2 layers) under --matmul_dtype int8 (ce_chunk 256)
    and fp8 (ce_chunk 0, as the trainer requires), eager (its products
    counted against the design and one step profiled) and under
    --steps_per_dispatch 13 (CUDA-graph replay, bitwise equal to eager);
    every loss finite and falling 1 nat (train_full_width), flash launches
    by design; step ms, tokens/s and peak memory beside bf16 (``trained``:
    the bf16 run at the same depth) and the largest |loss - bf16 loss|.  Then int8's
    witnesses, eager: ce_chunk 0 (the head's products whole, none run
    again) and the head unquantized (``--quantize_skip head``), their
    losses against bf16's and the int8 run's."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )

    cuda = device.type == "cuda"
    int8_ce = over.pop("int8_ce_chunk", 256)
    out, curves = {}, {"bf16": trained["losses"]}
    for fmt, ce in (("int8", int8_ce), ("fp8", 0)):
        flags = dict(over, matmul_dtype=fmt, ce_chunk=ce)
        cfg = config_from_args(build_argparser().parse_args(
            train_flags(**flags)))
        per_step = quant_step_design(cfg) if cuda else 0
        inspect = ((lambda t, f=fmt: profile_quant_step(torch, t, f))
                   if cuda else None)
        run = train_full_width(torch, np, device, keep_final=True,
                               profile=cuda, tag=f"quant {fmt}",
                               inspect=inspect, **flags)
        want = {"int8": 0, "fp8": 0}
        want[fmt] = per_step * run["steps"]
        if run["gemm_launches"] != want:
            raise AssertionError(f"quant {fmt}: products {run['gemm_launches']}"
                                 f", by design {want}")
        delta = max(abs(a - b) for a, b in zip(run["losses"],
                                                trained["losses"]))
        res = dict(losses=[round(x, 4) for x in run["losses"]],
                   bf16_losses=[round(x, 4) for x in trained["losses"]],
                   max_abs_loss_diff_vs_bf16=delta,
                   gemm_launches=run["gemm_launches"],
                   products_per_step=per_step,
                   **{k: run[k] for k in ("step_ms_median", "tokens_per_s",
                                          "peak_memory_gib", "mfu",
                                          "first_loss", "last3_loss",
                                          "profiled_products",
                                          "gemm_kernels",
                                          "profile_busy_share",
                                          "profile_ms_per_step")
                      if k in run})
        if cuda:
            graphed = dispatch_full_width(torch, np, device, run, exact=True,
                                          profile=False,
                                          tag=f"quant {fmt} dispatch",
                                          **flags)
            if graphed["gemm_launches"] != want:
                raise AssertionError(
                    f"quant {fmt} dispatch: products "
                    f"{graphed['gemm_launches']} (warm-up + replays x "
                    f"captured), by design {want}")
            res.update(graphed_step_ms_median=graphed["step_ms_median"],
                       graphed_tokens_per_s=graphed["tokens_per_s"],
                       graphed_peak_memory_gib=graphed["peak_memory_gib"],
                       graphed_bitwise=graphed["bitwise"])
            print(f"quant {fmt}: step {run['step_ms_median']:.2f} ms eager, "
                  f"{graphed['step_ms_median']:.2f} ms graphed vs bf16 "
                  f"{trained['step_ms_median']:.2f} ms eager; "
                  f"{run['tokens_per_s']:.0f} tokens/s eager; peak memory "
                  f"{run['peak_memory_gib']:.2f} GiB vs "
                  f"{trained['peak_memory_gib']:.2f} GiB; largest |loss - "
                  f"bf16 loss| {delta:.4f}", flush=True)
        out[fmt] = res
        curves[fmt] = run["losses"]
        del run
    witness = {}
    for name, extra in (("int8 ce_chunk 0", dict(ce_chunk=0)),
                        ("int8 head unquantized",
                         dict(ce_chunk=int8_ce, quantize_skip="head"))):
        # the first 6 steps are compared: one epoch
        flags = dict(dict(over, nepochs=1), matmul_dtype="int8", **extra)
        cfg = config_from_args(build_argparser().parse_args(
            train_flags(**flags)))
        run = train_full_width(torch, np, device, profile=False,
                               tag=f"quant {name}", **flags)
        want = (quant_step_design(cfg) * run["steps"]) if cuda else 0
        if run["gemm_launches"] != {"int8": want, "fp8": 0}:
            raise AssertionError(f"quant {name}: products "
                                 f"{run['gemm_launches']}, by design {want}")
        curves[name] = run["losses"]
        witness[name] = dict(
            losses=[round(x, 4) for x in run["losses"]],
            max_abs_loss_diff_vs_bf16=max(
                abs(a - b) for a, b in zip(run["losses"], curves["bf16"])),
            max_abs_loss_diff_vs_int8=max(
                abs(a - b) for a, b in zip(run["losses"], curves["int8"])),
            **{k: run[k] for k in ("step_ms_median", "last3_loss")
               if k in run})
        del run
    out["int8_witness"] = witness
    print("quant: loss - bf16 loss over the first 6 steps: " + "; ".join(
        f"{name} " + str([round(a - b, 4) for a, b in
                          zip(curve[:6], curves["bf16"])])
        for name, curve in curves.items() if name != "bf16"), flush=True)
    return out


def quant_runs(torch, device, names=("bf16", "int8", "fp8"), n_layers=2,
               steps=3, batch=2, seq_len=128, int8_ce_chunk=64, **over):
    """(d)'s training runs on ``device``: f32, TF32 off, full width at
    ``n_layers`` layers, T ``seq_len``, ``steps`` SGD-momentum steps from
    the same params and batches under each format of ``names`` (bf16: the
    plain f32 product, unquantized; int8 at ce_chunk ``int8_ce_chunk``;
    fp8 at 0).  Each run's (losses, final params, initial params), the
    params on the host."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.datasets import (  # noqa: E501
        text_dataset,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (  # noqa: E501
        ShardedLoader,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        data_parallel as dp,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        world_setup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(BIG, n_layers=n_layers, activation="gelu",
              pos_encoding="learned", attention="flash",
              param_dtype=torch.float32, compute_dtype=torch.float32)
    kw.update(over, max_seq_len=seq_len)
    data = text_dataset(TEXT_FILE, seq_len, kw["vocab_size"])
    ce_chunk = {"bf16": int8_ce_chunk, "int8": int8_ce_chunk, "fp8": 0}

    def train(fmt):
        model = Transformer(TransformerConfig(**kw, matmul_dtype=fmt,
                                              ce_chunk=ce_chunk[fmt]),
                            device=device)
        params = model.init(torch.Generator().manual_seed(SEED + 7))
        p0 = [p.detach().cpu().clone() for p in flat_params(params)]
        opt = optim.sgd(1e-2, 0.9, steps=steps)
        state = TrainState.from_params(params, opt, model)
        step = dp.make_train_step(model, opt, world_setup(device),
                                  loss_name="cross_entropy")
        losses = []
        loader = ShardedLoader(data, batch, device=device, shuffle=False)
        for _, b in zip(range(steps), loader.epoch(0)):
            state, loss = step(state, b)
            losses.append(float(loss))
        return losses, [p.detach().cpu() for p in
                        flat_params(state.params)], p0

    return {fmt: train(fmt) for fmt in names}


def quant_identity(torch, np, device, host, n_layers=2, steps=3,
                   seq_len=128, **kw):
    """(d) :func:`quant_runs` under int8 and fp8 on the card against
    ``host``, the host's three runs at the same arguments (made by a
    subprocess beside the phase: :func:`start_quant_host`,
    :func:`read_quant_host`): losses within QTRAIN_LOSS_RTOL and the
    params' change within QTRAIN_UPDATE_RL2, which the host's unquantized
    run (the plain f32 product) must exceed against the host's quantized
    one."""
    def update_rl2(got, want, p0):
        return float(sum(float(((a - b) ** 2).sum())
                         for a, b in zip(got, want)) ** 0.5
                     / sum(float(((b - z) ** 2).sum())
                           for b, z in zip(want, p0)) ** 0.5)

    card = quant_runs(torch, device, ("int8", "fp8"), n_layers=n_layers,
                      steps=steps, seq_len=seq_len, **kw)
    plain = host["bf16"]
    out = {}
    for fmt in ("int8", "fp8"):
        (lc, pc, p0c), (lh, ph, p0h) = card[fmt], host[fmt]
        if not all(torch.equal(a, b) for a, b in zip(p0c + p0h,
                                                     p0h + plain[2])):
            raise AssertionError(f"quant identity {fmt}: the runs start "
                                 "from different params")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        rl2 = update_rl2(pc, ph, p0h)
        control = update_rl2(plain[1], ph, p0h)
        bound = QTRAIN_UPDATE_RL2[fmt]
        print(f"quant identity {fmt} ({n_layers} layers, T {seq_len}, "
              f"{steps} steps): losses card {lc} host {lh} (largest "
              f"relative difference {loss_rel:.3g}, bound "
              f"{QTRAIN_LOSS_RTOL[fmt]:g}); params' change relative L2 "
              f"{rl2:.3g} (bound {bound:g}; the host's unquantized run "
              f"against its {fmt} run, the control: {control:.3g})",
              flush=True)
        if loss_rel > QTRAIN_LOSS_RTOL[fmt] or rl2 > bound:
            raise AssertionError(f"quant identity {fmt}: the card's run "
                                 "differs from the host's")
        if control <= bound:
            raise AssertionError(f"quant identity {fmt}: the bound {bound:g}"
                                 " would pass an unquantized run (control "
                                 f"{control:.3g})")
        out[fmt] = dict(loss_rel=loss_rel, update_rel_l2=rl2,
                        control_update_rel_l2=control)
    return out


def start_quant_host(tmp):
    """(d)'s host runs (unquantized, int8, fp8) in a subprocess of this
    script, started after phase 17 (a) and read by
    :func:`read_quant_host`."""
    path = f"{tmp}/quant_host.npz"
    env = dict(os.environ, OMP_NUM_THREADS="4")
    proc = subprocess.Popen([sys.executable, __file__, "--quant-host", path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(REPO_ROOT), env=env)
    return proc, path


def write_quant_host(torch, np, path):
    """The host side of (d): :func:`quant_runs`' three runs on the host,
    their losses, final params and initial params saved at ``path``."""
    runs = quant_runs(torch, torch.device("cpu"))
    arrays = {}
    for fmt, (losses, params, p0) in runs.items():
        arrays[f"{fmt}/losses"] = np.asarray(losses, np.float64)
        for i, (p, z) in enumerate(zip(params, p0)):
            arrays[f"{fmt}/p/{i}"] = p.numpy()
            arrays[f"{fmt}/p0/{i}"] = z.numpy()
    np.savez(path, **arrays)


def read_quant_host(torch, np, proc, path):
    o, e = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"quant identity host runs: rc "
                             f"{proc.returncode}\n{o[-2000:]}\n{e[-2000:]}")
    z = np.load(path)
    out = {}
    for fmt in ("bf16", "int8", "fp8"):
        n = sum(1 for k in z.files if k.startswith(f"{fmt}/p/"))
        out[fmt] = ([float(x) for x in z[f"{fmt}/losses"]],
                    [torch.from_numpy(z[f"{fmt}/p/{i}"]) for i in range(n)],
                    [torch.from_numpy(z[f"{fmt}/p0/{i}"]) for i in range(n)])
    return out


def ptq_token_identity(torch, np, device, cfg=None, n_new=16):
    """(e) f32 at ``__graft_entry__``'s geometry, int8 PTQ weights: for
    the dequant product (matmul_dtype bf16) and int8 compute, the fused
    scheduler, the gathered one and ``generate()`` give identical greedy
    ids; prints how many of int8 compute's ids equal the dequant
    path's."""
    import dataclasses

    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, generate,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops.quant import (  # noqa: E501
        quantize_params,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or flagship_config(torch)
    rng = np.random.default_rng(SEED + 8)
    requests = [(rng.integers(0, cfg.vocab_size, p).tolist(), n_new)
                for p in (3, 17, 40, 90)]
    params = None
    ids = {}
    for fmt in ("bf16", "int8"):
        model = Transformer(dataclasses.replace(cfg, matmul_dtype=fmt),
                            device=device)
        if params is None:
            params = quantize_params(model.init(
                torch.Generator(device=device).manual_seed(SEED + 8)))
        geom = dict(slots=4, block_size=16, max_len=cfg.max_seq_len,
                    prefill_chunk=64,
                    num_blocks=4 * -(-cfg.max_seq_len // 16) + 1)
        got = {}
        for impl in ("fused", "gathered"):
            sched = Scheduler(model, params, ServeConfig(**geom,
                                                         attn_impl=impl),
                              device=device)
            got[impl] = drive(sched, requests)[1]
        got["generate"] = [generate(model, params, [p], n,
                                    device=device)[0].tolist()
                           for p, n in requests]
        if not got["fused"] == got["gathered"] == got["generate"]:
            raise AssertionError(f"PTQ {fmt}: greedy ids differ between "
                                 "fused, gathered and generate()")
        ids[fmt] = got["fused"]
    new = [(a[len(p):], b[len(p):])
           for (p, _), a, b in zip(requests, ids["bf16"], ids["int8"])]
    same = sum(x == y for a, b in new for x, y in zip(a, b))
    total = sum(len(a) for a, _ in new)
    print(f"tokens PTQ f32 flagship: fused == gathered == generate() for "
          f"dequant and for int8 compute ({len(requests)} requests); int8 "
          f"compute's new ids equal the dequant path's {same}/{total}",
          flush=True)
    return dict(int8_vs_dequant_same=same, new_tokens=total)


def quant_serve(torch, np, device, **traffic):
    """(e) Phase 4's LM and traffic (``serve_setup``'s defaults: 32
    requests of 64-768 prompt and 32-128 new tokens on 16 slots; main
    passes ``n_requests=16``) with
    bf16 weights, int8 PTQ weights through the dequant product, and PTQ
    weights with int8 compute, each arm measured twice in the order
    A B C C B A (drift on the card or the host lands on both sides of
    every comparison): tokens/s, TTFT, ITL and the param bytes of each
    run, and each metric's spread over an arm's two runs (max - min over
    the mean); then ``ptq_token_identity``."""
    import dataclasses

    keep = ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
            "itl_p99_ms", "wall_s", "tokens_out", "param_bytes", "launches",
            "requests")
    setups = {}
    for tag, quantize, fmt in (("bf16 weights", False, "bf16"),
                               ("PTQ dequant", True, "bf16"),
                               ("PTQ int8 compute", True, "int8")):
        cfg = dataclasses.replace(big_config(torch), matmul_dtype=fmt)
        setups[tag] = serve_setup(torch, np, device, cfg=cfg,
                                  quantize=quantize, **traffic)
    runs = {tag: [] for tag in setups}
    order = list(setups) + list(setups)[::-1]
    for i, tag in enumerate(order):
        run = serve_measure(torch, device, *setups[tag],
                            tag=f"serve {tag} (run {i + 1} of {len(order)})")
        runs[tag].append({k: run[k] for k in keep})
    out = {}
    for tag, rs in runs.items():
        spread = {}
        for k in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                  "itl_p50_ms", "itl_p99_ms"):
            vals = [r[k] for r in rs]
            spread[k] = (max(vals) - min(vals)) / (sum(vals) / len(vals))
        out[tag] = dict(runs=rs, spread=spread)
        print(f"serve {tag}: tokens/s " + ", ".join(
            f"{r['tokens_per_s']:.1f}" for r in rs) + "; TTFT p50 "
            + ", ".join(f"{r['ttft_p50_ms']:.1f}" for r in rs)
            + " ms; ITL p50 " + ", ".join(f"{r['itl_p50_ms']:.2f}" for r in rs)
            + f" ms; spread of tokens/s {spread['tokens_per_s']:.1%}, of "
            f"ITL p50 {spread['itl_p50_ms']:.1%}", flush=True)
    del setups
    out["identity"] = ptq_token_identity(torch, np, device)
    return out


# ---------------------------------------------------------------------------
# phase 19: resilience on phase 7's job (guard, faults, rollback, SIGTERM,
# supervisor, watchdog)
# ---------------------------------------------------------------------------

def _bits(torch, t):
    """``t``'s bits as integers (bitwise comparison: -0.0 != 0.0, NaN ==
    the same NaN)."""
    t = t.detach()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _same_bits(torch, a, b):
    return all(torch.equal(_bits(torch, x), _bits(torch, y))
               for x, y in zip(a, b)) and len(a) == len(b)


def _state_tensors(trainer):
    """The params, the opt state (Adam's mu and nu, the guard's counts)
    and the fp8 histories, in a fixed order."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    s = trainer.state
    return leaves((s.params, s.opt_state, s.qstate))


def res_fit(torch, device, tag, inspect=None, **over):
    """Phase 7's flags with ``over`` through ``Trainer.fit``: the logged
    losses by step, the final state on the host, the step ms median (the
    graphed runs' after their first dispatch), peak memory and the flash
    launches by design of this run alone (counts set to 0 before it)."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )

    one_rank_group(torch, device)
    with tempfile.TemporaryDirectory() as tmp:
        metrics = f"{tmp}/metrics.jsonl"
        cfg = config_from_args(build_argparser().parse_args(
            train_flags(metrics_jsonl=metrics, **over)))
        before = memory_before(torch, device)
        trainer = Trainer(cfg, device=device)
        trainer.init_state()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        fa.set_launch_counts()
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        counts = fa.launch_counts()["all"]
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
        extra = inspect(trainer) if inspect is not None else {}
    graphed = trainer.multi_step
    launches = dict(counts)
    replays = getattr(graphed, "replays", 0)   # the host's group: eager
    if replays:
        per = graphed.launches_per_replay["all"]
        launches = {w: counts[w] + replays * per[w] for w in counts}
    k = trainer.k_dispatch
    # the card's step ms (the host's: nan)
    step_ms = sorted(result.get("step_ms", [])[k if k > 1 else 3:]) or [
        math.nan]
    out = dict(tag=tag, result=result, records=records,
               losses={r["step"]: r["loss"] for r in records
                       if "loss" in r},
               final=[t.detach().cpu().clone()
                      for t in _state_tensors(trainer)],
               step_ms=step_ms[len(step_ms) // 2],
               peak_gib=(result.get("peak_memory_bytes", before) - before)
               / 2 ** 30,
               launches=launches, fit_s=fit_s,
               captures=getattr(graphed, "captures", 0),
               **extra)
    print(f"{tag}: {result['steps']} steps in {fit_s:.1f} s, step "
          f"{out['step_ms']:.2f} ms, peak memory {out['peak_gib']:.2f} GiB, "
          f"flash launches {launches}", flush=True)
    del trainer
    memory_before(torch, device)
    return out


def guard_happy_path(torch, device):
    """(a) ``--skip-nonfinite`` against the same run without it, graphed
    (k 13) and eager, 2 epochs at phase 15's 2 layers: losses and final
    state bitwise equal; the guard's overhead on the step time and peak
    memory."""
    out, runs = {}, {}
    for mode, k in (("graphed", DISPATCH_K), ("eager", 1)):
        order = ((False, True) if mode == "graphed" else (True, False))
        for guard in order:
            extra = {"skip-nonfinite": True} if guard else {}
            runs[(mode, guard)] = res_fit(
                torch, device, f"guard {mode} {'on' if guard else 'off'}",
                nepochs=2, steps_per_dispatch=k, n_layers=CUT_LAYERS,
                **extra)
        on, off = runs[(mode, True)], runs[(mode, False)]
        if on["losses"] != off["losses"] or not all(
                math.isfinite(x) for x in on["losses"].values()):
            raise AssertionError(f"guard {mode}: losses differ from the "
                                 "unguarded run's")
        # the guarded state holds two more leaves (its 0-d counts): the
        # params and Adam's slots compare
        if not _same_bits(torch, [t for t in on["final"] if t.dim()],
                          [t for t in off["final"] if t.dim()]):
            raise AssertionError(f"guard {mode}: the final state differs "
                                 "from the unguarded run's")
        if on["result"]["skipped_updates"] != 0:
            raise AssertionError(f"guard {mode}: skipped "
                                 f"{on['result']['skipped_updates']}")
        overhead = (on["step_ms"] / off["step_ms"] - 1.0) * 100.0
        out[mode] = dict(step_ms_guard=on["step_ms"],
                         step_ms_plain=off["step_ms"],
                         overhead_pct=overhead, peak_gib_guard=on["peak_gib"],
                         peak_gib_plain=off["peak_gib"], bitwise=True)
        print(f"guard happy path {mode}: step {on['step_ms']:.3f} ms with "
              f"the guard vs {off['step_ms']:.3f} ms without "
              f"({overhead:+.2f}%), peak memory {on['peak_gib']:.2f} vs "
              f"{off['peak_gib']:.2f} GiB; losses and final state bitwise "
              "equal", flush=True)
    launches = {w: sum(r["launches"][w] for r in runs.values())
                for w in runs[("eager", True)]["launches"]}
    return out, launches


def _manual_eager(torch, device, faulted, **over):
    """The guarded eager run driven step by step (the Trainer's own step,
    loader and fault plan): each step's loss, and the state before and
    after every faulted step, which must be bitwise equal (params, Adam's
    mu and nu, the count that picks the lr row).  Returns the losses and
    the final state on the host."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import optim
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )

    with tempfile.TemporaryDirectory() as tmp:
        cfg = config_from_args(build_argparser().parse_args(train_flags(
            metrics_jsonl=f"{tmp}/m.jsonl", **over)))
        trainer = Trainer(cfg, device=device)
        trainer.init_state()
        losses, step = [], 0
        for epoch in range(cfg.nepochs):
            for batch in trainer.loader.epoch(epoch):
                batch = trainer.fault_plan.apply(step, batch)
                if step in faulted:
                    before = [t.clone() for t in _state_tensors(trainer)]
                    count = int(trainer.state.opt_state.count)
                trainer.state, loss = trainer.train_step(trainer.state,
                                                         batch)
                losses.append(float(loss))
                if step in faulted:
                    # every tensor but the 0-d counts (skipped moves on)
                    after = [t for t in _state_tensors(trainer) if t.dim()]
                    if not _same_bits(torch, [t for t in before if t.dim()],
                                      after):
                        raise AssertionError(
                            f"faults: the state after the skipped step "
                            f"{step} is not bitwise the state before it")
                    if int(trainer.state.opt_state.count) != count:
                        raise AssertionError(f"faults: the optimizer count "
                                             f"advanced on step {step}")
                    del before
                step += 1
        final = [t.detach().cpu().clone() for t in _state_tensors(trainer)]
        skipped = int(trainer.state.opt_state.skipped)
    del trainer
    memory_before(torch, device)
    return losses, final, skipped


def guard_faults(torch, device):
    """(b) ``--skip-nonfinite --faults nan@5,nan@18`` (18 inside the
    second dispatch) at ``CUT_LAYERS`` layers, with a constant lr and with
    a warm-up: the graphed
    run through ``Trainer.fit`` against the eager run driven step by
    step: the two steps' losses NaN, every other finite, 2 skipped, the
    state bitwise unchanged across each faulted step, the count (and so
    the lr row of the next step) not advanced, graphed == eager
    bitwise."""
    out, launches = {}, None
    for sched, extra in (("constant", {}),
                         ("warmup", dict(lr_schedule="cosine",
                                         warmup_steps=10))):
        flags = dict({"skip-nonfinite": True}, faults="nan@5,nan@18",
                     n_layers=CUT_LAYERS, **extra)
        g = res_fit(torch, device, f"faults graphed ({sched} lr)",
                    steps_per_dispatch=DISPATCH_K, **flags)
        losses, final, skipped = _manual_eager(torch, device, (5, 18),
                                               **flags)
        bad = [i for i, x in enumerate(losses) if not math.isfinite(x)]
        print(f"faults ({sched} lr): eager step losses "
              f"{[round(x, 4) for x in losses]}; non-finite at steps {bad}, "
              f"skipped {skipped} (graphed: "
              f"{g['result']['skipped_updates']})", flush=True)
        if bad != [5, 18] or skipped != 2 or \
                g["result"]["skipped_updates"] != 2:
            raise AssertionError(f"faults ({sched}): NaN at {bad}, skipped "
                                 f"{skipped} / {g['result']['skipped_updates']}")
        ends = {s: losses[s - 1] for s in g["losses"]}
        if g["losses"] != ends or not _same_bits(torch, g["final"], final):
            raise AssertionError(f"faults ({sched}): the graphed run differs "
                                 "from the eager one")
        out[sched] = dict(nan_steps=bad, skipped=skipped,
                          graphed_equals_eager=True,
                          step_ms_graphed=g["step_ms"])
        launches = g["launches"] if launches is None else {
            w: launches[w] + g["launches"][w] for w in launches}
    return out, launches


def guard_rollback(torch, device):
    """(c) ``--rollback_after 2 --checkpoint_every 8 --async-checkpoint
    --faults nan@9?max=1,nan@10?max=1`` without the guard, at
    ``CUT_LAYERS`` layers, graphed at k 4
    (a dispatch boundary at every snapshot step; the faults fire once, or
    the rolled-back window would replay them): exactly one rollback, to
    the step-8 snapshot, ``order_salt`` 1, no re-capture of the graph,
    every loss after it finite; the restore's seconds.  The run is traced
    (``--trace_dir``): the compile ledger holds one train_step event, the
    capture, and none for the rollback."""
    import glob
    import tempfile

    def inspect(t):
        events = [e for f in glob.glob(f"{tmp}/trace/compiles-*.jsonl")
                  for e in _jsonl(f) if e["name"].startswith("train_step")]
        return dict(salt=t.loader.order_salt, rolled=t.rollbacks,
                    ledger_events=len(events))

    with tempfile.TemporaryDirectory() as tmp:
        r = res_fit(torch, device, "rollback", steps_per_dispatch=4,
                    n_layers=CUT_LAYERS,
                    checkpoint_dir=f"{tmp}/ck", checkpoint_every=8,
                    **{"async-checkpoint": True},
                    rollback_after=2, faults="nan@9?max=1,nan@10?max=1",
                    trace_dir=f"{tmp}/trace", inspect=inspect)
    losses = [x["loss"] for x in r["records"] if "loss" in x]
    last_bad = max(i for i, x in enumerate(losses) if not math.isfinite(x))
    after = losses[last_bad + 1:]
    print(f"rollback: {r['result']['rollbacks']} rollback(s) "
          f"{r['rolled']}, order_salt {r['salt']}, graph captures "
          f"{r['captures']}, train_step events in the compile ledger "
          f"{r['ledger_events']}; losses "
          f"logged {[round(x, 4) for x in losses]}", flush=True)
    # the card captures the step once (the host runs no graph, and its
    # ledger holds the eager step's one signature event)
    captures = 1 if device.type == "cuda" else 0
    if (r["result"]["rollbacks"] != 1 or [x["step"] for x in r["rolled"]]
            != [8] or r["salt"] != 1 or r["captures"] != captures
            or r["ledger_events"] != 1
            or not after or not all(math.isfinite(x) for x in after)):
        raise AssertionError("rollback: expected one rollback to step 8, "
                             "salt 1, one capture (one ledger event) and "
                             "finite losses after")
    return dict(rollbacks=1, to_step=8, order_salt=1, recaptures=0,
                restore_s=r["rolled"][0]["seconds"],
                losses_after=len(after)), r["launches"]


def _timed_cli(args, timeout=600):
    """``python -m <port> args``, stdout and stderr merged, each line
    stamped with the seconds since the launch: (rc, [(t, line)])."""
    import threading

    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-m", PKG, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=str(REPO_ROOT), env=env)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append((time.monotonic() - t0, line.rstrip("\n")))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    return rc, lines, time.monotonic() - t0


def _first(lines, text):
    return next((t for t, line in lines if text in line), None)


def _fail_cli(what, rc, lines):
    tail = "\n".join(line for _, line in lines[-40:])
    raise AssertionError(f"{what}: rc {rc}\n{tail}")


def guard_cli(torch, device, straight):
    """(d) The CLI at phase 7's flags cut to ``CUT_LAYERS`` layers,
    graphed (k 13): SIGTERM at step 7 -> exit 0 with the step-13
    snapshot, and ``--resume`` from it ends bitwise at ``straight``'s
    final params (the same job's eager run, in process);
    ``--supervise 2`` with a crash at step 20 (once) relaunches once,
    resumes from the step-13 snapshot and ends bitwise there too;
    ``--rollback_after 1 --max_rollbacks 0`` with a NaN at step 5 exits
    44, not retried (``guard_abort``)."""
    import tempfile
    from pathlib import Path

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.registry import (  # noqa: E501
        build_model,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        checkpoint as ckpt,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    # the restore's template: the CLI's model, on the host
    cfg = config_from_args(build_argparser().parse_args(train_flags(
        n_layers=CUT_LAYERS)))
    template = build_model(cfg.model, device="cpu").init(
        torch.Generator().manual_seed(SEED))

    def final_bitwise(ck, what):
        step, params = ckpt.restore_params(str(ck), template)
        same = step == len(straight["losses"]) and _same_bits(
            torch, leaves(params), straight["final_params"])
        print(f"{what}: final snapshot step {step}, params bitwise equal "
              f"to the uninterrupted {CUT_LAYERS}-layer run: {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{what}: not bitwise the uninterrupted "
                                 "run")

    base = train_flags(steps_per_dispatch=DISPATCH_K, n_layers=CUT_LAYERS)

    def sigterm_chain(tmp):
        ck = Path(tmp) / "sigterm"
        rc, lines, wall = _timed_cli(base + [f"--checkpoint_dir={ck}",
                                             "--faults=sigterm@7"])
        if rc != 0 or ckpt.latest_step(str(ck)) != DISPATCH_K:
            _fail_cli("sigterm", rc, lines)
        t_sig = _first(lines, "injected SIGTERM")
        in_proc = next(float(line.rsplit(", ", 1)[1].split("s after")[0])
                       for _, line in lines if "s after the signal" in line)
        out = dict(signal_to_snapshot_s=in_proc,
                   signal_to_exit_s=wall - t_sig, wall_s=wall)
        rc, lines, wall = _timed_cli(base + [f"--checkpoint_dir={ck}",
                                             "--resume"])
        if rc != 0:
            _fail_cli("sigterm resume", rc, lines)
        out["resume_wall_s"] = wall
        out["start_to_first_step_s"] = _first(lines, "first dispatch done")
        final_bitwise(ck, "sigterm + resume")
        return out

    def crash_chain(tmp):
        ck = Path(tmp) / "crash"
        rc, lines, wall = _timed_cli(base + [
            f"--checkpoint_dir={ck}", f"--checkpoint_every={DISPATCH_K}",
            f"--faults=crash@20?once={tmp}/crashed", "--supervise=2",
            "--supervise_backoff=0.1", f"--telemetry_dir={tmp}/t",
            "--trace"])
        attempts = [line for _, line in lines if "[supervise] attempt" in line]
        if rc != 0 or len(attempts) != 2:
            _fail_cli("supervise crash", rc, lines)
        t_re = _first(lines, "[supervise] attempt 2")
        t_step = next(t for t, line in lines
                      if "first dispatch done" in line and t > t_re)
        out = dict(relaunch_to_first_step_s=t_step - t_re, wall_s=wall,
                   attempts=2, **obs_crash_merge(f"{tmp}/t", lines))
        final_bitwise(ck, "supervise crash + resume")
        return out

    # the two chains are independent processes: side by side
    from concurrent.futures import ThreadPoolExecutor

    out = {}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        crash = pool.submit(crash_chain, tmp)
        out["sigterm"] = sigterm_chain(tmp)
        out["supervise"] = crash.result()

    print(f"cli: sigterm at step 7 -> snapshot "
          f"{out['sigterm']['signal_to_snapshot_s']:.3f} s, exit "
          f"{out['sigterm']['signal_to_exit_s']:.2f} s after the signal; "
          f"resume to first step "
          f"{out['sigterm']['start_to_first_step_s']:.2f} s; supervised "
          f"relaunch to first step "
          f"{out['supervise']['relaunch_to_first_step_s']:.2f} s", flush=True)
    return out


def guard_abort():
    """(d) ``--rollback_after 1 --max_rollbacks 0`` with a NaN at step 5
    under ``--supervise 2``, at ``CUT_LAYERS`` layers: exit 44, not
    retried."""
    rc, lines, wall = _timed_cli(train_flags(steps_per_dispatch=DISPATCH_K,
                                             n_layers=CUT_LAYERS)
                                 + ["--rollback_after=1", "--max_rollbacks=0",
                                    "--faults=nan@5", "--supervise=2",
                                    "--supervise_backoff=0.1"])
    text = "\n".join(line for _, line in lines)
    if rc != 44 or "not retrying" not in text or \
            "[supervise] attempt 2" in text:
        _fail_cli("anomaly abort", rc, lines)
    print(f"cli: anomaly abort exit 44, one attempt ({wall:.1f} s)",
          flush=True)
    return dict(rc=rc, wall_s=wall, attempts=1)


def guard_watchdog():
    """(e) ``--hang_timeout 10 --faults peer_hang@4`` at 2 layers, with
    ``--telemetry_dir``: exit 42 with the stack dump, 10-30 s after the
    hang, and the flight recorder's ``postmortem.json`` (reason ``hang``)
    written before the exit (phase 20 (d) reads it)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        rc, lines, wall = _timed_cli(train_flags(
            n_layers=2, steps_per_dispatch=DISPATCH_K, hang_timeout=10,
            faults="peer_hang@4", telemetry_dir=tmp), timeout=300)
        try:
            with open(f"{tmp}/postmortem.json") as f:
                pm = json.load(f)
        except (OSError, ValueError):
            pm = {}
    t_hang = _first(lines, "injected peer_hang")
    t_fire = _first(lines, "HANG DETECTED")
    text = "\n".join(line for _, line in lines)
    if rc != 42 or t_hang is None or t_fire is None or \
            "Thread" not in text:
        _fail_cli("watchdog", rc, lines)
    secs = wall - t_hang
    print(f"watchdog: exit 42 {secs:.2f} s after the hang (fired at "
          f"{t_fire - t_hang:.2f} s), stack dump printed; postmortem "
          f"reason {pm.get('reason')!r}, {pm.get('n_records')} records",
          flush=True)
    if not 10.0 <= secs <= 30.0:
        raise AssertionError(f"watchdog: exit {secs:.2f} s after the hang")
    if pm.get("reason") != "hang" or not any(
            r.get("event") == "emergency" for r in pm.get("records", [])):
        raise AssertionError(f"watchdog: no hang postmortem ({pm})")
    return dict(rc=42, hang_to_exit_s=secs, hang_to_fire_s=t_fire - t_hang,
                postmortem_reason=pm["reason"],
                postmortem_records=pm["n_records"])


def resilience_full_width(torch, np, device, straight, background=None):
    """Phase 19: (a)-(e) above; the flash launches of the in-process runs
    (their counts set to 0 before each).  ``background()``, called once
    (a)'s runs are done, starts host work that runs beside the rest
    (phase 21's writer)."""
    out = {}
    # (d)'s chains, its exit-44 run and (e) are processes, run side by
    # side and beside (a)-(c), from the phase's head (the chains are its
    # longest path): their checks are exit codes, messages, bitwise
    # snapshots and a hang's seconds to exit (the watchdog's timeout and
    # poll); their start-up and signal-to-exit seconds, (a)'s step ms and
    # (c)'s restore seconds are read under that load
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(3) as pool:
        abort = pool.submit(guard_abort)
        cli = pool.submit(guard_cli, torch, device, straight)
        watchdog = pool.submit(guard_watchdog)
        out["happy"], l1 = guard_happy_path(torch, device)
        if background is not None:
            background()
        out["faults"], l2 = guard_faults(torch, device)
        out["rollback"], l3 = guard_rollback(torch, device)
        out["watchdog"] = watchdog.result()
        out["cli"] = cli.result()
        out["cli"]["abort"] = abort.result()
    launches = {w: l1[w] + l2[w] + l3[w] for w in l1}
    return out, launches


# ---------------------------------------------------------------------------
# phase 20: observability (telemetry, tracing, the capture ledger, goodput,
# the profiler, postmortems) on phase 7's job
# ---------------------------------------------------------------------------

# the telemetry flags of (a): a record per dispatch, the spans and the
# ledger, a rollup and a goodput record per dispatch of 13 steps
OBS_FLAGS = dict(trace=True, metrics_every=1, rollup_every=DISPATCH_K)
# the records' MFU (host wall between dispatches) against this script's
# (CUDA events): the two clocks measure the same steps
OBS_MFU_RTOL = 0.10
# (b): the card's f32 metrics against the host's, summation order only
OBS_METRICS_RTOL = 1e-4
OBS_METRICS = ("loss", "grad_norm", "param_norm", "update_ratio")
# the kernels the profiler's Chrome trace must name (B1-B3 at T 1024 run
# the serial backward: delta, dq, dkv) and Adam's _foreach kernels
OBS_TRACE_KERNELS = ("flash_fwd_sm90_kernel", "flash_dq_sm90_kernel",
                     "flash_dkv_sm90_kernel", "multi_tensor_apply_kernel")
TOOLS = ("metrics_summary", "trace_report", "goodput_report")


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _obs_inspect(torch, on, profile):
    """``res_fit``'s inspect: the fit's final state (before anything
    else runs) and, with ``profile``, the host's launch API calls per
    step under the profiler (one more dispatch of 13 replays, or 3 eager
    steps, each with the telemetry's per-dispatch staging when it is on)
    and, graphed, the device ms of one replay (the host held back)."""
    def inspect(trainer):
        cfg = trainer.cfg
        out = dict(fit_final=[t.detach().cpu().clone()
                              for t in _state_tensors(trainer)],
                   step_flops=3.0 * trainer.model.fwd_flops(
                       (cfg.batch_size, cfg.data.seq_len)),
                   peak_total=(trainer.telemetry.peak_total if on else None))
        if not profile:
            return out
        k = trainer.k_dispatch
        # res_fit counts the fit's replays only
        replays = getattr(trainer.multi_step, "replays", 0)
        stage = trainer.telemetry._stage
        if k > 1:
            groups = trainer.loader.epoch_groups(0, k)
            batches = next(groups)[0]
            groups.close()

            def run():
                trainer.state, o = trainer.multi_step(trainer.state, batches)
                if on:
                    stage(o)
        else:
            batches = [b for _, b in zip(range(3), trainer.loader.epoch(0))]

            def run():
                for b in batches:
                    trainer.state, o = trainer.train_step(trainer.state, b)
                    if on:
                        stage(o)
        out["profile"] = launch_profile(torch, run, len(batches))
        if k > 1 and trainer.device.type == "cuda":
            out["replay_ms"] = time_ms(torch, trainer.multi_step.graph.replay,
                                       10)
            trainer.multi_step.replays = replays
        return out
    return inspect


def _run_tool(tool, path):
    # goodput_report's text view raises on every ledger (its glyph table
    # lacks the "recovery" category); its --json view reads the same
    # ledger
    extra = ["--json"] if tool == "goodput_report" else []
    proc = subprocess.run([sys.executable, str(REPO_ROOT / "tools" /
                                               f"{tool}.py"), str(path),
                           *extra],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(REPO_ROOT))
    if proc.returncode != 0:
        raise AssertionError(f"tools/{tool}.py {path}: rc "
                             f"{proc.returncode}\n{proc.stderr[-2000:]}")
    return proc.stdout


def obs_on_off(torch, device):
    """(a) phase 7's job at 2 layers with the telemetry flags against the
    same run without them, graphed (k 13, 3 epochs: the third dispatch is
    the first whose record's host time is a whole dispatch of the loop's) and
    eager (2 epochs), each mode as the alternating pairs on, off, off, on
    (a drift of the card or the host along the four fits falls on both
    sides alike): the final params, Adam's mu and nu of all four bitwise
    equal; each run's step ms, the medians and the overhead between them,
    peak memory, the host's launch calls per step and, graphed, the busy
    share (the first run of each side profiled); the records: one per dispatch with
    every metric and (from the second on) step_time_ms, samples_per_sec
    and an mfu on the 989 TFLOP/s row within 10% of this script's; a
    rollup and a goodput record (with its step anatomy) every 13 steps, a
    heartbeat, exactly one capture in the ledger; the tools read the
    directory.  Then graphed with ``--skip-nonfinite --faults nan@5``:
    skipped reads 1 at every record, and the flight recorder holds the
    skip."""
    import shutil
    import tempfile

    import statistics

    out, launches = {}, None
    for mode, k, epochs in (("graphed", DISPATCH_K, 3), ("eager", 1, 2)):
        runs = {True: [], False: []}
        for on in (True, False, False, True):
            tdir = tempfile.mkdtemp() if on else None
            extra = dict(OBS_FLAGS, telemetry_dir=tdir) if on else {}
            # phase 7's job cut to 2 layers, for the time limit
            r = res_fit(torch, device, f"obs {mode} {'on' if on else 'off'}",
                        inspect=_obs_inspect(torch, on, not runs[on]),
                        nepochs=epochs, steps_per_dispatch=k,
                        n_layers=CUT_LAYERS, **extra)
            r["tdir"] = tdir
            runs[on].append(r)
            launches = r["launches"] if launches is None else {
                w: launches[w] + r["launches"][w] for w in launches}
        on, off = runs[True][0], runs[False][0]
        for r in runs[True][1:] + runs[False]:
            if r["losses"] != on["losses"] or not _same_bits(
                    torch, r["fit_final"], on["fit_final"]):
                raise AssertionError(f"obs {mode}: telemetry changed the "
                                     "losses or the final state")
        shutil.rmtree(runs[True][1]["tdir"], ignore_errors=True)
        ms_on = [r["step_ms"] for r in runs[True]]
        ms_off = [r["step_ms"] for r in runs[False]]
        med_on, med_off = statistics.median(ms_on), statistics.median(ms_off)
        tdir = on["tdir"]
        recs = _jsonl(f"{tdir}/metrics.jsonl")
        steps = [x for x in recs if x["kind"] == "step"]
        n = on["result"]["steps"]
        want_steps = list(range(k, n + 1, k))
        if [x["step"] for x in steps] != want_steps:
            raise AssertionError(f"obs {mode}: records at "
                                 f"{[x['step'] for x in steps]}")
        keys = ("grad_norm", "param_norm", "update_ratio", "skipped", "loss")
        timed = ("step_time_ms", "samples_per_sec", "mfu")
        if not all(all(key in x and math.isfinite(x[key]) for key in keys)
                   for x in steps) or not all(
                all(key in x for key in timed) for x in steps[1:]):
            raise AssertionError(f"obs {mode}: a record lacks a metric")
        if on["peak_total"] != PEAK_FLOPS["torch.bfloat16"]:
            raise AssertionError(f"obs {mode}: MFU over "
                                 f"{on['peak_total']:.4g}, not 989e12")
        # the records' steady MFU: graphed from the third dispatch,
        # eager from step 4 (the first steps build and warm up)
        steady = [x["mfu"] for x in steps
                  if x["step"] > (2 * k if k > 1 else 3)]
        rec_mfu = sorted(steady)[len(steady) // 2]
        own_mfu = on["step_flops"] / (on["step_ms"] / 1e3 * PEAK_FLOPS[
            "torch.bfloat16"])
        if abs(rec_mfu / own_mfu - 1.0) > OBS_MFU_RTOL:
            raise AssertionError(f"obs {mode}: the records' MFU "
                                 f"{rec_mfu:.4f} vs {own_mfu:.4f}")
        rollups = [x["step"] for x in recs if x["kind"] == "rollup"]
        goodput = [x for x in recs if x["kind"] == "goodput"]
        cadence = list(range(DISPATCH_K, n + 1, DISPATCH_K))
        if sorted(set(rollups)) != cadence or sorted(
                {x["step"] for x in goodput}) != cadence:
            raise AssertionError(f"obs {mode}: rollups at {rollups}, "
                                 f"goodput at "
                                 f"{[x['step'] for x in goodput]}")
        # the anatomy joins the capture's flops with a measured step: from
        # the second record on (the first has no step time yet)
        anatomy = [x.get("anatomy") for x in goodput]
        graphs = mode == "graphed" and device.type == "cuda"
        if graphs and not all(anatomy[1:]):
            raise AssertionError("obs graphed: a goodput record without "
                                 "its step anatomy")
        if not os.path.exists(f"{tdir}/heartbeat-train-p0.json"):
            raise AssertionError(f"obs {mode}: no heartbeat")
        captures = [e for e in _jsonl(_one(f"{tdir}/trace/compiles-*.jsonl"))
                    if e["name"].startswith("train_step")]
        want_captures = 1
        if len(captures) != want_captures or (
                graphs and captures[0]["program"] != "cuda_graph"):
            raise AssertionError(f"obs {mode}: {len(captures)} train_step "
                                 "events in the ledger")
        for tool in TOOLS:
            _run_tool(tool, tdir if tool == "metrics_summary"
                      else f"{tdir}/trace")
        overhead = (med_on / med_off - 1.0) * 100.0
        # in the order run: on, off, off, on
        row = dict(step_ms_runs=[ms_on[0], ms_off[0], ms_off[1], ms_on[1]],
                   step_ms_on=med_on, step_ms_off=med_off,
                   overhead_pct=overhead,
                   peak_gib_on=max(r["peak_gib"] for r in runs[True]),
                   peak_gib_off=max(r["peak_gib"] for r in runs[False]),
                   launch_calls_per_step_on=on["profile"][
                       "launch_calls_per_step"],
                   launch_calls_per_step_off=off["profile"][
                       "launch_calls_per_step"],
                   records=len(steps), record_mfu=rec_mfu, own_mfu=own_mfu,
                   rollups=len(rollups), goodput_records=len(goodput),
                   goodput_fraction=goodput[-1]["goodput_fraction"],
                   anatomy=anatomy[-1], captures=len(captures),
                   capture_s=captures[0].get("capture_s"), bitwise=True)
        if graphs:
            row.update(busy_on=on["replay_ms"] / on["step_ms"],
                       busy_off=off["replay_ms"] / off["step_ms"],
                       replay_ms_on=on["replay_ms"],
                       replay_ms_off=off["replay_ms"])
        out[mode] = row
        print(f"obs {mode}: step ms on, off, off, on "
              f"{', '.join(f'{x:.3f}' for x in row['step_ms_runs'])}: "
              f"medians {med_on:.3f} ms with telemetry vs {med_off:.3f} ms "
              f"without ({overhead:+.2f}%), peak memory "
              f"{row['peak_gib_on']:.3f} vs {row['peak_gib_off']:.3f} GiB, "
              f"host launch calls per step {row['launch_calls_per_step_on']:.1f}"
              f" vs {row['launch_calls_per_step_off']:.1f}"
              + (f", busy {100 * row['busy_on']:.1f}% vs "
                 f"{100 * row['busy_off']:.1f}%" if graphs else "")
              + f"; MFU records {rec_mfu:.4f} vs events {own_mfu:.4f}; "
              f"{len(steps)} records, {len(rollups)} rollups, "
              f"{len(goodput)} goodput, {len(captures)} capture; final "
              "state bitwise equal", flush=True)
        shutil.rmtree(tdir, ignore_errors=True)
    # the guard's skip, seen through the cumulative counter at the
    # dispatch ends
    tdir = tempfile.mkdtemp()
    r = res_fit(torch, device, "obs graphed nan@5", inspect=lambda t: dict(
        recorder=list(t.telemetry.recorder.records)),
        steps_per_dispatch=DISPATCH_K, telemetry_dir=tdir,
        n_layers=CUT_LAYERS,
        **{"skip-nonfinite": True, "faults": "nan@5"}, **OBS_FLAGS)
    launches = {w: launches[w] + r["launches"][w] for w in launches}
    steps = [x for x in _jsonl(f"{tdir}/metrics.jsonl")
             if x["kind"] == "step"]
    skips = [e for e in r["recorder"] if e.get("event") == "skip"]
    shutil.rmtree(tdir, ignore_errors=True)
    if [x["skipped"] for x in steps] != [1.0, 1.0] or [
            (e["step"], e["fires"]) for e in skips] != [(DISPATCH_K, 1)]:
        raise AssertionError(f"obs nan@5: skipped "
                             f"{[x['skipped'] for x in steps]}, skip events "
                             f"{skips}")
    out["skip"] = dict(skipped=[x["skipped"] for x in steps],
                       skip_events=len(skips))
    print(f"obs nan@5: skipped {out['skip']['skipped']} at the dispatch "
          f"ends {[x['step'] for x in steps]}, one skip event in the flight "
          "recorder", flush=True)
    return out, launches


def _one(pattern):
    import glob

    found = glob.glob(pattern)
    if len(found) != 1:
        raise AssertionError(f"{pattern}: {found}")
    return found[0]


def obs_card_vs_host(torch, device):
    """(b) f32, TF32 off, 2 layers, T 128 (ce_chunk 32: a chunk must lie
    inside the 32 tokens of one of the 4 sequence shards), 3 steps of
    batch 2: the card's
    metrics records (loss, grad_norm, param_norm, update_ratio) against
    the host's within 1e-4 relative, for the replicated step with flash
    and for striped_flash over ``LocalSeqGroup(4)`` (B5 on the card).
    Returns the largest relative differences and the card's B5 launches
    (counts set to 0 before each card run)."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        LocalSeqGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )

    one_rank_group(torch, device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, launches = {}, {}
    try:
        for attention, sp in (("flash", 1), ("striped_flash", 4)):
            recs = []
            for dev in (device, torch.device("cpu")):
                with tempfile.TemporaryDirectory() as tmp:
                    flags = dict(n_layers=2, seq_len=128, n_samples=6,
                                 batch_size=2, nepochs=1, ce_chunk=32,
                                 compute_dtype="float32",
                                 attention=attention, telemetry_dir=tmp,
                                 metrics_every=1)
                    if sp > 1:
                        flags["sp"] = sp
                    cfg = config_from_args(build_argparser().parse_args(
                        train_flags(**flags)))
                    t = Trainer(cfg, device=dev, seq_group=(
                        LocalSeqGroup(sp) if sp > 1 else None))
                    if dev.type == "cuda":
                        fa.set_launch_counts()
                    t.fit()
                    if dev.type == "cuda":
                        c = fa.launch_counts()
                        launches[attention] = dict(c["all"],
                                                   with_lse=c["with_lse"])
                    recs.append([x for x in _jsonl(
                        f"{tmp}/metrics.jsonl") if x["kind"] == "step"])
                    del t
            card, host = recs
            if [x["step"] for x in card] != [1, 2, 3] or \
                    [x["step"] for x in host] != [1, 2, 3]:
                raise AssertionError(f"obs card vs host {attention}: "
                                     "records")
            worst = {m: max(abs(a[m] - b[m]) / abs(b[m])
                            for a, b in zip(card, host)) for m in OBS_METRICS}
            out[attention] = worst
            print(f"obs card vs host {attention}"
                  + (f" over LocalSeqGroup({sp})" if sp > 1 else "")
                  + ": largest relative differences "
                  + ", ".join(f"{m} {v:.3g}" for m, v in worst.items())
                  + f" (bar {OBS_METRICS_RTOL}); card launches "
                  f"{launches.get(attention)}", flush=True)
            if max(worst.values()) > OBS_METRICS_RTOL:
                raise AssertionError(f"obs card vs host {attention}: "
                                     f"{worst}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    return out, launches


def obs_profile(torch, device):
    """(c) ``--profile_dir``: phase 7's job at 2 layers for 3 steps (24
    samples) under ``torch.profiler``, against the same 3 steps without
    it: the Chrome
    trace names B1-B3's kernels and Adam's ``_foreach`` kernels (each at
    least once: the profiler can drop a kernel's record); the profiler's
    cost per step (the fit's wall, the trace export included)."""
    import tempfile

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for prof in (False, True):
            extra = dict(profile_dir=tmp) if prof else {}
            runs[prof] = res_fit(torch, device,
                                 f"obs profile {'on' if prof else 'off'}",
                                 n_samples=24, nepochs=1,
                                 n_layers=CUT_LAYERS, **extra)
        path = _one(f"{tmp}/trace-*.json")
        size = os.path.getsize(path)
        with open(path) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"]
    found = {k: sum(k in n for n in names) for k in OBS_TRACE_KERNELS}
    cost = (runs[True]["fit_s"] - runs[False]["fit_s"]) / 3 * 1e3
    print(f"obs profile: {len(names)} kernels in the Chrome trace "
          f"({size / 2 ** 20:.1f} MiB), {found}; fit {runs[True]['fit_s']:.2f}"
          f" s with the profiler vs {runs[False]['fit_s']:.2f} s without: "
          f"{cost:.1f} ms per step", flush=True)
    # named, each; the counts are the trace's records, which the profiler
    # can drop (the wrappers' counters, 6 each here, count launches)
    if not all(found.values()):
        raise AssertionError(f"obs profile: kernels {found}")
    launches = {w: runs[True]["launches"][w] + runs[False]["launches"][w]
                for w in runs[True]["launches"]}
    return dict(kernels_found=found, trace_mib=size / 2 ** 20,
                profiler_ms_per_step=cost,
                fit_s_on=runs[True]["fit_s"],
                fit_s_off=runs[False]["fit_s"]), launches


def obs_crash_merge(tdir, lines):
    """(d) phase 19 (d)'s supervised crash (step 20, once) ran with
    ``--telemetry_dir tdir --trace``: the crash dumped the flight
    recorder, the supervisor's log points at it, and
    ``tools/trace_report.py`` merges the two incarnations of one run into
    one timeline."""
    text = "\n".join(line for _, line in lines)
    with open(f"{tdir}/postmortem.json") as f:
        pm = json.load(f)
    proc = subprocess.run(
        [sys.executable, str(REPO_ROOT / "tools" / "trace_report.py"),
         f"{tdir}/trace", "--json"], capture_output=True, text=True,
        timeout=120, cwd=str(REPO_ROOT))
    if proc.returncode != 0:
        raise AssertionError(f"trace_report: {proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout)
    merged = os.path.exists(f"{tdir}/trace/trace.json")
    incs = sorted(g["incarnation"] for g in summary["groups"])
    gaps = summary["relaunch_gaps"]
    print(f"obs supervised crash: postmortem {pm['reason']!r}, pointer "
          f"printed: {'child left a postmortem' in text}; trace_report "
          f"merged run {summary['runs']} incarnations {incs}, relaunch gap "
          f"{gaps[0]['gap_s'] if gaps else None} s", flush=True)
    if "child left a postmortem" not in text or not pm["reason"].startswith(
            "crash@20") or len(summary["runs"]) != 1 or incs != [0, 1] \
            or len(gaps) != 1 or not merged:
        raise AssertionError(f"obs supervised crash: {pm['reason']}, "
                             f"{summary['runs']}, {incs}, {gaps}")
    return dict(postmortem_reason=pm["reason"], incarnations=incs,
                relaunch_gap_s=gaps[0]["gap_s"])


def observability_full_width(torch, np, device, resilience):
    """Phase 20: (a)-(c) above; (d) reads phase 19's results
    (``resilience``): (e)'s run had ``--telemetry_dir`` (its postmortem:
    reason ``hang``), (d)'s supervised crash ``--telemetry_dir --trace``
    (``obs_crash_merge``).  Returns the phase's numbers and the flash
    launches of its in-process runs (counts set to 0 before each)."""
    out = {}
    out["on_off"], l1 = obs_on_off(torch, device)
    out["card_vs_host"], l2 = obs_card_vs_host(torch, device)
    out["profile"], l3 = obs_profile(torch, device)
    out["hang_postmortem"] = resilience["watchdog"]["postmortem_reason"]
    out["supervised_crash"] = {
        k: resilience["cli"]["supervise"][k]
        for k in ("postmortem_reason", "incarnations", "relaunch_gap_s")}
    launches = {w: l1[w] + l3[w] + sum(c[w] for c in l2.values())
                for w in l1}
    launches["with_lse"] = sum(c["with_lse"] for c in l2.values())
    out["launches"] = launches
    return out, launches


# ---------------------------------------------------------------------------
# phase 21: replica consistency (the fingerprint kernel, localize, heal)
# and elastic resume (N -> M reshard, batch policy, capacity floor)
# ---------------------------------------------------------------------------

# the elastic snapshot's job: phase 7's flags cut to 2 layers (full
# width), 2 rows a step, zero1 over 2 gloo ranks on the host
ELASTIC_FLAGS = dict(n_layers=2, batch_size=2, n_samples=2,
                     update_sharding="zero1")


def keep_state(stash):
    """An ``inspect`` hook for ``train_full_width``: a host copy of the
    trainer's replicated leaves, in the fingerprint's order, into
    ``stash`` (prints nothing)."""
    def inspect(trainer):
        from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (  # noqa: E501
            consistency,
        )

        stash["leaves"] = [(n, t.detach().cpu()) for n, t in
                           consistency.replicated_leaves(trainer.state)]
        return {}
    return inspect


def elastic_writer(tmp, ck):
    """Start phase 21 (c)'s writer: 2 gloo ranks of the CLI on the host
    (``CUDA_VISIBLE_DEVICES`` empty), zero1, one step, one snapshot."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    flags = train_flags(platform="cpu", nepochs=1, checkpoint_dir=ck,
                        **ELASTIC_FLAGS)
    procs = []
    for rank in range(2):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        env.pop("NNPT_FAULTS", None)
        log = open(f"{tmp}/writer{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", PKG, *flags], stdout=log,
            stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__))), log))
    return procs


def fp_full_width(torch, np, device, host_leaves):
    """(a) The digest kernel on the whole training state (params, Adam's
    mu and nu, the count): bitwise equal to the plain version on the card
    and on the host's copy; one flipped bit changes it (an f32 leaf, a
    bf16 copy of a param, the count); its time (CUDA events, median of
    20) beside the bytes bound and the plain version's.  (b) Two replicas
    on the card, bit 9 of one element of replica 1 flipped: the per-leaf
    digests through the localization core name that leaf, replica 1 and 1
    element; the heal restores replica 1 bitwise; ``digest_report`` of the
    (1, 2) matrix is ``local: [0]`` before and ``{}`` after."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        fingerprint as fp,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        consistency,
        faults,
    )

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    names = [n for n, _ in host_leaves]
    host = [t for _, t in host_leaves]
    cards = [t.to(device) for t in host]
    n_bytes = sum(t.numel() * t.element_size() for t in host)
    n_values = sum(t.numel() for t in host)
    table = fp.launch_table(cards)
    d_k, f_k = fp.fingerprint(cards, table)
    d_p, f_p = fp.fingerprint_reference(cards)
    d_h, _ = fp.fingerprint_reference(host)
    d_k, d_p = d_k.cpu(), d_p.cpu()
    # the kernel's two outputs against the plain version's: the digests
    # (held bitwise, against the card's and the host's) and the folds
    mismatches = int((d_k != d_p).sum()) + int((d_k != d_h).sum())
    digest_err = int((d_k - d_p).abs().max())
    fold_err = float((f_k.cpu() - f_p.cpu()).abs().max())
    if mismatches:
        raise AssertionError(f"fingerprint: kernel digests differ from the "
                             f"plain version's ({mismatches} of "
                             f"{2 * (len(names) + 1)})")
    fold_rel = abs(float(f_k[-1]) - float(f_p[-1])) / abs(float(f_p[-1]))
    if fold_rel > 1e-4:
        raise AssertionError(f"fingerprint fold {float(f_k[-1])} vs plain "
                             f"{float(f_p[-1])}")
    digest = int(d_k[-1])

    def chained(tensors):
        return int(fp.fingerprint(tensors)[0][-1])

    flips = {}
    big = max((i for i, t in enumerate(cards) if t.is_floating_point()),
              key=lambda i: cards[i].numel())
    count = next(i for i, n in enumerate(names) if n.endswith(".count"))
    for what, i, bit in (("f32 leaf", big, 9), ("count", count, 0)):
        faults.flip_bit_in_shard(cards[i], 0, bit)
        flipped = chained(cards)
        faults.flip_bit_in_shard(cards[i], 0, bit)
        flips[what] = [names[i], flipped != digest]
        if flipped == digest or chained(cards) != digest:
            raise AssertionError(f"fingerprint: a flipped bit in {what} "
                                 f"{names[i]} left the digest unchanged")
    param = next(i for i, n in enumerate(names) if n.startswith(".params")
                 and cards[i].dim() == 2)
    copy = cards[param].to(torch.bfloat16)
    if not torch.equal(fp.fingerprint([copy])[0].cpu(),
                       fp.fingerprint_reference([copy])[0].cpu()):
        raise AssertionError("fingerprint: the bf16 copy's digest differs "
                             "from the plain version's")
    base = chained([copy])
    faults.flip_bit_in_shard(copy, 0, 3)
    flips["bf16 copy"] = [names[param], chained([copy]) != base]
    if not flips["bf16 copy"][1]:
        raise AssertionError("fingerprint: a flipped bit in the bf16 copy "
                             "left the digest unchanged")
    del copy
    ms = median_ms(torch, lambda: fp.fingerprint(cards, table), runs=20)
    plain_ms = median_ms(torch, lambda: fp.fingerprint_reference(cards),
                         runs=5, warmup=1)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"fingerprint: {len(names)} leaves, {n_values:,} values, "
          f"{n_bytes / 1e9:.3f} GB: kernel == plain == host, bitwise "
          f"(digest {digest:#010x}, {mismatches} mismatches, largest "
          f"|difference| {digest_err}; fold {float(f_k[-1]):.6g}, largest "
          f"|difference| {fold_err:.3g}, the sum's {fold_rel:.2e} "
          f"relative); a flipped bit changes it: "
          f"{flips}; kernel {ms:.4f} ms (median of 20) vs bound "
          f"{bound:.4f} ms ({bound / ms:.1%}), plain {plain_ms:.4f} ms",
          flush=True)
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                  bound_by="bytes", library_ms=None, bytes=n_bytes,
                  values=n_values, leaves=len(names),
                  max_abs_err=max(digest_err, fold_err),
                  digest_mismatches=mismatches, digest_max_abs_err=digest_err,
                  fold_max_abs_err=fold_err, fold_rel_err=fold_rel)
    del table

    # (b) two replicas on the card
    rep1 = [t.clone() for t in cards]
    trees = [dict(enumerate(cards)), dict(enumerate(rep1))]
    victim = next(i for i, n in enumerate(names)
                  if n.startswith(".opt_state.mu") and rep1[i].dim() == 2)
    faults.flip_bit_in_shard(rep1[victim], 0, 9)
    mat = np.stack([consistency.leaf_digest_array(cards),
                    consistency.leaf_digest_array(rep1)])
    chains = np.array([[fp.chain(mat[0].tolist()),
                        fp.chain(mat[1].tolist())]], np.uint32)
    before = consistency.digest_report(chains)
    sync()
    t0 = time.perf_counter()
    report = consistency.localize(
        names, mat, lambda j: [cards[j], rep1[j]], ["replica0", "replica1"])
    sync()
    localize_s = time.perf_counter() - t0
    if (list(report) != [names[victim]]
            or report[names[victim]]["shards"] != [1]
            or report[names[victim]]["n_bad_elements"] != 1
            or before.get("local") != [0] or before.get("cross") != []):
        raise AssertionError(f"localize: {report}, verdict {before}; "
                             f"expected {names[victim]}, replica 1, 1 "
                             "element, local [0]")
    keyed = {f"[{victim}]": report[names[victim]]}
    t0 = time.perf_counter()
    consistency.heal_replication(trees, keyed)
    sync()
    heal_s = time.perf_counter() - t0
    after = np.array([[chained(cards), chained(rep1)]], np.uint32)
    healed = _same_bits(torch, rep1, cards)
    if not healed or consistency.digest_report(after) != {}:
        raise AssertionError("heal: replica 1 is not replica 0 bitwise "
                             "after the heal")
    print(f"localize + heal on the card: {names[victim]} replica 1, "
          f"{report[names[victim]]['n_bad_elements']} element, max |diff| "
          f"{report[names[victim]]['max_abs_diff']:.3g}; digest_report "
          f"before {before}, after {{}}; localize {localize_s:.3f} s, heal "
          f"{heal_s * 1e3:.2f} ms; replica 1 bitwise replica 0", flush=True)
    local = dict(leaf=names[victim], verdict_before=before,
                 localize_s=localize_s, heal_ms=heal_s * 1e3,
                 healed_bitwise=healed, flips=flips, fold_rel=fold_rel)
    del rep1, trees, cards
    return timing, local


def elastic_resume(torch, np, device, writer, ck):
    """(c) The 2-rank zero1 snapshot resumed with ``--elastic
    --elastic_batch global`` at dp=1 on the card, under
    ``--steps_per_dispatch 2`` with ``--sdc_check_every 1`` (the replica
    floor at 1: one card is one replica, so the digest of every dispatch
    is judged against itself): params and moments equal the snapshot's
    arrays bitwise (the flat buffers' padding cut off); the topology
    record 2 -> 1 with accumulation 1 -> 2; two more steps, finite, one
    capture; the fingerprint and flash launches of the run."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        fingerprint as fp,
        flash_attention as fa,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train import (
        trainer as trainer_mod,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        checkpoint as ckpt,
    )

    t0 = time.perf_counter()
    for proc, log in writer:
        rc = proc.wait(timeout=600)
        log.flush()
        if rc != 0:
            with open(log.name) as f:
                raise AssertionError(f"elastic writer rc {rc}:\n"
                                     f"{f.read()[-3000:]}")
    wait_s = time.perf_counter() - t0
    step = ckpt.latest_step(ck)
    with np.load(f"{ck}/ckpt-{step}/state.npz") as z:
        saved = [z[f"leaf_{i}"] for i in range(
            sum(k.startswith("leaf_") for k in z.files))]
    meta = ckpt.read_meta(ck)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = config_from_args(build_argparser().parse_args(train_flags(
            nepochs=3, checkpoint_dir=ck, resume=True, elastic=True,
            elastic_batch="global", steps_per_dispatch=2,
            sdc_check_every=1, telemetry_dir=f"{tmp}/t",
            metrics_every=1, **ELASTIC_FLAGS)))
        floor = trainer_mod.SDC_MIN_REPLICAS
        trainer_mod.SDC_MIN_REPLICAS = 1
        try:
            trainer = trainer_mod.Trainer(cfg, device=device)
            trainer.init_state()
            resumed = trainer.maybe_resume()
            restored = [a for _, a, _ in
                        ckpt.host_state(trainer.snapshot_state())]
            exact = len(restored) == len(saved) and all(
                a.shape == b.shape and np.array_equal(a, b)
                or (a.ndim == 1 and a.shape[0] >= b.shape[0]
                    and np.array_equal(a[:b.shape[0]], b)
                    and not np.any(a[b.shape[0]:]))
                for a, b in zip(saved, restored))
            if not exact or resumed != step:
                raise AssertionError(f"elastic restore: step {resumed} vs "
                                     f"{step}; arrays bitwise: {exact}")
            fa.set_launch_counts()
            fp.fingerprint.launches = 0
            result = trainer.fit()
            fp_launches = fp.fingerprint.launches
            counts = fa.launch_counts()["all"]
        finally:
            trainer_mod.SDC_MIN_REPLICAS = floor
        with open(f"{tmp}/t/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
    cuda = device.type == "cuda"
    graphed = trainer.multi_step
    captures = graphed.captures if cuda else 0
    flash = {k: counts[k] + (graphed.replays * graphed.launches_per_replay[
        "all"][k] if cuda else 0) for k in counts}
    topo = [r for r in recs if r.get("kind") == "topology"]
    losses = [r["loss"] for r in recs if r.get("kind") == "step"]
    ok = (len(topo) == 1 and topo[0]["from_world"]["dp"] == 2
          and topo[0]["to_world"]["dp"] == 1
          and topo[0]["accum_steps"] == [1, 2]
          and result["steps"] == step + 2
          and losses and all(math.isfinite(x) for x in losses)
          and result.get("sdc_incidents") == 0
          # the card's kernels (the host runs their plain versions)
          and (not cuda or (captures == 1 and fp_launches > 0
                            and all(flash.values()))))
    print(f"elastic: a dp=2 zero1 snapshot (step {step}, saved_world "
          f"{meta['saved_world']}) resumed at dp=1 under --elastic_batch "
          f"global: restored params and moments bitwise {exact}; topology "
          f"{topo[0] if topo else None}; steps {step + 1}-"
          f"{result['steps']} losses {losses}, captures "
          f"{captures}; fingerprint launches {fp_launches}, flash "
          f"{flash}; waited {wait_s:.1f} s for the host writer", flush=True)
    if not ok:
        raise AssertionError("elastic resume: the checks above failed")
    return dict(step=step, restored_bitwise=exact,
                accum_steps=topo[0]["accum_steps"], losses=losses,
                captures=captures, fp_launches=fp_launches,
                flash_launches=flash, writer_wait_s=wait_s)


def capacity_floor(device):
    """(d) A Trainer asking for 2 devices on one card: CapacityAbort,
    naming exit 46."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.resilience import (  # noqa: E501
        CapacityAbort,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )

    cfg = config_from_args(build_argparser().parse_args(
        ["--min_devices", "2"]))
    try:
        Trainer(cfg, device=device)
    except CapacityAbort as e:
        print(f"capacity floor: {e}", flush=True)
        if "exit 46" not in str(e):
            raise AssertionError("CapacityAbort does not name exit 46")
        return dict(raised=True)
    raise AssertionError("--min_devices 2 on one card did not raise")


def stop_writer(writer):
    """Kill what is left of (c)'s host writer and close its logs."""
    for proc, log in writer:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def sdc_elastic_full_width(torch, np, device, host_leaves, tmp, writer=None):
    """Phase 21: (a) and (b) on the card, then (c), whose host writer
    (``writer``, writing under ``tmp``; started here when not given) ran
    beside them, then (d)."""
    t0 = time.perf_counter()
    ck = f"{tmp}/ck"
    if writer is None:
        writer = elastic_writer(tmp, ck)
    try:
        timing, local = fp_full_width(torch, np, device, host_leaves)
        elastic = elastic_resume(torch, np, device, writer, ck)
    finally:
        stop_writer(writer)
    floor = capacity_floor(device)
    out = dict(fingerprint=timing, localize_heal=local, elastic=elastic,
               capacity=floor, seconds=time.perf_counter() - t0)
    print("sdc_elastic: " + json.dumps(out), flush=True)
    return out


def _clone_tree(torch, tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(torch, v) for k, v in tree.items()}
    return [_clone_tree(torch, v) for v in tree]


# ---------------------------------------------------------------------------
# phase 22: tensor parallelism and the ulysses / dense_blockwise attentions
# ---------------------------------------------------------------------------

# tensor shards of the flagship DP x TP run, all on the one card
TP_SHARDS = 4


def _rel_err(torch, got, want):
    """Largest |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def check_megatron_ops(torch, device):
    """(a) f / g and the vocab-parallel cross-entropy against their dense
    forms on the card: the flagship FFN pair (8192 x 1024 -> 4096 -> 1024,
    GELU) column- then row-split over ``LocalTensorGroup(4)`` and through
    the autograd functions of a ``ProcessTensorGroup`` over the 1-rank
    NCCL group; the CE over the flagship's logits (8, 1024, 32768) split 4
    ways, its max and sum-exp in f32 under bf16 compute.  Outputs and
    every gradient, relative to the dense form's largest value, within
    ``TOL``'s rtol of the dtype (TF32 off)."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        losses,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        megatron,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    one_rank_group(torch, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        rtol = TOL[str(dtype)][0]
        x = torch.randn(8192, 1024, device=device, generator=gen)
        w1 = torch.randn(1024, 4096, device=device, generator=gen) * 0.03
        w2 = torch.randn(4096, 1024, device=device, generator=gen) * 0.02
        ct = torch.randn(8192, 1024, device=device, generator=gen)

        def dense(x, w1, w2):
            return F.gelu(x.to(dtype) @ w1.to(dtype),
                          approximate="tanh") @ w2.to(dtype)

        def split(group, shards):
            def fn(x, w1, w2):
                h = group.f(x.to(dtype))
                return group.g([F.gelu(h @ a.to(dtype), approximate="tanh")
                                @ b.to(dtype) for a, b in zip(
                                    w1.chunk(shards, 1), w2.chunk(shards, 0))])
            return fn

        def run(fn):
            ins = [t.clone().requires_grad_() for t in (x, w1, w2)]
            y = fn(*ins)
            (y.float() * ct).sum().backward()
            return [y] + [t.grad for t in ins]

        want = run(dense)
        for tag, group, n in (
                ("local4", megatron.LocalTensorGroup(TP_SHARDS), TP_SHARDS),
                ("nccl1", megatron.ProcessTensorGroup(dist.group.WORLD), 1)):
            got = run(split(group, n))
            errs = [_rel_err(torch, g, w) for g, w in zip(got, want)]
            out[f"fg_{tag}_{name}"] = max(errs)
            if max(errs) > rtol:
                raise AssertionError(f"megatron f/g {tag} {name}: relative "
                                     f"errors (y, dx, dw1, dw2) {errs} over "
                                     f"{rtol}")
        # the vocab-parallel CE at the flagship's logits shape
        h = torch.randn(8, 1024, 1024, device=device, generator=gen)
        head = torch.randn(1024, 32768, device=device, generator=gen) * 0.03
        tgt = torch.randint(0, 32768, (8, 1024), device=device,
                            generator=gen)
        mask = torch.ones(8, device=device)

        def ce_dense(h, head):
            logits = (h.to(dtype) @ head.to(dtype)).float()
            return losses.softmax_cross_entropy(logits, tgt, mask)[0]

        def ce_split(h, head):
            group = megatron.LocalTensorGroup(TP_SHARDS)
            logits = megatron.vocab_parallel_logits(
                h, list(head.chunk(TP_SHARDS, 1)), group,
                compute_dtype=dtype)
            assert all(lg.dtype == torch.float32 for lg in logits)
            return megatron.vocab_parallel_cross_entropy(logits, tgt, mask,
                                                         group)[0]

        def ce_run(fn):
            ins = [t.clone().requires_grad_() for t in (h, head)]
            s = fn(*ins)
            s.backward()
            return [s.detach()] + [t.grad for t in ins]

        want = ce_run(ce_dense)
        got = ce_run(ce_split)
        errs = [_rel_err(torch, g, w) for g, w in zip(got, want)]
        out[f"vocab_ce_{name}"] = max(errs)
        if max(errs) > rtol:
            raise AssertionError(f"vocab-parallel CE {name}: relative errors "
                                 f"(loss, dh, dhead) {errs} over {rtol}")
        print(f"megatron {name}: f/g over LocalTensorGroup(4) and a 1-rank "
              f"NCCL ProcessTensorGroup against the dense FFN, largest "
              f"relative error {out[f'fg_local4_{name}']:.3g} / "
              f"{out[f'fg_nccl1_{name}']:.3g}; vocab-parallel CE over 4 "
              f"shards at (8, 1024, 32768) {out[f'vocab_ce_{name}']:.3g} "
              f"(loss {float(got[0]):.4f} vs {float(want[0]):.4f})",
              flush=True)
    return out


def tp_identity_runs(torch, device, attention="flash", tp=TP_SHARDS,
                     seq_size=1, vocab_parallel=False, n_layers=2, steps=3,
                     batch=8, matmul_dtype="bf16"):
    """Full width at ``n_layers`` layers, f32 with TF32 off, SGD-momentum:
    ``steps`` steps of the dense data-parallel step (over a
    ``LocalSeqGroup(seq_size)`` for a sequence-sharded attention) and of
    the tensor-parallel one over ``LocalTensorGroup(tp)`` (DP x TP, or
    sp_tp with the qkv columns permuted and ``vocab_parallel``) from the
    same params and batches; ``matmul_dtype`` int8 / fp8 quantizes both.
    Returns ((losses, params), (losses, params in the dense order), the
    flash launches of the tensor-parallel run, the initial params)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.datasets import (  # noqa: E501
        text_dataset,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (  # noqa: E501
        ShardedLoader,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
        optim,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        data_parallel as dp,
        gspmd,
        megatron,
        sequence as sq,
        spmd,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        world_setup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        tree_map,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(BIG, n_layers=n_layers, activation="gelu",
              pos_encoding="learned", attention=attention,
              matmul_dtype=matmul_dtype)
    data = text_dataset(TEXT_FILE, kw["max_seq_len"], kw["vocab_size"])
    world = world_setup(device)
    seq = sq.LocalSeqGroup(seq_size) if seq_size > 1 else None
    perm = (sq.striped_permutation(kw["max_seq_len"], seq_size)
            if attention.startswith("striped") else None)
    model = Transformer(TransformerConfig(**kw), device=device,
                        seq_group=seq)
    init = model.init(torch.Generator().manual_seed(SEED + 22))
    runs = []
    for tensor in (False, True):
        opt = optim.sgd(1e-2, 0.9, steps=steps)
        # a copy each: the update writes the params in place
        params = tree_map(lambda t: t.detach().clone(), init)
        if not tensor:
            step = dp.make_train_step(model, opt, world, "cross_entropy")
        elif seq is None:
            step = gspmd.make_gspmd_train_step(
                model, opt, world, megatron.LocalTensorGroup(tp),
                "cross_entropy")
        else:
            params = spmd.permute_params(model, params, tp)
            step = spmd.make_sp_tp_train_step(
                model, opt, world, megatron.LocalTensorGroup(tp), seq,
                "cross_entropy", vocab_parallel=vocab_parallel)
        state = TrainState.from_params(params, opt, model)
        loader = ShardedLoader(data, batch, device=device, shuffle=False,
                               seq_permutation=perm)
        fa.set_launch_counts()
        losses = []
        for _, b in zip(range(steps), loader.epoch(0)):
            state, loss = step(state, b)
            losses.append(float(loss))
        launches = fa.launch_counts()
        final = state.params
        if tensor and seq is not None:
            final = spmd.permute_params(model, final, tp, inverse=True)
        runs.append((losses, [p.detach() for p in flat_params(final)]))
    return runs[0], runs[1], launches, flat_params(init)


def check_tp_identity(torch, device, tag, bar=1e-6, **kw):
    """The tensor-parallel run against the dense one: losses to rtol 1e-5
    and params within ``bar`` (phase 12's tolerance: f32 on both sides,
    the row-parallel sums and the vocab-parallel CE reassociate only)."""
    (ld, pd), (lt, pt), launches, _ = tp_identity_runs(torch, device, **kw)
    loss_ok = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(lt, ld))
    worst = max(float((a - b).abs().max()) for a, b in zip(pt, pd))
    print(f"{tag}: losses {lt} vs {ld}; params max |diff| {worst:.3e}; "
          f"flash launches {launches['all']}, with_lse "
          f"{launches['with_lse']}", flush=True)
    if not (loss_ok and worst <= bar):
        raise AssertionError(f"{tag}: the tensor-parallel run differs from "
                             "the dense one")
    return dict(losses=lt, dense_losses=ld, param_max_abs_diff=worst,
                launches=launches)


def check_ulysses_blockwise(torch, device, shape=FLASH_SHAPE, seq_size=4):
    """(e) ulysses over ``LocalSeqGroup(4)`` and dense_blockwise against
    dense attention at T 1024, f32 (TF32 off): the output and the q, k, v
    gradients (``GRAD_TOL``); the forward+backward ms of each (CUDA
    events, median of 5)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        sequence as sq,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    q, k, v, do = (torch.randn(*shape, device=device, generator=gen)
                   for _ in range(4))
    group = sq.LocalSeqGroup(seq_size)
    impls = {"dense": lambda a, b, c: sq.attention_reference(a, b, c),
             "ulysses": lambda a, b, c: sq.ulysses_attention(a, b, c, group),
             "dense_blockwise": sq.attention_dense_blockwise}

    def fwd_bwd(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ins)
        (o * do).sum().backward()
        return [o.detach()] + [t.grad for t in ins]

    want = fwd_bwd(impls["dense"])
    rtol, atol = GRAD_TOL["torch.float32"]
    out = {}
    for name in ("ulysses", "dense_blockwise"):
        got = fwd_bwd(impls[name])
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        ok = all(bool(((g - w).abs() <= atol + rtol * w.abs()).all())
                 for g, w in zip(got, want))
        ms = median_ms(torch, lambda fn=impls[name]: fwd_bwd(fn), runs=5,
                       warmup=1)
        out[name] = dict(max_abs_err=errs, fwd_bwd_ms=ms)
        print(f"{name} f32 {shape} vs dense: largest |diff| (out, dq, dk, "
              f"dv) {errs}; forward+backward {ms:.2f} ms", flush=True)
        if not ok:
            raise AssertionError(f"{name} differs from dense attention")
    out["dense"] = dict(fwd_bwd_ms=median_ms(
        torch, lambda: fwd_bwd(impls["dense"]), runs=5, warmup=1))
    return out


def tensor_parallel_full_width(torch, np, device):
    """Phase 22: (a) the Megatron ops; (b) the flagship LM at full depth
    and width, DP x TP over ``LocalTensorGroup(4)``: 2 epochs eager, then
    2 at ``--steps_per_dispatch 13`` bitwise to them (B1-B3 12 x 4 per
    step, all sm90); (c) f32 DP x TP == dense DP at 2 layers; (d) DP x SP
    x TP, striped_flash over ``LocalSeqGroup(2)`` x ``LocalTensorGroup(2)``
    with ``--vocab_parallel`` at 2 layers (bf16 step, B5 2 x 4 x 2 per
    step) and its f32 identity with striped_flash without TP; (e)
    ulysses and dense_blockwise against dense, f32 at T 1024, and their
    bf16 steps at 2 layers."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        LocalSeqGroup,
    )

    t0 = time.perf_counter()
    out = {"ops": check_megatron_ops(torch, device)}
    tp_over = dict(tp=TP_SHARDS, ce_chunk=0)
    eager = train_full_width(torch, np, device,
                             tensor_group=LocalTensorGroup(TP_SHARDS),
                             keep_final="tree", tag="train dp x tp4",
                             **tp_over)
    graphed = dispatch_full_width(torch, np, device, eager,
                                  tensor_group=LocalTensorGroup(TP_SHARDS),
                                  exact=True, profile=False,
                                  tag="dispatch dp x tp4", **tp_over)
    del eager["final_params"]
    # phase 23 (c) reads the dense final params
    final_tree = eager.pop("final_tree")
    out["dp_tp"] = {k: eager[k] for k in (
        "step_ms_median", "tokens_per_s", "mfu", "peak_memory_gib",
        "launches", "launches_by_design", "first_loss", "last3_loss",
        "steps") if k in eager}
    out["dp_tp"]["profile_ms_per_step"] = eager.get("profile_ms_per_step")
    out["dp_tp_graphed"] = {k: graphed[k] for k in (
        "step_ms_median", "tokens_per_s", "mfu", "peak_memory_gib",
        "launches", "bitwise", "replays", "launches_per_replay")}
    out["identity_dp_tp"] = check_tp_identity(
        torch, device, "train f32 identity dp x tp4 == dp (2 layers, 3 "
        "steps)")
    sp_tp = train_full_width(torch, np, device, seq_group=LocalSeqGroup(2),
                             tensor_group=LocalTensorGroup(2), profile=False,
                             n_layers=CUT_LAYERS, attention="striped_flash",
                             sp=2, tp=2, vocab_parallel=True, ce_chunk=0,
                             tag="train sp2 x tp2 striped_flash "
                                 "vocab_parallel 2 layers")
    out["sp_tp"] = {k: sp_tp[k] for k in (
        "step_ms_median", "tokens_per_s", "peak_memory_gib", "launches",
        "with_lse_launches", "first_loss", "last3_loss", "steps")}
    out["identity_sp_tp"] = check_tp_identity(
        torch, device, "train f32 identity sp2 x tp2 striped_flash "
        "vocab_parallel == striped_flash (2 layers, 3 steps)",
        attention="striped_flash", tp=2, seq_size=2, vocab_parallel=True)
    out["ulysses_blockwise"] = check_ulysses_blockwise(torch, device)
    for attention, kw in (("ulysses", dict(seq_group=LocalSeqGroup(4),
                                           sp=4)),
                          ("dense_blockwise", {})):
        r = train_full_width(torch, np, device, profile=False,
                             n_layers=CUT_LAYERS, attention=attention,
                             tag=f"train {attention} 2 layers", **kw)
        out[f"train_{attention}"] = {k: r[k] for k in (
            "step_ms_median", "tokens_per_s", "peak_memory_gib",
            "first_loss", "last3_loss")}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 22: {out['seconds']:.1f} s", flush=True)
    return out, final_tree



# ---------------------------------------------------------------------------
# phase 23: the GSPMD layout's memory half (--fsdp, the sliced state) and
# the combinations held out of --tp until it (int8/fp8, sharded, the
# replica check, --generate)
# ---------------------------------------------------------------------------

# per rank of --tp 4, the flagship's params + Adam's mu and nu (f32): the
# 12 layers' qkv / ff_in / attn_out / ff_out slices and the head's vocab
# slice beside the whole embeddings and norms, worked out from the rules
TP4_VALUES = 80_837_632
# the quantized training's code-flip bounds (tests/test_torch_qmm.py):
# losses, and the params' change against the dense quantized step's
QUANT_LOSS_RTOL = {"int8": 1e-4, "fp8": 5e-4}
QUANT_UPDATE_RL2 = 1e-2


class _TensorRank:
    """Rank ``rank`` of a tensor process group of ``size``, as
    ``StateLayout`` reads it to slice (no collective is made)."""

    pg = None

    def __init__(self, size, rank):
        self.size, self.rank = size, rank


def quant_tp_full_width(torch, np, device, bf16_losses, **over):
    """(a) Phase 7's job at full width (``over``: its flags changed; the
    script cuts it to phase 15's 2 layers), DP x TP over
    ``LocalTensorGroup(4)``, int8 and fp8 (ce_chunk 0, as ``--tp``
    requires): one epoch eager (its products counted against tp x the
    dense step's design, one step profiled: no unquantized product) and
    one graphed (k 13, bitwise to eager); B1-B3 4 x n_layers a step, all
    sm90; the largest |loss - bf16 loss| over the epoch (``bf16_losses``:
    phase 15's DP run at the same depth).  Then the f32 identity at 2
    layers: the TP quantized step within the code-flip bounds of the
    dense quantized step."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )

    cuda = device.type == "cuda"
    out = {}
    for fmt in ("int8", "fp8"):
        flags = dict(over, tp=TP_SHARDS, ce_chunk=0, matmul_dtype=fmt,
                     nepochs=1)
        cfg = config_from_args(build_argparser().parse_args(
            train_flags(**flags)))
        per_step = TP_SHARDS * quant_step_design(cfg)
        inspect = ((lambda t, f=fmt: profile_quant_step(torch, t, f,
                                                         per_step))
                   if cuda else None)
        run = train_full_width(torch, np, device, keep_final=True,
                               profile=False, inspect=inspect,
                               tensor_group=LocalTensorGroup(TP_SHARDS),
                               tag=f"tp4 quant {fmt}", **flags)
        want = {"int8": 0, "fp8": 0}
        want[fmt] = per_step * run["steps"] if cuda else 0
        if run["gemm_launches"] != want:
            raise AssertionError(f"tp4 quant {fmt}: products "
                                 f"{run['gemm_launches']}, by design {want}")
        delta = max(abs(a - b) for a, b in zip(run["losses"], bf16_losses))
        res = dict(losses=[round(x, 4) for x in run["losses"]],
                   max_abs_loss_diff_vs_bf16=delta,
                   gemm_launches=run["gemm_launches"],
                   products_per_step=per_step, launches=run["launches"],
                   **{k: run[k] for k in ("step_ms_median", "tokens_per_s",
                                          "peak_memory_gib",
                                          "profiled_products",
                                          "profiled_plain_products",
                                          "gemm_kernels") if k in run})
        if cuda:
            graphed = dispatch_full_width(
                torch, np, device, run, exact=True, profile=False,
                tensor_group=LocalTensorGroup(TP_SHARDS),
                tag=f"tp4 quant {fmt} dispatch", **flags)
            res.update(graphed_step_ms_median=graphed["step_ms_median"],
                       graphed_step_ms_from=graphed["step_ms_from"],
                       graphed_tokens_per_s=graphed["tokens_per_s"],
                       graphed_peak_memory_gib=graphed["peak_memory_gib"],
                       graphed_bitwise=graphed["bitwise"],
                       graphed_launches=graphed["launches"])
            print(f"tp4 quant {fmt}: step {run['step_ms_median']:.2f} ms "
                  f"eager, {graphed['step_ms_median']:.2f} ms graphed (one "
                  f"replay's device time); "
                  f"{run['tokens_per_s']:.0f} tokens/s eager; peak memory "
                  f"{run['peak_memory_gib']:.2f} GiB; largest |loss - bf16 "
                  f"loss| {delta:.4f}", flush=True)
        (ld, pd), (lt, pt), _, p0 = tp_identity_runs(torch, device,
                                                     matmul_dtype=fmt)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lt, ld))
        num = sum(float(((a - b).double() ** 2).sum())
                  for a, b in zip(pt, pd))
        den = sum(float(((b - z.to(b.device)).double() ** 2).sum())
                  for b, z in zip(pd, p0))
        update_rl2 = (num / den) ** 0.5
        res.update(identity_loss_rel=loss_rel, identity_update_rl2=update_rl2)
        print(f"tp4 quant {fmt} f32 identity (2 layers, 3 steps): losses "
              f"{lt} vs dense {ld} (largest relative {loss_rel:.2e}, bound "
              f"{QUANT_LOSS_RTOL[fmt]}); params' change {update_rl2:.2e} "
              f"relative (bound {QUANT_UPDATE_RL2})", flush=True)
        if loss_rel > QUANT_LOSS_RTOL[fmt] or update_rl2 > QUANT_UPDATE_RL2:
            raise AssertionError(f"tp4 quant {fmt}: the TP quantized step "
                                 "is outside the code-flip bounds of the "
                                 "dense quantized step")
        out[fmt] = res
        del run
    return out


def _trainer(torch, device, steps=None, **over):
    """A Trainer of ``train_flags(**over)`` (its extra keywords:
    ``seq_group``, ``tensor_group``, ``fsdp_group``), its
    seeded state and, with ``steps``, that many eager steps of its first
    epoch (their losses in ``trainer.losses``)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.trainer import (  # noqa: E501
        Trainer,
    )

    groups = {k: over.pop(k) for k in ("seq_group", "tensor_group",
                                       "fsdp_group", "expert_group")
              if k in over}
    trainer = Trainer(config_from_args(build_argparser().parse_args(
        train_flags(**over))), device=device, **groups)
    trainer.init_state()
    trainer.losses = []
    for _, batch in zip(range(steps or 0), trainer.loader.epoch(0)):
        trainer.state, loss = trainer.train_step(trainer.state, batch)
        trainer.losses.append(float(loss))
    return trainer


F32_2L = dict(n_layers=CUT_LAYERS, dtype="float32", compute_dtype="float32",
              optimizer="sgd", lr=1e-2, momentum=0.9, ce_chunk=0)


FSDP_SLICES = 4


def fsdp_on_card(torch, np, device):
    """(b) ``--fsdp 4`` on the card over a local fsdp group: each leaf the
    rules split on an fsdp dim held as its 4 slices, stacked, joined
    where its block uses it and its gradient split back into them.  At 2
    layers, f32 with TF32 off, 3 SGD steps: params within 1e-6 of the
    replicated DP step's; then the bf16 step at full width, 2 layers, one
    epoch eager and one graphed (k 13, bitwise)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.fsdp import (  # noqa: E501
        LocalFsdpGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    one_rank_group(torch, device)
    dense = _trainer(torch, device, steps=3, **F32_2L)
    fsdp = _trainer(torch, device, steps=3, fsdp=FSDP_SLICES,
                    fsdp_group=LocalFsdpGroup(FSDP_SLICES), **F32_2L)
    lay = fsdp.state_layout
    held = leaves(fsdp.state.params)
    split = [j for j, st in enumerate(lay.stored) if st.fsdp is not None]
    stacked = all(held[j].shape[0] == FSDP_SLICES
                  and held[j].dim() == len(lay.shapes[j]) + 1
                  for j in split)
    split_values = sum(held[j].numel() for j in split)
    whole_values = sum(x.numel() for x in held)
    if fsdp.layout_tag != "gspmd" or not split or not stacked:
        raise AssertionError(f"fsdp: layout {fsdp.layout_tag}, "
                             f"{len(split)} leaves held as stacked slices")
    worst = max(float((a - b).abs().max()) for a, b in zip(
        flat_params(fsdp.whole_params()), flat_params(dense.state.params)))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fsdp.losses,
                                                       dense.losses))
    print(f"fsdp f32 identity (2 layers, 3 steps, a local fsdp group of "
          f"{FSDP_SLICES}: {len(split)} of {len(held)} leaves held as "
          f"{FSDP_SLICES} stacked slices, {split_values:,} of "
          f"{whole_values:,} values): losses {fsdp.losses} vs "
          f"{dense.losses}; params max |diff| {worst:.3e}", flush=True)
    if worst > 1e-6 or loss_rel > 1e-5:
        raise AssertionError("fsdp: the f32 step differs from the "
                             "replicated DP step")
    del dense, fsdp
    torch.backends.cuda.matmul.allow_tf32 = tf32
    over = dict(n_layers=CUT_LAYERS, ce_chunk=0, fsdp=FSDP_SLICES)
    eager = train_full_width(torch, np, device, keep_final=True,
                             profile=False,
                             fsdp_group=LocalFsdpGroup(FSDP_SLICES),
                             tag="fsdp4 bf16 2 layers", **over)
    out = dict(identity_params_max_abs_diff=worst,
               identity_loss_rel=loss_rel, split_leaves=len(split),
               split_values=split_values, whole_values=whole_values,
               **{k: eager[k] for k in ("step_ms_median", "tokens_per_s",
                                        "peak_memory_gib", "launches")
                  if k in eager})
    if device.type == "cuda":
        graphed = dispatch_full_width(
            torch, np, device, eager, exact=True, profile=False,
            fsdp_group=LocalFsdpGroup(FSDP_SLICES),
            tag="fsdp4 bf16 2 layers dispatch", **over)
        out.update(graphed_step_ms_median=graphed["step_ms_median"],
                   graphed_bitwise=graphed["bitwise"],
                   graphed_launches=graphed["launches"])
    return out


def sliced_state_on_card(torch, device, dense_tree):
    """(c) Tensor rank 0's slices of ``--tp 4`` built on the card from the
    flagship's params (phase 22's final dense tree): the params and
    Adam's mu and nu, ``torch.cuda.memory_allocated``'s growth against
    the 0.97 GB worked out from the rules (80,837,632 values x 12 bytes);
    then every rank's slices joined as a snapshot gathers them, bitwise
    the dense params."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.registry import (  # noqa: E501
        build_model,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        optim,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        tensor_parallel as tp_lib,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves, tree_map,
    )

    model = build_model(config_from_args(build_argparser().parse_args(
        train_flags(tp=TP_SHARDS, ce_chunk=0))).model, device=device)
    layouts = [tp_lib.state_layout(model, dense_tree,
                                   _TensorRank(TP_SHARDS, r))
               for r in range(TP_SHARDS)]
    host = [lay.local(dense_tree) for lay in layouts]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device) if cuda else 0
    params = tree_map(lambda t: t.to(device), host[0])
    opt = optim.adam(1e-3, steps=1).init(params)
    if cuda:
        torch.cuda.synchronize()
    grown = (torch.cuda.memory_allocated(device) - before) if cuda else 0
    values = sum(t.numel() for t in leaves(params))
    slots = sum(x.numel() for x in leaves(opt) if x.dim())
    want = TP4_VALUES * 12
    del params, opt
    joined = [layouts[0].join_leaf([leaves(h)[j] for h in host], j)
              for j in range(len(layouts[0].specs))]
    dense = leaves(dense_tree)
    bitwise = len(joined) == len(dense) and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(joined, dense))
    whole = sum(t.numel() for t in dense)
    print(f"sliced state, tensor rank 0 of --tp 4: {values:,} param values "
          f"+ {slots:,} in mu and nu (of {whole:,} whole); "
          f"memory_allocated grew {grown / 1e9:.4f} GB against "
          f"{want / 1e9:.4f} GB worked out ({whole * 12 / 1e9:.2f} GB "
          f"whole); the 4 ranks' slices joined: bitwise the dense params "
          f"{bitwise}", flush=True)
    if values != TP4_VALUES or slots != 2 * TP4_VALUES or not bitwise or (
            cuda and not want <= grown < want + 64 * 2 ** 20):
        raise AssertionError("sliced state: the counts, the memory or the "
                             "join differ from the rules'")
    return dict(param_values=values, slot_values=slots, whole_values=whole,
                memory_grown_bytes=grown, worked_out_bytes=want,
                gathered_bitwise=bitwise)


def _state_bits(torch, trainer):
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    s = trainer.state
    return [t.detach().cpu() for t in leaves((s.params, s.opt_state))]


def sharded_under_tp(torch, device, ck, after_save=None):
    """(d) ``--update_sharding sharded`` under ``--tp 4`` at 2 layers (one
    card: one data rank, so the plans split nothing): bitwise to the
    replicated update over 3 steps.  And a ``qkv_tp`` 2 snapshot (``--sp
    2 --tp 2`` striped_flash, Adam) resumed under ``--tp 4 --update_sharding
    sharded``: params and every optimizer slot re-permuted into the dense
    order, bitwise the saver's state de-permuted.  The snapshot is written
    first and ``after_save()`` runs then, so what it starts runs beside
    the rest.  Returns (the result, the saver's
    params de-permuted on the card: (f)'s reference)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        spmd,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        LocalSeqGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    over = dict(n_layers=CUT_LAYERS, tp=TP_SHARDS, ce_chunk=0)
    # lr 1e-5: the params stay near the seeded init, so (f)'s sampled
    # tokens spread over the vocabulary (at 1e-3 three steps collapse
    # them onto one frequent byte, whatever the qkv order)
    saver = _trainer(torch, device, steps=3, checkpoint_dir=ck,
                     n_layers=CUT_LAYERS, sp=2, tp=2, ce_chunk=0, lr=1e-5,
                     attention="striped_flash",
                     seq_group=LocalSeqGroup(2),
                     tensor_group=LocalTensorGroup(2))
    saver.save(final=True)
    if after_save is not None:
        after_save()

    def dense(tree):     # the qkv columns back in the dense order
        return (spmd.permute_params(saver.model, tree, 2, inverse=True)
                if isinstance(tree, dict) else tree)

    opt = saver.state.opt_state
    ref = dense(saver.state.params)
    want = [t.detach().cpu() for t in leaves((
        ref, type(opt)(*map(dense, opt))))]
    del saver, opt
    runs = {}
    for layout in ("replicated", "sharded"):
        t = _trainer(torch, device, steps=3, update_sharding=layout,
                     tensor_group=LocalTensorGroup(TP_SHARDS), **over)
        runs[layout] = (t.losses, _state_bits(torch, t), t.layout_tag)
        del t
    bitwise = runs["replicated"][0] == runs["sharded"][0] and _same_bits(
        torch, runs["replicated"][1], runs["sharded"][1])
    t = _trainer(torch, device, update_sharding="sharded", resume=True,
                 checkpoint_dir=ck, tensor_group=LocalTensorGroup(TP_SHARDS),
                 **over)
    t.maybe_resume()
    resumed = _same_bits(torch, _state_bits(torch, t), want)
    del t
    print(f"sharded under tp4 (2 layers, 3 steps): {runs['sharded'][2]} "
          f"bitwise to {runs['replicated'][2]} {bitwise}; a qkv_tp 2 "
          f"snapshot (sp 2 x tp 2, Adam) resumed under --tp 4 "
          f"--update_sharding sharded: params and mu, nu re-permuted, "
          f"bitwise the saver's de-permuted {resumed}", flush=True)
    if not (bitwise and resumed):
        raise AssertionError("sharded under tp: not bitwise")
    return dict(bitwise_to_replicated=bitwise,
                qkv_tp_resume_bitwise=resumed), ref


def replica_check_under_tp(torch, np, device):
    """(e) The replica check under ``--tp 4`` at 2 layers, two replicas
    on the card (phase 21's way): the fingerprint kernel over the leaves
    the layout holds replicated (JAX's ``Fingerprinter``'s), kernel ==
    plain version bitwise; a bit flipped in a whole leaf of replica 1 is
    seen, localized and healed; one flipped in a sliced leaf (a qkv
    weight) leaves the digest as it was, unchecked as in JAX."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        fingerprint as fp,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        consistency,
        faults,
    )

    t = _trainer(torch, device, steps=1, n_layers=CUT_LAYERS, tp=TP_SHARDS,
                 ce_chunk=0, tensor_group=LocalTensorGroup(TP_SHARDS))
    fpr = consistency.Fingerprinter(t.state, skip=t._unreplicated())
    names = fpr.paths
    first = fp.fingerprint.launches
    rep0 = [x.detach() for x in fpr.leaves(t.state)]
    rep1 = [x.clone() for x in rep0]
    kernel_ok = torch.equal(fp.fingerprint(rep0)[0].cpu(),
                            fp.fingerprint_reference(rep0)[0].cpu())

    def chained(tensors):
        return int(fp.fingerprint(tensors)[0][-1])

    base = chained(rep0)
    victim = next(i for i, n in enumerate(names) if "['ln1']" in n)
    faults.flip_bit_in_shard(rep1[victim], 0, 9)
    mat = np.stack([consistency.leaf_digest_array(rep0),
                    consistency.leaf_digest_array(rep1)])
    chains = np.array([[fp.chain(mat[0].tolist()),
                        fp.chain(mat[1].tolist())]], np.uint32)
    before = consistency.digest_report(chains)
    report = consistency.localize(names, mat, lambda j: [rep0[j], rep1[j]],
                                  ["replica0", "replica1"])
    consistency.heal_replication(
        [dict(enumerate(rep0)), dict(enumerate(rep1))],
        {f"[{victim}]": report[names[victim]]})
    healed = _same_bits(torch, rep1, rep0) and chained(rep1) == base
    qkv = t.state.params["blocks"][0]["qkv"]["w"]
    unchecked = not any("['qkv']['w']" in n for n in names)
    faults.flip_bit_in_shard(qkv, 0, 9)
    sliced_silent = chained(fpr.leaves(t.state)) == base
    faults.flip_bit_in_shard(qkv, 0, 9)
    launches = fp.fingerprint.launches - first
    print(f"replica check under tp4 (2 layers): {len(names)} replicated "
          f"leaves of {len(consistency.replicated_leaves(t.state))} "
          f"fingerprinted, kernel == plain {kernel_ok}; a flip in "
          f"{names[victim]}: verdict {before}, localized "
          f"{list(report)}, healed {healed}; a flip in a qkv weight (sliced, "
          f"not fingerprinted {unchecked}): digest unchanged {sliced_silent}; "
          f"fingerprint launches {launches}", flush=True)
    if not (kernel_ok and before.get("local") == [0]
            and list(report) == [names[victim]] and healed and unchecked
            and sliced_silent):
        raise AssertionError("replica check under tp: a verdict differs")
    return dict(leaves=len(names), localized=list(report), healed=healed,
                sliced_leaf_unchecked=sliced_silent, launches=launches)


# sampled (the seed's draws): every logit shapes the tokens
GENERATE_FLAGS = ["--generate", ",".join(map(str, PROMPT)),
                  "--max_new_tokens", "16", "--temperature", "1.0"]


def start_generate_under_tp(ck):
    """(f) ``--generate`` under ``--tp 4`` through the CLI from (d)'s
    ``qkv_tp`` 2 snapshot, beside the same command without ``--tp``,
    sampled at temperature 1 from the seed; the two processes start here
    and run beside (d) and (e)."""
    flags = train_flags(checkpoint_dir=ck, n_layers=CUT_LAYERS, ce_chunk=0)
    return [subprocess.Popen([sys.executable, "-m", PKG, *flags,
                              *GENERATE_FLAGS,
                              *extra], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             cwd=str(REPO_ROOT))
            for extra in ([], ["--tp", str(TP_SHARDS)])]


def reference_decode(torch, device, params, **over):
    """(f)'s reference: the CLI's decode of :data:`GENERATE_FLAGS` run in
    this process on ``params``, the saver's live params de-permuted, not
    read back from the snapshot (``over``: more model flags, e.g. an MoE
    model's, or its depth)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.config import (
        build_argparser, config_from_args,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate import (  # noqa: E501
        generate,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.registry import (  # noqa: E501
        build_model,
    )

    args = build_argparser().parse_args(train_flags(
        **dict(dict(n_layers=CUT_LAYERS, ce_chunk=0), **over))
        + GENERATE_FLAGS)
    cfg = config_from_args(args)
    model = build_model(cfg.model, device=device)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    out = generate(model, params, [PROMPT], args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, generator=generator,
                   prefill_chunk=args.prefill_chunk, device=device)
    return [int(t) for t in out[0].tolist()]


def generate_under_tp(procs, reference):
    """(f) The two ``--generate`` processes' tokens: the same (both
    reconcile the snapshot into dense params and decode on one card), and
    those of ``reference`` (:func:`reference_decode`), so the snapshot's
    qkv columns were put back in the dense order; at least half of the 16
    sampled tokens distinct, so a wrong order could not print the same
    ones."""
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"--generate: rc {p.returncode}\n"
                                 f"{o[-2000:]}\n{e[-2000:]}")
    ids = [[int(x) for x in o.strip().splitlines()[-1].split(",")]
           for o, _ in outs]
    new = ids[1][len(PROMPT):]
    distinct = len(set(new))
    print(f"generate --tp 4 (sampled, 16 tokens from a qkv_tp 2 snapshot): "
          f"{new}; without --tp {ids[0][len(PROMPT):]}; the saver's live "
          f"params {reference[len(PROMPT):]}; equal {ids[0] == ids[1]} / "
          f"{ids[1] == reference}; {distinct} distinct", flush=True)
    if ids[0] != ids[1] or len(ids[0]) != len(PROMPT) + 16:
        raise AssertionError("--generate --tp 4 differs from --generate")
    if ids[1] != reference:
        raise AssertionError("--generate --tp 4 differs from the decode of "
                             "the saver's own params")
    if distinct < 8:
        raise AssertionError(f"--generate: {distinct} distinct tokens of "
                             "16, too few to tell the qkv orders apart")
    return dict(tokens=new, equal=True, equal_to_reference=True,
                distinct=distinct)


def gspmd_memory_half(torch, np, device, short, tp_final):
    """Phase 23: (a)-(f) above; its seconds.  ``short``: phase 15's bf16
    run at 2 layers, (a)'s reference."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    t0 = time.perf_counter()
    marks = [t0]

    def mark():
        marks.append(time.perf_counter())

    out = {"quant_tp": quant_tp_full_width(torch, np, device,
                                           short["losses"],
                                           n_layers=CUT_LAYERS)}
    mark()
    out["fsdp"] = fsdp_on_card(torch, np, device)
    mark()
    out["sliced_state"] = sliced_state_on_card(torch, device, tp_final)
    mark()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            out["sharded_tp"], ref = sharded_under_tp(
                torch, device, tmp,
                after_save=lambda: procs.extend(start_generate_under_tp(
                    tmp)))
            reference = reference_decode(torch, device, ref)
            del ref
            mark()
            out["replica_check_tp"] = replica_check_under_tp(torch, np,
                                                             device)
            mark()
            out["generate_tp"] = generate_under_tp(procs, reference)
            mark()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    # (f)'s processes run beside (d) and (e): its seconds are its wait
    out["seconds_by_part"] = dict(zip("abcdef", np.diff(marks).round(1)
                                      .tolist()))
    # B1-B3 of the main path's runs: (a) eager and graphed, (b)
    launches = {w: 0 for w in fa.COUNTERS}
    for run in (out["quant_tp"]["int8"], out["quant_tp"]["fp8"],
                out["fsdp"]):
        for key in ("launches", "graphed_launches"):
            for w in fa.COUNTERS:
                launches[w] += run.get(key, {}).get(w, 0)
    out["flash_launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 23: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 24: pipeline parallelism (--pp, --pp_interleave); one card runs the
# stages of a LocalPipeGroup in this process, one after the other
# ---------------------------------------------------------------------------

PIPE_STAGES = 4


def pipe_identity_runs(torch, device, pipe=2, interleave=1, n_layers=2,
                       steps=3, batch=8, attention="flash", seq_size=1):
    """Full width at ``n_layers`` layers, f32 with TF32 off, SGD-momentum:
    ``steps`` steps of the dense data-parallel step (over a
    ``LocalSeqGroup(seq_size)`` for a sequence-sharded attention) and of
    the pipeline step over ``LocalPipeGroup(pipe)`` (``interleave``
    virtual stages per stage), from the same params and batches.
    Returns ((losses, params), (losses, params in the dense per-layer
    order), the pipeline run's flash launches)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.datasets import (  # noqa: E501
        text_dataset,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (  # noqa: E501
        ShardedLoader,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
        optim,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        data_parallel as dp,
        pipeline as pp,
        sequence as sq,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        world_setup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        tree_map,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(BIG, n_layers=n_layers, activation="gelu",
              pos_encoding="learned", attention=attention)
    data = text_dataset(TEXT_FILE, kw["max_seq_len"], kw["vocab_size"])
    world = world_setup(device)
    seq = sq.LocalSeqGroup(seq_size) if seq_size > 1 else None
    perm = (sq.striped_permutation(kw["max_seq_len"], seq_size)
            if attention.startswith("striped") else None)
    model = Transformer(TransformerConfig(**kw), device=device,
                        seq_group=seq)
    init = model.init(torch.Generator().manual_seed(SEED + 24))
    runs = []
    for piped in (False, True):
        opt = optim.sgd(1e-2, 0.9, steps=steps)
        # a copy each: the update writes the params in place
        params = tree_map(lambda t: t.detach().clone(), init)
        if piped:
            params = dict(params, blocks=pp.to_pipeline_blocks(
                params["blocks"], model.cfg, pipe, 1, interleave))
            step = pp.make_pipeline_train_step(
                model, opt, world, pp.LocalPipeGroup(pipe), "cross_entropy",
                interleave=interleave)
        else:
            step = dp.make_train_step(model, opt, world, "cross_entropy")
        state = TrainState.from_params(params, opt, model)
        loader = ShardedLoader(data, batch, device=device, shuffle=False,
                               seq_permutation=perm)
        fa.set_launch_counts()
        losses = []
        for _, b in zip(range(steps), loader.epoch(0)):
            state, loss = step(state, b)
            losses.append(float(loss))
        launches = fa.launch_counts()
        final = state.params
        if piped:
            final = dict(final, blocks=pp.dense_layer_blocks(final["blocks"]))
        runs.append((losses, [p.detach() for p in flat_params(final)]))
    return runs[0], runs[1], launches


def check_pipe_identity(torch, device, tag, bar=1e-6, **kw):
    """The pipeline run against the dense one: losses to rtol 1e-5 and
    params within ``bar`` (f32 on both sides: the microbatches' gradient
    sums reassociate only); its flash launches, on the simt kernels in
    f32, one set per layer, microbatch and ring block."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    (ld, pd), (lp, pp_), launches = pipe_identity_runs(torch, device, **kw)
    loss_ok = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(lp, ld))
    worst = max(float((a - b).abs().max()) for a, b in zip(pp_, pd))
    n_layers, steps = kw.get("n_layers", 2), kw.get("steps", 3)
    seq_size = kw.get("seq_size", 1)
    blocks = ring_blocks(kw.get("attention", "flash"), seq_size)
    expect = (n_layers * blocks * kw.get("pipe", 2) * steps
              if device.type == "cuda" else 0)
    want = {"all": dict.fromkeys(fa.COUNTERS, expect),
            "with_lse": expect if seq_size > 1 else 0}
    got = {"all": launches["all"], "with_lse": launches["with_lse"]}
    print(f"{tag}: losses {lp} vs {ld}; params max |diff| {worst:.3e}; "
          f"flash launches {launches['all']} (simt {launches['simt']}), "
          f"with_lse {launches['with_lse']}; expected {want}", flush=True)
    if not (loss_ok and worst <= bar):
        raise AssertionError(f"{tag}: the pipeline run differs from the "
                             "dense one")
    if got != want:
        raise AssertionError(f"{tag}: flash launches {got}, expected {want}")
    return dict(losses=lp, dense_losses=ld, param_max_abs_diff=worst,
                launches=launches["all"], with_lse=launches["with_lse"])


def start_generate_from_pipe(ck):
    """(f) ``--generate`` through the CLI from the ``--pp 2 --tp 2``
    snapshot (the mesh flags accepted and ignored, as JAX's CLI), sampled
    at temperature 1 from the seed; the process starts here and runs
    beside (a)-(e)."""
    flags = train_flags(checkpoint_dir=ck, n_layers=CUT_LAYERS, ce_chunk=0,
                        pp=2, tp=2)
    return subprocess.Popen([sys.executable, "-m", PKG, *flags,
                             *GENERATE_FLAGS], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=str(REPO_ROOT))


def generate_from_pipe(proc, reference, what="a --pp 2 --tp 2 snapshot"):
    """(f) The ``--generate`` process's tokens against ``reference``
    (:func:`reference_decode` of the saver's live params, unstacked and
    de-permuted in this process), at least half of the 16 distinct;
    ``what`` names the snapshot (phase 25 (e) reads its MoE one here)."""
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"--generate from {what}: rc "
                             f"{proc.returncode}\n{out[-2000:]}\n"
                             f"{err[-2000:]}")
    ids = [int(x) for x in out.strip().splitlines()[-1].split(",")]
    new = ids[len(PROMPT):]
    distinct = len(set(new))
    print(f"generate from {what} (sampled, 16 tokens): "
          f"{new}; the saver's live params {reference[len(PROMPT):]}; "
          f"equal {ids == reference}; {distinct} distinct", flush=True)
    if ids != reference or len(ids) != len(PROMPT) + 16:
        raise AssertionError(f"--generate from {what} differs from "
                             "the decode of the saver's own params")
    if distinct < 8:
        raise AssertionError(f"--generate: {distinct} distinct tokens of "
                             "16, too few to tell the layouts apart")
    return dict(tokens=new, equal=True, distinct=distinct)


def pipeline_full_width(torch, np, device):
    """Phase 24: (f)'s snapshot (2 layers, ``--pp 2 --tp 2`` over local
    groups, 3 Adam steps at lr 1e-5: near the init) and its ``--generate``
    process first, beside the rest; (a) f32 identities: ``--pp 2`` at 2
    layers and ``--pp 2 --pp_interleave 2`` at 4 layers == the dense DP
    step within 1e-6; (b) phase 7's job at 12 layers under ``--pp 4``
    over ``LocalPipeGroup(4)``, one epoch eager (the 1-nat check, step
    ms, tokens/s, peak memory, B1-B3 12 x 4 a step all on sm90, a
    profile) and one at ``--steps_per_dispatch 13``, bitwise to it; (c)
    ``--pp 4 --pp_interleave 3``; (d) ``--pp 2`` x ``LocalTensorGroup(2)``
    at 12 layers; (e) ``--pp 2`` x ``LocalSeqGroup(2)`` with
    ``striped_flash`` at 2 layers (B5 2 x 2^2 x 2 a step) and its f32
    identity to the dense striped_flash step; (f) the tokens."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        pipeline as pp,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        LocalSeqGroup,
    )

    t0 = time.perf_counter()
    out = {}
    keys = ("step_ms_median", "tokens_per_s", "mfu", "peak_memory_gib",
            "launches", "launches_by_design", "with_lse_launches",
            "first_loss", "last3_loss", "steps", "profile_ms_per_step")
    proc = None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            saver = _trainer(torch, device, steps=3, checkpoint_dir=tmp,
                             n_layers=CUT_LAYERS, pp=2, tp=2, ce_chunk=0,
                             lr=1e-5, tensor_group=LocalTensorGroup(2))
            saver.save(final=True)
            proc = start_generate_from_pipe(tmp)
            params = dict(saver.state.params, blocks=pp.dense_layer_blocks(
                saver.state.params["blocks"], saver.model.cfg, 2))
            reference = reference_decode(torch, device, params)
            del saver, params
            out["identity_pp2"] = check_pipe_identity(
                torch, device, "pipe f32 identity --pp 2 == dp (2 layers, "
                "3 steps)", pipe=2)
            out["identity_pp2_interleave2"] = check_pipe_identity(
                torch, device, "pipe f32 identity --pp 2 --pp_interleave 2 "
                "== dp (4 layers, 3 steps)", pipe=2, interleave=2,
                n_layers=4)
            pp4 = dict(pp=PIPE_STAGES, nepochs=1)
            eager = train_full_width(
                torch, np, device, keep_final=True, tag="train pp4", **pp4)
            graphed = dispatch_full_width(
                torch, np, device, eager, exact=True, profile=False, tag="dispatch pp4", **pp4)
            del eager["final_params"]
            out["pp4"] = {k: eager[k] for k in keys if k in eager}
            out["pp4_graphed"] = {k: graphed[k] for k in (
                "step_ms_median", "step_ms_from", "tokens_per_s", "mfu",
                "peak_memory_gib", "launches", "bitwise", "replays",
                "launches_per_replay")}
            inter = train_full_width(
                torch, np, device, profile=False,
                tag="train pp4 interleave 3",
                pp_interleave=3, **pp4)
            out["pp4_interleave3"] = {k: inter[k] for k in keys if k in inter}
            pp_tp = train_full_width(
                torch, np, device, tensor_group=LocalTensorGroup(2),
                profile=False, tag=f"train pp2 x tp2 {CUT_LAYERS} layers",
                pp=2, tp=2, nepochs=1, n_layers=CUT_LAYERS)
            out["pp2_tp2"] = {k: pp_tp[k] for k in keys if k in pp_tp}
            pp_sp = train_full_width(
                torch, np, device, seq_group=LocalSeqGroup(2),
                profile=False,
                n_layers=CUT_LAYERS, attention="striped_flash", sp=2, pp=2,
                tag="train pp2 x sp2 striped_flash 2 layers")
            out["pp2_sp2"] = {k: pp_sp[k] for k in keys if k in pp_sp}
            out["identity_pp2_sp2"] = check_pipe_identity(
                torch, device, "pipe f32 identity --pp 2 x sp2 "
                "striped_flash == striped_flash (2 layers, 3 steps)",
                pipe=2, attention="striped_flash", seq_size=2)
            out["generate"] = generate_from_pipe(proc, reference)
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    # B1-B3 and B5 of the main path's runs: (b) eager and graphed, (c),
    # (d), (e)
    runs = (out["pp4"], out["pp4_graphed"], out["pp4_interleave3"],
            out["pp2_tp2"], out["pp2_sp2"])
    out["flash_launches"] = {w: sum(r["launches"][w] for r in runs)
                             for w in out["pp4"]["launches"]}
    out["with_lse_launches"] = out["pp2_sp2"]["with_lse_launches"]
    out["bubble_fraction"] = {
        "pp4": pp.bubble_fraction(PIPE_STAGES, PIPE_STAGES),
        "pp4_interleave3": pp.bubble_fraction(PIPE_STAGES, PIPE_STAGES, 3),
        "pp2": pp.bubble_fraction(2, 2)}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 24: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 25: MoE and expert parallelism
# ---------------------------------------------------------------------------

MOE_EXPERTS = 8      # bench.py's _MOE_EXPERTS: the Switch top-1 LM
EP_SHARDS = 4
MOE_FLAGS = dict(moe_experts=MOE_EXPERTS)
# the card-vs-host identities of (d): 2 layers at full width, T 128
MOE_HOST = dict(n_layers=CUT_LAYERS, seq_len=128, batch_size=4,
                n_samples=12, nepochs=1, dtype="float32",
                compute_dtype="float32", optimizer="sgd", lr=1e-2,
                momentum=0.9, ce_chunk=0, attention="flash", **MOE_FLAGS)
MOE_HOST_JOBS = {"sp2_ep2_striped_flash": dict(sp=2, ep=2,
                                               attention="striped_flash"),
                 # EP x TP runs Megatron attention over the whole local
                 # sequence: dense, as JAX's step
                 "ep2_tp2": dict(ep=2, tp=2, attention="dense")}
MOE_HOST_STEPS = 3


def _moe_layer_inputs(torch, device, dtype, top_k, seed=SEED + 25):
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.moe import (  # noqa: E501
        MoEFFN,
    )

    b = BIG
    layer = MoEFFN(b["d_model"], b["d_ff"], MOE_EXPERTS, router_top_k=top_k,
                   compute_dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = layer.init(gen, device)
    x = torch.randn((8, b["max_seq_len"], b["d_model"]), generator=gen,
                    device=device)
    ct = torch.randn(x.shape, generator=gen, device=device)
    return layer, params, x.to(dtype), ct


def _moe_fwd_bwd(torch, fn, layer, params, x, ct):
    """(y, aux, dx, dparams) of sum(y * ct) + sum(aux) through ``fn``."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves, tree_map,
    )

    ps = tree_map(lambda t: t.detach().requires_grad_(), params)
    xx = x.detach().requires_grad_()
    y, aux = fn(layer, ps, xx)
    ((y.float() * ct).sum() + aux.sum()).backward()
    return y.detach(), aux.detach(), xx.grad, [p.grad for p in leaves(ps)]


def check_moe_layer(torch, device):
    """(a) One MoE layer at the flagship shape (d 1024, f 4096, 8
    experts, 8 x 1024 tokens), forward and backward: the index dispatch
    and combine against the one-hot einsum form, f32 (TF32 off) top-1
    and bf16 top-1 (outputs bitwise), f32 top-2 (within 1e-6 of the
    outputs' largest magnitude); every gradient
    within 1e-5 relative in f32 (the combine weight's gradient is a
    length-d dot product the einsum reduces in another order); the time
    of each form, forward and forward + backward, in bf16, beside the
    expert FFN's alone."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.moe import (  # noqa: E501
        _join_groups, dispatch_combine_onehot,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    index = lambda layer, p, x: layer.apply(p, x)  # noqa: E731
    onehot = dispatch_combine_onehot
    out = {}
    for tag, dtype, top_k in (("f32 top-1", torch.float32, 1),
                              ("f32 top-2", torch.float32, 2),
                              ("bf16 top-1", torch.bfloat16, 1)):
        layer, params, x, ct = _moe_layer_inputs(torch, device, dtype,
                                                 top_k)
        yi, ai, gi, pi = _moe_fwd_bwd(torch, index, layer, params, x, ct)
        yo, ao, go, po = _moe_fwd_bwd(torch, onehot, layer, params, x, ct)
        y_diff = float((yi.float() - yo.float()).abs().max())
        scale = float(yo.float().abs().max())
        g_rel = max(float(((a.float() - b.float()).abs().max())
                          / max(float(b.float().abs().max()), 1e-30))
                    for a, b in zip([gi] + pi, [go] + po))
        bitwise = bool(torch.equal(yi, yo))
        print(f"moe layer {tag} (8, 1024, 1024), {MOE_EXPERTS} experts, "
              f"capacity {layer._capacity(8 * 1024)}: index vs one-hot "
              f"outputs max |diff| {y_diff:.3g} (of max |y| {scale:.3g}; "
              f"bitwise {bitwise}), aux {float(ai[0]):.6f} vs "
              f"{float(ao[0]):.6f}, gradients' largest relative diff "
              f"{g_rel:.3g}", flush=True)
        if not torch.equal(ai, ao):
            raise AssertionError(f"moe layer {tag}: the aux differs")
        # top-1: one product per output in either form, so bitwise in
        # both dtypes
        ok = bitwise if top_k == 1 else y_diff <= 1e-6 * scale
        if dtype == torch.float32:
            ok = ok and g_rel <= 1e-5
        if not ok:
            raise AssertionError(f"moe layer {tag}: the index form differs "
                                 "from the one-hot einsum form")
        out[tag] = dict(out_max_abs_diff=y_diff, out_max_abs=scale,
                        bitwise=bitwise, grad_max_rel_diff=g_rel)
    # times in bf16 (the training dtype): forward, forward + backward
    layer, params, x, ct = _moe_layer_inputs(torch, device, torch.bfloat16,
                                             1)
    slots = _join_groups(torch.zeros(
        (1, MOE_EXPERTS, layer._capacity(8 * 1024), x.shape[-1]),
        dtype=x.dtype, device=device)).normal_()
    timing = {}
    for name, fn in (("index", index), ("onehot", onehot)):
        timing[f"{name}_fwd_ms"] = median_ms(
            torch, lambda: fn(layer, params, x), runs=10)
        timing[f"{name}_fwd_bwd_ms"] = median_ms(
            torch, lambda: _moe_fwd_bwd(torch, fn, layer, params, x, ct),
            runs=10)
    timing["experts_fwd_ms"] = median_ms(
        torch, lambda: layer.experts_ffn(params["experts"], slots), runs=10)
    print("moe layer bf16 times (ms, medians): " + json.dumps(
        {k: round(v, 4) for k, v in timing.items()}) + "; the dispatch and "
          "combine (index) take the layer's forward less the experts': "
          f"{timing['index_fwd_ms'] - timing['experts_fwd_ms']:.4f} ms",
          flush=True)
    out["times"] = timing
    return out


def moe_identity_ep_dense(torch, device, n_layers=CUT_LAYERS, steps=3,
                          batch=8):
    """(d) f32, TF32 off, full width at ``n_layers`` layers, SGD-momentum:
    ``steps`` steps of the expert step over ``LocalExpertGroup(4)`` with
    aux weight 0 and of the plain DP step over the dense MoE model (every
    expert here, the batch one routing group), each with the capacity of
    its groups' tokens (no token dropped), from the same params and
    batches: losses within 1e-5 relative, params within 1e-6.  The DP
    step's first loss is the forward's cross-entropy of the first batch:
    the aux is not in its loss (JAX's data_parallel step)."""
    import dataclasses

    from neural_networks_parallel_training_with_mpi_tpu_torch.data.datasets import (  # noqa: E501
        text_dataset,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.data.loader import (  # noqa: E501
        ShardedLoader,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        losses as losses_lib,
        optim,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        data_parallel as dp,
        expert as ep,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.distributed import (  # noqa: E501
        world_setup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.train.state import (  # noqa: E501
        TrainState,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        tree_map,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens = batch * BIG["max_seq_len"]
    base = TransformerConfig(**dict(BIG, n_layers=n_layers),
                             activation="gelu", pos_encoding="learned",
                             attention="flash", moe_experts=MOE_EXPERTS)
    data = text_dataset(TEXT_FILE, base.max_seq_len, base.vocab_size)
    world = world_setup(device)
    group = ep.LocalExpertGroup(EP_SHARDS)
    init = Transformer(base, device=device).init(
        torch.Generator().manual_seed(SEED + 25))
    runs = []
    for expert in (True, False):
        cfg = dataclasses.replace(base, moe_capacity=(
            tokens // EP_SHARDS if expert else tokens))
        model = Transformer(cfg, device=device,
                            expert_group=group if expert else None)
        opt = optim.sgd(1e-2, 0.9, steps=steps)
        params = tree_map(lambda t: t.detach().clone(), init)
        step = (ep.make_moe_train_step(model, opt, world, group,
                                       aux_weight=0.0) if expert
                else dp.make_train_step(model, opt, world, "cross_entropy"))
        state = TrainState.from_params(params, opt, model)
        loader = ShardedLoader(data, batch, device=device, shuffle=False)
        losses, first = [], None
        for i, b in zip(range(steps), loader.epoch(0)):
            if i == 0 and not expert:
                with torch.no_grad():
                    s, c = losses_lib.softmax_cross_entropy(
                        model.forward(state.params, b["x"]), b["y"],
                        b.get("mask"))
                    first = float(s / c)
            state, out = step(state, b)
            losses.append(float(out["loss"] if expert else out))
        runs.append((losses, [p.detach() for p in flat_params(
            state.params)], first))
    (le, pe, _), (ld, pd, first) = runs
    worst = max(float((a - b).abs().max()) for a, b in zip(pe, pd))
    loss_ok = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(le, ld))
    no_aux = abs(first - ld[0]) <= 1e-5 * abs(ld[0])
    print(f"moe f32 identity --ep {EP_SHARDS} (aux weight 0) == the dense "
          f"MoE DP step ({n_layers} layers, {steps} steps, capacity = the "
          f"tokens): losses {le} vs {ld}; params max |diff| {worst:.3e}; "
          f"the DP step's first loss {ld[0]:.6f} vs the forward's CE "
          f"{first:.6f} (no aux)", flush=True)
    if not (loss_ok and worst <= 1e-6 and no_aux):
        raise AssertionError("moe f32 identity: --ep 4 differs from the "
                             "dense MoE step, or the DP loss holds an aux")
    return dict(losses=le, dense_losses=ld, param_max_abs_diff=worst,
                dp_first_loss_vs_forward=[ld[0], first])


def moe_host_runs(torch, device, out_path=None, jobs=None):
    """(d) :data:`MOE_HOST_JOBS` (or ``jobs``: phase 26 (b)'s) through
    the Trainer over local groups on ``device``, f32 (TF32 off),
    :data:`MOE_HOST_STEPS` steps each: the losses and final params (host
    numpy, the blocks per layer) by job; with ``out_path``, saved there
    (the host's run, a subprocess of this script)."""
    import numpy as np

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.pipeline import (  # noqa: E501
        dense_layer_blocks,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    platform = {} if device.type == "cuda" else dict(platform="cpu")
    out = {}
    for name, job in (jobs or MOE_HOST_JOBS).items():
        groups = _groups_of(torch, job)
        fa.set_launch_counts()
        t = _trainer(torch, device, steps=MOE_HOST_STEPS,
                     **dict(MOE_HOST, **job, **platform, **groups))
        params = t.state.params
        if job.get("pp"):
            params = dict(params, blocks=dense_layer_blocks(params["blocks"]))
        out[name] = dict(losses=t.losses, params=[
            p.detach().cpu().numpy() for p in flat_params(params)],
            launches=fa.launch_counts())
        del t
    if out_path is not None:
        flat = {f"{n}/{i}": a for n, r in out.items()
                for i, a in enumerate(r["params"])}
        np.savez(out_path, **flat)
        with open(out_path + ".json", "w") as f:
            json.dump({n: r["losses"] for n, r in out.items()}, f)
    return out


def start_moe_host_runs(tmp, flag="--moe-host"):
    """(d)'s host runs (``--pp-ep-host``: phase 26 (b)'s) in a subprocess
    of this script (the CPU's threads beside the card's work);
    :func:`moe_card_vs_host` reads them."""
    path = f"{tmp}/{flag.strip('-')}.npz"
    env = dict(os.environ, OMP_NUM_THREADS="4")
    proc = subprocess.Popen([sys.executable, __file__, flag, path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(REPO_ROOT), env=env)
    return proc, path


def moe_card_vs_host(torch, np, device, proc, path, jobs=None):
    """(d) the card's runs of :data:`MOE_HOST_JOBS` (or ``jobs``) against
    the host's: losses within 1e-5 relative, params within 1e-5 (absolute
    and relative); the card's B1-B3 (simt in f32) and B5 launches by
    design (a pipeline's per microbatch)."""
    jobs = jobs or MOE_HOST_JOBS
    card = moe_host_runs(torch, device, jobs=jobs)
    o, e = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"moe host runs: rc {proc.returncode}\n"
                             f"{o[-2000:]}\n{e[-2000:]}")
    host = np.load(path)
    with open(path + ".json") as f:
        host_losses = json.load(f)
    out = {}
    for name, job in jobs.items():
        got = card[name]
        want = [host[f"{name}/{i}"] for i in range(len(got["params"]))]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
            got["losses"], host_losses[name]))
        worst = max(float(np.max(np.abs(a - b) / (1e-5 + np.abs(b))))
                    for a, b in zip(got["params"], want))
        ok = loss_rel <= 1e-5 and all(
            np.allclose(a, b, rtol=1e-5, atol=1e-5)
            for a, b in zip(got["params"], want))
        blocks = ring_blocks(job.get("attention", "flash"), job.get("sp", 1),
                             job.get("tp", 1)) * job.get("pp", 1)
        expect = (MOE_HOST["n_layers"] * blocks * MOE_HOST_STEPS
                  if device.type == "cuda" else 0)
        launches = got["launches"]
        print(f"moe card vs host {name} (f32, {MOE_HOST['n_layers']} "
              f"layers, T {MOE_HOST['seq_len']}, {MOE_HOST_STEPS} steps): "
              f"losses {got['losses']} vs {host_losses[name]} (largest "
              f"relative diff {loss_rel:.3g}); params' largest |diff| / "
              f"(1e-5 + |host|) {worst:.3g}; flash launches "
              f"{launches['all']} (simt {launches['simt']}), with_lse "
              f"{launches['with_lse']}; expected {expect} each", flush=True)
        if not ok:
            raise AssertionError(f"moe card vs host {name}: beyond 1e-5")
        if launches["all"] != dict.fromkeys(launches["all"], expect) or (
                job.get("sp") and launches["with_lse"] != expect):
            raise AssertionError(f"moe card vs host {name}: flash launches "
                                 f"{launches}, expected {expect}")
        out[name] = dict(losses=got["losses"], host_losses=host_losses[name],
                         loss_max_rel_diff=loss_rel, launches=launches["all"],
                         with_lse_launches=launches["with_lse"])
    return out


def start_moe_generate(ck):
    """(e) ``--generate`` through the CLI from (b)'s ``--ep 4`` snapshot
    (12 layers; the mesh flags accepted and ignored, as JAX's CLI),
    sampled at temperature 1 from the seed; it runs beside (d) and
    (f)."""
    flags = train_flags(checkpoint_dir=ck, ce_chunk=0, ep=EP_SHARDS,
                        **MOE_FLAGS)
    return subprocess.Popen([sys.executable, "-m", PKG, *flags,
                             *GENERATE_FLAGS], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=str(REPO_ROOT))


def moe_serve(torch, np, device):
    """(f) The MoE LM (12 layers, 8 experts, bf16) behind the fused
    paged scheduler: 8 seeded requests, each call routing all its lanes;
    every request finishes, the allocator drains, paged attention (B4)
    launches n_layers x passes.  Then f32 (TF32 off) at 2 layers with the
    capacity factor 8 (no token dropped): fused == gathered ==
    ``generate()`` on the card (``token_identity``), and the card's fused
    tokens against the host's (the kernel's plain version) on ragged
    requests."""
    import dataclasses

    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        tree_map,
    )

    cfg = dataclasses.replace(big_config(torch), moe_experts=MOE_EXPERTS)
    served = serve_full_width(torch, np, device, checks=False,
                              tag="serve moe", cfg=cfg, n_requests=8,
                              slots=8, p_lo=32, p_hi=256, n_lo=16, n_hi=48)
    # capacity factor E: no call drops a token, so generate() (one
    # request a call) and the scheduler (every lane a call) route alike
    small = dataclasses.replace(big_config(torch, n_layers=2,
                                           dtype=torch.float32),
                                moe_experts=MOE_EXPERTS,
                                moe_capacity_factor=float(MOE_EXPERTS))
    token_identity(torch, np, device, cfg=small, tag=" moe")
    model = Transformer(small, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 2))
    rng = np.random.default_rng(SEED + 2)
    requests = [(rng.integers(0, small.vocab_size, p).tolist(), 12)
                for p in (7, 60, 200)]
    geom = dict(slots=4, block_size=16, max_len=small.max_seq_len,
                prefill_chunk=256, attn_impl="fused",
                num_blocks=4 * -(-small.max_seq_len // 16) + 1)
    card = drive(Scheduler(model, params, ServeConfig(**geom),
                           device=device), requests)[1]
    cpu = torch.device("cpu")
    host_model = Transformer(small, device=cpu)
    host = drive(Scheduler(host_model, tree_map(lambda t: t.cpu(), params),
                           ServeConfig(**geom), device=cpu), requests)[1]
    print(f"tokens f32 moe card vs host (2 layers, {len(requests)} ragged "
          f"requests, 12 new each): equal {card == host}", flush=True)
    if card != host:
        raise AssertionError("moe serving: the card's tokens differ from "
                             "the host's")
    return dict(serve=served, card_vs_host_equal=True)


MOE_KEYS = ("step_ms_median", "tokens_per_s", "mfu", "peak_memory_gib",
            "launches", "launches_by_design", "with_lse_launches",
            "first_loss", "last3_loss", "steps", "profile_ms_per_step",
            "profile_shares", "n_params", "save_s", "snapshot_bytes")


def moe_full_width(torch, np, device, keep=None):
    """Phase 25: (d)'s host runs start first, in a subprocess; (a) the
    layer; (b) the flagship MoE LM (924M params) under ``--ep 4`` over
    ``LocalExpertGroup(4)`` at full width, ce_chunk 0, one epoch eager
    (the 1-nat check, step ms, tokens/s, peak memory, B1-B3 12 a step all
    on sm90, a profile with the dispatch/combine class, the final
    snapshot (e) decodes) and one graphed (k 13, bitwise); (e)'s
    ``--generate`` process starts; (c) ``--moe_top_k 2`` on the plain DP
    step (ce_chunk 256) at full width, eager (with a profile) and graphed
    (bitwise), from (b)'s seeded init (the same global tree: drawn once,
    and kept in ``keep["init"]`` for phase 26 (c)); (d) the f32 identities; (f) serving; (e) the tokens
    against the decode of (b)'s final params."""
    import tempfile
    from pathlib import Path

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.expert import (  # noqa: E501
        LocalExpertGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        tree_map,
    )

    t0 = time.perf_counter()
    out = {}
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            host_proc, host_path = start_moe_host_runs(tmp)
            procs.append(host_proc)
            out["layer"] = check_moe_layer(torch, device)
            ep4 = dict(ep=EP_SHARDS, ce_chunk=0, nepochs=1, **MOE_FLAGS)
            ck = Path(tmp) / "ck"
            eager = train_full_width(
                torch, np, device, keep_final="tree", tag="train moe ep4",
                keep_init=True,
                checkpoint_dir=ck, inspect=lambda t: dict(
                    save_s=t.save_seconds[-1], snapshot_bytes=snapshot_bytes(
                        ck / f"ckpt-{int(t.state.step)}")),
                expert_group=LocalExpertGroup(EP_SHARDS), **ep4)
            graphed = dispatch_full_width(
                torch, np, device, eager, exact=True, profile=False,
                tag="dispatch moe ep4",
                expert_group=LocalExpertGroup(EP_SHARDS), **ep4)
            # the seeded init, drawn once: the plain DP layout (c) and the
            # GSPMD one (phase 26 (c)) draw the same global tree as --ep 4
            moe_init = eager["init_params"]
            if keep is not None:
                keep["init"] = moe_init
            del eager["final_params"], eager["init_params"]
            out["ep4"] = {k: eager[k] for k in MOE_KEYS if k in eager}
            out["ep4_graphed"] = {k: graphed[k] for k in (
                "step_ms_median", "step_ms_from", "tokens_per_s", "mfu",
                "peak_memory_gib", "launches", "bitwise", "replays",
                "launches_per_replay")}
            # (e) once (b)'s timed runs are done: its start-up, the
            # snapshot's checksum and restore run beside (c) (its decode,
            # 16 tokens, shares the card for well under a second)
            gen = start_moe_generate(ck)
            procs.append(gen)
            top2 = dict(moe_top_k=2, nepochs=1, **MOE_FLAGS)
            with eager_init(torch, moe_init):
                dense = train_full_width(torch, np, device, keep_final=True,
                                         tag="train moe top-2 dp",
                                         keep_init=True, **top2)
            del moe_init
            dense_g = dispatch_full_width(
                torch, np, device, dense, exact=True, profile=False,
                tag="dispatch moe top-2 dp", **top2)
            del dense["final_params"], dense["init_params"]
            out["dp_top2"] = {k: dense[k] for k in MOE_KEYS if k in dense}
            out["dp_top2_graphed"] = {k: dense_g[k] for k in (
                "step_ms_median", "tokens_per_s", "mfu", "peak_memory_gib",
                "launches", "bitwise", "replays")}
            reference = reference_decode(
                torch, device, tree_map(lambda t: t.to(device),
                                        eager.pop("final_tree")),
                n_layers=BIG["n_layers"], **MOE_FLAGS)
            out["identity_ep4_dense"] = moe_identity_ep_dense(torch, device)
            out["card_vs_host"] = moe_card_vs_host(torch, np, device,
                                                   host_proc, host_path)
            out["serve"] = moe_serve(torch, np, device)
            out["generate"] = generate_from_pipe(
                gen, reference, what="(b)'s --ep 4 MoE snapshot")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    runs = (out["ep4"], out["ep4_graphed"], out["dp_top2"],
            out["dp_top2_graphed"])
    out["flash_launches"] = {w: sum(r["launches"][w] for r in runs)
                             for w in out["ep4"]["launches"]}
    out["with_lse_launches"] = out["card_vs_host"][
        "sp2_ep2_striped_flash"]["with_lse_launches"]
    out["paged_launches"] = out["serve"]["serve"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 25: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 26: MoE on the pipe and GSPMD layouts, tensor-parallel decoding
# ---------------------------------------------------------------------------

PP_EP = dict(pp=2, ep=2, **MOE_FLAGS)
# (b)'s card-vs-host identity of pp 2 x sp 2 x ep 2 (MOE_HOST's 2 layers
# at full width, T 128)
PP_EP_HOST_JOBS = {"pp2_sp2_ep2_striped_flash": dict(
    pp=2, sp=2, ep=2, attention="striped_flash")}
# (d)'s decode: 4 prompts of 32 tokens, 16 greedy tokens in f32; 8 of 128
# and 16 new tokens for the bf16 rate (each decoder warmed up on 2)
TP_DECODE = dict(rows=4, prompt=32, new=16)
TP_DECODE_RATE = dict(rows=8, prompt=128, new=16)


def _groups_of(torch, kw):
    """Local groups for the layout flags ``kw`` (``ep``, ``pp``, ``sp``,
    ``tp``, ``fsdp``), one card holding every shard."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.expert import (  # noqa: E501
        LocalExpertGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.fsdp import (  # noqa: E501
        LocalFsdpGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        LocalSeqGroup,
    )

    groups = {}
    for flag, name, cls in (("ep", "expert_group", LocalExpertGroup),
                            ("sp", "seq_group", LocalSeqGroup),
                            ("tp", "tensor_group", LocalTensorGroup),
                            ("fsdp", "fsdp_group", LocalFsdpGroup)):
        if kw.get(flag, 1) > 1:
            groups[name] = cls(kw[flag])
    return groups


def _dense_flat(trainer):
    """A trainer's params as :func:`flat_params` leaves in the per-layer
    order (a pipeline's stage stack unstacked; the qkv order kept)."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.pipeline import (  # noqa: E501
        dense_layer_blocks,
    )

    params = trainer.whole_params()
    if trainer.pipeline:
        params = dict(params, blocks=dense_layer_blocks(params["blocks"]))
    return [p.detach() for p in flat_params(params)]


def layout_identity(torch, device, tag, ref, run, steps=3, bar=1e-6,
                    refs=None, **common):
    """(b), (c) f32, TF32 off, full width at 2 layers (``common`` may
    change the depth), SGD-momentum: ``steps`` steps of two Trainers
    over local groups from the same seeded init and batches (``ref`` and
    ``run``: their layout flags): losses within 1e-5 relative, params
    within ``bar``; each run's flash launches (simt in f32) of
    ``n_layers`` x shards x microbatches (x accumulation) a step.
    ``refs``: a dict keeping each reference run for the calls after."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one_rank_group(torch, device)
    kw = dict(F32_2L, **MOE_FLAGS)
    kw.update(common)
    refs = {} if refs is None else refs
    runs = []
    for flags in (ref, run):
        key = json.dumps(dict(kw, **flags), sort_keys=True)
        if flags is ref and key in refs:
            runs.append(refs[key])
            continue
        fa.set_launch_counts()
        t = _trainer(torch, device, steps=steps,
                     **dict(kw, **flags, **_groups_of(torch, flags)))
        per = (kw["n_layers"] * flags.get("pp", 1)
               * flags.get("accum_steps", 1)
               * ring_blocks(flags.get("attention", kw.get("attention",
                                                           "flash")),
                             flags.get("sp", 1), flags.get("tp", 1)))
        runs.append((t.losses, _dense_flat(t), fa.launch_counts()["all"],
                     per * steps if device.type == "cuda" else 0))
        if flags is ref:
            refs[key] = runs[-1]
        del t
    (lr_, pr, ar, er), (lu, pu, au, eu) = runs
    worst = max(float((a - b).abs().max()) for a, b in zip(pu, pr))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lu, lr_))
    print(f"{tag}: losses {lu} vs {lr_} (largest relative diff "
          f"{loss_rel:.3g}); params max |diff| {worst:.3e}; flash launches "
          f"{au} vs {ar}, expected {eu} / {er} each", flush=True)
    if loss_rel > 1e-5 or worst > bar:
        raise AssertionError(f"{tag}: beyond the bar")
    if au != dict.fromkeys(au, eu) or ar != dict.fromkeys(ar, er):
        raise AssertionError(f"{tag}: flash launches {au} / {ar}, expected "
                             f"{eu} / {er}")
    return dict(losses=lu, ref_losses=lr_, loss_max_rel_diff=loss_rel,
                param_max_abs_diff=worst, launches=au)


def start_generate_from_pp_ep(ck):
    """(b) ``--generate`` through the CLI from the pp 2 x ep 2 snapshot
    (2 layers; the mesh flags accepted and ignored), sampled at
    temperature 1 from the seed; it starts here and runs beside the
    rest of the phase."""
    flags = train_flags(checkpoint_dir=ck, n_layers=CUT_LAYERS, ce_chunk=0,
                        **PP_EP)
    return subprocess.Popen([sys.executable, "-m", PKG, *flags,
                             *GENERATE_FLAGS], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=str(REPO_ROOT))


def _decode_model(torch, device, dtype, moe):
    """(d) The flagship (or its MoE LM) at full width in ``dtype``, its
    params drawn on the card from the seed."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer,
    )

    import dataclasses

    cfg = big_config(torch, dtype=dtype)
    if moe:
        cfg = dataclasses.replace(cfg, moe_experts=MOE_EXPERTS)
    model = Transformer(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(
        SEED + 26 + moe))
    return model, params


def generate_tp_full_width(torch, np, device):
    """(d) ``models.generate_tp`` under ``LocalTensorGroup(4)`` at full
    width: the flagship and its MoE LM (8 experts), f32 (TF32 off),
    greedy :data:`TP_DECODE` tokens equal to ``generate()``'s with the
    head whole and vocab-parallel; bf16 tokens/s of both decoders at
    :data:`TP_DECODE_RATE`; a pp 2 x tp 2 snapshot (2 layers, f32)
    through ``pipeline_params_for_decode`` at tensor size 4 (the qkv
    columns re-permuted) against ``generate()`` over the saver's own
    params."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate import (  # noqa: E501
        generate,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate_tp import (  # noqa: E501
        generate_tp, pipeline_params_for_decode,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        megatron,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.pipeline import (  # noqa: E501
        dense_layer_blocks,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils import (
        checkpoint as ckpt,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        tree_map,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = megatron.LocalTensorGroup(TP_SHARDS)
    rng = np.random.default_rng(SEED + 26)
    out = {}
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    def permuted(model, params, tp):
        c = model.cfg
        return dict(params, blocks=megatron.permute_qkv(
            params["blocks"], c.d_model, c.n_heads, tp, kv_heads=c.kv_heads))

    for name, moe in (("flagship", False), ("moe", True)):
        model, params = _decode_model(torch, device, torch.float32, moe)
        prompt = rng.integers(0, model.cfg.vocab_size,
                              (TP_DECODE["rows"], TP_DECODE["prompt"]))
        want = generate(model, params, prompt, TP_DECODE["new"],
                        device=device)
        tp_params = permuted(model, params, TP_SHARDS)
        equal = {}
        for vp in (False, True):
            got = generate_tp(model, tp_params, prompt, group,
                              TP_DECODE["new"], vocab_parallel=vp,
                              device=device)
            equal[vp] = bool(torch.equal(got, want))
        print(f"generate_tp {name} f32 (LocalTensorGroup({TP_SHARDS}), "
              f"{TP_DECODE['rows']} x {TP_DECODE['prompt']} prompt, "
              f"{TP_DECODE['new']} greedy tokens): equal to generate() "
              f"with the head whole {equal[False]}, vocab-parallel "
              f"{equal[True]}", flush=True)
        if not all(equal.values()):
            raise AssertionError(f"generate_tp {name}: the f32 greedy "
                                 "tokens differ from generate()'s")
        del params, tp_params
        model, params = _decode_model(torch, device, torch.bfloat16, moe)
        prompt = rng.integers(0, model.cfg.vocab_size,
                              (TP_DECODE_RATE["rows"],
                               TP_DECODE_RATE["prompt"]))
        tp_params = permuted(model, params, TP_SHARDS)
        rate = {}
        for which, fn in (
                ("generate_tp", lambda n: generate_tp(
                    model, tp_params, prompt, group, n, device=device)),
                ("generate_tp_vocab_parallel", lambda n: generate_tp(
                    model, tp_params, prompt, group, n, vocab_parallel=True,
                    device=device)),
                ("generate", lambda n: generate(
                    model, params, prompt, n, device=device))):
            fn(2)       # warm-up: the prefill and a decode step
            sync()
            t0 = time.perf_counter()
            fn(TP_DECODE_RATE["new"])
            sync()
            rate[which] = (TP_DECODE_RATE["rows"] * TP_DECODE_RATE["new"]
                           / (time.perf_counter() - t0))
        print(f"generate_tp {name} bf16 tokens/s ({TP_DECODE_RATE['rows']} "
              f"x {TP_DECODE_RATE['prompt']} prompt, "
              f"{TP_DECODE_RATE['new']} new, wall): " + json.dumps(
                  {k: round(v, 1) for k, v in rate.items()}), flush=True)
        out[name] = dict(f32_equal=equal, bf16_tokens_per_s=rate)
        del model, params, tp_params
    # a pp 2 x tp 2 snapshot decoded at tensor size 4
    with tempfile.TemporaryDirectory() as tmp:
        saver = _trainer(torch, device, steps=2, checkpoint_dir=tmp,
                         pp=2, tp=2, **dict(F32_2L, lr=1e-5),
                         **_groups_of(torch, dict(tp=2)))
        saver.save(final=True)
        ckpt.wait_pending()
        model = saver.model
        dense = dict(saver.state.params, blocks=dense_layer_blocks(
            saver.state.params["blocks"], model.cfg, 2))
        template = tree_map(lambda t: t.detach().cpu(), saver.state.params)
        step, restored = ckpt.restore_params(tmp, template)
        saved_tp = int(ckpt.read_meta(tmp, step=step)["qkv_tp"])
        del saver
    restored = tree_map(lambda t: t.to(device), restored)
    prompt = rng.integers(0, model.cfg.vocab_size,
                          (TP_DECODE["rows"], TP_DECODE["prompt"]))
    want = generate(model, dense, prompt, TP_DECODE["new"], device=device)
    dec = pipeline_params_for_decode(restored, model, qkv_tp=saved_tp,
                                     decode_tp=TP_SHARDS)
    got = generate_tp(model, dec, prompt, group, TP_DECODE["new"],
                      device=device)
    equal = bool(torch.equal(got, want))
    print(f"generate_tp from a pp 2 x tp 2 snapshot (qkv_tp {saved_tp}, "
          f"step {step}, 2 layers, f32) at tensor size {TP_SHARDS}, qkv "
          f"re-permuted: equal to generate() over the saver's params "
          f"{equal}", flush=True)
    if not equal or saved_tp != 2:
        raise AssertionError("generate_tp from the pipeline snapshot "
                             "differs from generate()")
    out["pipeline_snapshot_equal"] = equal
    return out


def moe_layouts_full_width(torch, np, device, init=None):
    """Phase 26 (``init``: phase 25's seeded init, which (a), stacked for
    the pipe, and (c) start from rather than draw it again): (b)'s host run (pp 2 x sp 2 x ep 2) starts first, in a
    subprocess, and (b)'s pp 2 x ep 2 snapshot with its ``--generate``
    process; (a) the flagship MoE LM (924.5M params) under ``--pp 2 --ep
    2`` over ``LocalPipeGroup(2)`` x ``LocalExpertGroup(2)`` at full
    width, one epoch eager (the 1-nat check, step ms, tokens/s, peak
    memory, B1-B3 12 x 2 a step all on sm90, a profile with the
    dispatch/combine class) and one graphed (k 13, bitwise); (c) the MoE
    LM on the GSPMD layout under ``--tp 4`` over ``LocalTensorGroup(4)``
    (one routing group of 8192 tokens), eager (profiled) and graphed;
    ``--fsdp 4`` over ``LocalFsdpGroup(4)`` at 2 layers; (b) and (c)'s f32
    identities at 2 layers: pp 2 x ep 2, pp 2 x ep 2 x tp 2 and the
    interleave against the expert steps with ``accum_steps`` 2, tp 4 and
    fsdp 4 against the plain DP MoE step, and pp 2 x sp 2 x ep 2
    striped_flash card against host; (d) ``generate_tp``; (b) the
    tokens."""
    import tempfile

    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.expert import (  # noqa: E501
        LocalExpertGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.fsdp import (  # noqa: E501
        LocalFsdpGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.megatron import (  # noqa: E501
        LocalTensorGroup,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.pipeline import (  # noqa: E501
        dense_layer_blocks, stack_blocks,
    )

    t0 = time.perf_counter()
    out = {}
    procs = []
    graphed_keys = ("step_ms_median", "step_ms_from", "tokens_per_s", "mfu",
                    "peak_memory_gib", "launches", "bitwise", "replays",
                    "launches_per_replay")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            host_proc, host_path = start_moe_host_runs(tmp, "--pp-ep-host")
            procs.append(host_proc)
            saver = _trainer(torch, device, steps=3, checkpoint_dir=tmp,
                             n_layers=CUT_LAYERS, ce_chunk=0, lr=1e-5,
                             expert_group=LocalExpertGroup(2), **PP_EP)
            saver.save(final=True)
            gen = start_generate_from_pp_ep(tmp)
            procs.append(gen)
            reference = reference_decode(
                torch, device, dict(saver.state.params,
                                    blocks=dense_layer_blocks(
                                        saver.state.params["blocks"])),
                **MOE_FLAGS)
            del saver
            # (a) pp 2 x ep 2 at full width, from phase 25's init with the
            # blocks stage-stacked (the pipeline's own draw: the same tree)
            pp_ep = dict(nepochs=1, **PP_EP)
            pp_init = None if init is None else dict(
                init, blocks=stack_blocks(init["blocks"], PP_EP["pp"], 1))
            with eager_init(torch, pp_init):
                eager = train_full_width(
                    torch, np, device, keep_final=True,
                    tag="train moe pp2 x ep2", keep_init=True,
                    expert_group=LocalExpertGroup(2), **pp_ep)
            del pp_init
            graphed = dispatch_full_width(
                torch, np, device, eager, exact=True, profile=False,
                tag="dispatch moe pp2 x ep2",
                expert_group=LocalExpertGroup(2), **pp_ep)
            del eager["final_params"], eager["init_params"]
            out["pp2_ep2"] = {k: eager[k] for k in MOE_KEYS if k in eager}
            out["pp2_ep2_graphed"] = {k: graphed[k] for k in graphed_keys}
            # (c) the GSPMD layout: --tp 4, then --fsdp 4 at 2 layers
            tp4 = dict(tp=TP_SHARDS, ce_chunk=0, nepochs=1, **MOE_FLAGS)
            with eager_init(torch, init):
                eager = train_full_width(
                    torch, np, device, keep_final=True, tag="train moe tp4",
                    keep_init=True,
                    tensor_group=LocalTensorGroup(TP_SHARDS), **tp4)
            init = None
            graphed = dispatch_full_width(
                torch, np, device, eager, exact=True, profile=False,
                tag="dispatch moe tp4",
                tensor_group=LocalTensorGroup(TP_SHARDS), **tp4)
            del eager["final_params"], eager["init_params"]
            out["tp4"] = {k: eager[k] for k in MOE_KEYS if k in eager}
            out["tp4_graphed"] = {k: graphed[k] for k in graphed_keys}
            fsdp = train_full_width(
                torch, np, device, profile=False,
                tag="train moe fsdp4 2 layers",
                fsdp_group=LocalFsdpGroup(FSDP_SLICES), fsdp=FSDP_SLICES,
                n_layers=CUT_LAYERS, ce_chunk=0, **MOE_FLAGS)
            out["fsdp4"] = {k: fsdp[k] for k in MOE_KEYS if k in fsdp}
            # (b), (c) f32 identities at 2 layers
            ident, refs = {}, {}
            ident["pp2_ep2"] = layout_identity(
                torch, device, "moe f32 identity pp2 x ep2 == --ep 2 "
                "--accum_steps 2 (2 layers, 3 steps)",
                dict(ep=2, accum_steps=2), dict(pp=2, ep=2))
            ident["pp2_ep2_tp2"] = layout_identity(
                torch, device, "moe f32 identity pp2 x ep2 x tp2 == --ep 2 "
                "--tp 2 --accum_steps 2 (2 layers, 3 steps)",
                dict(ep=2, tp=2, accum_steps=2, attention="dense"),
                dict(pp=2, ep=2, tp=2, attention="dense"))
            ident["pp2_ep2_interleave2"] = layout_identity(
                torch, device, "moe f32 identity --pp 2 --pp_interleave 2 "
                "x ep2 == --ep 2 --accum_steps 2 (4 layers, 3 steps)",
                dict(ep=2, accum_steps=2),
                dict(pp=2, ep=2, pp_interleave=2), n_layers=4)
            ident["tp4"] = layout_identity(
                torch, device, "moe f32 identity --tp 4 (GSPMD, one routing "
                "group) == the DP MoE step (2 layers, 3 steps)", {},
                dict(tp=TP_SHARDS), refs=refs)
            ident["fsdp4"] = layout_identity(
                torch, device, "moe f32 identity --fsdp 4 (GSPMD) == the DP "
                "MoE step (2 layers, 3 steps)", {}, dict(fsdp=FSDP_SLICES),
                refs=refs)
            out["identity"] = ident
            out["card_vs_host"] = moe_card_vs_host(
                torch, np, device, host_proc, host_path, PP_EP_HOST_JOBS)
            out["generate_tp"] = generate_tp_full_width(torch, np, device)
            out["generate"] = generate_from_pipe(
                gen, reference, what="a pp 2 x ep 2 MoE snapshot")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    runs = (out["pp2_ep2"], out["pp2_ep2_graphed"], out["tp4"],
            out["tp4_graphed"], out["fsdp4"])
    out["flash_launches"] = {w: sum(r["launches"][w] for r in runs)
                             for w in out["pp2_ep2"]["launches"]}
    out["with_lse_launches"] = out["card_vs_host"][
        "pp2_sp2_ep2_striped_flash"]["with_lse_launches"]
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 26: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 27: disaggregated serving (the prefill -> decode block handoff),
# the scheduler's telemetry, tracing and fleet surface, the load sweep
# ---------------------------------------------------------------------------

# (a)'s telemetry cadence: a kind="serve" record every 10 ticks, a rollup
# (and a goodput record) every 25
DISAGG_TELEMETRY = dict(metrics_every=10, rollup_every=25)


def disagg_pump(torch, pre, dec, requests, timings=None, syncs=None,
                max_ticks=20_000):
    """Serve ``requests`` through a ``role="prefill"`` scheduler and a
    ``role="decode"`` one on one thread: each pass ticks the prefill side,
    moves its ``take_handoffs()`` into ``dec.inject()`` (an inject that
    returns None is retried on the next pass) and ticks the decode side.
    Checks each request's tokens for length and prompt and both
    allocators drained; returns ``(tokens in request order, prefill-side
    handoff descriptors, decode-side rids)``.  ``timings``: a dict that
    receives the export and import ms of each handoff (the device
    device synchronised before each export, whose read of the rows waits
    for it anyway; an import's is the host's time in ``inject``, the
    copy to the card and the row writes queued behind it).  ``syncs``: a
    list that receives the synchronising calls of the decode side's
    ticks (``inject`` left out)."""
    import warnings

    cuda = pre.server.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if timings is not None:
        timings.update(export_ms=[], import_ms=[], payload_bytes=[],
                       prompt_tokens=[], rows=[])
        export = pre.server.export_stream

        def timed_export(rid):
            sync()
            t0 = time.perf_counter()
            out = export(rid)
            timings["export_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        pre.server.export_stream = timed_export
    rids = [pre.submit(p, n) for p, n in requests]
    assert all(r is not None for r in rids), "a request was rejected"
    dec_of, waiting, out, handoffs = {}, [], {}, []
    for _ in range(max_ticks):
        for rid in pre.tick():
            out[rid] = pre.result(rid)          # finished at prefill
        taken = pre.take_handoffs()
        handoffs += taken
        waiting += taken
        for h in list(waiting):
            t0 = time.perf_counter()
            got = dec.inject(h["payload"], slo_ms=h["slo_ms"])
            if got is None:
                continue
            if timings is not None:
                pay = h["payload"]
                timings["import_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                timings["payload_bytes"].append(sum(
                    len(b) for lay in pay["layers"] for b in lay.values()))
                timings["prompt_tokens"].append(len(pay["prompt"]))
                timings["rows"].append(pay["n_blocks"])
            dec_of[got] = h["rid"]
            waiting.remove(h)
        if syncs is not None and cuda:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    finished = dec.tick()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs.append(sum("synchroniz" in str(w.message)
                             for w in caught))
        else:
            finished = dec.tick()
        for rid in finished:
            out[dec_of[rid]] = dec.result(rid)
        if len(out) == len(rids):
            break
    else:
        raise AssertionError(f"disaggregated serving not drained: "
                             f"{len(out)}/{len(rids)} done")
    if timings is not None:
        pre.server.export_stream = export
    toks = [out[r] for r in rids]
    for (p, n), t in zip(requests, toks):
        assert len(t) == len(p) + n, "a request came back short"
        assert t[:len(p)] == p, "a prompt came back altered"
    pre.server.allocator.assert_drained()
    dec.server.allocator.assert_drained()
    return toks, handoffs, list(dec_of)


def disagg_full_width(torch, np, device, tmp, setup):
    """(a) Phase 4's LM, params, scheduler geometry and 16 requests
    through a prefill and a decode scheduler on the one card, each with
    ``telemetry_dir``, ``trace_dir`` and rollups in ``tmp``: every request
    finishes, both allocators drain, 16 handoffs each way, paged attention
    (B4) launched n_layers x (prefill chunks + decode steps), fewer syncs
    than decode steps in the decode loop.  Before it the unified fused
    scheduler on the same requests with telemetry and tracing off, on,
    on, off: the ms a tick they cost, and the unified runs the
    disaggregated one stands beside."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig,
    )

    model, params = setup["model"], setup["params"]
    sconf, requests = setup["sconf"], setup["requests"]
    c = model.cfg
    unified = {"off": [], "on": []}
    for i, arm in enumerate(("off", "on", "on", "off")):
        obs = (dict(telemetry_dir=f"{tmp}/unified{i}",
                    trace_dir=f"{tmp}/unified{i}-trace", **DISAGG_TELEMETRY)
               if arm == "on" else {})
        unified[arm].append(serve_measure(
            torch, device, model, params, dict(sconf, **obs), requests,
            f"disagg unified, telemetry + trace {arm}"))
    tick_ms = {arm: [1e3 * r["wall_s"] / r["ticks"] for r in runs]
               for arm, runs in unified.items()}
    clock = synced_clock(torch, device)
    roles = {}
    for role in ("prefill", "decode"):
        roles[role] = Scheduler(model, params, ServeConfig(
            **sconf, role=role, telemetry_dir=f"{tmp}/{role}",
            trace_dir=f"{tmp}/{role}-trace", **DISAGG_TELEMETRY),
            now_fn=clock, device=device)
    pre, dec = roles["prefill"], roles["decode"]
    timings, syncs = {}, []
    paged_attention.launches = 0
    t0 = clock()
    _, handoffs, dec_rids = disagg_pump(torch, pre, dec, requests,
                                        timings=timings, syncs=syncs)
    wall = clock() - t0
    launches = paged_attention.launches
    ps, ds = pre.snapshot(), dec.snapshot()
    passes = (ps["prefill_chunks"] + ps["decode_steps"]
              + ds["prefill_chunks"] + ds["decode_steps"])
    expect = c.n_layers * passes if device.type == "cuda" else 0
    n = len(requests)
    checks = {
        f"handed_off == injected == {n}": (
            ps["handed_off"] == ds["injected"] == n),
        "prefill side decodes nothing, decode side prefills nothing": (
            ps["decode_steps"] == 0 and ds["prefill_chunks"] == 0),
        f"B4 launches {launches} == n_layers x passes {expect}": (
            launches == expect),
        f"decode-loop syncs {sum(syncs)} < decode steps "
        f"{ds['decode_steps']}": (
            device.type != "cuda" or sum(syncs) < ds["decode_steps"]),
        "completed 16 on the decode side": ds["completed"] == n,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"disagg (a): {failed}")
    stats = [dec.stats(r) for r in dec_rids]
    itl = [s.itl_ms for s in stats]
    ttft = [h["ttft_ms"] for h in handoffs]
    kv_bytes_token = c.n_layers * 2 * c.kv_heads * c.head_dim * \
        torch.tensor([], dtype=c.compute_dtype).element_size()
    raw = [r * sconf["block_size"] * kv_bytes_token for r in timings["rows"]]
    out = dict(
        requests=n, handed_off=ps["handed_off"], injected=ds["injected"],
        wall_s=wall, prefill_chunks=ps["prefill_chunks"],
        decode_steps=ds["decode_steps"], launches=launches,
        decode_loop_syncs=sum(syncs),
        export_ms_p50=pct(timings["export_ms"], 50),
        export_ms_max=max(timings["export_ms"]),
        import_ms_p50=pct(timings["import_ms"], 50),
        import_ms_max=max(timings["import_ms"]),
        payload_bytes_p50=pct(timings["payload_bytes"], 50),
        payload_bytes_max=max(timings["payload_bytes"]),
        kv_bytes_per_prompt_token=kv_bytes_token,
        raw_row_bytes_max=max(raw),
        payload_over_raw=sum(timings["payload_bytes"]) / sum(raw),
        longest_prompt=max(timings["prompt_tokens"]),
        decode_tokens_per_s=ds["tokens_out"] / wall,
        decode_itl_p50_ms=pct(itl, 50), decode_itl_p99_ms=pct(itl, 99),
        prefill_ttft_p50_ms=pct(ttft, 50), prefill_ttft_p99_ms=pct(ttft, 99),
        unified={arm: [{k: r[k] for k in (
            "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
            "itl_p99_ms", "wall_s", "ticks")} for r in runs]
            for arm, runs in unified.items()},
        ms_per_tick_telemetry=tick_ms)
    on, off = unified["on"], unified["off"]

    def rates(runs, key="tokens_per_s"):
        return ", ".join(f"{r[key]:.2f}" for r in runs)

    print(f"disagg (a): {n} requests, {ps['handed_off']} handoffs; export "
          f"{out['export_ms_p50']:.1f} ms p50 / {out['export_ms_max']:.1f} "
          f"max, import {out['import_ms_p50']:.1f} / "
          f"{out['import_ms_max']:.1f} ms; payload "
          f"{out['payload_bytes_max'] / 1e6:.2f} MB at most (prompt "
          f"{out['longest_prompt']} tokens; rows "
          f"{out['raw_row_bytes_max'] / 1e6:.2f} MB raw, {kv_bytes_token} "
          f"B of K/V a token; base64 x "
          f"{out['payload_over_raw']:.3f}); decode side "
          f"{out['decode_tokens_per_s']:.1f} tokens/s, ITL "
          f"{out['decode_itl_p50_ms']:.2f} / {out['decode_itl_p99_ms']:.2f} "
          f"ms p50/p99 (unified, telemetry on: {rates(on)} tokens/s, "
          f"ITL p50 {rates(on, 'itl_p50_ms')}, p99 "
          f"{rates(on, 'itl_p99_ms')}; off: {rates(off)} "
          f"tokens/s); prefill side TTFT "
          f"{out['prefill_ttft_p50_ms']:.1f} / "
          f"{out['prefill_ttft_p99_ms']:.1f} ms; B4 {launches} launches; "
          f"decode-loop syncs {sum(syncs)} over {ds['decode_steps']} steps; "
          f"ms a tick with telemetry and tracing off / on / on / off: "
          f"{tick_ms['off'][0]:.2f} / {tick_ms['on'][0]:.2f} / "
          f"{tick_ms['on'][1]:.2f} / {tick_ms['off'][1]:.2f}", flush=True)
    out["records"] = disagg_records(tmp, pre, dec, n)
    return out


def disagg_records(tmp, pre, dec, n):
    """(d) Both roles' telemetry after (a): one ``serve_req`` per request
    the decode side finished, none on the prefill side (its final
    ``serve`` record counts the handoffs), rollup and goodput records and
    heartbeats stamped with each role, the flows' handoff and inject
    stages in the one trace, the load reports' roles;
    ``tools/metrics_summary.py`` and ``tools/obs_agg.py`` (``--json``)
    read both directories."""
    import glob

    reports = {r: s.load_report()["now"]["role"]
               for r, s in (("prefill", pre), ("decode", dec))}
    pre.close()
    dec.close()
    out = {}
    for role in ("prefill", "decode"):
        recs = _jsonl(f"{tmp}/{role}/metrics.jsonl")
        kinds = {}
        for r in recs:
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        final = [r for r in recs if r["kind"] == "serve"][-1]
        stamped = {r["role"] for r in recs
                   if r["kind"] in ("rollup", "goodput")}
        beats = sorted(os.path.basename(f) for f in glob.glob(
            f"{tmp}/{role}/heartbeat*.json"))
        summary = _tool_json("metrics_summary", f"{tmp}/{role}")
        out[role] = dict(kinds=kinds, heartbeats=beats,
                         final_handed_off=final["handed_off"],
                         final_injected=final["injected"],
                         summary_keys=sorted(summary))
        want_req = n if role == "decode" else 0
        ok = (kinds.get("serve_req", 0) == want_req
              and kinds.get("rollup", 0) >= 1
              and kinds.get("goodput", 0) >= 1
              and stamped == {f"serve-{role}"}
              and beats == [f"heartbeat-serve-{role}-p0.json"]
              and reports[role] == role
              and (final["handed_off"] if role == "prefill"
                   else final["injected"]) == n)
        if not ok:
            raise AssertionError(f"disagg (d) {role}: {out[role]}, "
                                 f"stamped {stamped}, load report role "
                                 f"{reports[role]}")
    fleet = _tool_json("obs_agg", f"{tmp}/prefill", f"{tmp}/decode")
    roles = sorted(fleet.get("roles", {}))
    if not {"serve-prefill", "serve-decode"} <= set(roles):
        raise AssertionError(f"disagg (d): obs_agg roles {roles}")
    stages = {}
    for path in glob.glob(f"{tmp}/prefill-trace/trace-*.jsonl"):
        for r in _jsonl(path):
            if r.get("kind") == "flow":
                stages[r.get("stage")] = stages.get(r.get("stage"), 0) + 1
    if stages.get("handoff") != n or stages.get("inject") != n:
        raise AssertionError(f"disagg (d): flow stages {stages}")
    out.update(obs_agg_roles=roles, flow_stages=stages,
               load_report_roles=reports)
    print(f"disagg (d): records prefill {out['prefill']['kinds']}, decode "
          f"{out['decode']['kinds']}; heartbeats "
          f"{out['prefill']['heartbeats'] + out['decode']['heartbeats']}; "
          f"obs_agg roles {roles}; flow stages {stages}", flush=True)
    return out


def _tool_json(tool, *paths):
    """``tools/<tool>.py <paths> --json``, parsed."""
    proc = subprocess.run([sys.executable, str(REPO_ROOT / "tools" /
                                               f"{tool}.py"), *paths,
                           "--json"], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO_ROOT))
    if proc.returncode != 0:
        raise AssertionError(f"tools/{tool}.py {paths}: rc "
                             f"{proc.returncode}\n{proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def disagg_identity(torch, np, device, cfg=None):
    """(b), (c) f32 with TF32 off, phase 5's LM at 2 layers (or ``cfg``)
    and its requests: disaggregated tokens == unified == ``generate()``, with plain
    pools, int8 KV pools and the prefix cache on both sides; payloads
    exported on the card decode on the host (a CPU server of the port,
    the gathered path) to the same tokens, and the other way.  (c)
    ``quiesce()`` with streams in flight on both roles and requests
    queued: both allocators drain, and the drained requests readmitted on
    a fresh scheduler give the same tokens."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer, generate,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        tree_map,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or big_config(torch, n_layers=2, dtype=torch.float32)
    model = Transformer(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 1))
    rng = np.random.default_rng(SEED + 1)
    vocab = cfg.vocab_size
    ragged = [(rng.integers(0, vocab, p).tolist(), 16)
              for p in (5, 40, 100, 300) if p + 16 <= cfg.max_seq_len]
    base = rng.integers(0, vocab, 100).tolist()
    shared = [(base + [1], 12), (base + [2, 3], 12), (base[:37] + [4], 10),
              (base, 12), (base + [1], 8)]
    geom = dict(slots=4, block_size=16, max_len=cfg.max_seq_len,
                prefill_chunk=256, attn_impl="fused",
                num_blocks=4 * -(-cfg.max_seq_len // 16) + 1)

    def sched(role="unified", dev=device, mdl=model, prm=params, **kw):
        return Scheduler(mdl, prm, ServeConfig(**{**geom, **kw}, role=role),
                         device=dev)

    out = {}
    unified = {}
    for tag, kw, reqs in (("plain", {}, ragged),
                          ("int8_kv", dict(kv_quant=True), ragged),
                          ("prefix_cache", dict(prefix_cache=True), shared)):
        uni = drive(sched(**kw), reqs)[1]
        pre, dec = sched("prefill", **kw), sched("decode", **kw)
        dis = disagg_pump(torch, pre, dec, reqs)[0]
        oracle = [generate(model, params, [p], n, device=device,
                           kv_quant=kw.get("kv_quant", False))[0].tolist()
                  for p, n in reqs]
        hits = (dec.snapshot().get("prefix_hits"),
                pre.snapshot().get("prefix_hits"))
        out[tag] = dict(disagg_eq_unified=dis == uni,
                        unified_eq_generate=uni == oracle,
                        handoffs=pre.handed_off, prefix_hits=hits)
        print(f"disagg (b) f32 {tag}: disaggregated == unified "
              f"{dis == uni}, unified == generate() {uni == oracle} "
              f"({len(reqs)} requests, {pre.handed_off} handoffs"
              f"{', prefix hits (decode, prefill) %s' % (hits,) if kw.get('prefix_cache') else ''})",
              flush=True)
        if not (dis == uni == oracle):
            raise AssertionError(f"disagg (b) {tag}: tokens differ")
        unified[tag] = uni
    # card <-> host: a CPU server of the port on a host copy of the params
    cpu = torch.device("cpu")
    host_model = Transformer(cfg, device=cpu)
    host_params = tree_map(lambda t: t.cpu(), params)
    pair = ragged[1:3]
    want = unified["plain"][1:3]
    got = {}
    for src, dst in (("card", "host"), ("host", "card")):
        dev_of = {"card": device, "host": cpu}
        mdl = {"card": model, "host": host_model}
        prm = {"card": params, "host": host_params}
        pre = sched("prefill", dev_of[src], mdl[src], prm[src],
                    attn_impl="fused" if src == "card" else "gathered")
        dec = sched("decode", dev_of[dst], mdl[dst], prm[dst],
                    attn_impl="fused" if dst == "card" else "gathered")
        got[f"{src}_to_{dst}"] = disagg_pump(torch, pre, dec, pair)[0] == want
    out["card_host"] = got
    print(f"disagg (b) f32 payloads across devices (2 requests, prompts "
          f"40 and 100): {got}", flush=True)
    if not all(got.values()):
        raise AssertionError(f"disagg (b): card <-> host tokens {got}")
    # (c) quiesce with a prompt mid-prefill on the prefill side (chunks of
    # 32), streams decoding on the decode side and requests queued
    pre, dec = sched("prefill", prefill_chunk=32), sched("decode")
    extra = [(rng.integers(0, vocab, p).tolist(), 16)
             for p in (60, 7, 20, 33)]
    reqs = ragged + extra
    for p, n in reqs:
        assert pre.submit(p, n) is not None
    waiting = []
    for _ in range(50):
        pre.tick()
        waiting += pre.take_handoffs()
        waiting = [h for h in waiting if dec.inject(h["payload"]) is None]
        dec.tick()
        if pre.tokens_at_risk() and dec.in_flight():
            break
    else:
        raise AssertionError("disagg (c): never in flight on both roles")
    if waiting:
        raise AssertionError("disagg (c): a handoff was left untaken")
    state = dict(prefill_in_flight=pre.in_flight(),
                 prefill_pending=pre.pending(),
                 decode_in_flight=dec.in_flight(),
                 tokens_at_risk=pre.tokens_at_risk() + dec.tokens_at_risk())
    drained = pre.quiesce() + dec.quiesce()     # each asserts its drain
    fresh = sched()
    rids = [fresh.submit(d["prompt"], d["max_new"]) for d in drained]
    fresh.run_until_drained()
    by_prompt = {tuple(p): t for (p, _), t in zip(
        ragged, unified["plain"])}
    oracle = {tuple(p): generate(model, params, [p], n,
                                 device=device)[0].tolist()
              for p, n in extra}
    redo = [fresh.result(r) for r in rids]
    ok = (len(drained) == len(reqs)
          and all(t == {**by_prompt, **oracle}[tuple(d["prompt"])]
                  for d, t in zip(drained, redo)))
    out["drain"] = dict(state, drained=len(drained), reproduced=ok)
    print(f"disagg (c) quiesce: {state}; {len(drained)} drained, "
          f"readmitted tokens equal {ok}", flush=True)
    if not ok:
        raise AssertionError("disagg (c): readmission changed the tokens")
    fresh.server.allocator.assert_drained()
    return out


def load_sweep(torch, device, setup, loads=(4, 16), per_client=2,
               mix="long_prefill"):
    """(e) ``serve.loadgen.sweep_loads`` on the unified fused scheduler at
    full width with a synced clock: ``loads`` closed-loop clients,
    ``per_client`` requests each, traffic of ``mix``."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig, resolve_mix, sweep_loads,
    )

    model, params, sconf = setup["model"], setup["params"], setup["sconf"]
    prompt_lens, max_new, spl, frac = resolve_mix(mix, None, None, 0, 0.0)
    rows = sweep_loads(
        lambda: Scheduler(model, params, ServeConfig(**sconf),
                          now_fn=synced_clock(torch, device), device=device),
        list(loads), per_client, vocab_size=model.cfg.vocab_size,
        prompt_lens=prompt_lens, max_new=max_new, seed=SEED,
        shared_prefix_len=spl, shared_fraction=frac)
    keys = ("clients", "requests", "tokens_per_sec", "ttft_ms_p50",
            "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99", "ttft_ms_p50_shared",
            "ttft_ms_p50_unique", "evicted")
    out = [{k: r.get(k) for k in keys} for r in rows]
    for r in out:
        if r["requests"] != r["clients"] * per_client:
            raise AssertionError(f"load sweep: {r}")
        print(f"disagg (e) load sweep {mix}: " + json.dumps(r), flush=True)
    return out


def disagg_phase(torch, np, device, setup, cfg_f32=None):
    """Phase 27: (a) + (d), (e), (b) + (c) (``cfg_f32``: their LM)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-disagg-")
    try:
        out = dict(full_width=disagg_full_width(torch, np, device, tmp,
                                                setup))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["sweep"] = load_sweep(torch, device, setup)
    out["identity"] = disagg_identity(torch, np, device, cfg=cfg_f32)
    out["phase_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the GPU only",
              file=sys.stderr)
        return 1
    try:
        import numpy as np

        import neural_networks_parallel_training_with_mpi_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not importable next to chip_smoke.py: {e}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase("2 build")
    build_kernels()

    phase("3 kernels against their plain versions")
    max_err = check_kernels(torch, device)
    timing = time_paged_attention(torch, device)
    # the other head_dims and blocks the kernel takes
    other_shapes = [dict(head_dim=hd, block_size=bs, **time_paged_attention(
        torch, device, head_dim=hd, block_size=bs, sweep=False))
        for hd, bs in ((32, 16), (64, 64), (64, 128))]

    phase("4 serve the 218M LM through the fused kernel")
    # phase 27 serves the same LM and requests
    serve_kept = {}
    served = serve_full_width(torch, np, device, keep=serve_kept,
                              n_requests=16)

    phase("5 f32 token identity")
    token_identity(torch, np, device)
    # the flagship geometry: paged attention at head_dim 32, blocks of 16
    # and of 64 keys
    for bs in (16, 64):
        token_identity(torch, np, device, cfg=flagship_config(torch),
                       block_size=bs, tag=f" flagship (head_dim 32, block "
                                          f"{bs})")

    phase("6 flash attention against its plain versions")
    flash_err = check_flash(torch, device)
    flash_timing = time_flash(torch, device)
    small_timing = time_flash_small(torch, device)

    phase("7 train the 219M LM at full width through the flash kernels")
    # phase 21 fingerprints this run's final state (a host copy)
    final_state = {}
    trained = train_full_width(torch, np, device,
                               inspect=keep_state(final_state))

    phase("8 f32 training identity: flash == dense")
    train_identity(torch, np, device)

    phase("9 flash_attention_with_lse against its plain version")
    lse_err = check_flash_lse(torch, device)
    lse_timing = time_flash_lse(torch, device)

    phase("10 ring and striped flash over a local group of 4 vs full flash")
    check_ring(torch, device)
    check_ring(torch, device, shape=(8, 128, 16, 64), timed=False)

    phase("11 train the 219M LM with striped_flash over a local group of 4")
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        LocalSeqGroup,
    )

    seq_trained = train_full_width(torch, np, device,
                                   seq_group=LocalSeqGroup(4),
                                   keep_final=True,
                                   attention="striped_flash", sp=4)
    merge_ms = (seq_trained["profile_ms_per_step"].get("other", 0.0)
                - trained["profile_ms_per_step"].get("other", 0.0))
    print(f"seqtrain: step {seq_trained['step_ms_median']:.2f} ms vs flash "
          f"{trained['step_ms_median']:.2f} ms; elementwise ('other') "
          f"{merge_ms:+.2f} ms/step over flash (the lse merges, the "
          f"splits and joins)", flush=True)
    # B5 under quantized compute: every Linear quantizes its 4 sequence
    # shards as 4 ranks would (fp8 takes no --ce_chunk); at phase 15's
    # depth, for the time limit
    seq_quant = {}
    for fmt, ce in (("int8", 256), ("fp8", 0)):
        q = train_full_width(torch, np, device, seq_group=LocalSeqGroup(4),
                             profile=False,
                             tag=f"train striped_flash {fmt} "
                                 f"{CUT_LAYERS} layers",
                             attention="striped_flash", sp=4,
                             matmul_dtype=fmt, ce_chunk=ce, nepochs=1,
                             n_layers=CUT_LAYERS)
        seq_quant[fmt] = {k: q[k] for k in (
            "step_ms_median", "peak_memory_gib", "first_loss", "last3_loss",
            "with_lse_launches", "gemm_launches")}
        print(f"seqtrain {fmt} {CUT_LAYERS} layers: step "
              f"{q['step_ms_median']:.2f} ms vs bf16 "
              f"{seq_trained['step_ms_median']:.2f} ms (12 layers), peak "
              f"memory "
              f"{q['peak_memory_gib']:.2f} vs "
              f"{seq_trained['peak_memory_gib']:.2f} GiB, with_lse "
              f"launches {q['with_lse_launches']}", flush=True)

    phase("12 f32 training identity: ring_flash == striped_flash == flash")
    train_identity_seq(torch, np, device)

    phase("13 fused_layernorm against its plain version")
    ln_err, ln_launches = check_layernorm(torch, device)
    ln_timing = time_layernorm(torch, device)

    phase("14 reference: the reference job through the CLI, quality bars")
    reference_job()
    quality_bars(device)

    phase("15 resume: checkpoint, resume and --generate of the 219M LM at "
          f"{CUT_LAYERS} layers")
    # phase 7's job cut to CUT_LAYERS layers (full width), eager: the
    # reference of 15, 16 (a), 17 (c) and 19 (d)
    short = train_full_width(torch, np, device, keep_final=True,
                             profile=False, n_layers=CUT_LAYERS,
                             tag=f"train {CUT_LAYERS} layers")
    resume_full_width(torch, np, device, short, n_layers=CUT_LAYERS)

    phase("16 dispatch: --steps_per_dispatch as CUDA-graph replay")
    dispatch_full_width(torch, np, device, short, n_layers=CUT_LAYERS,
                        tag=f"dispatch {CUT_LAYERS} layers")
    # the striped job unprofiled, for the time limit: its graphed step,
    # bitwise identity and launches by design stay
    dispatch_full_width(torch, np, device, seq_trained,
                        seq_group=LocalSeqGroup(4), profile=False,
                        attention="striped_flash", sp=4)
    del seq_trained["final_params"]
    dispatch_identity(torch, np, device)

    phase("17 slice: the auto row, --remat, --scan-layers, update sharding, "
          "master weights")
    auto = measure_auto(torch, np, device)
    # phase 18 (d)'s host runs, in a subprocess beside 17 (b)-(f) (checks,
    # not a timed pick) and 18 (a)-(c)
    import shutil
    import tempfile

    quant_tmp = tempfile.mkdtemp(prefix="chip-smoke-quant-")
    quant_host = start_quant_host(quant_tmp)
    try:
        sliced = slice_full_width(torch, np, device, short)

        phase("18 quantized compute: --matmul_dtype int8|fp8, --quantize "
              "int8")
        quant = dict(products=check_qmm(torch, device),
                     card_vs_host=qdot_card_vs_host(torch, device))
        # (b)-(c) at phase 15's depth: its bf16 run is their reference
        quant["train"] = quant_train_full_width(
            torch, np, device, short, nepochs=1, n_layers=CUT_LAYERS)
        quant["identity"] = quant_identity(
            torch, np, device, read_quant_host(torch, np, *quant_host))
    finally:
        if quant_host[0].poll() is None:
            quant_host[0].kill()
            quant_host[0].wait()
        shutil.rmtree(quant_tmp, ignore_errors=True)
    # 16 of phase 4's requests an arm's run, for the time limit
    quant["serve"] = quant_serve(torch, np, device, n_requests=16)
    print("quant: " + json.dumps(quant), flush=True)

    # phase 21 (c)'s snapshot is written on the host by 2 gloo ranks,
    # started once phase 19's timed runs are done (beside its (b)-(e))
    import shutil
    import tempfile

    elastic_tmp = tempfile.mkdtemp(prefix="chip-smoke-elastic-")
    writer = []
    try:
        phase("19 resilience: guard, faults, rollback, SIGTERM, supervisor, "
              "watchdog")
        resilience, res_launches = resilience_full_width(
            torch, np, device, short, background=lambda: writer.extend(
                elastic_writer(elastic_tmp, f"{elastic_tmp}/ck")))
        print("resilience: " + json.dumps(resilience), flush=True)

        phase("20 observability: telemetry, tracing, the capture ledger, "
              "goodput, the profiler, postmortems")
        observability, obs_launches = observability_full_width(
            torch, np, device, resilience)
        print("observability: " + json.dumps(observability), flush=True)

        phase("21 replica consistency and elastic resume: the fingerprint "
              "kernel, localize + heal, N -> M restore, the capacity floor")
        sdc = sdc_elastic_full_width(torch, np, device,
                                     final_state.pop("leaves"), elastic_tmp,
                                     writer)
    finally:
        stop_writer(writer)
        shutil.rmtree(elastic_tmp, ignore_errors=True)

    phase("22 tensor parallelism: Megatron f/g and the vocab-parallel CE, DP "
          "x TP, DP x SP x TP, ulysses and dense_blockwise")
    tensor, tp_final = tensor_parallel_full_width(torch, np, device)
    print("tensor_parallel: " + json.dumps(tensor), flush=True)

    phase("23 the GSPMD layout's memory half: int8/fp8 under TP, --fsdp, "
          "the sliced state, sharded under TP, the replica check under "
          "TP, --generate --tp")
    gspmd_mem = gspmd_memory_half(torch, np, device, short, tp_final)
    del tp_final
    print("gspmd_memory_half: " + json.dumps(gspmd_mem), flush=True)

    phase("24 pipeline parallelism: --pp and --pp_interleave over a local "
          "pipe group, pipe x tensor, pipe x seq, --generate from a pipe "
          "snapshot")
    pipeline = pipeline_full_width(torch, np, device)
    print("pipeline: " + json.dumps(pipeline), flush=True)

    phase("25 MoE and expert parallelism: the layer, --ep 4, top-2 on DP, "
          "the f32 identities, --generate from (b)'s snapshot, MoE "
          "serving")
    moe_kept = {}
    moe = moe_full_width(torch, np, device, keep=moe_kept)
    print("moe: " + json.dumps(moe), flush=True)

    phase("26 MoE on the pipe and GSPMD layouts: --pp 2 --ep 2, MoE under "
          "--tp 4 / --fsdp 4 (global-batch routing), the f32 identities, "
          "generate_tp")
    moe_layouts = moe_layouts_full_width(torch, np, device,
                                         init=moe_kept.pop("init"))
    print("moe_layouts: " + json.dumps(moe_layouts), flush=True)
    torch.distributed.destroy_process_group()

    phase("27 disaggregated serving: the prefill -> decode block handoff, "
          "the roles' telemetry, tracing and drain, the load sweep")
    disagg = disagg_phase(torch, np, device, serve_kept)
    del serve_kept
    print("disagg: " + json.dumps(disagg), flush=True)

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    src = "neural_networks_parallel_training_with_mpi_tpu_torch/csrc/"
    tpu = "neural_networks_parallel_training_with_mpi_tpu/ops/pallas_kernels.py"
    kernels = [dict(name="paged_attention", route="cuda",
                    source=src + "paged_attention.cu",
                    design="split-K over the context, cp.async ring, "
                           "in-kernel merge in split order",
                    takes="head_dim 32/64/128; pool blocks of any multiple "
                          "of 16 keys (16, 32, 64, 128 checked)",
                    replaces=f"{tpu}:486",
                    launches=(served["launches"] + moe["paged_launches"]
                              + disagg["full_width"]["launches"]),
                    launches_phase25=moe["paged_launches"],
                    # phase 27 (a): both roles of the disaggregated run
                    launches_phase27=disagg["full_width"]["launches"],
                    max_abs_err=max_err, other_shapes=other_shapes,
                    **timing)]
    # phase 22 (b): the DP x TP run, eager and graphed
    tp_launches = {w: tensor["dp_tp"]["launches"][w]
                   + tensor["dp_tp_graphed"]["launches"][w]
                   for w in ("fwd", "dq", "dkv")}
    for which, line in (("fwd", 97), ("dq", 255), ("dkv", 296)):
        # bf16 on the tensor cores; f32 on csrc/flash_attention.cu
        kernels.append(dict(name=f"flash_attention_{which}", route="cuda",
                            source=src + "flash_attention_sm90.cu",
                            sources=[src + "flash_attention_sm90.cu",
                                     src + "flash_attention.cu"],
                            design="sm90 wgmma + cp.async (bf16, head_dim "
                                   "32/64/128); simt (f32, and bf16 at "
                                   "head_dim 8/16)",
                            takes="head_dim 8/16/32/64/128, any T the "
                                  "blocks divide",
                            replaces=f"{tpu}:{line}",
                            # phase 7's run and phases 19, 20 and 21's
                            # in-process runs
                            launches=(trained["launches"][which]
                                      + res_launches[which]
                                      + obs_launches[which]
                                      + sdc["elastic"]["flash_launches"][
                                          which]
                                      + tp_launches[which]
                                      + gspmd_mem["flash_launches"][which]
                                      + pipeline["flash_launches"][which]
                                      + moe["flash_launches"][which]
                                      + moe_layouts["flash_launches"][
                                          which]),
                            launches_phase7=trained["launches"][which],
                            launches_phase22=tp_launches[which],
                            launches_phase23=gspmd_mem["flash_launches"][
                                which],
                            launches_phase24=pipeline["flash_launches"][
                                which],
                            launches_phase25=moe["flash_launches"][which],
                            launches_phase26=moe_layouts["flash_launches"][
                                which],
                            launches_phase20=obs_launches[which],
                            launches_phase21=sdc["elastic"][
                                "flash_launches"][which],
                            max_abs_err=flash_err[which],
                            **flash_timing[which]))
    # bf16 at head_dim 8 and 16 (simt), timed at (8, 1024, 16, d)
    kernels[1]["small_head_dims"] = small_timing
    # under --remat the forward runs again in the backward (phase 17)
    kernels[1]["launches_remat_full"] = sliced["remat_full"]["launches"]["fwd"]
    kernels[1]["auto_row"] = {k: r["measured_row"] for k, r in auto.items()}
    kernels.append(dict(name="flash_attention_with_lse", route="cuda",
                        source=src + "flash_attention_sm90.cu",
                        sources=[src + "flash_attention_sm90.cu",
                                 src + "flash_delta.cuh",
                                 src + "flash_attention.cu"],
                        design="sm90 (bf16): forward kernel, then one C "
                               "call: delta kernel, dq + dk/dv in one "
                               "shared launch up to T "
                               f"{fa.SHARED_MAX_T}, else two; masked tail "
                               "tiles; f32, and bf16 at head_dim 8/16, on "
                               "the simt source",
                        takes="head_dim 8/16/32/64/128, any T the blocks "
                              "divide",
                        replaces=f"{tpu}:445",
                        launches=(seq_trained["with_lse_launches"]
                                  + obs_launches["with_lse"]
                                  + tensor["sp_tp"]["with_lse_launches"]
                                  + pipeline["with_lse_launches"]
                                  + moe["with_lse_launches"]
                                  + moe_layouts["with_lse_launches"]),
                        # phase 25 (d): sp 2 x ep 2, f32, 2 layers
                        launches_phase25=moe["with_lse_launches"],
                        # phase 26 (b): pp 2 x sp 2 x ep 2, f32, 2 layers
                        launches_phase26=moe_layouts["with_lse_launches"],
                        launches_phase20=obs_launches["with_lse"],
                        # phase 24 (e): pp 2 x sp 2, 2 layers
                        launches_phase24=pipeline["with_lse_launches"],
                        # phase 22 (d): sp 2 x tp 2, 2 layers
                        launches_phase22=tensor["sp_tp"][
                            "with_lse_launches"],
                        launches_int8=seq_quant["int8"]["with_lse_launches"],
                        launches_fp8=seq_quant["fp8"]["with_lse_launches"],
                        max_abs_err=lse_err, **lse_timing))
    kernels.append(dict(name="fused_layernorm", route="cuda",
                        source=src + "layernorm.cu", replaces=f"{tpu}:711",
                        takes="any rows, d_model up to 4096, f32 or bf16",
                        launches=ln_launches, max_abs_err=ln_err,
                        **ln_timing))
    # no Pallas counterpart: XLA ops in the JAX package
    fp_timing = sdc["fingerprint"]
    kernels.append(dict(
        name="fingerprint", route="cuda", source=src + "fingerprint.cu",
        replaces="none (no pl.pallas_call): XLA ops of "
                 "neural_networks_parallel_training_with_mpi_tpu/utils/"
                 "consistency.py:329 (Fingerprinter.device_fp)",
        takes="any number of leaves in one launch: f32, bf16, f16, int32, "
              "int8, uint8/bool, int64",
        launches=sdc["elastic"]["fp_launches"],
        # phase 23 (e)'s digests of two replicas: checks, not the path
        launches_phase23_checks=gspmd_mem["replica_check_tp"]["launches"],
        **{k: fp_timing[k] for k in (
            "max_abs_err", "digest_mismatches", "digest_max_abs_err",
            "fold_max_abs_err", "fold_rel_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "bytes")}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["--moe-host"], ["--pp-ep-host"],
                         ["--quant-host"]):
        # phase 25 (d)'s, phase 26 (b)'s and phase 18 (d)'s host runs,
        # subprocesses of the card's run
        import numpy
        import torch

        if sys.argv[1] == "--moe-host":
            moe_host_runs(torch, torch.device("cpu"), sys.argv[2])
        elif sys.argv[1] == "--pp-ep-host":
            moe_host_runs(torch, torch.device("cpu"), sys.argv[2],
                          jobs=PP_EP_HOST_JOBS)
        else:
            write_quant_host(torch, numpy, sys.argv[2])
        sys.exit(0)
    sys.exit(main())
