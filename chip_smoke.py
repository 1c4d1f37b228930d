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
              inside a split.  Times the kernel at 32-512 keys per split,
              its plain version and a library yardstick (gather +
              ``F.scaled_dot_product_attention``) at the decode shape,
              medians of single calls, beside the bound (bytes or
              operations at the card's peak).
4. serve    — the 218M-parameter LM (vocab 32768, 12 layers, d_model
              1024, 16 heads, d_ff 4096; random weights from a seed, bf16)
              behind ``Scheduler`` -> ``PagedDecodeServer`` with
              ``attn_impl="fused"``: 32 seeded greedy requests (prompts
              64-768 tokens, 32-128 new tokens).  Every request must
              finish, the allocator must drain, and the kernel's launch
              count must equal n_layers x (prefill chunks + decode
              steps).  Prints tokens/s, TTFT and ITL percentiles.
5. tokens   — f32 with TF32 off, the same LM at 2 layers: the fused
              scheduler, the gathered scheduler and ``generate()`` give
              identical greedy tokens; then fused == gathered again with
              int8 KV pools and the prefix cache on.
6. flash    — the flash-attention forward, dq and dkv kernels against
              their plain versions at the training shape (8, 1024, 16, 64)
              in bf16 and f32 and all three mask modes, plus T 256 with
              blocks 64 x 128, head_dim 128 and 32, and T 320 (a multiple
              of 64, not of 128) with blocks 64 x 64; q/k/v are the
              strided views of a fused qkv tensor.  The bf16 forward, dq
              and dkv run the sm90 kernels (wgmma, cp.async) and are held
              against both plain versions: the one that rounds P and dS
              to bf16 as they do (tighter tolerance) and the unrounded
              one.  Each case's launches by design, read from the
              counters.  Times each kernel, its plain version and the
              library yardstick (``F.scaled_dot_product_attention``,
              forward and forward+backward) beside the bound.
7. train    — the 219M LM trained at full width through the port's
              ``Trainer`` (CLI flags, a 1-rank NCCL group so the gradient
              all-reduce runs): bytes of DESIGN.md, batch 8 x 1024, bf16
              compute, f32 params, flash attention, ce_chunk 256, 2 epochs
              of Adam (26 steps).  Every loss finite, the last 3 steps'
              mean 1 nat below the first, each flash launch count equal
              to 12 x steps, all on the sm90 kernels.  Prints step time,
              tokens/s, MFU, peak memory and a profile of 3 more steps.
8. identity — f32, TF32 off, 2 layers: 3 SGD-momentum steps with flash
              and with dense attention from the same params and batches
              agree.
9. with_lse — ``flash_attention_with_lse`` (out, lse and the lse
              cotangent folded into delta, over the fwd/dq/dkv kernels)
              against its plain version at the ring's shard shape
              (8, 256, 16, 64) in bf16 and f32 and all three mask modes:
              out, lse, and dq/dk/dv of sum(out * w) + sum(lse * u).
              bf16 dq/dk/dv also against the rounding plain versions;
              each case's launches by design.  Times it beside its bound, its
              plain version and SDPA forward+backward.
10. ring    — ``ring_flash_attention`` and ``striped_ring_flash_attention``
              over a ``LocalSeqGroup(4)`` at (8, 1024, 16, 64) bf16 (the
              striped one on permuted inputs) against full-sequence flash
              attention: output and q/k/v gradients, launches per call
              (striped 16 of each kernel, ring 10: future blocks skipped),
              and the time of each beside full flash.
11. seqtrain — the 219M LM trained as in phase 7 but with
              ``striped_flash`` over ``LocalSeqGroup(4)`` (T_local 256):
              finite losses falling 1 nat, 12 x 16 launches per step of
              each flash kernel (by design as in phase 7) and of
              ``flash_attention_with_lse``; step
              time, tokens/s, MFU, peak memory and a profile.
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
15. resume   — phase 7's flags with ``--checkpoint_dir``: one epoch (13
              steps) and its snapshot, then a new ``Trainer`` with
              ``--nepochs 2 --resume --async-checkpoint
              --checkpoint_every 13``: steps 14-26's losses and the final
              params against phase 7's uninterrupted run, bitwise (the
              largest differences are printed);
              the async snapshot of step 26 restored and equal to the
              state, leaf for leaf; ``--generate`` of 32 tokens from it as
              a subprocess equal to the in-process ``generate()``, greedy
              and sampled (temperature 1, the same seed).  Prints the
              snapshot's bytes and the save and restore seconds.

The last lines are the kernels JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
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


def device_busy_ms(torch, fn, calls=3):
    """Device time of one call: the sum of its kernels' durations under
    ``torch.profiler`` (gaps between them excluded), over ``calls`` calls.
    A one-element marker kernel (~µs, counted) opens the window, whose
    first kernel the profiler can drop."""
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
    return sum(ev.device_time_total for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / 1e3 / calls


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


def time_paged_attention(torch, device):
    """Kernel, plain version and library yardstick at the decode shape
    of phase 4 (16 lanes, 16 heads of 64, block 16, bf16; the table at
    the server's capacity of 64 blocks), each the median of single calls
    behind a GPU sleep.  The kernel is timed at several split sizes
    (``SPLIT_KEYS``); the row's time is that of the size the port
    ships."""
    import torch.nn.functional as F

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        paged_attention as pa,
    )

    lengths = decode_lengths()
    case = make_case(torch, device, torch.bfloat16, lengths,
                     [max(ln - 1, 0) for ln in lengths], 1, 16, 16,
                     max_blocks=64)
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
    sweep = {}
    try:
        for keys in sorted({32, 64, 128, 256, 512, shipped}):
            pa.SPLIT_KEYS = keys
            sweep[keys] = median_ms(torch, lambda: pa.paged_attention(*args))
    finally:
        pa.SPLIT_KEYS = shipped
    pa.paged_attention.launches = before   # timing launches do not count
    kernel_ms = sweep[shipped]
    split_blocks, n_splits = pa.split_plan(tables.shape[1], bs)
    plain_ms = median_ms(torch, lambda: pa.paged_attention_reference(*args))
    library_ms = median_ms(torch, library)
    bound_ms, bound_by = paged_bound(case)
    print(f"paged_attention decode (16 lanes, sum(len)={sum(lengths)}, "
          f"bf16, table of {tables.shape[1]} blocks): split_blocks "
          f"{split_blocks} ({split_blocks * bs} keys), {n_splits} splits; "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"medians of 25", flush=True)
    print("paged_attention split sweep (keys per split: kernel ms): "
          + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(sweep.items())),
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


def flash_cases():
    """(name, kwargs) for every flash case: the training shape in both
    dtypes and all three mask modes, then T 256 with blocks 64 x 128,
    head_dim 128, and in bf16 head_dim 32 and T 320 (a multiple of 64 but
    not of 128) with blocks 64 x 64 in two mask modes."""
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
    """Every flash case: the fwd, dq and dkv kernels against their plain
    versions on the same inputs, the sm90 ones (bf16) also against the
    plain versions that round as they do; each case launches
    each kernel once, on the design ``kernel_design`` routes it to, as the
    by-design counters show.  Returns {kernel: largest abs error against
    the unrounded plain version}."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for i, (name, kw) in enumerate(cases or flash_cases()):
        dtype = getattr(torch, kw["dtype"])
        q, k, v, dout = make_flash_case(torch, device, dtype, kw["shape"],
                                        seed=100 + i)
        mask = kw["mask"]
        blocks = (kw.get("block_q", 128), kw.get("block_k", 128))
        before = fa.launch_counts()
        out, lse = fa.flash_forward(q, k, v, mask, *blocks)
        delta = fa.flash_delta(out, dout)
        dq = fa.flash_backward_dq(q, k, v, dout, lse, delta, mask, *blocks)
        dk, dv = fa.flash_backward_dkv(q, k, v, dout, lse, delta, mask,
                                       *blocks)
        if device.type == "cuda":
            torch.cuda.synchronize()
        after = fa.launch_counts()
        # the design each kernel ran on, by the counters (none on the CPU)
        ran = {w: [d for d in ("sm90", "simt")
                   if after[d].get(w, 0) > before[d].get(w, 0)]
               for w in worst}
        n = int(device.type == "cuda")
        routed = {w: fa.kernel_design(w, dtype, kw["shape"][-1])
                  for w in worst}
        launched_ok = all(
            sum(after[d].get(w, 0) - before[d].get(w, 0)
                for d in ("sm90", "simt")) == n
            and ran[w] == ([routed[w]] if n else [])
            for w in worst)
        # the plain side is fed the kernel's out/lse, so each kernel is
        # held against its own plain version on identical inputs
        r_out, r_lse = fa.flash_forward_reference(q, k, v, mask, blocks[1])
        r_dq = fa.flash_dq_reference(q, k, v, dout, lse, delta, mask)
        r_dk, r_dv = fa.flash_dkv_reference(q, k, v, dout, lse, delta, mask)
        atol, rtol = TOL[str(dtype)]
        gatol, grtol = GRAD_TOL[str(dtype)]
        f32 = TOL["torch.float32"]
        results = {
            "fwd": [_close(torch, out, r_out, atol, rtol),
                    _close(torch, lse, r_lse, *f32)],
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
        if routed["fwd"] == "sm90":
            # 64-key blocks: the running max the kernel rounds P under
            g_out, _ = fa.flash_forward_reference(q, k, v, mask, 64,
                                                  round_p=True)
            rounded["fwd"] = [_close(torch, out, g_out, *ROUND_TOL)]
        if routed["dq"] == "sm90":
            g_dq = fa.flash_dq_reference(q, k, v, dout, lse, delta, mask,
                                         round_p=True)
            rounded["dq"] = [_close(torch, dq, g_dq, *ROUND_GRAD_TOL,
                                    scaled=True)]
        if routed["dkv"] == "sm90":
            g_dk, g_dv = fa.flash_dkv_reference(q, k, v, dout, lse, delta,
                                                mask, round_p=True)
            rounded["dkv"] = [_close(torch, dk, g_dk, *ROUND_GRAD_TOL,
                                     scaled=True),
                              _close(torch, dv, g_dv, *ROUND_GRAD_TOL,
                                     scaled=True)]
        parts = []
        ok_all = launched_ok
        for kern, res in results.items():
            ok = all(r[0] for r in res + rounded.get(kern, []))
            err = max(r[1] for r in res)
            worst[kern] = max(worst[kern], err)
            ok_all = ok_all and ok
            part = f"{kern} [{'/'.join(ran[kern]) or 'plain'}] {err:.3e}"
            if kern in rounded:
                part += (" (rounding plain version "
                         f"{max(r[1] for r in rounded[kern]):.3e})")
            parts.append(part + ("" if ok else " FAIL"))
        print(f"flash {name} {tuple(kw['shape'])} blocks {blocks}: "
              + ", ".join(parts) + f" (tolerance out atol {atol} + rtol "
              f"{rtol}; lse {f32}; grads {gatol}*max|ref| + {grtol}*|ref|; "
              f"against the rounding plain version out {ROUND_TOL}, grads "
              f"{ROUND_GRAD_TOL}); launches "
              f"{'ok' if launched_ok else f'FAIL (routed to {routed})'}",
              flush=True)
        if not ok_all:
            raise AssertionError(f"flash attention disagrees with its plain "
                                 f"version, or ran another design, in case "
                                 f"{name}")
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
    shape (bf16, causal).  Returns {kernel: timing dict}."""
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype = torch.bfloat16
    q, k, v, dout = make_flash_case(torch, device, dtype, FLASH_SHAPE)
    out, lse = fa.flash_forward(q, k, v, "causal")
    delta = fa.flash_delta(out, dout)
    before = fa.launch_counts()
    kernel = {
        "fwd": time_ms(torch, lambda: fa.flash_forward(q, k, v), 50),
        "dq": time_ms(torch, lambda: fa.flash_backward_dq(
            q, k, v, dout, lse, delta), 20),
        "dkv": time_ms(torch, lambda: fa.flash_backward_dkv(
            q, k, v, dout, lse, delta), 50),
    }
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
    print(f"flash library yardstick (F.scaled_dot_product_attention, "
          f"is_causal, median of 25): forward {sdpa_fwd:.4f} ms, "
          f"forward+backward {sdpa_both:.4f} ms, backward alone "
          f"{sdpa_bwd:.4f} ms; kernels fwd+dq+dkv "
          f"{sum(kernel.values()):.4f} ms", flush=True)
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


def serve_full_width(torch, np, device, cfg=None, n_requests=32,
                     slots=16, warmup=2, **req_kw):
    from neural_networks_parallel_training_with_mpi_tpu_torch.models import (
        Transformer,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.serve import (
        Scheduler, ServeConfig,
    )

    cfg = cfg or big_config(torch)
    model = Transformer(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    print(f"model: {model.n_params(params) / 1e6:.1f}M parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.compute_dtype}", flush=True)
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
    # warm-up on its own scheduler: first-call costs (cuBLAS handles,
    # allocator growth) stay out of the measured run
    drive(Scheduler(model, params, ServeConfig(**sconf), device=device),
          requests[:warmup])
    sched = Scheduler(model, params, ServeConfig(**sconf),
                      now_fn=synced_clock(torch, device), device=device)
    paged_attention.launches = 0
    t0 = sched.now()
    rids, _ = drive(sched, requests[warmup:])
    wall = sched.now() - t0
    launches = paged_attention.launches
    snap = sched.snapshot()
    passes = snap["prefill_chunks"] + snap["decode_steps"]
    # one launch per layer per forward pass; CPU tensors (a rehearsal of
    # this script's control flow) take the plain version and launch none
    expect = cfg.n_layers * passes if device.type == "cuda" else 0
    if launches != expect:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected n_layers x passes = {expect}")
    stats = [sched.stats(r) for r in rids]
    ttft = [s.ttft_ms for s in stats]
    itl = [s.itl_ms for s in stats]
    out = dict(requests=len(rids), tokens_out=snap["tokens_out"],
               wall_s=wall, tokens_per_s=snap["tokens_out"] / wall,
               ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
               itl_p50_ms=pct(itl, 50), itl_p99_ms=pct(itl, 99),
               prefill_chunks=snap["prefill_chunks"],
               decode_steps=snap["decode_steps"], launches=launches,
               attended_ratio=snap["attended_ratio"],
               evicted=snap["evicted"])
    print("serve: " + json.dumps(out), flush=True)
    if device.type == "cuda":
        make = lambda: Scheduler(model, params,  # noqa: E731
                                 ServeConfig(**sconf), device=device)
        count_host_syncs(torch, make, requests[warmup:warmup + slots])
        profile_serving(torch, make, requests[warmup:warmup + slots])
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


def profile_serving(torch, make_scheduler, requests):
    """Where the serving time goes: one profiled drain of ``requests``
    (a fresh scheduler, so every request is admitted at once).  Prints
    the device's busy share of the window, device kernels per forward
    pass, and the top kernels by device time.  The profiler's own cost
    lengthens the window, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sched = make_scheduler()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(sched, requests)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.device_time_total, cnt + 1)
    busy_us = sum(t for t, _ in by_name.values())
    n_dev = sum(c for _, c in by_name.values())
    snap = sched.snapshot()
    passes = snap["prefill_chunks"] + snap["decode_steps"]
    print(f"profile: {len(requests)} requests, {passes} forward passes, "
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

def token_identity(torch, np, device, cfg=None):
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
              for p in (5, 40, 100, 300)]
    base = rng.integers(0, vocab, 100).tolist()
    shared = [(base + [1], 12), (base + [2, 3], 12), (base[:37] + [4], 10),
              (base, 12), (base + [1], 8)]
    geom = dict(slots=4, block_size=16, max_len=cfg.max_seq_len,
                prefill_chunk=256,
                num_blocks=4 * -(-cfg.max_seq_len // 16) + 1)

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
    print(f"tokens f32: fused == gathered == generate() for "
          f"{len(ragged)} ragged requests", flush=True)
    fq, sched = run(shared, attn_impl="fused", kv_quant=True,
                    prefix_cache=True)
    gq, _ = run(shared, attn_impl="gathered", kv_quant=True,
                prefix_cache=True)
    hits = sched.snapshot()["prefix_hits"]
    if fq != gq or hits == 0:
        raise AssertionError(f"int8 + prefix cache: fused == gathered is "
                             f"{fq == gq}, prefix hits {hits}")
    print(f"tokens f32 int8-KV + prefix cache: fused == gathered for "
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
    return [f"--{k}={v}" for k, v in flags.items()]


def one_rank_group(torch, device):
    """A process group of one (NCCL on the card), so the train step's
    gradient all-reduce runs as it would in a larger world."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)


def ring_blocks(attention, s):
    """Block calls per layer and step of each flash kernel: 1 for flash,
    S^2 for striped_flash, S(S+1)/2 for causal ring_flash."""
    return {"flash": 1, "striped_flash": s * s,
            "ring_flash": s * (s + 1) // 2}[attention]


def train_full_width(torch, np, device, seq_group=None, keep_final=False,
                     **over):
    """Train through the port's own Trainer and CLI config (over
    ``seq_group`` for a sequence-sharded attention); check finite, falling
    losses and the flash launch counts; print step time, tokens/s, MFU,
    peak memory and a profile of 3 more steps.  Returns the printed
    numbers and every step's loss; with ``keep_final``, also a host copy
    of the params after the last step (taken before the profile's
    steps)."""
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
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
    )

    one_rank_group(torch, device)
    with tempfile.TemporaryDirectory() as tmp:
        metrics = f"{tmp}/metrics.jsonl"
        args = build_argparser().parse_args(
            train_flags(metrics_jsonl=metrics, **over))
        cfg = config_from_args(args)
        trainer = Trainer(cfg, device=device, seq_group=seq_group)
        trainer.init_state()
        n_params = sum(p.numel() for p in leaves(trainer.state.params))
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        fa.set_launch_counts()
        result = trainer.fit()
        counts = fa.launch_counts()
        final = ([p.detach().cpu() for p in leaves(trainer.state.params)]
                 if keep_final else None)
        launches, with_lse = counts["all"], counts["with_lse"]
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in sorted(records, key=lambda r: r["step"])
              if "loss" in r]
    steps = result["steps"]
    m = cfg.model
    tag = "train" if seq_group is None else f"train {m.attention}"
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
    per_step = m.n_layers * ring_blocks(m.attention, s_n)
    expect = per_step * steps if device.type == "cuda" else 0
    if any(v != expect for v in launches.values()):
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{per_step} per step x {steps} = {expect} each")
    # bf16: every kernel on the sm90 design, none on the simt one
    by_design = {"sm90": counts["sm90"], "simt": counts["simt"]}
    want_design = {"sm90": {"fwd": expect, "dq": expect, "dkv": expect},
                   "simt": {"fwd": 0, "dq": 0, "dkv": 0}}
    if by_design != want_design:
        raise AssertionError(f"flash launches by design {by_design}, "
                             f"expected {want_design}")
    if seq_group is not None and with_lse != expect:
        raise AssertionError(f"flash_attention_with_lse launched {with_lse} "
                             f"times, expected {expect}")
    out = dict(steps=steps, launches=launches, with_lse_launches=with_lse,
               launches_by_design=by_design, first_loss=losses[0],
               last3_loss=tail, n_params=n_params)
    if device.type == "cuda":
        step_ms = sorted(result["step_ms"][3:])
        med = step_ms[len(step_ms) // 2]
        tokens = cfg.batch_size * cfg.data.seq_len
        flops = 3.0 * trainer.model.fwd_flops((cfg.batch_size,
                                               cfg.data.seq_len))
        out.update(step_ms_median=med, tokens_per_s=tokens / med * 1e3,
                   step_tflop=flops / 1e12,
                   mfu=flops / (med / 1e3 * PEAK_FLOPS["torch.bfloat16"]),
                   peak_memory_gib=result["peak_memory_bytes"] / 2 ** 30,
                   step_ms_all=[round(x, 3) for x in result["step_ms"]])
        out.update(profile_training(torch, trainer))
    print(f"{tag}: " + json.dumps(out), flush=True)
    return dict(out, losses=losses, final_params=final)


def _kernel_class(name):
    n = name.lower()
    if "flash_" in n:
        return "flash"
    if any(s in n for s in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
        return "gemm"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer"
    return "other"


def profile_training(torch, trainer, n_steps=3):
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
            c = _kernel_class(ev.name)
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
              f"[{_kernel_class(name)}] {name[:100]}", flush=True)
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
    return dict(profile_busy_share=busy / wall_us, profile_shares=shares,
                profile_ms_per_step=per_step,
                profile_host_op_ms_per_step=host_us / 1e3 / n_steps)


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
    from neural_networks_parallel_training_with_mpi_tpu_torch.utils.tree import (  # noqa: E501
        leaves,
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
        opt = optim.sgd(1e-2, 0.9)
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
                                    leaves(state.params)])
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
    return [(f"{mask}_{dt}", dict(dtype=dt, shape=SHARD_SHAPE, mask=mask))
            for dt in ("bfloat16", "float32")
            for mask in ("causal", "none", "causal_exclusive")]


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
    kernel's out/lse as in phase 6.  Returns the largest abs error."""
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
        want = {d: {"fwd": 0, "dq": 0, "dkv": 0} for d in ("sm90", "simt")}
        for which in ("fwd", "dq", "dkv"):
            want[fa.kernel_design(which, dtype, q.shape[-1])][which] = n
        r_out, r_lse = fa.flash_forward_reference(q, k, v, mask)
        r_grads = fa.flash_backward_reference(q, k, v, out, lse, w, mask,
                                              g_lse=u)
        atol, rtol = TOL[str(dtype)]
        gatol, grtol = GRAD_TOL[str(dtype)]
        res = [_close(torch, out, r_out, atol, rtol),
               _close(torch, lse, r_lse, *TOL["torch.float32"])]
        res += [_close(torch, g, r, gatol, grtol, scaled=True)
                for g, r in zip(grads, r_grads)]
        rounded = []
        if dtype == torch.bfloat16:
            delta = fa.flash_delta(out, w, u)
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
              f"{'/'.join(f'{r[1]:.3e}' for r in res[2:])}{extra}; "
              f"launches {by_design} {'ok' if ok else 'FAIL'} (tolerance "
              f"out atol {atol} + rtol {rtol}; lse {TOL['torch.float32']}; "
              f"grads {gatol}*max|ref| + {grtol}*|ref|; rounding "
              f"{ROUND_GRAD_TOL})", flush=True)
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
    (bf16, causal): the kernels, the plain version, SDPA
    forward+backward on the same inputs (which returns no lse: a
    yardstick only) and the bound."""
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
    kernel_ms = time_ms(torch, kernel, 20)
    fa.set_launch_counts(before)   # timing does not count
    plain_ms = time_ms(torch, plain, 3)
    _, library_ms = sdpa_yardstick(torch, q, k, v, w, True)
    bound_ms, bound_by = lse_bound(torch, SHARD_SHAPE, dtype)
    print(f"with_lse {SHARD_SHAPE} bf16 causal, forward+backward: kernels "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA fwd+bwd "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phase 10: ring composition at the training shape
# ---------------------------------------------------------------------------

def check_ring(torch, device, shape=FLASH_SHAPE, seq_size=4, iters=10):
    """ring_flash and striped_flash over a LocalSeqGroup against
    full-sequence flash attention (the kernels) on the same bf16 inputs:
    output and q/k/v gradients, the launches of one call, and the time of
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
        if device.type == "cuda":
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
    losses = {}
    for platform in (card, "cpu"):
        t0 = time.perf_counter()
        proc = run_cli(REFERENCE_JOB + ["--platform", platform])
        secs = time.perf_counter() - t0
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
    against the live state; ``--generate`` from it as a subprocess against
    the in-process ``generate()``."""
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
    with tempfile.TemporaryDirectory() as tmp:
        ck = Path(tmp) / "ck"
        first = trainer(nepochs=1, checkpoint_dir=ck)
        r1 = first.fit()
        n_params = sum(p.numel() for p in leaves(first.state.params))
        save_s = first.save_seconds[-1]
        spe = r1["steps"]     # 13 at full width
        del first
        out.update(first_steps=spe, save_s=save_s,
                   snapshot_bytes=snapshot_bytes(ck / f"ckpt-{spe}"),
                   expected_bytes=n_params * 12)
        if ckpt.latest_step(str(ck)) != spe:
            raise AssertionError(f"resume: {spe} steps, newest snapshot "
                                 f"{ckpt.latest_step(str(ck))}")
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
              f"{loss_diff:.3g}, largest param difference {param_diff:.3g}"
              f" (bitwise: {out['bitwise']})", flush=True)
        # every op on this path is deterministic (same kernels, inputs and
        # order), so anything short of bitwise is a resume fault
        if not out["bitwise"]:
            raise AssertionError(
                f"resume: not bitwise: losses differ by {loss_diff}, params "
                f"by {param_diff}")
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
            if not (torch.equal(a[1], b[1]) if isinstance(a[1], torch.Tensor)
                    else a[1] == b[1])]
        if mismatched:
            raise AssertionError(f"resume: the async snapshot differs from "
                                 f"the state at step {2 * spe} in leaves "
                                 f"{mismatched[:8]}")
        out["async_snapshot_bytes"] = snapshot_bytes(ck / f"ckpt-{2 * spe}")
        # --generate from the snapshot, as a user runs it: greedy, then
        # sampled (a near-constant greedy continuation of a barely trained
        # LM says little; the draws follow the whole distribution)
        for temperature in (0.0, 1.0):
            t0 = time.perf_counter()
            proc = run_cli(train_flags(checkpoint_dir=ck, **over) + [
                "--generate", ",".join(map(str, PROMPT)),
                "--max_new_tokens", "32", "--temperature", str(temperature),
                "--seed", "7"])
            out[f"generate_s_t{temperature}"] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"--generate: rc {proc.returncode}\n"
                                     f"{proc.stdout[-2000:]}\n"
                                     f"{proc.stderr[-2000:]}")
            cli_ids = [int(t) for t in
                       proc.stdout.strip().splitlines()[-1].split(",")]
            ids = generate(second.model, restored.params, [PROMPT], 32,
                           temperature=temperature,
                           generator=torch.Generator(device).manual_seed(7),
                           device=device)[0].tolist()
            print(f"generate (temperature {temperature}): --generate "
                  f"printed {cli_ids[len(PROMPT):]}; in-process "
                  f"{ids[len(PROMPT):]}", flush=True)
            if cli_ids != ids or len(ids) != len(PROMPT) + 32:
                raise AssertionError(
                    f"--generate's ids (temperature {temperature}) differ "
                    "from the in-process generate()'s")
        del restored, second
    print(f"resume: snapshot {out['snapshot_bytes']:,} bytes (params + Adam "
          f"mu and nu: {out['expected_bytes']:,}); save {save_s:.2f} s, "
          f"resume restore "
          f"{out['restore_s']:.2f} s, second restore "
          f"{out['restore_again_s']:.2f} s, async save's host copy "
          f"{out['async_save_host_s']:.2f} s", flush=True)
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

    phase("4 serve the 218M LM through the fused kernel")
    served = serve_full_width(torch, np, device)

    phase("5 f32 token identity")
    token_identity(torch, np, device)

    phase("6 flash attention against its plain versions")
    flash_err = check_flash(torch, device)
    flash_timing = time_flash(torch, device)

    phase("7 train the 219M LM at full width through the flash kernels")
    trained = train_full_width(torch, np, device, keep_final=True)

    phase("8 f32 training identity: flash == dense")
    train_identity(torch, np, device)

    phase("9 flash_attention_with_lse against its plain version")
    lse_err = check_flash_lse(torch, device)
    lse_timing = time_flash_lse(torch, device)

    phase("10 ring and striped flash over a local group of 4 vs full flash")
    check_ring(torch, device)

    phase("11 train the 219M LM with striped_flash over a local group of 4")
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel.sequence import (  # noqa: E501
        LocalSeqGroup,
    )

    seq_trained = train_full_width(torch, np, device,
                                   seq_group=LocalSeqGroup(4),
                                   attention="striped_flash", sp=4)
    merge_ms = (seq_trained["profile_ms_per_step"].get("other", 0.0)
                - trained["profile_ms_per_step"].get("other", 0.0))
    print(f"seqtrain: step {seq_trained['step_ms_median']:.2f} ms vs flash "
          f"{trained['step_ms_median']:.2f} ms; elementwise ('other') "
          f"{merge_ms:+.2f} ms/step over flash (the lse merges, the "
          f"splits and joins)", flush=True)

    phase("12 f32 training identity: ring_flash == striped_flash == flash")
    train_identity_seq(torch, np, device)

    phase("13 fused_layernorm against its plain version")
    ln_err, ln_launches = check_layernorm(torch, device)
    ln_timing = time_layernorm(torch, device)

    phase("14 reference: the reference job through the CLI, quality bars")
    reference_job()
    quality_bars(device)

    phase("15 resume: checkpoint, resume and --generate of the 219M LM")
    resume_full_width(torch, np, device, trained)
    torch.distributed.destroy_process_group()

    src = "neural_networks_parallel_training_with_mpi_tpu_torch/csrc/"
    tpu = "neural_networks_parallel_training_with_mpi_tpu/ops/pallas_kernels.py"
    kernels = [dict(name="paged_attention", route="cuda",
                    source=src + "paged_attention.cu",
                    design="split-K over the context, cp.async ring, "
                           "in-kernel merge in split order",
                    replaces=f"{tpu}:486", launches=served["launches"],
                    max_abs_err=max_err, **timing)]
    for which, line in (("fwd", 97), ("dq", 255), ("dkv", 296)):
        # bf16 on the tensor cores; f32 on csrc/flash_attention.cu
        kernels.append(dict(name=f"flash_attention_{which}", route="cuda",
                            source=src + "flash_attention_sm90.cu",
                            design="sm90 wgmma + cp.async (bf16)",
                            replaces=f"{tpu}:{line}",
                            launches=trained["launches"][which],
                            max_abs_err=flash_err[which],
                            **flash_timing[which]))
    # B5 has no kernel body: the autograd function over B1-B3
    kernels.append(dict(name="flash_attention_with_lse", route="cuda",
                        source=("neural_networks_parallel_training_with_mpi"
                                "_tpu_torch/ops/flash_attention.py"),
                        replaces=f"{tpu}:445",
                        launches=seq_trained["with_lse_launches"],
                        max_abs_err=lse_err, **lse_timing))
    kernels.append(dict(name="fused_layernorm", route="cuda",
                        source=src + "layernorm.cu", replaces=f"{tpu}:711",
                        launches=ln_launches, max_abs_err=ln_err,
                        **ln_timing))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
