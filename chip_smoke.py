#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device   — a CUDA device must be present; prints its name and power
              limit as ``nvidia-smi`` reports them.
2. build    — builds the CUDA kernels from ``csrc/`` with ``nvcc`` for
              sm_90a (one ``nvcc`` per source, all started together).
3. kernels  — each kernel against its plain PyTorch version on the card,
              in bf16 and f32: paged attention for decode at the 218M
              LM's head geometry (ragged lengths up to 1024, a stream
              straddling blocks, a length-0 lane), prefill chunks of
              width 16 and 256 at non-zero starts, GQA (16 query heads
              over 4 KV heads) and int8 pools with scales.  Times the
              kernel, its plain version and a library yardstick (gather
              + ``F.scaled_dot_product_attention``) at the decode shape,
              beside the bound (bytes or operations at the card's peak).
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
              blocks 64 x 128 and head_dim 128; q/k/v are the strided
              views of a fused qkv tensor.  Times each kernel, its plain
              version and the library yardstick
              (``F.scaled_dot_product_attention``, forward and
              forward+backward) beside the bound.
7. train    — the 219M LM trained at full width through the port's
              ``Trainer`` (CLI flags, a 1-rank NCCL group so the gradient
              all-reduce runs): bytes of DESIGN.md, batch 8 x 1024, bf16
              compute, f32 params, flash attention, ce_chunk 256, 2 epochs
              of Adam (26 steps).  Every loss finite, the last 3 steps'
              mean 1 nat below the first, each flash launch count equal
              to 12 x steps.  Prints step time, tokens/s, MFU, peak memory
              and a profile of 3 more steps.
8. identity — f32, TF32 off, 2 layers: 3 SGD-momentum steps with flash
              and with dense attention from the same params and batches
              agree.

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


def phase(name):
    print(f"== phase {name}", flush=True)


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
    """One line per compiled kernel from ``nvcc -Xptxas -v``: template
    arguments (as mangled), registers, spills."""
    import re

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"kernelI(.*?)EEv", m.group(1))
            name, spill = (t.group(1) if t else m.group(1)), ""
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
              kv_heads, head_dim=64, block_size=16, quant=False, seed=0):
    """Random pools and a random block table per stream, q as the strided
    view the fused qkv projection gives (columns [q | k | v])."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    s_n = len(lengths)
    needs = [-(-max(ln, 1) // block_size) for ln in lengths]
    max_blocks = max(needs)
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


def time_ms(torch, fn, iters):
    """Mean ms per call from CUDA events around ``iters`` calls, after a
    warm-up call."""
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
    of phase 4 (16 lanes, 16 heads of 64, block 16, bf16)."""
    import torch.nn.functional as F

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops.paged_attention import (  # noqa: E501
        paged_attention, paged_attention_reference,
    )

    lengths = decode_lengths()
    case = make_case(torch, device, torch.bfloat16, lengths,
                     [max(ln - 1, 0) for ln in lengths], 1, 16, 16)
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

    before = paged_attention.launches
    kernel_ms = time_ms(torch, lambda: paged_attention(*args), 200)
    paged_attention.launches = before      # timing launches do not count
    plain_ms = time_ms(torch, lambda: paged_attention_reference(*args), 20)
    library_ms = time_ms(torch, library, 50)
    bound_ms, bound_by = paged_bound(case)
    print(f"paged_attention decode (16 lanes, sum(len)={sum(lengths)}, "
          f"bf16): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})", flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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


def flash_cases():
    """(name, kwargs) for every flash case: the training shape in both
    dtypes and all three mask modes, then T 256 with blocks 64 x 128 and
    head_dim 128."""
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
    versions on the same inputs.  Returns {kernel: largest abs error}."""
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
        out, lse = fa.flash_forward(q, k, v, mask, *blocks)
        delta = fa.flash_delta(out, dout)
        dq = fa.flash_backward_dq(q, k, v, dout, lse, delta, mask, *blocks)
        dk, dv = fa.flash_backward_dkv(q, k, v, dout, lse, delta, mask,
                                       *blocks)
        if device.type == "cuda":
            torch.cuda.synchronize()
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
            # row 0 of every head attends no key: output 0, lse -1e30
            results["fwd"].append((bool((out[:, 0] == 0).all())
                                   and bool((lse[:, 0] <= -1e29).all()),
                                   0.0))
        parts = []
        ok_all = True
        for kern, res in results.items():
            ok = all(r[0] for r in res)
            err = max(r[1] for r in res)
            worst[kern] = max(worst[kern], err)
            ok_all = ok_all and ok
            parts.append(f"{kern} {err:.3e}{'' if ok else ' FAIL'}")
        print(f"flash {name} {tuple(kw['shape'])} blocks {blocks}: "
              + ", ".join(parts) + f" (tolerance out atol {atol} + rtol "
              f"{rtol}; lse {f32}; grads {gatol}*max|ref| + {grtol}*|ref|)",
              flush=True)
        if not ok_all:
            raise AssertionError(f"flash attention disagrees with its plain "
                                 f"version in case {name}")
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
    import torch.nn.functional as F

    from neural_networks_parallel_training_with_mpi_tpu_torch.ops import (
        flash_attention as fa,
    )

    dtype = torch.bfloat16
    q, k, v, dout = make_flash_case(torch, device, dtype, FLASH_SHAPE)
    out, lse = fa.flash_forward(q, k, v, "causal")
    delta = fa.flash_delta(out, dout)
    before = dict(fa.flash_attention.launches)
    kernel = {
        "fwd": time_ms(torch, lambda: fa.flash_forward(q, k, v), 20),
        "dq": time_ms(torch, lambda: fa.flash_backward_dq(
            q, k, v, dout, lse, delta), 20),
        "dkv": time_ms(torch, lambda: fa.flash_backward_dkv(
            q, k, v, dout, lse, delta), 20),
    }
    fa.flash_attention.launches.update(before)   # timing does not count
    plain = {
        "fwd": time_ms(torch, lambda: fa.flash_forward_reference(
            q, k, v, "causal"), 3),
        "dq": time_ms(torch, lambda: fa.flash_dq_reference(
            q, k, v, dout, lse, delta), 3),
        "dkv": time_ms(torch, lambda: fa.flash_dkv_reference(
            q, k, v, dout, lse, delta), 3),
    }
    # yardstick only: PyTorch's fused attention on (B, H, T, D) copies
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, dout))
    sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), dot)

    sdpa_both = time_ms(torch, fwd_bwd, 20)
    out_t = {}
    for which in ("fwd", "dq", "dkv"):
        bound_ms, bound_by = flash_bound(torch, which, FLASH_SHAPE, dtype)
        out_t[which] = dict(ms=kernel[which], plain_ms=plain[which],
                            library_ms=sdpa_fwd if which == "fwd" else None,
                            bound_ms=bound_ms, bound_by=bound_by)
        print(f"flash {which} {FLASH_SHAPE} bf16 causal: kernel "
              f"{kernel[which]:.4f} ms, plain {plain[which]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    print(f"flash library yardstick (F.scaled_dot_product_attention, "
          f"is_causal): forward {sdpa_fwd:.4f} ms, forward+backward "
          f"{sdpa_both:.4f} ms; kernels fwd+dq+dkv "
          f"{sum(kernel.values()):.4f} ms", flush=True)
    return out_t


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


def train_full_width(torch, np, device, **over):
    """Train through the port's own Trainer and CLI config; check finite,
    falling losses and the flash launch counts; print step time, tokens/s,
    MFU, peak memory and a profile of 3 more steps."""
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
        trainer = Trainer(cfg, device=device)
        trainer.init_state()
        n_params = sum(p.numel() for p in leaves(trainer.state.params))
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        for k in fa.flash_attention.launches:
            fa.flash_attention.launches[k] = 0
        result = trainer.fit()
        launches = dict(fa.flash_attention.launches)
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in sorted(records, key=lambda r: r["step"])
              if "loss" in r]
    steps = result["steps"]
    m = cfg.model
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: {len(losses)} losses for {steps} "
                             f"steps, finite: "
                             f"{all(math.isfinite(x) for x in losses)}")
    tail = sum(losses[-3:]) / 3
    print(f"train: losses first {losses[0]:.4f}, last-3 mean {tail:.4f} "
          f"over {steps} steps: {[round(x, 4) for x in losses]}", flush=True)
    if tail > losses[0] - 1.0:
        raise AssertionError(f"train: the last 3 steps' mean loss {tail:.4f}"
                             f" is not 1 nat below the first {losses[0]:.4f}")
    expect = m.n_layers * steps if device.type == "cuda" else 0
    if any(v != expect for v in launches.values()):
        raise AssertionError(f"flash launches {launches}, expected "
                             f"n_layers x steps = {expect} each")
    out = dict(steps=steps, launches=launches, first_loss=losses[0],
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
    print("train: " + json.dumps(out), flush=True)
    return out


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
    time.  The profiler's own cost lengthens the window, so the busy share
    is a lower bound."""
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
    print("profile shares of device time: " + ", ".join(
        f"{c} {100 * v:.1f}%" for c, v in shares.items()), flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {100 * us / max(busy, 1e-9):5.1f}% {us / 1e3:8.2f} ms  "
              f"[{_kernel_class(name)}] {name[:100]}", flush=True)
    return dict(profile_busy_share=busy / wall_us, profile_shares=shares)


# ---------------------------------------------------------------------------
# phase 8: f32 flash == dense through the train step
# ---------------------------------------------------------------------------

def train_identity(torch, np, device, n_layers=2, steps=3, batch=8, **over):
    """Full width at ``n_layers`` layers, f32 with TF32 off, SGD-momentum:
    ``steps`` train steps from the same params and batches with
    attention='flash' and 'dense'.  Losses must agree to rtol 1e-5 and
    params to 1e-5 + 1e-4 * |p| (f32 on both sides; the attention sums
    run in another order, ~1e-6 relative, and 3 small SGD steps carry
    that into the params scaled by lr)."""
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
              pos_encoding="learned", ce_chunk=256)
    kw.update(over)
    data = text_dataset(TEXT_FILE, kw["max_seq_len"], kw["vocab_size"])
    world = world_setup(device)
    runs = {}
    for attention in ("flash", "dense"):
        model = Transformer(TransformerConfig(**kw, attention=attention),
                            device=device)
        params = model.init(torch.Generator().manual_seed(SEED + 2))
        opt = optim.sgd(1e-2, 0.9)
        state = TrainState.from_params(params, opt)
        step = dp.make_train_step(model, opt, world,
                                  loss_name="cross_entropy")
        losses = []
        loader = ShardedLoader(data, batch, device=device, shuffle=False)
        for i, b in zip(range(steps), loader.epoch(0)):
            state, loss = step(state, b)
            losses.append(float(loss))
        runs[attention] = (losses, [p.detach() for p in
                                    leaves(state.params)])
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
    trained = train_full_width(torch, np, device)

    phase("8 f32 training identity: flash == dense")
    train_identity(torch, np, device)
    torch.distributed.destroy_process_group()

    src = "neural_networks_parallel_training_with_mpi_tpu_torch/csrc/"
    tpu = "neural_networks_parallel_training_with_mpi_tpu/ops/pallas_kernels.py"
    kernels = [dict(name="paged_attention", route="cuda",
                    source=src + "paged_attention.cu",
                    replaces=f"{tpu}:486", launches=served["launches"],
                    max_abs_err=max_err, **timing)]
    for which, line in (("fwd", 97), ("dq", 255), ("dkv", 296)):
        kernels.append(dict(name=f"flash_attention_{which}", route="cuda",
                            source=src + "flash_attention.cu",
                            replaces=f"{tpu}:{line}",
                            launches=trained["launches"][which],
                            max_abs_err=flash_err[which],
                            **flash_timing[which]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
