"""Smoke run of sie_tpu_torch on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final `ok` line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel source of the package, in parallel;
     ptxas's registers and spills of each instantiation beside its SASS
     counts of HGMMA (wgmma) and HMMA (mma.sync) instructions
     (`cuobjdump -sass`); fails unless each of the 32 bf16 attention
     instantiations has HGMMA and no HMMA;
  3. K1 (shapelet distance) against its plain version at the flagship
     shapes: B=64, C=122, T=845, n=10, each of the six banks, both metrics;
     kernel, plain and torch.cdist times and the bound;
  4. K5 (fused attention) against its plain version at BH=512, T=845,
     dk=64 in bf16 and f32, and at a ragged T=300; kernel, plain and
     scaled_dot_product_attention times and the bound;
  5. serving: the flagship InterpGN (weights from seed 0) behind
     `Predictor` on the card answers requests of 1, 5, 64 and 150 rows
     (max_batch 64), three of each, with launch counts checked per chunk
     of every request (K1 6, K5 2, no other kernel); the median time of
     each size is printed; its logits are held against the plain CPU path
     on 2 rows;
  6. K5 with dropout (rate 0.1) against its plain version at BH=512, T=845,
     dk=64 in bf16 and f32; its row log-sum-exp output; times at rate 0.1
     and rate 0;
  7. K2 (shapelet-distance backward) against its plain version at B=64 on
     each of the six banks, both metrics, random output gradients, and
     against itself (deterministic); kernel and plain times and the bound;
     the library time, the bank gradient through torch.cdist(p=1), timed
     per bank in a child process (a fault there cannot reach this one's
     CUDA context), kept only if all six banks run;
  8. K6 (attention backward) against its plain version at BH=512, T=845,
     dk=64 in bf16 and f32 and at a ragged T=300, rates 0 and 0.1; kernel,
     plain and scaled_dot_product_attention-backward times and the bound;
  9. training: the flagship InterpGN under `Trainer` on the card, 256 rows
     held there, B=64: 3 warm-up and 10 timed steps, each checked for its
     kernel launches (K1 6, K2 6, K5 2, K6 2), a finite loss and moved
     weights; the median step time, the full/sbm/dnn fwd+bwd split and the
     optimizer's share; a step at dropout 0.1; the card's gradients held
     against the plain CPU path's on 2 rows;
 10. K3 and K4 (the six flagship banks in one launch, `fuse_short_banks`):
     K3 equal bit for bit to six K1 launches and K4 to six K2 launches
     (random output gradients), K4 equal to itself on a second run, both
     against their plain versions; K3 against the sum of the six K1 times
     and K4 against the six K2 times, and the bound;
 11. the flagship with `fuse_short_banks=True`, at the same weights:
     served (1, 5, 64, 150 rows; K3 1 and K5 2 launches per chunk, no
     other kernel; logits equal to the unfused predictor's on the card) and
     trained (3 warm-up and 5 timed steps; K3 1, K4 1, K5 2, K6 2 launches
     a step; gradients on 2 rows equal to the unfused card path's, bit for
     bit);
 12. K5 and K6 at the long-sequence shape of an EigenWorms-shaped model
     (BH=64 = 8 rows x 8 heads, T=17984, dk=64), where the JAX package runs
     its kv-blocked kernels K7, K8a and K8b: bf16 and f32, rates 0 and 0.1,
     held against the chunked plain versions on the first 2 heads (both
     kernels within their limit times max|want|), the
     log-sum-exp against torch.logsumexp; kernel, plain (chunked, all
     heads) and scaled_dot_product_attention times, the bound, and the
     device time of K6's dQ pass (K8a) and dK/dV pass (K8b) from
     torch.profiler;
 13. training the EigenWorms-shaped InterpGN (T=17984, 6 channels, 5
     classes, float32, `fused_attention_max_len=0`, B=8) under `Trainer`:
     2 warm-up and 5 timed steps, each checked for its launches (K1 and K2
     once per polyphase component of the six strided banks, K5 2, K6 2), a
     finite loss and moved weights; the median step time; a step at
     dropout 0.1;
 14. one JSON line of per-kernel numbers (K1 ... K8b; launches from the
     timed training steps of each kernel's path), then the device line.

The K5 and K6 phases (4, 6, 8, 12) run under a time limit that ends the
process, so that a kernel that hangs fails the run instead of holding the
card. Times are CUDA-event times after warm-up (kernels) or host-clock times of
work that ends in a synchronisation (requests, steps). Bounds use the
published H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s FP32, 989 TFLOP/s bf16,
495 TFLOP/s TF32. An f32 attention product is bound by the smaller of the
FP32-FMA time and that of three TF32 products (3xTF32, the f32 kernels'
arithmetic); both figures are printed. It needs no network and imports
nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

PEAK_BYTES = 3.35e12           # B/s
PEAK_FP32 = 67e12              # FLOP/s, CUDA cores
PEAK_BF16 = 989e12             # FLOP/s, tensor cores, dense
PEAK_TF32 = 495e12             # FLOP/s, tensor cores, dense

K1_TOL = 1e-4   # f32, summation order (multiply by 1/L vs divide by L)
K5_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # bf16: output
# rounding and the online softmax's rounding of unnormalised probabilities
SERVE_TOL = 5e-2   # bf16 logits, card vs CPU plain path
REPEATS = 3        # requests of each size; the median time is reported
K2_TOL = 1e-4      # x max|want|: f32 sums of up to 64 * 803 terms, and the
# 1/L applied once at the end, in another order than the plain loop's
K6_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # x max|want|; bf16:
# outputs rounded to bf16, delta from the bf16 output O, and the recomputed
# probabilities from the forward's log-sum-exp
GRAD_TOL = 5e-2    # relative norm error per parameter, bf16, card vs CPU
RATE = 0.1         # attention dropout of the dropout checks
WARMUP, STEPS = 3, 10   # training steps: warm-up, then timed
FUSED_STEPS = 5         # timed steps of the fused flagship (after WARMUP)
LONG_WARMUP, LONG_STEPS = 2, 5   # EigenWorms-shaped training steps
LONG_BH, LONG_T, LONG_DK = 64, 17984, 64   # its attention: 8 rows x 8 heads
LONG_HEADS = 2     # heads held against the chunked plain versions


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


class time_limit:
    """Ends the process with code 1, and no `ok` line, if the block runs
    past `seconds`: a kernel that hangs blocks this thread inside the
    driver, where no Python exception reaches it."""

    def __init__(self, seconds: float, what: str):
        self.seconds, self.what = seconds, what

    def _expire(self) -> None:
        print(f"chip_smoke FAILED: {self.what} ran past {self.seconds} s",
              file=sys.stderr, flush=True)
        os._exit(1)

    def __enter__(self):
        self.timer = threading.Timer(self.seconds, self._expire)
        self.timer.daemon = True
        self.timer.start()

    def __exit__(self, *exc):
        self.timer.cancel()


def events_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean CUDA-event time of fn() over reps calls, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(nbytes: float, flops: float, dtype):
    """(ms, "bytes" or "operations", text) of an attention kernel's work:
    bf16 at the bf16 tensor-core peak; f32 the smaller of the FP32-FMA
    bound and the 3xTF32 one (each product as three TF32 products), the
    text naming it beside the other figure."""
    if dtype == torch.bfloat16:
        ms, by = bound_ms(nbytes, flops, PEAK_BF16)
        return ms, by, f"{by}, bf16"
    fma = bound_ms(nbytes, flops, PEAK_FP32)
    tf32 = bound_ms(nbytes, 3 * flops, PEAK_TF32)
    if tf32[0] <= fma[0]:
        return (*tf32, f"{tf32[1]}, 3xTF32; FP32-FMA {fma[0]:.4f}")
    return (*fma, f"{fma[1]}, FP32-FMA; 3xTF32 {tf32[0]:.4f}")


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    return smi


def kernel_name(mangled: str) -> str:
    """kernel<template arguments> of a mangled entry name, else the name."""
    k = re.search(r"\d((?:attn|shapelet)_[a-z0-9_]+?)I(.*?)EEv", mangled)
    if not k:
        return mangled
    args = re.findall(r"L[ib](\d+)E", k.group(2))
    return f"{k.group(1)}<{', '.join(args) or k.group(2)}>"


def ptxas_entries(log: str) -> list:
    """(kernel<template arguments>, registers, spill stores, spill loads)
    of each entry function in an `nvcc -Xptxas -v` report."""
    rows, name, spill = [], None, ("?", "?")
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = m.groups()
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


# the bf16 attention kernels, which must run their products on wgmma
WGMMA_KERNELS = ("attn_fwd_bf16", "attn_bwd_dq_bf16", "attn_bwd_dkv_bf16")


def sass_counts(lib: str) -> dict:
    """{kernel<template arguments>: (HGMMA, HMMA)}: the warpgroup (wgmma)
    and warp-level (mma.sync) tensor-core instructions of each function in
    a built library, from `cuobjdump -sass`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = [0, 0]
        elif name is not None:
            op = re.search(r"\b(HGMMA|HMMA)\.", line)
            if op:
                counts[name][op.group(1) == "HMMA"] += 1
    return {k: tuple(v) for k, v in counts.items()}


def phase_build() -> None:
    from sie_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.build()
    print(f"[build] {time.perf_counter() - t0:.3f} s for "
          f"{', '.join(build.SIGNATURES)}")
    sass = {}
    for src in ("attention_fwd", "attention_bwd"):
        sass.update(sass_counts(build._lib_path(src)))
    for src, log in build.PTXAS_LOG.items():
        for name, regs, stores, loads in ptxas_entries(log):
            ops = sass.get(name)
            extra = "" if ops is None else f"; SASS HGMMA {ops[0]}, HMMA {ops[1]}"
            print(f"[build] {src}: {name}: {regs} registers, spill stores "
                  f"{stores} B, loads {loads} B{extra}")
    for src in ("attention_fwd", "attention_bwd"):   # e.g. serialized wgmma
        for line in build.PTXAS_LOG.get(src, "").splitlines():
            if "arning" in line:
                print(f"[build] {src}: ptxas: {line.strip()}")
    wg = {k: v for k, v in sass.items() if k.startswith(WGMMA_KERNELS)}
    # 2 widths x 2 loaders (TMA, cp.async) x (4 forward, 2 + 2 backward)
    if len(wg) != 32:
        fail(f"bf16 attention instantiations in the SASS: {sorted(wg)}")
    off = {k: v for k, v in wg.items() if v[0] == 0 or v[1] != 0}
    if off:
        fail(f"bf16 attention kernels without wgmma, or with mma.sync: {off}")
    print(f"[build] bf16 attention: all {len(wg)} instantiations run wgmma "
          f"(HGMMA {min(v[0] for v in wg.values())}-"
          f"{max(v[0] for v in wg.values())} each), no HMMA")


def phase_k1() -> dict:
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                               l1_sliding_distance_plain)
    b, c, t, n = 64, 122, 845, 10
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((b, c, t), generator=g, device="cuda")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes=0.0, flops=0.0)
    err = 0.0
    for l in bank_lengths(Config()):
        s = torch.randn((n, c, l), generator=g, device="cuda")
        w = t - l + 1
        for metric in ("euclidean", "sqeuclidean"):
            got = l1_sliding_distance(x, s, metric)
            want = l1_sliding_distance_plain(x, s, metric)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            if not e <= K1_TOL:
                fail(f"K1 {metric} L={l}: max abs err {e} > {K1_TOL}")
            del got, want
        # times: the euclidean metric, which the flagship serves
        ms = events_ms(lambda: l1_sliding_distance(x, s), reps=10)
        plain_ms = events_ms(lambda: l1_sliding_distance_plain(x, s), reps=1)
        xu = x.unfold(-1, l, 1).transpose(0, 1).reshape(c, b * w, l)
        sc = s.transpose(0, 1).contiguous()                      # (C, n, L)
        lib_ms = events_ms(lambda: torch.cdist(xu, sc, p=1), reps=2)
        lib = torch.cdist(xu, sc, p=1).view(c, b, w, n).permute(1, 3, 0, 2) / l
        e = float((lib - l1_sliding_distance(x, s)).abs().max())
        del xu, lib
        nbytes = 4 * (b * c * t + n * c * l + b * n * c * w)
        flops = 2 * b * n * c * w * l
        bms, _ = bound_ms(nbytes, flops, PEAK_FP32)
        print(f"[K1] L={l} W={w}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms,"
              f" cdist {lib_ms:.3f} ms (|diff| {e:.2e}), bound {bms:.4f} ms")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bound_ms", bms), ("bytes", nbytes), ("flops", flops)):
            tot[k] += v
    _, by = bound_ms(tot["bytes"], tot["flops"], PEAK_FP32)
    print(f"[K1] six banks: kernel {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, cdist {tot['library_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.4f} ms ({by}), max abs err {err:.3e}")
    # The table's FP32 peak counts an FMA as two operations; a tap is two
    # FP32 instructions (subtract, add of |.|), so at one instruction per
    # lane and clock the floor is twice that: taps * 2 / (SMs * 128 * clock)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_ms = 1e3 * tot["flops"] / (sms * 128 * mhz * 1e6)
    print(f"[K1] six banks: issue-slot floor {issue_ms:.4f} ms ({sms} SMs x "
          f"128 FP32 lanes at {mhz:.0f} MHz max SM clock); its "
          f"{tot['bytes'] / 1e9:.3f} GB in and out take "
          f"{1e3 * tot['bytes'] / PEAK_BYTES:.4f} ms at 3.35 TB/s")
    return {"name": "K1 shapelet_l1_fwd", "route": "cuda",
            "source": "sie_tpu_torch/csrc/shapelet_l1_fwd.cu",
            "replaces": "sie_tpu/ops/pallas/shapelet_pallas.py:110",
            "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"]}


def phase_k5() -> dict:
    import torch.nn.functional as F
    from sie_tpu_torch.ops.attention import attention_plain, fused_attention
    g = torch.Generator(device="cuda").manual_seed(2)
    main = None
    err_main = 0.0
    for bh, t, dk, dtype in ((512, 845, 64, torch.bfloat16),
                             (512, 845, 64, torch.float32),
                             (64, 300, 64, torch.bfloat16),
                             (64, 300, 64, torch.float32)):
        q, k, v = (torch.randn((bh, t, dk), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        scale = 1.0 / dk ** 0.5
        got = fused_attention(q, k, v, scale)
        want = attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        tag = f"BH={bh} T={t} dk={dk} {str(dtype)[6:]}"
        if not e <= K5_TOL[dtype]:
            fail(f"K5 {tag}: max abs err {e} > {K5_TOL[dtype]}")
        ms = events_ms(lambda: fused_attention(q, k, v, scale), reps=20)
        plain_ms = events_ms(lambda: attention_plain(q, k, v, scale), reps=3)
        q4, k4, v4 = (z.view(1, bh, t, dk) for z in (q, k, v))  # (N, H, T, dk)
        lib_ms = events_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=scale), reps=20)
        nbytes = 4 * bh * t * dk * q.element_size()
        flops = 4 * bh * t * t * dk
        bms, by, btxt = attention_bound(nbytes, flops, dtype)
        print(f"[K5] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({btxt}), max abs err "
              f"{e:.3e}")
        if main is None:   # the flagship serving shape
            main = {"name": "K5 attention_fwd", "route": "cuda",
                    "source": "sie_tpu_torch/csrc/attention_fwd.cu",
                    "replaces": "sie_tpu/ops/pallas/attention_pallas.py:97",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib_ms}
        if dtype == torch.bfloat16:
            err_main = max(err_main, e)
        del q, k, v, q4, k4, v4, got, want
    main["max_abs_err"] = err_main
    return main


def flagship_config():
    from sie_tpu_torch.config import Config
    # bench.py's flagship: CHISCO shapes, 6 banks of 10 shapelets,
    # Transformer expert d_model 512 / 8 heads / 2 layers / d_ff 2048, bf16
    return Config(model="InterpGN", dnn_type="Transformer", seq_len=845,
                  enc_in=122, num_class=3, num_shapelet=10, d_model=512,
                  d_ff=2048, n_heads=8, e_layers=2, dropout=0.0, amp=True,
                  seed=0)


class Counts:
    """The kernels' launch counters: zeroed, read, and checked. K7 is K5's
    wrapper and K8a/K8b are K6's: they count under K5 and K6."""

    def __init__(self):
        from sie_tpu_torch.ops.attention import attention_bwd, fused_attention
        from sie_tpu_torch.ops.shapelet_l1 import (
            l1_sliding_distance, l1_sliding_distance_bwd,
            l1_sliding_distance_grouped, l1_sliding_distance_grouped_bwd)
        self.fns = {"K1": l1_sliding_distance, "K2": l1_sliding_distance_bwd,
                    "K3": l1_sliding_distance_grouped,
                    "K4": l1_sliding_distance_grouped_bwd,
                    "K5": fused_attention, "K6": attention_bwd}

    def zero(self) -> None:
        for fn in self.fns.values():
            fn.launches = 0

    def read(self) -> dict:
        return {k: fn.launches for k, fn in self.fns.items()}

    def since(self, before: dict) -> dict:
        return {k: v - before[k] for k, v in self.read().items()}

    @staticmethod
    def full(want: dict, times: int = 1) -> dict:
        """`want` scaled by `times`, with 0 for every kernel it omits."""
        return {k: want.get(k, 0) * times
                for k in ("K1", "K2", "K3", "K4", "K5", "K6")}


SERVE_SIZES = (1, 5, 64, 150)


def serve_requests(cfg, model, want: dict, tag: str):
    """Requests of SERVE_SIZES rows through `Predictor` on the card, each
    checked for `want` launches per chunk of max_batch rows and none of
    the other kernels; returns the outputs by size and the median ms."""
    from sie_tpu_torch.serve import Predictor
    pred = Predictor.from_module(cfg, model, device="cuda", max_batch=64)
    counts = Counts()
    rng = np.random.default_rng(0)
    xs = {b: rng.normal(size=(b, cfg.seq_len, cfg.enc_in)).astype(np.float32)
          for b in SERVE_SIZES}
    for b in SERVE_SIZES:   # warm-up: every bucket the run below hits
        pred.predict(xs[b][: min(b, 64)])
    torch.cuda.synchronize()
    counts.zero()
    outs, served_ms = {}, {}
    for b in SERVE_SIZES:
        times = []
        for _ in range(REPEATS):
            c0 = counts.read()
            t0 = time.perf_counter()
            out = pred.predict(xs[b])
            times.append(1e3 * (time.perf_counter() - t0))
            chunks = -(-b // pred.max_batch)
            got, expect = counts.since(c0), Counts.full(want, chunks)
            if got != expect:
                fail(f"{tag} request of {b}: launches {got}, want {expect}")
        served_ms[b] = float(np.median(times))
        outs[b] = out
    print(f"[{tag}] launches over the run: {counts.read()}")
    for b, out in outs.items():
        if out.logits.shape != (b, cfg.num_class) or \
                out.p.shape != (b, 7320) or out.eta.shape != (b, 1):
            fail(f"{tag} request of {b}: shapes {out.logits.shape}, "
                 f"{out.p.shape}")
        for name in ("logits", "probs", "eta", "p", "d"):
            if not np.isfinite(getattr(out, name)).all():
                fail(f"{tag} request of {b}: non-finite {name}")
        if not (out.classes == out.logits.argmax(-1)).all():
            fail(f"{tag} request of {b}: classes != argmax(logits)")
    print(f"[{tag}] ms per request (median of {REPEATS}): " + ", ".join(
        f"{b} rows {served_ms[b]:.3f}" for b in SERVE_SIZES))
    return outs, xs


def phase_serve() -> dict:
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.serve import Predictor
    cfg = flagship_config()
    model = build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    outs, xs = serve_requests(cfg, model, {"K1": 6, "K5": 2}, "serve")
    cpu = Predictor.from_module(cfg, copy.deepcopy(model).cpu(),
                                device="cpu", max_batch=64)
    ref = cpu.predict(xs[5][:2])
    got = outs[5].logits[:2]
    e = float(np.abs(got - ref.logits).max())
    print(f"[serve] card vs CPU plain path, 2 rows: max |dlogits| {e:.3e}; "
          f"classes {got.argmax(-1).tolist()} vs {ref.classes.tolist()}")
    if not e <= SERVE_TOL or not (got.argmax(-1) == ref.classes).all():
        fail(f"served logits differ from the CPU plain path: {e}")
    return outs


def phase_k5_dropout() -> None:
    """K5 at rate 0.1 against its plain version, and its log-sum-exp
    output; times at rate 0.1 and rate 0."""
    from sie_tpu_torch.ops.attention import (attention_fwd, attention_plain,
                                             fused_attention)
    g = torch.Generator(device="cuda").manual_seed(5)
    bh, t, dk = 512, 845, 64
    scale, seed = 1.0 / dk ** 0.5, 1234
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((bh, t, dk), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        got, lse = attention_fwd(q, k, v, scale, RATE, seed, want_lse=True)
        want = attention_plain(q, k, v, scale, RATE, seed)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        tag = f"BH={bh} T={t} dk={dk} {str(dtype)[6:]} rate {RATE}"
        if not e <= K5_TOL[dtype]:
            fail(f"K5 {tag}: max abs err {e} > {K5_TOL[dtype]}")
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if dtype == torch.bfloat16:
            s = s.to(torch.bfloat16).float()
        e_lse = float((lse - torch.logsumexp(s * scale, dim=-1)).abs().max())
        del s
        if not e_lse <= 1e-3:
            fail(f"K5 {tag}: log-sum-exp max abs err {e_lse} > 1e-3")
        ms = events_ms(lambda: fused_attention(q, k, v, scale, RATE, seed),
                       reps=20)
        ms0 = events_ms(lambda: fused_attention(q, k, v, scale), reps=20)
        print(f"[K5] {tag}: kernel {ms:.4f} ms (rate 0: {ms0:.4f} ms), max "
              f"abs err {e:.3e}, log-sum-exp err {e_lse:.3e}")
        del q, k, v, got, want, lse


def phase_k2() -> dict:
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance_bwd,
                                               l1_sliding_distance_bwd_plain)
    b, c, t, n = 64, 122, 845, 10
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((b, c, t), generator=gen, device="cuda")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0, flops=0.0)
    err, rel = 0.0, 0.0   # max abs error, and relative to max|want|
    for l in bank_lengths(Config()):
        w = t - l + 1
        s = torch.randn((n, c, l), generator=gen, device="cuda")
        g = torch.randn((b, n, c, w), generator=gen, device="cuda")
        for metric in ("euclidean", "sqeuclidean"):
            got = l1_sliding_distance_bwd(x, s, g, metric)
            want = l1_sliding_distance_bwd_plain(x, s, g, metric)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            e = float((got - want).abs().max())
            err, rel = max(err, e), max(rel, e / scale)
            if not e <= K2_TOL * scale:
                fail(f"K2 {metric} L={l}: max abs err {e} > {K2_TOL} x "
                     f"{scale}")
            if not torch.equal(got, l1_sliding_distance_bwd(x, s, g, metric)):
                fail(f"K2 {metric} L={l}: two runs differ")
        ms = events_ms(lambda: l1_sliding_distance_bwd(x, s, g), reps=10)
        plain_ms = events_ms(lambda: l1_sliding_distance_bwd_plain(x, s, g),
                             reps=1)
        nbytes = 4 * (b * c * t + 2 * n * c * l + b * n * c * w)
        flops = 2 * b * n * c * w * l
        bms, _ = bound_ms(nbytes, flops, PEAK_FP32)
        print(f"[K2] L={l} W={w}: kernel {ms:.4f} ms, plain {plain_ms:.3f} "
              f"ms, bound {bms:.4f} ms")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bms), ("bytes", nbytes),
                         ("flops", flops)):
            tot[key] += val
        del s, g
    _, by = bound_ms(tot["bytes"], tot["flops"], PEAK_FP32)
    del x
    lib = k2_library_ms()
    print(f"[K2] six banks: kernel {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms ({by}), "
          f"max abs err {err:.3e} ({rel:.3e} x max|want|); library "
          f"{'(not all banks ran)' if lib is None else f'{lib:.4f} ms'}")
    return {"name": "K2 shapelet_l1_bwd", "route": "cuda",
            "source": "sie_tpu_torch/csrc/shapelet_l1_bwd.cu",
            "replaces": "sie_tpu/ops/pallas/shapelet_pallas.py:162",
            "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by, "library_ms": lib}


K2_LIB_FLAG = "--k2-library"   # argument of the child process below
K2_LIB_BUDGET = 240            # s, all child processes together


def k2_library_child(first: int) -> None:
    """The child process of `k2_library_ms`: times the one PyTorch call for
    K2's function, the bank gradient through torch.cdist(p=1) (backward
    only, as the SDPA backward is timed), on banks first, first + 1, ... at
    phase_k2's shapes; one flushed line a bank, with its max abs difference
    from K2. A fault ends the process at its bank."""
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet_l1 import l1_sliding_distance_bwd
    b, c, t, n = 64, 122, 845, 10
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((b, c, t), generator=gen, device="cuda")
    for i, l in enumerate(bank_lengths(Config())):
        if i < first:
            continue
        w = t - l + 1
        s = torch.randn((n, c, l), generator=gen, device="cuda")
        g = torch.randn((b, n, c, w), generator=gen, device="cuda")
        sg = s.detach().requires_grad_()
        xu = x.unfold(-1, l, 1).transpose(0, 1).reshape(c, b * w, l)
        d = torch.cdist(xu, sg.transpose(0, 1), p=1)          # (C, B*W, n)
        gd = (g / l).permute(2, 0, 3, 1).reshape(c, b * w, n)
        run = lambda: torch.autograd.grad(d, sg, gd, retain_graph=True)[0]
        ms = events_ms(run, reps=2)
        e = float((run() - l1_sliding_distance_bwd(x, s, g)).abs().max())
        print(f"{K2_LIB_FLAG} {i} {l} {ms} {e}", flush=True)
        del d, xu, run


def k2_library_ms():
    """K2's library time summed over the six banks, each timed in a child
    process so that a fault cannot reach this process's CUDA context; a
    child that faults is followed by one from the next bank, within
    K2_LIB_BUDGET seconds for all. None unless every bank ran; every
    bank's time or fault is printed."""
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    lengths = bank_lengths(Config())
    torch.cuda.empty_cache()   # the children need the card's memory
    times, first = {}, 0
    deadline = time.monotonic() + K2_LIB_BUDGET
    while first < len(lengths):
        cmd = [sys.executable, os.path.abspath(__file__), K2_LIB_FLAG,
               str(first)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=max(1.0, deadline - time.monotonic()))
            errs = [ln for ln in r.stderr.splitlines() if "Error:" in ln]
            out, why = r.stdout, (errs or [f"exit code {r.returncode}"])[0]
        except subprocess.TimeoutExpired as exc:
            out = exc.stdout or ""
            out = out.decode() if isinstance(out, bytes) else out
            why = f"the {K2_LIB_BUDGET} s for all banks ran out"
        for line in out.splitlines():
            if line.startswith(K2_LIB_FLAG):
                _, i, l, ms, e = line.split()
                times[int(i)] = float(ms)
                print(f"[K2] library, bank L={l}: cdist(p=1) backward "
                      f"{float(ms):.4f} ms, max |diff| from K2 {float(e):.3e}")
        first = max([first - 1, *times]) + 1
        if first < len(lengths):
            print(f"[K2] library, bank L={lengths[first]}: no time: "
                  f"{why[:160]}")
            first += 1
    return sum(times.values()) if len(times) == len(lengths) else None


def phase_k6() -> dict:
    import torch.nn.functional as F
    from sie_tpu_torch.ops.attention import (attention_bwd,
                                             attention_bwd_plain,
                                             attention_fwd)
    gen = torch.Generator(device="cuda").manual_seed(6)
    main, err_main = None, 0.0   # max abs error of the bf16 cases
    for bh, t, dk, dtype, rate in ((512, 845, 64, torch.bfloat16, 0.0),
                                   (512, 845, 64, torch.bfloat16, RATE),
                                   (512, 845, 64, torch.float32, 0.0),
                                   (512, 845, 64, torch.float32, RATE),
                                   (64, 300, 64, torch.bfloat16, RATE),
                                   (64, 300, 64, torch.float32, 0.0)):
        q, k, v, do = (torch.randn((bh, t, dk), generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        scale, seed = 1.0 / dk ** 0.5, 4321
        o, lse = attention_fwd(q, k, v, scale, rate, seed, want_lse=True)
        run = lambda: attention_bwd(q, k, v, o, do, lse, scale, rate, seed)
        got = run()
        want = attention_bwd_plain(q, k, v, do, scale, rate, seed)
        torch.cuda.synchronize()
        tag = f"BH={bh} T={t} dk={dk} {str(dtype)[6:]} rate {rate}"
        errs, abs_errs = [], []
        for name, a, w in zip("qkv", got, want):
            scl = float(w.float().abs().max())
            e = float((a.float() - w.float()).abs().max())
            errs.append(e / scl)
            abs_errs.append(e)
            if not e <= K6_TOL[dtype] * scl:
                fail(f"K6 {tag} d{name}: max abs err {e} > {K6_TOL[dtype]} x "
                     f"{scl}")
        if not all(torch.equal(a, b) for a, b in zip(got, run())):
            fail(f"K6 {tag}: two runs differ")
        del got, want
        ms = events_ms(run, reps=10)
        plain_ms = events_ms(lambda: attention_bwd_plain(
            q, k, v, do, scale, rate, seed), reps=2)
        lib_ms = None
        if rate == 0.0:
            q4, k4, v4 = (z.view(1, bh, t, dk).detach().requires_grad_()
                          for z in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            lib_ms = events_ms(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do.view(1, bh, t, dk), retain_graph=True),
                reps=10)
            del q4, k4, v4, out4
        esz = q.element_size()
        nbytes = 8 * bh * t * dk * esz + 4 * bh * t
        flops = 10 * bh * t * t * dk
        bms, by, btxt = attention_bound(nbytes, flops, dtype)
        print(f"[K6] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"sdpa backward {lib_ms} ms, bound {bms:.4f} ms ({btxt}), max "
              f"err dq/dk/dv {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} x "
              f"max|want|")
        if dtype == torch.bfloat16:
            err_main = max(err_main, max(abs_errs))
        if main is None:   # the flagship training shape, bf16, rate 0
            main = {"name": "K6 attention_bwd", "route": "cuda",
                    "source": "sie_tpu_torch/csrc/attention_bwd.cu",
                    "replaces": "sie_tpu/ops/pallas/attention_pallas.py:111",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib_ms}
        del q, k, v, do, o, lse
    main["max_abs_err"] = err_main
    return main


def train_config(**kw):
    # the flagship with bench.py's training settings: lr 5e-3, beta 1
    return flagship_config().replace(batch_size=64, lr=5e-3, **kw)


def random_rows(cfg, n: int):
    """n rows of random inputs and labels from np.random.default_rng(0),
    shaped like a dataset split for `Trainer.device_data`."""
    rng = np.random.default_rng(0)
    return type("Rows", (), dict(
        x=rng.normal(size=(n, cfg.seq_len, cfg.enc_in)).astype(np.float32),
        y=rng.integers(0, cfg.num_class, n).astype(np.int32),
        padding_mask=np.ones((n, cfg.seq_len), np.float32)))()


WATCH = ("sbm.shapelets_0", "sbm.output_layer.weight",
         "deep_model.encoder.layers.0.attention.query.weight",
         "deep_model.projection.weight")


def train_steps(cfg, ds, want: dict, warmup: int, steps: int, tag: str):
    """`warmup` then `steps` timed `Trainer.train_step_indexed` steps of
    cfg.batch_size rows gathered on the card from `ds` (held there), each
    checked for `want` launches a step and none of the other kernels, a
    finite loss and moved weights. The counts are zeroed just before the
    timed steps and read just after. Returns (trainer, device data, the
    index schedule, step ms, losses, launches over the timed steps)."""
    from sie_tpu_torch.train.trainer import Trainer
    counts = Counts()
    n, b = len(ds.y), cfg.batch_size
    trainer = Trainer(cfg, steps_per_epoch=max(1, n // b), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    dev = trainer.device_data("train", ds)
    w = np.ones((b,), np.float32)
    rng = np.random.default_rng(1)
    sched = [rng.integers(0, n, b) for _ in range(warmup + steps)]
    params = dict(trainer.model.named_parameters())
    expect = Counts.full(want)

    def step(i):
        before = {k: params[k].detach().clone() for k in WATCH}
        c0 = counts.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step_indexed(dev, sched[i], w, 1.0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = counts.since(c0)
        if got != expect:
            fail(f"{tag} step {i}: launches {got}, want {expect}")
        if not np.isfinite(float(loss)):
            fail(f"{tag} step {i}: loss {float(loss)}")
        still = [k for k in WATCH if torch.equal(before[k], params[k])]
        if still:
            fail(f"{tag} step {i}: parameters did not move: {still}")
        return ms, float(loss)

    for i in range(warmup):
        step(i)
    counts.zero()   # the path's main run: the timed steps
    res = [step(warmup + i) for i in range(steps)]
    launches = counts.read()
    times = [r[0] for r in res]
    step_ms = float(np.median(times))
    print(f"[{tag}] ms per step (B={b}): " + ", ".join(f"{t:.3f}" for t in
                                                      times))
    print(f"[{tag}] median {step_ms:.3f} ms/step, {1e3 * b / step_ms:.1f} "
          f"samples/s; losses {res[0][1]:.4f} .. {res[-1][1]:.4f}; launches "
          f"over {steps} steps {launches}")
    return trainer, dev, sched, times, [r[1] for r in res], launches


def dropout_step(cfg, dev, idx, want: dict, tag: str) -> None:
    """One step at attention and layer dropout RATE: the same kernels, a
    finite loss."""
    from sie_tpu_torch.train.trainer import Trainer
    counts = Counts()
    drop = Trainer(cfg.replace(dropout=RATE), steps_per_epoch=1,
                   device="cuda", generator=torch.Generator().manual_seed(0))
    c0 = counts.read()
    loss, _ = drop.train_step_indexed(dev, idx, np.ones(len(idx), np.float32),
                                      1.0)
    got = counts.since(c0)
    if got != Counts.full(want) or not np.isfinite(float(loss)):
        fail(f"{tag} dropout step: launches {got}, loss {float(loss)}")
    print(f"[{tag}] dropout {RATE}: loss {float(loss):.4f}, launches {got}")


def gradients(cfg, model, device, batch) -> dict:
    """The loss gradient of every parameter of `model` on `batch`, on the
    host, in float32."""
    from sie_tpu_torch.train.trainer import Trainer
    t = Trainer(cfg, 1, model=model, device=device)
    loss, _ = t.loss_fn(t.model, t._device_batch(batch), 1.0, None)
    loss.backward()
    return {k: p.grad.float().cpu() for k, p in t.model.named_parameters()}


def worst_gradient(got: dict, want: dict, what: str):
    """The largest relative norm error of got against want, per parameter;
    fails above GRAD_TOL."""
    worst = ("", 0.0)
    for name, gw in want.items():
        if name.endswith("attention.key.bias"):
            continue   # zero in exact arithmetic: only rounding noise
        e = float((got[name] - gw).norm() / gw.norm())
        worst = max(worst, (name, e), key=lambda z: z[1])
        if not e <= GRAD_TOL:
            fail(f"{what} gradient of {name}: relative error {e}")
    return worst


def phase_train() -> dict:
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.train.trainer import weighted_ce
    cfg = train_config()
    ds = random_rows(cfg, 256)
    b = cfg.batch_size
    want = {"K1": 6, "K2": 6, "K5": 2, "K6": 2}
    trainer, dev, sched, times, _, launches = train_steps(
        cfg, ds, want, WARMUP, STEPS, "train")
    step_ms = float(np.median(times))

    # decomposition (bench.py's): fwd+bwd of the full model, of the SBM
    # branch alone and of the Transformer expert alone, every gradient
    # leaf consumed; the optimizer's share is the step minus the full one
    model = trainer.model
    idx = torch.as_tensor(sched[0], device="cuda")
    x, y, mask = (leaf[idx] for leaf in dev)
    wt = torch.ones(b, device="cuda")
    plist = [p for p in model.parameters()]

    def fwdbwd(which):
        if which == "sbm":
            out, info = model.sbm(x, mask, generator=trainer.generator)
            loss = weighted_ce(out, y, wt) + info.loss.mean()
        elif which == "dnn":
            loss = weighted_ce(model.deep_model(x, mask, trainer.generator),
                               y, wt)
        else:
            out, info = model(x, mask, generator=trainer.generator)
            loss = weighted_ce(out, y, wt) + info.loss.mean()
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
        return sum(g.float().sum() for g in grads if g is not None)

    split = {}
    for which in ("full", "sbm", "dnn"):
        fwdbwd(which)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            total = fwdbwd(which)
        float(total)
        split[which] = 1e3 * (time.perf_counter() - t0) / STEPS
    print(f"[train] fwd+bwd ms: full {split['full']:.3f}, sbm "
          f"{split['sbm']:.3f}, dnn {split['dnn']:.3f}; optimizer_ms "
          f"{step_ms - split['full']:.3f} (step minus full fwd+bwd)")
    dropout_step(cfg, dev, sched[0], want, "train")

    # card against the CPU plain path: gradients at the same weights, 2 rows
    fresh = build_model(cfg, "cuda", torch.Generator().manual_seed(0)).train()
    cpu = copy.deepcopy(fresh).cpu()
    batch = (ds.x[:2], ds.y[:2], ds.padding_mask[:2], np.ones(2, np.float32))
    worst = worst_gradient(gradients(cfg, fresh, "cuda", batch),
                           gradients(cfg, cpu, "cpu", batch), "card vs CPU")
    print(f"[train] card vs CPU plain path, 2 rows: worst relative gradient "
          f"error {worst[1]:.3e} ({worst[0]})")
    return launches


def phase_k3_k4() -> tuple:
    """K3 and K4 on the six flagship banks against six K1 and six K2
    launches (bit for bit) and against their plain versions; times."""
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet_l1 import (
        l1_sliding_distance, l1_sliding_distance_bwd,
        l1_sliding_distance_grouped, l1_sliding_distance_grouped_bwd,
        l1_sliding_distance_grouped_bwd_plain,
        l1_sliding_distance_grouped_plain)
    b, c, t, n = 64, 122, 845, 10
    gen = torch.Generator(device="cuda").manual_seed(7)
    lengths = bank_lengths(Config())
    x = torch.randn((b, c, t), generator=gen, device="cuda")
    banks = [torch.randn((n, c, l), generator=gen, device="cuda")
             for l in lengths]
    gs = [torch.randn((b, n, c, t - l + 1), generator=gen, device="cuda")
          for l in lengths]

    outs = l1_sliding_distance_grouped(x, banks)
    per_bank = [l1_sliding_distance(x, s) for s in banks]
    want = l1_sliding_distance_grouped_plain(x, banks)
    torch.cuda.synchronize()
    for l, o, k1 in zip(lengths, outs, per_bank):
        if not torch.equal(o, k1):
            fail(f"K3 L={l}: differs from K1 by "
                 f"{float((o - k1).abs().max())}")
    err3 = max(float((o - w).abs().max()) for o, w in zip(outs, want))
    if not err3 <= K1_TOL:
        fail(f"K3: max abs err {err3} against the plain version > {K1_TOL}")
    del outs, per_bank, want

    grads = l1_sliding_distance_grouped_bwd(x, banks, gs)
    per_bank = [l1_sliding_distance_bwd(x, s, g) for s, g in zip(banks, gs)]
    want = l1_sliding_distance_grouped_bwd_plain(x, banks, gs)
    again = l1_sliding_distance_grouped_bwd(x, banks, gs)
    torch.cuda.synchronize()
    err4, rel4 = 0.0, 0.0
    for l, gr, k2, w, a in zip(lengths, grads, per_bank, want, again):
        if not torch.equal(gr, k2):
            fail(f"K4 L={l}: differs from K2 by "
                 f"{float((gr - k2).abs().max())}")
        if not torch.equal(gr, a):
            fail(f"K4 L={l}: two runs differ")
        scale = float(w.abs().max())
        e = float((gr - w).abs().max())
        err4, rel4 = max(err4, e), max(rel4, e / scale)
        if not e <= K2_TOL * scale:
            fail(f"K4 L={l}: max abs err {e} > {K2_TOL} x {scale}")
    del grads, per_bank, want, again

    def k1_all():
        for s in banks:
            l1_sliding_distance(x, s)

    def k2_all():
        for s, g in zip(banks, gs):
            l1_sliding_distance_bwd(x, s, g)

    # in turns: grouped, per bank, per bank, grouped
    ms3a = events_ms(lambda: l1_sliding_distance_grouped(x, banks), reps=10)
    ms1a = events_ms(k1_all, reps=10)
    ms1b = events_ms(k1_all, reps=10)
    ms3b = events_ms(lambda: l1_sliding_distance_grouped(x, banks), reps=10)
    ms4a = events_ms(lambda: l1_sliding_distance_grouped_bwd(x, banks, gs),
                     reps=10)
    ms2a = events_ms(k2_all, reps=10)
    ms2b = events_ms(k2_all, reps=10)
    ms4b = events_ms(lambda: l1_sliding_distance_grouped_bwd(x, banks, gs),
                     reps=10)
    plain3 = events_ms(lambda: l1_sliding_distance_grouped_plain(x, banks),
                       reps=1)
    plain4 = events_ms(lambda: l1_sliding_distance_grouped_bwd_plain(
        x, banks, gs), reps=1)
    taps = sum(2 * b * n * c * (t - l + 1) * l for l in lengths)
    outb = sum(4 * b * n * c * (t - l + 1) for l in lengths)
    sb = sum(4 * n * c * l for l in lengths)
    bms3, by3 = bound_ms(4 * b * c * t + sb + outb, taps, PEAK_FP32)
    bms4, by4 = bound_ms(4 * b * c * t + 2 * sb + outb, taps, PEAK_FP32)
    ms3, ms4 = (ms3a + ms3b) / 2, (ms4a + ms4b) / 2
    print(f"[K3] six flagship banks, B={b}: kernel {ms3a:.4f}/{ms3b:.4f} ms, "
          f"six K1 {ms1a:.4f}/{ms1b:.4f} ms (in turns), plain {plain3:.3f} "
          f"ms, bound {bms3:.4f} ms ({by3}); equal to K1 bit for bit, max "
          f"abs err {err3:.3e} against the plain version")
    print(f"[K4] six flagship banks, B={b}: kernel {ms4a:.4f}/{ms4b:.4f} ms, "
          f"six K2 {ms2a:.4f}/{ms2b:.4f} ms (in turns), plain {plain4:.3f} "
          f"ms, bound {bms4:.4f} ms ({by4}); equal to K2 bit for bit and to "
          f"itself on a second run, max abs err {err4:.3e} ({rel4:.3e} x "
          f"max|want|) against the plain version")
    # No library time: no one PyTorch call computes several banks (K1's
    # row times torch.cdist per bank; K2 has none, see phase_k2)
    return ({"name": "K3 shapelet_l1_grouped_fwd", "route": "cuda",
             "source": "sie_tpu_torch/csrc/shapelet_l1_grouped_fwd.cu",
             "replaces": "sie_tpu/ops/pallas/shapelet_pallas.py:504",
             "max_abs_err": err3, "ms": ms3, "plain_ms": plain3,
             "bound_ms": bms3, "bound_by": by3, "library_ms": None},
            {"name": "K4 shapelet_l1_grouped_bwd", "route": "cuda",
             "source": "sie_tpu_torch/csrc/shapelet_l1_grouped_bwd.cu",
             "replaces": "sie_tpu/ops/pallas/shapelet_pallas.py:561",
             "max_abs_err": err4, "ms": ms4, "plain_ms": plain4,
             "bound_ms": bms4, "bound_by": by4, "library_ms": None})


def phase_fused(unfused_outs: dict) -> dict:
    """The flagship with fuse_short_banks=True, at the unfused model's
    weights: served and trained through K3/K4."""
    from sie_tpu_torch.models.registry import build_model
    cfg = flagship_config().replace(fuse_short_banks=True)
    model = build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    outs, _ = serve_requests(cfg, model, {"K3": 1, "K5": 2}, "serve fused")
    e = max(float(np.abs(outs[b].logits - unfused_outs[b].logits).max())
            for b in SERVE_SIZES)
    print(f"[serve fused] against the unfused predictor on the card: max "
          f"|dlogits| {e:.3e}")
    # K3 is K1 bit for bit and the rest of the path is the same code on
    # the same card, so the logits and gradients must be equal, not close
    if e != 0.0:
        fail(f"fused serving differs from unfused serving: {e}")
    del model

    tcfg = train_config(fuse_short_banks=True)
    ds = random_rows(tcfg, 256)
    _, _, _, _, _, launches = train_steps(
        tcfg, ds, {"K3": 1, "K4": 1, "K5": 2, "K6": 2}, WARMUP, FUSED_STEPS,
        "train fused")
    fused = build_model(tcfg, "cuda", torch.Generator().manual_seed(0))
    plain = build_model(train_config(), "cuda",
                        torch.Generator().manual_seed(0))
    batch = (ds.x[:2], ds.y[:2], ds.padding_mask[:2], np.ones(2, np.float32))
    got = gradients(tcfg, fused.train(), "cuda", batch)
    want = gradients(train_config(), plain.train(), "cuda", batch)
    differ = [k for k, w in want.items() if not torch.equal(got[k], w)]
    if differ:
        fail(f"fused gradients differ from unfused ones in {differ}")
    print(f"[train fused] against the unfused card path, 2 rows: all "
          f"{len(want)} parameter gradients equal bit for bit")
    return launches


def profile_ms(fn, names, reps: int = 2) -> dict:
    """Device ms per call of fn() of the kernels whose names contain each of
    `names`, from torch.profiler over reps calls after one warm-up; fails
    if the profiler saw none of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in e.key:
                out[name] += e.self_device_time_total / 1e3 / reps
    if not all(out.values()):
        fail(f"the profiler saw no device time for some of {names}: {out}")
    return out


def phase_long_attention() -> tuple:
    """K5 and K6 at the EigenWorms-shaped model's attention (BH=64, T=17984,
    dk=64), where the JAX package runs K7, K8a and K8b."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from sie_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_plain_chunked, attention_fwd,
        attention_plain_chunked)
    bh, t, dk, hd = LONG_BH, LONG_T, LONG_DK, LONG_HEADS
    gen = torch.Generator(device="cuda").manual_seed(8)
    scale, seed = 1.0 / dk ** 0.5, 2468
    # max abs errors by dtype: K5's output, K6's dQ (K8a), K6's dK/dV (K8b)
    rows, err = {}, {torch.bfloat16: [0.0] * 3, torch.float32: [0.0] * 3}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn((bh, t, dk), generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        esz = q.element_size()
        for rate in (0.0, RATE):
            tag = f"BH={bh} T={t} dk={dk} {str(dtype)[6:]} rate {rate}"
            o, lse = attention_fwd(q, k, v, scale, rate, seed, want_lse=True)
            want = attention_plain_chunked(q[:hd], k[:hd], v[:hd], scale,
                                           rate, seed)
            e5 = float((o[:hd].float() - want.float()).abs().max())
            # x max|want|, as K6's limit: over 17984 keys a typical |o| is
            # ~0.01, below the flagship's absolute limit; in bf16 this is
            # 2.5 or more rounding steps of the largest output
            scl5 = float(want.float().abs().max())
            if not e5 <= K5_TOL[dtype] * scl5:
                fail(f"K5 {tag}: max abs err {e5} > {K5_TOL[dtype]} x {scl5}")
            e_lse = 0.0
            for r0 in range(0, t, 2048):
                sc = torch.matmul(q[:hd, r0:r0 + 2048].float(),
                                  k[:hd].float().transpose(-1, -2))
                if dtype == torch.bfloat16:
                    sc = sc.to(torch.bfloat16).float()
                e_lse = max(e_lse, float(
                    (lse[:hd, r0:r0 + 2048]
                     - torch.logsumexp(sc * scale, dim=-1)).abs().max()))
            del sc
            if not e_lse <= 1e-3:
                fail(f"K5 {tag}: log-sum-exp max abs err {e_lse} > 1e-3")
            run = lambda: attention_bwd(q, k, v, o, do, lse, scale, rate, seed)
            got = run()
            want = attention_bwd_plain_chunked(q[:hd], k[:hd], v[:hd], do[:hd],
                                               scale, rate, seed)
            e6, abs6 = [], []
            for name, a, w in zip("qkv", got, want):
                scl = float(w.float().abs().max())
                e = float((a[:hd].float() - w.float()).abs().max())
                e6.append(e / scl)
                abs6.append(e)
                if not e <= K6_TOL[dtype] * scl:
                    fail(f"K6 {tag} d{name}: max abs err {e} > "
                         f"{K6_TOL[dtype]} x {scl}")
            del got, want
            err[dtype] = [max(a, b) for a, b in
                          zip(err[dtype], (e5, abs6[0], max(abs6[1:])))]
            reps = 3 if dtype == torch.bfloat16 else 2
            ms5 = events_ms(lambda: attention_fwd(q, k, v, scale, rate, seed,
                                                  want_lse=True), reps=reps)
            ms6 = events_ms(run, reps=reps)
            print(f"[long] K5 {tag}: kernel {ms5:.4f} ms, max abs err "
                  f"{e5:.3e} (first {hd} heads), log-sum-exp err {e_lse:.3e};"
                  f" K6: kernel {ms6:.4f} ms, max err dq/dk/dv "
                  f"{e6[0]:.2e}/{e6[1]:.2e}/{e6[2]:.2e} x max|want|")
            if rate != 0.0:
                continue
            passes = profile_ms(run, ("attn_bwd_dq", "attn_bwd_dkv",
                                      "attn_bwd_delta"))
            plain5 = events_ms(lambda: attention_plain_chunked(
                q, k, v, scale, chunk=256), reps=1, warmup=0)
            plain6 = events_ms(lambda: attention_bwd_plain_chunked(
                q, k, v, do, scale, chunk=256), reps=1, warmup=0)
            # the library's time, without its (BH, T, T) math fallback,
            # which this shape does not fit
            q4, k4, v4 = (z.view(8, bh // 8, t, dk).detach().requires_grad_()
                          for z in (q, k, v))
            try:
                with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                  SDPBackend.EFFICIENT_ATTENTION]):
                    lib5 = events_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, scale=scale), reps=reps)
                    out4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                          scale=scale)
                    lib6 = events_ms(lambda: torch.autograd.grad(
                        out4, (q4, k4, v4), do.view(8, bh // 8, t, dk),
                        retain_graph=True), reps=reps)
                    del out4
            except RuntimeError as exc:   # no fused library kernel for it
                print(f"[long] {str(dtype)[6:]}: no library time: {exc}")
                lib5 = lib6 = None
            del q4, k4, v4
            # bytes: each input read once, each output written once
            io, lse_b = bh * t * dk * esz, 4 * bh * t
            b5 = attention_bound(4 * io + lse_b, 4 * bh * t * t * dk, dtype)
            b8a = attention_bound(6 * io + lse_b, 6 * bh * t * t * dk, dtype)
            b8b = attention_bound(7 * io + lse_b, 8 * bh * t * t * dk, dtype)
            b6 = attention_bound(8 * io + lse_b, 10 * bh * t * t * dk, dtype)
            print(f"[long] {str(dtype)[6:]} rate 0: K5 {ms5:.4f} ms (plain "
                  f"{plain5:.3f}, sdpa {lib5}, bound {b5[0]:.4f} ms "
                  f"({b5[2]})); K6 {ms6:.4f} ms (plain {plain6:.3f}, sdpa "
                  f"backward {lib6}, bound {b6[0]:.4f} ms ({b6[2]})); "
                  f"profiler per K6 call: dQ pass (K8a) "
                  f"{passes['attn_bwd_dq']:.4f} ms (bound {b8a[0]:.4f}: "
                  f"{b8a[2]}), dK/dV pass (K8b) "
                  f"{passes['attn_bwd_dkv']:.4f} ms (bound {b8b[0]:.4f}: "
                  f"{b8b[2]}), delta pass "
                  f"{passes['attn_bwd_delta']:.4f} ms")
            rows[dtype] = dict(ms5=ms5, ms8a=passes["attn_bwd_dq"],
                               ms8b=passes["attn_bwd_dkv"], plain5=plain5,
                               plain6=plain6, lib5=lib5, lib6=lib6, b5=b5,
                               b8a=b8a, b8b=b8b)
        del q, k, v, do, o, lse
    # the rows: float32, the dtype of the EigenWorms-shaped model's path;
    # K8a and K8b share the plain and library time of the whole backward
    r, e = rows[torch.float32], err[torch.float32]
    att = "sie_tpu/ops/pallas/attention_pallas.py"
    return ({"name": "K7 attention_fwd (kv-blocked)", "route": "cuda",
             "source": "sie_tpu_torch/csrc/attention_fwd.cu",
             "replaces": f"{att}:163", "max_abs_err": e[0], "ms": r["ms5"],
             "plain_ms": r["plain5"], "bound_ms": r["b5"][0],
             "bound_by": r["b5"][1], "library_ms": r["lib5"]},
            {"name": "K8a attention_bwd dQ pass", "route": "cuda",
             "source": "sie_tpu_torch/csrc/attention_bwd.cu",
             "replaces": f"{att}:202", "max_abs_err": e[1],   # dQ
             "ms": r["ms8a"], "plain_ms": r["plain6"],
             "bound_ms": r["b8a"][0], "bound_by": r["b8a"][1],
             "library_ms": r["lib6"]},
            {"name": "K8b attention_bwd dK/dV pass", "route": "cuda",
             "source": "sie_tpu_torch/csrc/attention_bwd.cu",
             "replaces": f"{att}:236", "max_abs_err": e[2],   # dK, dV
             "ms": r["ms8b"], "plain_ms": r["plain6"],
             "bound_ms": r["b8b"][0], "bound_by": r["b8b"][1],
             "library_ms": r["lib6"]})


def long_config(**kw):
    """InterpGN + Transformer at the Config defaults' width on an
    EigenWorms-shaped input (sie_tpu/data/uea.py: 6 channels, 17984 steps,
    5 classes), float32 as run_uea.sh trains UEA, batch 8 (its advice for
    EigenWorms), every sequence length through the fused attention."""
    from sie_tpu_torch.config import Config
    return Config(model="InterpGN", dnn_type="Transformer", data="UEA",
                  dataset="EigenWorms", seq_len=LONG_T, enc_in=6,
                  num_class=5, d_model=512, n_heads=8, e_layers=2, d_ff=2048,
                  fused_attention_max_len=0, batch_size=8, lr=5e-3,
                  dropout=0.0, amp=False, seed=0, **kw)


def phase_train_long() -> dict:
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet import shapelet_stride
    cfg = long_config()
    strides = [shapelet_stride(cfg.seq_len, l) for l in bank_lengths(cfg)]
    if min(strides) < 2:
        fail(f"EigenWorms-shaped banks: strides {strides}, want all > 1")
    # one K1 (K2) launch per polyphase component of each strided bank
    want = {"K1": sum(strides), "K2": sum(strides), "K5": 2, "K6": 2}
    print(f"[train long] banks L={bank_lengths(cfg)}, strides {strides}; "
          f"launches a step {want}")
    ds = random_rows(cfg, 2 * cfg.batch_size)
    _, dev, sched, _, _, launches = train_steps(
        cfg, ds, want, LONG_WARMUP, LONG_STEPS, "train long")
    dropout_step(cfg, dev, sched[0], want, "train long")
    return launches


def main() -> None:
    phase_device()
    phase_build()
    k1 = phase_k1()
    with time_limit(300, "the K5 phase"):
        k5 = phase_k5()
    served = phase_serve()
    with time_limit(300, "the K5 dropout phase"):
        phase_k5_dropout()
    k2 = phase_k2()
    with time_limit(300, "the K6 phase"):
        k6 = phase_k6()
    launches = phase_train()
    k3, k4 = phase_k3_k4()
    fused = phase_fused(served)
    del served
    with time_limit(600, "the long-sequence K5/K6 phase"):
        k7, k8a, k8b = phase_long_attention()
    long_launches = phase_train_long()
    # each row's launches: the timed training steps of its own path
    paths = ((k1, launches, "K1"), (k2, launches, "K2"),
             (k3, fused, "K3"), (k4, fused, "K4"), (k5, launches, "K5"),
             (k6, launches, "K6"), (k7, long_launches, "K5"),
             (k8a, long_launches, "K6"), (k8b, long_launches, "K6"))
    kernels = []
    for d, counted, key in paths:
        d["launches"] = counted[key]
        if not d["launches"]:
            fail(f"{d['name']} was not launched on its path")
        kernels.append(d)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [K2_LIB_FLAG]:
        k2_library_child(int(sys.argv[2]))
    else:
        main()
