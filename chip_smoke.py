"""Smoke run of sie_tpu_torch on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final `ok` line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel source of the package, in parallel;
  3. K1 (shapelet distance) against its plain version at the flagship
     shapes: B=64, C=122, T=845, n=10, each of the six banks, both metrics;
     kernel, plain and torch.cdist times and the bound;
  4. K5 (fused attention) against its plain version at BH=512, T=845,
     dk=64 in bf16 and f32, and at a ragged T=300; kernel, plain and
     scaled_dot_product_attention times and the bound;
  5. serving: the flagship InterpGN (weights from seed 0) behind
     `Predictor` on the card answers requests of 1, 5, 64 and 150 rows
     (max_batch 64), three of each, with launch counts checked per chunk
     of every request (K2 and K6, the backward kernels, never); the median
     time of each size is printed; its logits are held against the plain
     CPU path on 2 rows;
  6. K5 with dropout (rate 0.1) against its plain version at BH=512, T=845,
     dk=64 in bf16 and f32; its row log-sum-exp output; times at rate 0.1
     and rate 0;
  7. K2 (shapelet-distance backward) against its plain version at B=64 on
     each of the six banks, both metrics, random output gradients, and
     against itself (deterministic); kernel and plain times and the bound;
  8. K6 (attention backward) against its plain version at BH=512, T=845,
     dk=64 in bf16 and f32 and at a ragged T=300, rates 0 and 0.1; kernel,
     plain and scaled_dot_product_attention-backward times and the bound;
  9. training: the flagship InterpGN under `Trainer` on the card, 256 rows
     held there, B=64: 3 warm-up and 10 timed steps, each checked for its
     kernel launches (K1 6, K2 6, K5 2, K6 2), a finite loss and moved
     weights; the median step time, the full/sbm/dnn fwd+bwd split and the
     optimizer's share; a step at dropout 0.1; the card's gradients held
     against the plain CPU path's on 2 rows;
 10. one JSON line of per-kernel numbers (launches from the timed training
     steps), then the device line.

Times are CUDA-event times after warm-up (kernels) or host-clock times of
work that ends in a synchronisation (requests, steps). Bounds use the
published H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s FP32, 989 TFLOP/s bf16.
It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES = 3.35e12           # B/s
PEAK_FP32 = 67e12              # FLOP/s, CUDA cores
PEAK_BF16 = 989e12             # FLOP/s, tensor cores, dense

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


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


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


def phase_build() -> None:
    from sie_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.build()
    print(f"[build] {time.perf_counter() - t0:.3f} s for "
          f"{', '.join(build.SIGNATURES)}")
    for name, log in build.PTXAS_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


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
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
        bms, by = bound_ms(nbytes, flops, peak)
        print(f"[K5] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), max abs err "
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


def phase_serve() -> None:
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.ops.attention import fused_attention
    from sie_tpu_torch.ops.shapelet_l1 import l1_sliding_distance
    from sie_tpu_torch.serve import Predictor
    cfg = flagship_config()
    model = build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    pred = Predictor.from_module(cfg, model, device="cuda", max_batch=64)
    rng = np.random.default_rng(0)
    sizes = (1, 5, 64, 150)
    xs = {b: rng.normal(size=(b, cfg.seq_len, cfg.enc_in)).astype(np.float32)
          for b in sizes}
    for b in sizes:   # warm-up: every bucket the run below hits
        pred.predict(xs[b][: min(b, 64)])
    torch.cuda.synchronize()

    from sie_tpu_torch.ops.attention import attention_bwd
    from sie_tpu_torch.ops.shapelet_l1 import l1_sliding_distance_bwd
    l1_sliding_distance.launches = 0
    fused_attention.launches = 0
    attention_bwd.launches = l1_sliding_distance_bwd.launches = 0
    outs, served_ms = {}, {}
    for b in sizes:
        times = []
        for _ in range(REPEATS):
            k1, k5 = l1_sliding_distance.launches, fused_attention.launches
            t0 = time.perf_counter()
            out = pred.predict(xs[b])
            times.append(1e3 * (time.perf_counter() - t0))
            chunks = -(-b // pred.max_batch)
            d1 = l1_sliding_distance.launches - k1
            d5 = fused_attention.launches - k5
            if d1 != 6 * chunks or d5 != 2 * chunks:
                fail(f"request of {b}: K1 launched {d1} times, K5 {d5}; want "
                     f"{6 * chunks} and {2 * chunks}")
        served_ms[b] = float(np.median(times))
        outs[b] = out
    print(f"[serve] launches over the run: K1 {l1_sliding_distance.launches},"
          f" K5 {fused_attention.launches}, K2 "
          f"{l1_sliding_distance_bwd.launches}, K6 {attention_bwd.launches}")
    if attention_bwd.launches or l1_sliding_distance_bwd.launches:
        fail(f"serving launched backward kernels: K2 "
             f"{l1_sliding_distance_bwd.launches}, K6 "
             f"{attention_bwd.launches}")

    for b, out in outs.items():
        if out.logits.shape != (b, cfg.num_class) or \
                out.p.shape != (b, 7320) or out.eta.shape != (b, 1):
            fail(f"request of {b}: shapes {out.logits.shape}, {out.p.shape}")
        for name in ("logits", "probs", "eta", "p", "d"):
            if not np.isfinite(getattr(out, name)).all():
                fail(f"request of {b}: non-finite {name}")
        if not (out.classes == out.logits.argmax(-1)).all():
            fail(f"request of {b}: classes != argmax(logits)")
    print(f"[serve] ms per request (median of {REPEATS}): " + ", ".join(
        f"{b} rows {served_ms[b]:.3f}" for b in sizes))

    cpu = Predictor.from_module(cfg, copy.deepcopy(model).cpu(),
                                device="cpu", max_batch=64)
    ref = cpu.predict(xs[5][:2])
    got = outs[5].logits[:2]
    e = float(np.abs(got - ref.logits).max())
    print(f"[serve] card vs CPU plain path, 2 rows: max |dlogits| {e:.3e}; "
          f"classes {got.argmax(-1).tolist()} vs {ref.classes.tolist()}")
    if not e <= SERVE_TOL or not (got.argmax(-1) == ref.classes).all():
        fail(f"served logits differ from the CPU plain path: {e}")


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
    # No library time: the one PyTorch call for this gradient, the bank's
    # gradient through torch.cdist(p=1), buffers (C, B*W, n, L) floats,
    # 2.7e9 to 9.0e9 of them here, and its backward stopped the card with an
    # illegal memory access at L=43 (H100 80GB HBM3, torch 2.11.0+cu128).
    print(f"[K2] six banks: kernel {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms ({by}), "
          f"max abs err {err:.3e} ({rel:.3e} x max|want|); no library time "
          f"(cdist backward fails at these shapes)")
    return {"name": "K2 shapelet_l1_bwd", "route": "cuda",
            "source": "sie_tpu_torch/csrc/shapelet_l1_bwd.cu",
            "replaces": "sie_tpu/ops/pallas/shapelet_pallas.py:162",
            "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by, "library_ms": None}


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
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
        bms, by = bound_ms(nbytes, flops, peak)
        print(f"[K6] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"sdpa backward {lib_ms} ms, bound {bms:.4f} ms ({by}), max err "
              f"dq/dk/dv {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} x max|want|")
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


class Counts:
    """The four kernels' launch counters: zeroed, read, and checked."""

    def __init__(self):
        from sie_tpu_torch.ops.attention import attention_bwd, fused_attention
        from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                                   l1_sliding_distance_bwd)
        self.fns = {"K1": l1_sliding_distance, "K2": l1_sliding_distance_bwd,
                    "K5": fused_attention, "K6": attention_bwd}

    def zero(self) -> None:
        for fn in self.fns.values():
            fn.launches = 0

    def read(self) -> dict:
        return {k: fn.launches for k, fn in self.fns.items()}


def train_config(**kw):
    # the flagship with bench.py's training settings: lr 5e-3, beta 1
    return flagship_config().replace(batch_size=64, lr=5e-3, **kw)


def phase_train() -> dict:
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.train.trainer import Trainer, weighted_ce
    cfg = train_config()
    counts = Counts()
    rng = np.random.default_rng(0)
    n, b = 256, cfg.batch_size
    ds = type("Rows", (), dict(
        x=rng.normal(size=(n, cfg.seq_len, cfg.enc_in)).astype(np.float32),
        y=rng.integers(0, cfg.num_class, n).astype(np.int32),
        padding_mask=np.ones((n, cfg.seq_len), np.float32)))()
    trainer = Trainer(cfg, steps_per_epoch=n // b, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    dev = trainer.device_data("train", ds)
    w = np.ones((b,), np.float32)
    sched = [rng.integers(0, n, b) for _ in range(WARMUP + STEPS)]
    params = dict(trainer.model.named_parameters())
    watch = ("sbm.shapelets_0", "sbm.output_layer.weight",
             "deep_model.encoder.layers.0.attention.query.weight",
             "deep_model.projection.weight")
    want = {"K1": 6, "K2": 6, "K5": 2, "K6": 2}

    def step(i):
        before = {k: params[k].detach().clone() for k in watch}
        c0 = counts.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step_indexed(dev, sched[i], w, 1.0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        c1 = counts.read()
        delta = {k: c1[k] - c0[k] for k in c1}
        if delta != want:
            fail(f"train step {i}: launches {delta}, want {want}")
        if not np.isfinite(float(loss)):
            fail(f"train step {i}: loss {float(loss)}")
        still = [k for k in watch if torch.equal(before[k], params[k])]
        if still:
            fail(f"train step {i}: parameters did not move: {still}")
        return ms, float(loss)

    for i in range(WARMUP):
        step(i)
    counts.zero()   # the main path: the timed steps
    res = [step(WARMUP + i) for i in range(STEPS)]
    launches = counts.read()
    times = [r[0] for r in res]
    step_ms = float(np.median(times))
    print(f"[train] ms per step (B={b}): " + ", ".join(f"{t:.3f}" for t in
                                                       times))
    print(f"[train] median {step_ms:.3f} ms/step, {1e3 * b / step_ms:.1f} "
          f"samples/s; losses {res[0][1]:.4f} .. {res[-1][1]:.4f}; launches "
          f"over {STEPS} steps {launches}")

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

    # one step at dropout 0.1: the same kernels, a finite loss
    drop = Trainer(train_config(dropout=RATE), steps_per_epoch=n // b,
                   device="cuda", generator=torch.Generator().manual_seed(0))
    c0 = counts.read()
    loss, _ = drop.train_step_indexed(dev, sched[0], w, 1.0)
    delta = {k: v - c0[k] for k, v in counts.read().items()}
    if delta != want or not np.isfinite(float(loss)):
        fail(f"dropout step: launches {delta}, loss {float(loss)}")
    print(f"[train] dropout {RATE}: loss {float(loss):.4f}, launches {delta}")
    del drop

    # card against the CPU plain path: gradients at the same weights, 2 rows
    fresh = build_model(cfg, "cuda", torch.Generator().manual_seed(0)).train()
    cpu = copy.deepcopy(fresh).cpu()
    batch = (ds.x[:2], ds.y[:2], ds.padding_mask[:2], np.ones(2, np.float32))
    grads = []
    for m, device in ((fresh, "cuda"), (cpu, "cpu")):
        t = Trainer(cfg, 1, model=m, device=device)
        loss, (_, _) = t.loss_fn(t.model, t._device_batch(batch), 1.0, None)
        loss.backward()
        grads.append({k: p.grad.float().cpu() for k, p in
                      t.model.named_parameters()})
    worst = ("", 0.0)
    for name, gc in grads[1].items():
        gd = grads[0][name]
        if name.endswith("attention.key.bias"):
            continue   # zero in exact arithmetic: only rounding noise
        e = float((gd - gc).norm() / gc.norm())
        worst = max(worst, (name, e), key=lambda z: z[1])
        if not e <= GRAD_TOL:
            fail(f"card vs CPU gradient of {name}: relative error {e}")
    print(f"[train] card vs CPU plain path, 2 rows: worst relative gradient "
          f"error {worst[1]:.3e} ({worst[0]})")
    return launches


def main() -> None:
    phase_device()
    phase_build()
    k1 = phase_k1()
    k5 = phase_k5()
    phase_serve()
    phase_k5_dropout()
    k2 = phase_k2()
    k6 = phase_k6()
    launches = phase_train()
    kernels = []
    for d in (k1, k2, k5, k6):
        d["launches"] = launches[d["name"].split()[0]]
        kernels.append(d)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
