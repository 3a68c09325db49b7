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
     of every request; the median time of each size is printed; its logits
     are held against the plain CPU path on 2 rows;
  6. one JSON line of per-kernel numbers, then the device line.

Times are CUDA-event times after warm-up (kernels) or host-clock times of
whole requests ending in a copy to the host (serving). Bounds use the
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


def phase_serve() -> dict:
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

    l1_sliding_distance.launches = 0
    fused_attention.launches = 0
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
    launches = {"K1": l1_sliding_distance.launches,
                "K5": fused_attention.launches}

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
    return launches


def main() -> None:
    phase_device()
    phase_build()
    k1 = phase_k1()
    k5 = phase_k5()
    launches = phase_serve()
    k1["launches"], k5["launches"] = launches["K1"], launches["K5"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in (k1, k5)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
