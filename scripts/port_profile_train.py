"""Where a training step's time goes in sie_tpu_torch, on one CUDA card.

    python scripts/port_profile_train.py [--config flagship|fused|eigenworms|
        uea_fcn|eegcnn|regression|patchtst|timesnet|moe]
        [--path indexed|staged]
        [--steps 10] [--no-profile] [--out DIR]

Builds the configuration's model (weights from seed 0) under `Trainer` on
the card: `flagship` is bench.py's InterpGN (B=64), `fused` the same with
`fuse_short_banks`, `eigenworms` chip_smoke.py's EigenWorms-shaped
InterpGN + Transformer (T=17984, float32, B=8), `uea_fcn` chip_smoke.py's
InterpGN + FCN as run_uea.sh trains it at that shape, `eegcnn` bench.py's
EEGCNN (chip_smoke.py's `eegcnn_config`, dropout 0.1), `regression` the
flagship's InterpGN at chip_smoke.py phase 24's BIDMC32HR shape (C = 2,
T = 1000 after subsampling, 10 bins, lr 1e-5, B=64) with the CRPS head and
float targets, `patchtst` and `timesnet` chip_smoke.py's InterpGN +
PatchTST (full width, four recomputed chunks) and + TimesNet (d_model 32)
at the flagship's data shape, dropout 0.1, and `moe` chip_smoke.py's
flagship with a Switch-MoE FFN (8 experts, top-1, dropout 0.1). Holds
four batches of random rows on the card.
`--path indexed` (the default) trains through the eager
`train_step_indexed`; `--path staged` stages a schedule of four batches
and trains through `train_step_staged`, whose first call is the eager
warm-up and second the capture of its CUDA graph, which later steps
replay. Warms up with 3 steps, then times `--steps` steps with the host
clock (each ending in a synchronisation) and prints their times and
median.
Unless `--no-profile`, it then profiles two more steps with torch.profiler
and prints the device busy time, the idle share of the profiled window and
the ops by device time, with the device time summed by kind of kernel
(the shapelet kernels K1-K4, the attention kernels K5/K6, cuDNN
convolutions, GEMMs, the rest); `--out` also writes the Chrome trace
there. For a model with BatchNorm it also sums the device time of the
forward and backward of the whole model, of InterpGN's SBM branch and of
its expert alone, each with BatchNorm and with every BatchNorm's forward
replaced by the identity: the difference is BatchNorm's share. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
import time

import numpy as np
import torch

WARMUP = 3

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "fused", "eigenworms", "uea_fcn",
                             "eegcnn", "regression", "patchtst", "timesnet",
                             "moe"))
    ap.add_argument("--path", default="indexed", choices=("indexed", "staged"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import (eegcnn_config, long_config, moe_config,
                            patchtst_config, timesnet_config, train_config,
                            uea_config)
    from sie_tpu_torch.train.trainer import Trainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = {"flagship": train_config,
           "fused": lambda: train_config(fuse_short_banks=True),
           "eigenworms": long_config,
           "uea_fcn": lambda: uea_config("FCN"),
           "eegcnn": eegcnn_config,
           "regression": lambda: train_config(seq_len=1000, enc_in=2,
                                              num_class=10).replace(lr=1e-5),
           "patchtst": patchtst_config, "timesnet": timesnet_config,
           "moe": moe_config,
           }[args.config]()
    batch = cfg.batch_size
    rows = 4 * batch
    rng = np.random.default_rng(0)
    regression = args.config == "regression"
    ds = type("Rows", (), dict(
        x=rng.normal(size=(rows, cfg.seq_len, cfg.enc_in)).astype(np.float32),
        y=(rng.uniform(0.5, 5.0, rows).astype(np.float32) if regression else
           rng.integers(0, cfg.num_class, rows).astype(np.int32)),
        padding_mask=np.ones((rows, cfg.seq_len), np.float32)))()
    head = None
    if regression:
        from sie_tpu_torch.data.monash import make_bin_edges
        from sie_tpu_torch.train.regression import make_crps_head
        head = make_crps_head(make_bin_edges(ds.y))
    trainer = Trainer(cfg, steps_per_epoch=4, device="cuda",
                      generator=torch.Generator().manual_seed(0),
                      loss_head=head)
    dev = trainer.device_data("train", ds)
    w = np.ones((batch,), np.float32)
    idx = lambda: rng.integers(0, rows, batch)
    if args.path == "staged":
        staged = trainer.stage_steps([(idx(), w) for _ in range(4)], 1.0)
        ks = itertools.count()
        step = lambda: trainer.train_step_staged(dev, staged, next(ks) % 4)
    else:
        step = lambda: trainer.train_step_indexed(dev, idx(), w, 1.0)

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    med = float(np.median(times))
    print(f"{args.config} {args.path} train step of {batch} rows, ms: "
          + ", ".join(f"{t:.3f}" for t in times)
          + f"; median {med:.3f} ({1e3 * batch / med:.1f} samples/s)")
    if args.no_profile:
        return

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sie_tpu_torch.utils.profiling import device_busy_ms, idle_share
    steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    print(f"profiled {steps} {args.path} steps: wall {wall:.3f} ms, device "
          f"busy {device_busy_ms(prof):.3f} ms (idle share "
          f"{idle_share(prof, wall):.3f})")
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60))
    kinds: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key:
            k = kernel_kind(e.key)
            kinds[k] = kinds.get(k, 0.0) + e.self_device_time_total / 1e3
    print(f"device ms a step by kind ({steps} steps): " + ", ".join(
        f"{k} {v / steps:.3f}" for k, v in sorted(kinds.items(),
                                                  key=lambda kv: -kv[1])))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.out, f"train_trace_{args.config}_{args.path}.json"))
    from sie_tpu_torch.compat.from_jax import batch_stats_buffers
    if batch_stats_buffers(trainer.model):
        batchnorm_split(trainer, dev, rng.integers(0, rows, batch), args.steps)


def kernel_kind(name: str) -> str:
    """The kind of a CUDA kernel, from its name."""
    low = name.lower()
    if "shapelet" in low or "l1_" in low:
        return "shapelet K1-K4"
    if "attn" in low:
        return "attention K5/K6"
    # cuDNN's convolutions first: some of their names hold "gemm"
    # (implicit_gemm, implicit_convolve_sgemm); then cuBLAS's GEMMs, whose
    # names hold "xmma" too (sm80_xmma_gemm_f32f32...)
    if any(t in low for t in ("conv", "cudnn", "implicit", "fprop", "dgrad",
                              "wgrad", "winograd", "fft")):
        return "convolution"
    if any(t in low for t in ("gemm", "cutlass", "sm90_", "nvjet")):
        return "GEMM"
    if "xmma" in low:
        return "convolution"
    return "other"


def batchnorm_split(trainer, dev, idx, reps: int) -> None:
    """Device ms (torch.profiler, summed kernel time) of the forward and
    backward of the whole model, and of InterpGN's SBM branch and expert,
    each with BatchNorm and with every BatchNorm's forward replaced by the
    identity (no batch statistics), in turns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sie_tpu_torch.models.layers import BatchNorm
    from sie_tpu_torch.train.trainer import weighted_ce
    model = trainer.model.train()
    x, y, mask = (leaf[torch.as_tensor(idx, device="cuda")] for leaf in dev)
    w = torch.ones(len(idx), device="cuda")
    params = list(model.parameters())
    parts = {"full": lambda: model(x, mask, generator=trainer.generator)[0]}
    if hasattr(model, "sbm"):
        parts["sbm"] = lambda: model.sbm(x, mask,
                                         generator=trainer.generator)[0]
        parts["dnn"] = lambda: model.deep_model(x, mask, trainer.generator)

    def device_ms(fn) -> float:
        def once():
            torch.autograd.grad(weighted_ce(fn(), y, w), params,
                                allow_unused=True)
        once()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                once()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "Activity Buffer" not in e.key) / 1e3 / reps

    real = BatchNorm.forward
    times: dict = {}
    for name, fn in parts.items():
        for mode in ("with", "identity"):
            BatchNorm.forward = (real if mode == "with" else
                                 lambda self, h: h.to(self.dtype))
            try:
                times[name, mode] = device_ms(fn)
            finally:
                BatchNorm.forward = real
    print("fwd+bwd device ms, with BatchNorm / with it as the identity: "
          + ", ".join(f"{k} {times[k, 'with']:.3f} / "
                      f"{times[k, 'identity']:.3f}" for k in parts))

if __name__ == "__main__":
    main()
