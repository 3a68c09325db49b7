"""Where a training step's time goes in sie_tpu_torch, on one CUDA card.

    python scripts/port_profile_train.py [--config flagship|fused|eigenworms]
        [--path indexed|staged] [--steps 10] [--no-profile] [--out DIR]

Builds the configuration's InterpGN (weights from seed 0) under `Trainer`
on the card: `flagship` is bench.py's (B=64), `fused` the same with
`fuse_short_banks`, `eigenworms` chip_smoke.py's EigenWorms-shaped model
(T=17984, float32, B=8). Holds four batches of random rows on the card.
`--path indexed` (the default) trains through the eager
`train_step_indexed`; `--path staged` stages a schedule of four batches
and trains through `train_step_staged`, whose first call is the eager
warm-up and second the capture of its CUDA graph, which later steps
replay. Warms up with 3 steps, then times `--steps` steps with the host
clock (each ending in a synchronisation) and prints their times and
median.
Unless `--no-profile`, it then profiles two more steps with torch.profiler
and prints the device busy time, the idle share of the profiled window and
the ops by device time; `--out` also writes the Chrome trace there. Exits
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
                    choices=("flagship", "fused", "eigenworms"))
    ap.add_argument("--path", default="indexed", choices=("indexed", "staged"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import long_config, train_config
    from sie_tpu_torch.train.trainer import Trainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = {"flagship": train_config,
           "fused": lambda: train_config(fuse_short_banks=True),
           "eigenworms": long_config}[args.config]()
    batch = cfg.batch_size
    rows = 4 * batch
    rng = np.random.default_rng(0)
    ds = type("Rows", (), dict(
        x=rng.normal(size=(rows, cfg.seq_len, cfg.enc_in)).astype(np.float32),
        y=rng.integers(0, cfg.num_class, rows).astype(np.int32),
        padding_mask=np.ones((rows, cfg.seq_len), np.float32)))()
    trainer = Trainer(cfg, steps_per_epoch=4, device="cuda",
                      generator=torch.Generator().manual_seed(0))
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
    steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # kernel and copy rows only: operator rows repeat their kernels' time;
    # "Activity Buffer Request" is the profiler's own buffer, not the model's
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and "Activity Buffer" not in e.key) / 1e3
    if busy == 0.0:
        raise SystemExit(f"the profiler saw no device time over {steps} "
                         f"{args.path} steps: no idle share")
    print(f"profiled {steps} {args.path} steps: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms (idle share {max(0.0, 1 - busy / wall):.3f})")
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.out, f"train_trace_{args.config}_{args.path}.json"))


if __name__ == "__main__":
    main()
