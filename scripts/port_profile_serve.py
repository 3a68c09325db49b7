"""Where a served request's time goes in sie_tpu_torch, on one CUDA card.

    python scripts/port_profile_serve.py [--rows 1,5,64] [--repeats 5]
                                         [--no-profile] [--out DIR]

Builds the flagship InterpGN (bench.py's configuration, weights from seed
0) behind `Predictor` on the card (max_batch 64), warms up, then times
`--repeats` requests of each size in `--rows` with the host clock and
prints each size's times and median. Unless `--no-profile`, it then
profiles one request of the largest size with torch.profiler and prints
the device busy time and the ops by device time; `--out` also writes the
Chrome trace there. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

MAX_BATCH = 64

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1,5,64")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import flagship_config
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.serve import Predictor

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = flagship_config()
    pred = Predictor.from_module(
        cfg, build_model(cfg, "cuda", torch.Generator().manual_seed(0)),
        device="cuda", max_batch=MAX_BATCH)
    rng = np.random.default_rng(0)
    sizes = [int(r) for r in args.rows.split(",")]
    xs = {b: rng.normal(size=(b, cfg.seq_len, cfg.enc_in)).astype(np.float32)
          for b in sizes}
    for b in sizes:
        for _ in range(2):
            pred.predict(xs[b])
    for b in sizes:
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            pred.predict(xs[b])
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"request of {b} rows, ms: "
              + ", ".join(f"{t:.3f}" for t in times)
              + f"; median {float(np.median(times)):.3f}")
    if args.no_profile:
        return

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = xs[max(sizes)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(x)
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # kernel and copy rows only: operator rows repeat their kernels' time;
    # "Activity Buffer Request" is the profiler's own buffer, not the model's
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and "Activity Buffer" not in e.key) / 1e3
    print(f"profiled request of {len(x)} rows: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms (idle share {max(0.0, 1 - busy / wall):.3f})")
    print(events.table(sort_by="self_device_time_total", row_limit=30))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "serve_trace.json"))


if __name__ == "__main__":
    main()
