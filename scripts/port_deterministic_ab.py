"""What deterministic cuDNN convolutions cost a training step, on one CUDA
card.

    python scripts/port_deterministic_ab.py [--config uea_fcn|eegcnn]
        [--steps 10]

The port sets `torch.backends.cudnn.deterministic` (sie_tpu_torch/device.py)
so that a train step, eager or replayed as a CUDA graph, repeats bit for
bit. This script builds two trainers of chip_smoke.py's configuration
(weights from seed 0, four batches of random rows held on the card), one
capturing its staged step with the switch on and one with it off, then
times `--steps` graph replays and `--steps` eager steps of each in turns
(on, off, off, on; host clock around work that ends in a synchronisation)
and prints the medians beside the card's name and power limit. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="uea_fcn", choices=("uea_fcn",
                                                            "eegcnn"))
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import eegcnn_config, random_rows, uea_config
    from sie_tpu_torch.train.trainer import Trainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = uea_config("FCN") if args.config == "uea_fcn" else eegcnn_config()
    b = cfg.batch_size
    ds = random_rows(cfg, 4 * b)
    rng = np.random.default_rng(3)
    sched = [(rng.permutation(4 * b)[:b], np.ones(b, np.float32))
             for _ in range(4)]

    def build(deterministic: bool):
        t = Trainer(cfg, 4, device="cuda",
                    generator=torch.Generator().manual_seed(0))
        torch.backends.cudnn.deterministic = deterministic
        dev = t.device_data("train", ds)
        staged = t.stage_steps(sched, 1.0)
        for k in range(3):   # warm-up, capture, a replay
            t.train_step_staged(dev, staged, k)
        return t, dev, staged

    trainers = {d: build(d) for d in (True, False)}

    def median_ms(deterministic: bool, path: str) -> float:
        torch.backends.cudnn.deterministic = deterministic
        t, dev, staged = trainers[deterministic]
        times = []
        for i in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if path == "graph":
                t.train_step_staged(dev, staged, i % 4)
            else:
                t.train_step_indexed(dev, *sched[i % 4], 1.0)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    for path in ("graph", "eager"):
        res = [(d, median_ms(d, path)) for d in (True, False, False, True)]
        print(f"{args.config} {path} step median ms (B={b}), "
              f"cudnn.deterministic on/off/off/on: "
              + ", ".join(f"{m:.3f}" for _, m in res))


if __name__ == "__main__":
    main()
