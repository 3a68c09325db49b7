"""CUDA-event times of the port's kernels at the flagship shapes on one
CUDA card, for A/B runs of two trees in one call:

- `shapelet`: K1 and K2 summed over the six banks (B=64, C=122, T=845,
  n=10, L = 43 ... 676, 'euclidean') and, where the tree has them, K3 and
  K4 (the six banks in one launch);
- `attention`: the fused-attention forward K5 at BH=512, T=845, dk=64, bf16
  and float32 (`--rate` adds attention dropout, in a tree that has it).

    python scripts/port_profile_kernels.py [--tree DIR] [--reps 20]
        [--kernels shapelet,attention] [--rate R]

`--tree` imports `sie_tpu_torch` from another checkout (e.g. the parent
commit unpacked under archive_check/), so that two versions can be timed in
turn within one call on one card. Prints the card's name and power limit
and one line per kernel. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

LENGTHS = (43, 85, 169, 254, 423, 676)   # the flagship's banks at T=845


def shapelet_runs(torch, gen):
    from sie_tpu_torch.ops import shapelet_l1 as ops
    b, c, t, n = 64, 122, 845, 10
    x = torch.randn((b, c, t), generator=gen, device="cuda")
    banks = [torch.randn((n, c, l), generator=gen, device="cuda")
             for l in LENGTHS]
    gs = [torch.randn((b, n, c, t - l + 1), generator=gen, device="cuda")
          for l in LENGTHS]
    runs = {
        "K1 six banks": lambda: [ops.l1_sliding_distance(x, s)
                                 for s in banks],
        "K2 six banks": lambda: [ops.l1_sliding_distance_bwd(x, s, g)
                                 for s, g in zip(banks, gs)],
    }
    if hasattr(ops, "l1_sliding_distance_grouped"):
        runs["K3"] = lambda: ops.l1_sliding_distance_grouped(x, banks)
        runs["K4"] = lambda: ops.l1_sliding_distance_grouped_bwd(x, banks, gs)
    return runs


def attention_runs(torch, gen, rate):
    from sie_tpu_torch.ops.attention import fused_attention
    extra = (rate, 77) if rate else ()
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((512, 845, 64), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        runs[f"K5 {str(dtype)[6:]} rate {rate}"] = \
            lambda q=q, k=k, v=v: fused_attention(q, k, v, 0.125, *extra)
    return runs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--kernels", default="shapelet,attention")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rate", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(1)
    runs = {}
    for group in args.kernels.split(","):
        if group == "shapelet":
            runs.update(shapelet_runs(torch, gen))
        elif group == "attention":
            runs.update(attention_runs(torch, gen, args.rate))
        else:
            raise SystemExit(f"unknown kernel group {group!r}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        print(f"{name} tree {args.tree}: "
              f"{start.elapsed_time(end) / args.reps:.4f} ms")


if __name__ == "__main__":
    main()
