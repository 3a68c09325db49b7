"""CUDA-event time of the fused-attention forward (K5) at the flagship
shape (BH=512, T=845, dk=64), bf16 and float32, on one CUDA card.

    python scripts/port_profile_attention.py [--tree DIR] [--reps 50] [--rate R]

`--tree` imports `sie_tpu_torch` from another checkout (e.g. the parent
commit unpacked under archive_check/), so that two versions can be timed in
turn within one call on one card. `--rate` times K5 with attention dropout
(a tree that has it). Prints the card's name and power limit and one line
per dtype. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rate", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from sie_tpu_torch.ops.attention import fused_attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    extra = (args.rate, 77) if args.rate else ()
    g = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((512, 845, 64), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        fused_attention(q, k, v, 0.125, *extra)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fused_attention(q, k, v, 0.125, *extra)
        end.record()
        torch.cuda.synchronize()
        print(f"K5 {str(dtype)[6:]} rate {args.rate} tree {args.tree}: "
              f"{start.elapsed_time(end) / args.reps:.4f} ms")


if __name__ == "__main__":
    main()
