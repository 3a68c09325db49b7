"""CUDA-event times of the port's kernels at the flagship shapes on one
CUDA card, for A/B runs of two trees in one call:

- `shapelet`: K1 and K2 at each of the six banks and summed over them
  (B=64, C=122, T=845, n=10, L = 43 ... 676, 'euclidean') and, where the
  tree has them, K3 and K4 (the six banks in one launch); `--sass` also
  prints, for each instantiation of the tree's shapelet kernels, ptxas's
  registers and spills and the FP32, ALU and LDS instructions of its
  innermost busy loop (`chip_smoke.sass_inner_loops`);
- `attention`: the fused-attention forward K5 (with the row log-sum-exp, as
  training runs it) and its backward K6 (from that forward's output) at
  BH=512, T=845, dk=64 (`--rate` adds attention dropout, in a tree that
  has it); with `--long`, at the EigenWorms-shaped model's BH=64, T=17984,
  dk=64 (K7, and K8a + K8b in K6). `--dtypes` picks bf16, float32 or both
  (default: both at the flagship shape, float32 with `--long`);
- `flash`: the flash kernels of `use_flash_attention`, bf16: K9 (with the
  row log-sum-exp, as training runs it), K10b (di and dK, dV) and K10a
  (dQ) from its outputs, at the same shapes (`--long` as above).

    python scripts/port_profile_kernels.py [--tree DIR] [--reps 20]
        [--kernels shapelet,attention,flash] [--rate R] [--long]
        [--dtypes bfloat16,float32] [--sass]

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
    runs = {}
    for l, s, g in zip(LENGTHS, banks, gs):
        runs[f"K1 L={l}"] = lambda s=s: ops.l1_sliding_distance(x, s)
        runs[f"K2 L={l}"] = lambda s=s, g=g: ops.l1_sliding_distance_bwd(
            x, s, g)
    runs["K1 six banks"] = lambda: [ops.l1_sliding_distance(x, s)
                                    for s in banks]
    runs["K2 six banks"] = lambda: [ops.l1_sliding_distance_bwd(x, s, g)
                                    for s, g in zip(banks, gs)]
    if hasattr(ops, "l1_sliding_distance_grouped"):
        runs["K3"] = lambda: ops.l1_sliding_distance_grouped(x, banks)
        runs["K4"] = lambda: ops.l1_sliding_distance_grouped_bwd(x, banks, gs)
    return runs


def attention_runs(torch, gen, rate, long, dtypes):
    from sie_tpu_torch.ops.attention import attention_bwd, attention_fwd
    extra = (rate, 77) if rate else ()
    shape = (64, 17984, 64) if long else (512, 845, 64)
    if dtypes is None:
        dtypes = ("float32",) if long else ("bfloat16", "float32")
    dtypes = [getattr(torch, d) for d in dtypes]
    runs = {}
    for dtype in dtypes:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        o, lse = attention_fwd(q, k, v, 0.125, *extra, want_lse=True)
        tag = f"{str(dtype)[6:]} {'x'.join(map(str, shape))} rate {rate}"
        runs[f"K5 {tag}"] = lambda q=q, k=k, v=v: attention_fwd(
            q, k, v, 0.125, *extra, want_lse=True)
        runs[f"K6 {tag}"] = lambda q=q, k=k, v=v, do=do, o=o, lse=lse: \
            attention_bwd(q, k, v, o, do, lse, 0.125, *extra)
    return runs


def flash_runs(torch, gen, long):
    from sie_tpu_torch.ops.flash import (flash_attention_bwd_dkv,
                                         flash_attention_bwd_dq, flash_fwd)
    shape = (64, 17984, 64) if long else (512, 845, 64)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = flash_fwd(q, k, v, 0.125, want_lse=True)
    _, _, delta = flash_attention_bwd_dkv(q, k, v, o, do, lse, 0.125)
    tag = "x".join(map(str, shape))
    return {f"K9 {tag}": lambda: flash_fwd(q, k, v, 0.125, want_lse=True),
            f"K10b {tag}": lambda: flash_attention_bwd_dkv(
                q, k, v, o, do, lse, 0.125),
            f"K10a {tag}": lambda: flash_attention_bwd_dq(
                q, k, v, do, lse, delta, 0.125)}


def print_sass(tree: str) -> None:
    """ptxas's registers and spills and the inner loop's instruction mix of
    every instantiation of the tree's shapelet kernels."""
    import chip_smoke
    from sie_tpu_torch.ops import build
    names = [n for n in build.SIGNATURES if n.startswith("shapelet")]
    for src in names:
        loops = chip_smoke.sass_inner_loops(build._lib_path(src))
        regs = {k: v for k, *v in chip_smoke.ptxas_entries(
            build.PTXAS_LOG.get(src, ""))}
        for name in sorted(set(loops) | set(regs)):
            fp32, alu, lds, total = loops.get(name, ("?",) * 4)
            r = regs.get(name, ("?", "?", "?"))
            print(f"sass {src} {name} tree {tree}: registers {r[0]}, spill "
                  f"stores {r[1]} B, loads {r[2]} B; inner loop FP32 {fp32}, "
                  f"ALU {alu}, LDS {lds}, all {total}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--kernels", default="shapelet,attention")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rate", type=float, default=0.0)
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--dtypes", type=lambda v: v.split(","), default=None)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    # chip_smoke (its SASS parser) from this script's own checkout
    sys.path.insert(1, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from sie_tpu_torch.ops import build
    groups = {"shapelet": "shapelet", "attention": "attention",
              "flash": "attention"}   # the flash kernels' sources
    build.build([n for n in build.SIGNATURES if any(
        n.startswith(groups.get(k, k)) for k in args.kernels.split(","))])
    if args.sass:
        print_sass(args.tree)
    gen = torch.Generator(device="cuda").manual_seed(1)
    runs = {}
    for group in args.kernels.split(","):
        if group == "shapelet":
            runs.update(shapelet_runs(torch, gen))
        elif group == "attention":
            runs.update(attention_runs(torch, gen, args.rate, args.long,
                                        args.dtypes))
        elif group == "flash":
            runs.update(flash_runs(torch, gen, args.long))
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
