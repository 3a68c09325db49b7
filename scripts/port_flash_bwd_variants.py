"""K10b's and K10a's design choices side by side on one CUDA card: the
flash-attention backward (sie_tpu_torch/csrc/flash_bwd.cu) as the package
builds it, and the same source built with -DFLASH_BWD_VARIANTS=1 (K10b's
entry `flash_bwd_dkv_variant`) and =2 (K10a's `flash_bwd_dq_variant`),
two nvcc runs started together, which run the other choices:

- the ring's depth: K10b's stages of Q and dO, K10a's one-tile K/V slots;
- the consumer warpgroups a block at dk 64: K10b two or three (384 or
  512 threads, consumers at 240 or 160 registers), K10a two, three or
  four (640 threads, consumers at 112 registers);
- K10a at dk 64: each 64-key tile whole or in two halves of 32 keys, and
  one block an SM or two (two consumers at 104 registers).

    python scripts/port_flash_bwd_variants.py [--reps 20] [--kernels K10a]
        [--shape BH,T,DK ...]

Each variant's outputs (dK, dV and di; dQ) must equal the package's K10b
and K10a bit for bit, since every variant sums in the same order, at
every shape of chip_smoke.py's FLASH_SHAPES and each `--shape`, where
each is then timed with CUDA events in four turns (variants in order, in
reverse, and again; at T above 4096 with half the repetitions). Prints
the card's name and power limit, ptxas's registers and spills of each
variant and its performance advisories (serialised wgmma), and one line
per shape and variant. Exits non-zero without a card or on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (ring depth, consumer warpgroups) by dk: the combinations the variant
# entries take (csrc/flash_bwd.cu, FLASH_BWD_CASE)
DKV = {64: ((4, 2), (4, 3), (2, 3)), 128: ((4, 2), (2, 2)),
       256: ((2, 2), (1, 2))}
# K10a: (ring, consumers, blocks an SM, half key tiles)
DQ = {64: ((8, 2, 1, 0), (8, 3, 1, 0), (4, 3, 1, 0), (8, 3, 1, 1),
           (8, 2, 2, 1), (8, 4, 1, 1)),
      128: ((8, 2, 1, 0), (4, 2, 1, 0)), 256: ((3, 2, 1, 0), (2, 2, 1, 0))}


def label(kernel: str, ring: int, ncons: int, blocks: int = 1,
          half: int = 0) -> str:
    depth = "stages" if kernel == "K10b" else "slots"
    return (f"{ring} {depth}, {ncons} consumers"
            + (f", {blocks} blocks" if blocks > 1 else "")
            + (", half tiles" if half else ""))


def build_variants():
    """nvcc of csrc/flash_bwd.cu with each variant entry into the package's
    build directory, both at once; returns (dkv library, dq library, ptxas
    report)."""
    from sie_tpu_torch.ops import build
    src = os.path.join(build.CSRC, "flash_bwd.cu")
    os.makedirs(build.BUILD, exist_ok=True)
    jobs = []
    for which in (1, 2):
        flags = (*build.FLAGS, f"-DFLASH_BWD_VARIANTS={which}")
        digest = hashlib.sha256(" ".join(flags).encode())
        for f in ["flash_bwd.cu", "attention_common.cuh"]:
            with open(os.path.join(build.CSRC, f), "rb") as fh:
                digest.update(fh.read())
        path = os.path.join(build.BUILD, f"libflash_bwd_variants{which}-"
                                         f"{digest.hexdigest()[:12]}.so")
        jobs.append((path, subprocess.Popen(
            [build._nvcc(), *flags, "-o", path, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    log = ""
    for path, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{out}")
        log += out
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dkv, dq = (ctypes.CDLL(path) for path, _ in jobs)
    dkv.flash_bwd_dkv_variant.argtypes = [p] * 9 + [i, i, i, f, p] + [i] * 2
    dq.flash_bwd_dq_variant.argtypes = [p] * 7 + [i, i, i, f, p] + [i] * 4
    dkv.flash_bwd_dkv_variant.restype = dq.flash_bwd_dq_variant.restype = i
    return dkv, dq, log


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="K10b,K10a",
                    help="the kernels whose variants run")
    ap.add_argument("--shape", action="append", default=[],
                    help="BH,T,DK: another shape to run, after FLASH_SHAPES")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from sie_tpu_torch.ops import build
    from sie_tpu_torch.ops.flash import (flash_attention_bwd_dkv,
                                         flash_attention_bwd_dq, flash_fwd)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libdkv, libdq, log = build_variants()
    for name, regs, stores, loads in chip_smoke.ptxas_entries(log):
        print(f"ptxas {name}: {regs} registers, spill stores {stores} B, "
              f"loads {loads} B")
    for line in log.splitlines():
        if "arning" in line or "Performance Loss" in line:
            print(f"ptxas: {line.strip()}")
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def dkv_variant(q, k, v, o, do, lse, scale, choice):
        bh, t, dk = q.shape
        gk, gv = torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((bh, t), dtype=torch.float32, device=q.device)
        build.check(libdkv.flash_bwd_dkv_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), gk.data_ptr(),
            gv.data_ptr(), bh, t, dk, scale, stream(), *choice),
            "flash_bwd_dkv_variant")
        return gk, gv, delta

    def dq_variant(q, k, v, do, lse, delta, scale, choice):
        bh, t, dk = q.shape
        gq = torch.empty_like(q)
        build.check(libdq.flash_bwd_dq_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), gq.data_ptr(), bh, t, dk,
            scale, stream(), *choice), "flash_bwd_dq_variant")
        return (gq,)

    gen = torch.Generator(device="cuda").manual_seed(3)
    bad = 0
    extra = [(f"T {t}", bh, t, dk) for bh, t, dk in (
        map(int, v.split(",")) for v in args.shape)]
    for tag, bh, t, dk in (*chip_smoke.FLASH_SHAPES, *extra):
        q, k, v, do = (torch.randn((bh, t, dk), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        scale = 1.0 / dk ** 0.5
        o, lse = flash_fwd(q, k, v, scale, want_lse=True)
        delta = flash_attention_bwd_dkv(q, k, v, o, do, lse, scale)[2]
        groups = {
            "K10b": ({"package": lambda: flash_attention_bwd_dkv(
                q, k, v, o, do, lse, scale)}, DKV[dk], lambda c: (
                    lambda: dkv_variant(q, k, v, o, do, lse, scale, c))),
            "K10a": ({"package": lambda: (flash_attention_bwd_dq(
                q, k, v, do, lse, delta, scale),)}, DQ[dk], lambda c: (
                    lambda: dq_variant(q, k, v, do, lse, delta, scale, c)))}
        for kernel in args.kernels.split(","):
            runs, choices, make = groups[kernel]
            for c in choices:
                runs[label(kernel, *c)] = make(c)
            want = runs["package"]()
            for name, fn in runs.items():
                if not all(torch.equal(a, b) for a, b in zip(want, fn())):
                    print(f"{kernel} {tag}: {name} differs from the package's")
                    bad += 1
            reps = max(5, args.reps // 2) if t > 4096 else args.reps
            times = {n: [] for n in runs}
            for name in 2 * (list(runs) + list(runs)[::-1]):
                times[name].append(chip_smoke.events_ms(runs[name], reps=reps))
            for name, ms in times.items():
                print(f"{kernel} {tag} ({bh}x{t}x{dk}) {name}: "
                      + " / ".join(f"{x:.4f}" for x in ms) + " ms")
            del want
        del q, k, v, do, o, lse, delta
    if bad:
        raise SystemExit(f"{bad} variants differ from the package's kernels")


if __name__ == "__main__":
    main()
