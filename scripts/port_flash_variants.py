"""K9's design choices side by side on one CUDA card: the flash-attention
forward (sie_tpu_torch/csrc/flash_fwd.cu) as the package builds it, and
the same source built with -DFLASH_FWD_VARIANTS, whose entry
`flash_fwd_variant` runs the other choices:

- `serial, 1 block`: a consumer waits for each product in turn (S, the
  softmax, P V) and one block runs on an SM, at every dk: the design's
  warp specialisation, TMA ring, one score pass and 128-row blocks alone;
- `overlap`: tile j + 1's S = Q K^T issued before tile j's P V (the
  package takes it at dk 128);
- `2 blocks`: at dk 64 two blocks an SM, consumers at 104 registers (the
  package takes it at dk 64, without the overlap).

    python scripts/port_flash_variants.py [--reps 20]

Each variant's output and row log-sum-exp must equal the package's K9 bit
for bit (the same arithmetic in the same order) at every shape of
chip_smoke.py's FLASH_SHAPES, where each is then timed with CUDA events,
in turns (variants in order, then in reverse). Prints the card's name
and power limit, ptxas's registers and spills of each variant, and one
line per shape and variant. Exits non-zero without a card or on a
mismatch.
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

# (name, overlap, two blocks an SM, the dk it applies to or None for all)
VARIANTS = (("serial, 1 block", 0, 0, None), ("overlap, 1 block", 1, 0, None),
            ("serial, 2 blocks", 0, 1, 64), ("overlap, 2 blocks", 1, 1, 64))


def build_variants():
    """nvcc of csrc/flash_fwd.cu with the variant entry into the package's
    build directory; returns (library, ptxas report)."""
    from sie_tpu_torch.ops import build
    src = os.path.join(build.CSRC, "flash_fwd.cu")
    flags = (*build.FLAGS, "-DFLASH_FWD_VARIANTS")
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in ["flash_fwd.cu", "attention_common.cuh"]:
        with open(os.path.join(build.CSRC, f), "rb") as fh:
            digest.update(fh.read())
    os.makedirs(build.BUILD, exist_ok=True)
    path = os.path.join(build.BUILD, f"libflash_fwd_variants-"
                                     f"{digest.hexdigest()[:12]}.so")
    out = subprocess.run([build._nvcc(), *flags, "-o", path, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_variant.argtypes = [p, p, p, p, p, i, i, i, f, p, i, i]
    lib.flash_fwd_variant.restype = i
    return lib, out.stdout + out.stderr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from sie_tpu_torch.ops import build
    from sie_tpu_torch.ops.flash import flash_fwd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    lib, log = build_variants()
    for name, regs, stores, loads in chip_smoke.ptxas_entries(log):
        print(f"ptxas {name}: {regs} registers, spill stores {stores} B, "
              f"loads {loads} B")

    def variant(q, k, v, over, two):
        bh, t, dk = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
        build.check(lib.flash_fwd_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, t, dk, 1.0 / dk ** 0.5,
            torch.cuda.current_stream().cuda_stream, over, two),
            "flash_fwd_variant")
        return o, lse

    gen = torch.Generator(device="cuda").manual_seed(3)
    bad = 0
    for tag, bh, t, dk in chip_smoke.FLASH_SHAPES:
        q, k, v = (torch.randn((bh, t, dk), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        runs = {"package": lambda: flash_fwd(q, k, v, 1.0 / dk ** 0.5,
                                             want_lse=True)}
        for name, over, two, only in VARIANTS:
            if only in (None, dk):
                runs[name] = (lambda o=over, w=two: variant(q, k, v, o, w))
        o, lse = runs["package"]()
        for name, fn in runs.items():
            o2, lse2 = fn()
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                print(f"{tag}: {name} differs from the package's K9")
                bad += 1
        reps = max(1, args.reps // 5) if t > 4096 else args.reps
        times = {n: [] for n in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(chip_smoke.events_ms(runs[name], reps=reps))
        for name, ms in times.items():
            print(f"K9 {tag} ({bh}x{t}x{dk}) {name}: "
                  + " / ".join(f"{x:.4f}" for x in ms) + " ms")
        del q, k, v, o, lse
    if bad:
        raise SystemExit(f"{bad} variants differ from the package's K9")


if __name__ == "__main__":
    main()
