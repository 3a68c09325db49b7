"""The flagship InterpGN trained over a mesh of cards, one process a card
over NCCL:

    python scripts/port_mesh_cards.py --mesh 4 [--mesh_axes data]
        [--timed 10]
    python scripts/port_mesh_cards.py --mesh 2x2 --mesh_axes data,model
    python scripts/port_mesh_cards.py --mesh 2x2 --mesh_axes data,seq \
        --seq_len 844
    python scripts/port_mesh_cards.py --mesh 2x2 --mesh_axes data,expert \
        --moe_experts 8
    python scripts/port_mesh_cards.py --mesh 2x2 --mesh_axes data,pipe

Without the launch variables (parallel/multihost.py) it builds the
kernels, starts one worker a card with the variables set, waits for all
under a deadline, and exits with the first failing worker's code; the
host must have the mesh's cards. `--seq_len` sets T (844 splits over
'seq'; the flagship's 845 does not) and `--moe_experts` gives each
encoder layer chip_smoke.py's Switch-MoE FFN (top 1, capacity factor
1.25, aux weight 0.01) with that many experts. Each worker, on card
(process id):
1. the flagship (chip_smoke.py's `flagship_config`) in f32 at dropout 0,
   a global batch of 64 numpy-seeded rows: 3 staged steps (warm-up,
   capture with its all-reduces, replay) over the mesh; process 0 then
   runs the same steps alone (no mesh) on its card and holds the losses
   to rtol 1e-5, atol 1e-6 (tests/test_torch_port_mesh_dist.py's limits);
2. the flagship as trained (amp, dropout 0.1), 64 rows a 'data' rank:
   warm-up, capture, then `--timed` replays, each timed with the host
   clock around a synchronisation; process 0 then times the lone
   trainer's replays of 64 rows on its card;
3. with a 'pipe' axis: the flagship's encoder (d_model 512, 8 heads,
   d_ff 2048, 2 layers) through parallel/pipeline.py, one layer a stage,
   64 rows a 'data' rank in 4 microbatches, amp: the forward against the
   sequential encoder on the same rows (within 5e-2 x max |out|), then
   `--timed` forward + backward passes of sum(sin(out)), each timed;
   process 0 then times the sequential encoder's on its 64 rows alone.
Process 0 prints the card's name and power limit, the time widths its
backbone's forwards saw in step 1 (a 'seq' rank's block), the losses and
their gap, the medians of the mesh's and the lone replays, and the rows a
second of each. Exits non-zero without the cards. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

B = 64          # the f32 check's global batch; the timed rows a 'data' rank
STEPS = 3       # staged steps of the f32 check
DEADLINE = 900  # seconds the workers have in all


SHAPE = {}      # --seq_len and --moe_experts, set by main


def flagship(**kw):
    from sie_tpu_torch.config import Config
    return Config(model="InterpGN", dnn_type="Transformer", seq_len=845,
                  enc_in=122, num_class=3, num_shapelet=10, d_model=512,
                  d_ff=2048, n_heads=8, e_layers=2, dropout=0.0, amp=True,
                  seed=0, batch_size=B, lr=5e-3, moe_top_k=1,
                  moe_capacity_factor=1.25, moe_aux_weight=0.01
                  ).replace(**SHAPE).replace(**kw)


def rows(cfg, n: int):
    rng = np.random.default_rng(0)
    return type("Rows", (), dict(
        x=rng.normal(size=(n, cfg.seq_len, cfg.enc_in)).astype(np.float32),
        y=rng.integers(0, cfg.num_class, n).astype(np.int32),
        padding_mask=np.ones((n, cfg.seq_len), np.float32)))()


def staged(cfg, ds, b: int, steps: int, mesh):
    """A trainer at the seed-0 weights over `mesh` (None: alone), its
    device data and a staged schedule of `steps` batches of b rows."""
    from sie_tpu_torch.train.trainer import Trainer
    t = Trainer(cfg, steps, device="cuda", mesh=mesh,
                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    sched = [(rng.permutation(len(ds.y))[:b], np.ones(b, np.float32))
             for _ in range(steps)]
    return t, t.device_data("train", ds), t.stage_steps(sched, 1.0)


def replay_ms(t, dev, st, timed: int) -> list:
    """Warm-up and capture, then `timed` replays, each timed."""
    t.train_step_staged(dev, st, 0)
    t.train_step_staged(dev, st, 1)
    out = []
    for k in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_step_staged(dev, st, k % 2)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def worker(shape, axes, timed: int) -> None:
    import torch.distributed as dist
    from sie_tpu_torch.parallel.mesh import Mesh
    from sie_tpu_torch.parallel.multihost import init_distributed
    init_distributed(device="cuda")
    rank = dist.get_rank()
    mesh = Mesh(shape, axes)
    say = print if rank == 0 else (lambda *a, **k: None)
    if rank == 0:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        say(f"[cards] {len(out)} cards: {sorted(set(out))}; mesh "
            f"{mesh.shape}, backend {mesh.backend}; T {SHAPE['seq_len']}, "
            f"{SHAPE['moe_experts']} experts a MoE layer", flush=True)
    from sie_tpu_torch.models import registry
    widths, call_dnn = set(), registry.call_dnn   # the backbone's time axis
    registry.call_dnn = lambda dnn, x, *a: (widths.add(x.shape[1]),
                                            call_dnn(dnn, x, *a))[1]
    cfg = flagship(amp=False)
    ds = rows(cfg, 256)
    t, dev, st = staged(cfg, ds, B, STEPS, mesh)
    got = [float(t.train_step_staged(dev, st, k)[0]) for k in range(STEPS)]
    registry.call_dnn = call_dnn
    say(f"[cards] the backbone's forwards on rank 0 saw T {sorted(widths)}",
        flush=True)
    del t, dev, st
    if rank == 0:
        t, dev, st = staged(cfg, ds, B, STEPS, None)
        want = [float(t.train_step_staged(dev, st, k)[0])
                for k in range(STEPS)]
        del t, dev, st
        ok = np.allclose(got, want, rtol=1e-5, atol=1e-6)
        say(f"[cards] f32 staged steps (warm-up, capture, replay), global "
            f"batch {B}: losses {got} against one card's {want}; max gap "
            f"{max(abs(a - b) for a, b in zip(got, want)):.3e} "
            f"({'within' if ok else 'OUTSIDE'} rtol 1e-5, atol 1e-6)",
            flush=True)
        if not ok:
            raise SystemExit(1)
    dist.barrier()
    cfg = flagship(dropout=0.1)
    dp = mesh.size("data")
    ds = rows(cfg, 256 * dp)
    t, dev, st = staged(cfg.replace(batch_size=B * dp), ds, B * dp, 2, mesh)
    ms = replay_ms(t, dev, st, timed)
    del t, dev, st
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        t, dev, st = staged(cfg, ds, B, 2, None)
        lone = replay_ms(t, dev, st, timed)
        m, lm = float(np.median(ms)), float(np.median(lone))
        say(f"[cards] amp, dropout 0.1, {B} rows a 'data' rank: mesh "
            f"replays " + ", ".join(f"{v:.3f}" for v in ms) + f" ms, "
            f"median {m:.3f} ({B * dp / m * 1e3:.1f} rows/s); one card "
            f"alone {lm:.3f} ms ({B / lm * 1e3:.1f} rows/s); "
            f"{B * dp / m / (B / lm):.3f} x one card's rows a second",
            flush=True)
    dist.barrier()
    if mesh.size("pipe") > 1:
        pipeline(mesh, rank, say, timed)
    dist.barrier()
    dist.destroy_process_group()


def pipeline(mesh, rank: int, say, timed: int) -> None:
    """Step 3 of the module docstring."""
    import torch.distributed as dist
    from sie_tpu_torch.compat.from_jax import load_jax_stage, to_jax_params
    from sie_tpu_torch.parallel.pipeline import (encoder_stage,
                                                 pipelined_encoder_apply)
    cfg = flagship()
    n, dp = mesh.size("pipe"), mesh.size("data")
    full = encoder_stage(cfg, 1, torch.Generator().manual_seed(0),
                         "cuda").eval()
    stage = load_jax_stage(encoder_stage(cfg, n, device="cuda"),
                           to_jax_params(full), mesh.index("pipe"), n)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B * dp, cfg.seq_len, cfg.d_model)).astype(np.float32)).cuda()
    mine = x[mesh.index("data") * B:(mesh.index("data") + 1) * B]
    with torch.no_grad():
        want = full(mine)
        got = pipelined_encoder_apply(cfg, stage, x, mesh, n_microbatches=4,
                                      data_axis="data")
    err = float((got - want).abs().max() / want.abs().max())
    errs = [None] * dist.get_world_size()
    dist.all_gather_object(errs, err)
    xg = x.clone().requires_grad_(True)

    def passes(fn) -> list:
        out = []
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.sin(fn()).sum().backward()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out
    ms = passes(lambda: pipelined_encoder_apply(
        cfg, stage, xg, mesh, n_microbatches=4, data_axis="data"))
    dist.barrier()
    if rank == 0:
        xs = mine.clone().requires_grad_(True)
        lone = passes(lambda: full(xs))
        m, lm = float(np.median(ms)), float(np.median(lone))
        ok = max(errs) <= 5e-2
        say(f"[cards] pipeline, amp, {B} rows a 'data' rank, 4 "
            f"microbatches, {n} stages: forward within "
            + ", ".join(f"{e:.3e}" for e in errs) + f" (ranks; x max|out|) "
            f"of the sequential encoder ({'within' if ok else 'OUTSIDE'} "
            f"5e-2); forward + backward ms " + ", ".join(
                f"{v:.2f}" for v in ms) + f", median {m:.3f} "
            f"({B * dp / m * 1e3:.1f} rows/s); the sequential encoder "
            f"alone {lm:.3f} ms ({B / lm * 1e3:.1f} rows/s)", flush=True)
        if not ok:
            raise SystemExit(1)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="4")
    p.add_argument("--mesh_axes", default="data,model")
    p.add_argument("--timed", type=int, default=10)
    p.add_argument("--seq_len", type=int, default=845)
    p.add_argument("--moe_experts", type=int, default=0)
    args = p.parse_args()
    SHAPE.update(seq_len=args.seq_len, moe_experts=args.moe_experts)
    shape = tuple(int(s) for s in args.mesh.split("x"))
    axes = tuple(a.strip() for a in args.mesh_axes.split(","))
    if os.environ.get("SIE_TPU_COORDINATOR"):
        worker(shape, axes, args.timed)
        return
    from sie_tpu_torch.ops import build
    from sie_tpu_torch.parallel.multihost import free_port
    n = int(np.prod(shape))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise SystemExit(f"mesh {shape} needs {n} cards, have {have}")
    build.build()   # once, before the workers load the kernels
    env = {**os.environ, "SIE_TPU_COORDINATOR": f"localhost:{free_port()}",
           "SIE_TPU_NUM_PROCESSES": str(n), "SIE_TPU_BACKEND": "nccl"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               *sys.argv[1:]],
                              env={**env, "SIE_TPU_PROCESS_ID": str(i)})
             for i in range(n)]
    end = time.time() + DEADLINE
    try:
        while time.time() < end:
            codes = [q.poll() for q in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            time.sleep(0.5)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    codes = [q.returncode for q in procs]
    print(f"[cards] worker exit codes {codes}", flush=True)
    if any(codes):
        raise SystemExit(next(c for c in codes if c) or 1)


if __name__ == "__main__":
    main()
