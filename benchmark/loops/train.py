"""Training throughput: replayed steps of `Trainer.train_step_staged`, as
the port's experiment drives them (train/experiment.py), on rows held on
the card.

Traffic parameters: "batch_rows" (a card's rows a step) and "rows" (the
rows held; an epoch is rows / (batch_rows x cards) steps of a
permutation drawn from the seed and the epoch). On several cards the
step runs on a 'data' mesh, one process a card over NCCL (rank 0 starts
the others), each holding every row as the experiment does.

Set-up: weights and rows made on the card from the seed, the model and
its `Trainer`, and epoch 0's schedule staged. Two steps through the
window's own call build the kernels (the first runs eagerly) and capture
the CUDA graph (the second); the seeded state is then put back in place
(parameters, buffers, Adam's moments and counts, the tensors the graph
reads), and the first three steps of epoch 0 run as replays of that
graph, as every step of the window does: the program's loss of each,
the first gradient as Adam holds it (its first moment over 1 - b1), and
the weights after the third step are kept for the comparison.
The window then continues epoch 0 at step 4 and dispatches steps back to
back, at most AHEAD steps ahead of the card, staging each new epoch's
schedule as the experiment does (whose copy waits for the card once an
epoch). It takes no step once `seconds` have passed (on several cards it
closes at an epoch's end, rank 0 deciding for every rank), and ends at
a synchronisation after the last step. After the window the
program's state is freed and the plain reference runs the same three
steps from the same weights on the same rows.
"""

from __future__ import annotations

import collections
import gc
import sys
import time

import numpy as np
import torch

from benchmark import compare
from benchmark.reference import adam
from benchmark.reference.precision import control_of, tf32_matmuls
from benchmark.harness import sync
from benchmark.weights import load_into, make_rows, make_weights

CHECKED_STEPS = 3
WARM_STEPS = 2  # the eager step and the capture, on a state put back after
AHEAD = 2       # steps dispatched ahead of the card in the window
BETA = 1.0      # the SBM loss's weight under the "constant" schedule


def epoch_schedule(seed: int, epoch: int, rows: int, batch: int):
    """The (index, weight) pairs of an epoch, as the port's Batcher
    draws them: a permutation of the rows cut into batches."""
    order = np.random.default_rng((seed, epoch)).permutation(rows)
    w = np.ones((batch,), np.float32)
    return [(order[i * batch:(i + 1) * batch].astype(np.int32), w)
            for i in range(rows // batch)]


def _batches(x, y, mask, schedule, device):
    out = []
    for idx, w in schedule[:CHECKED_STEPS]:
        i = torch.as_tensor(idx, dtype=torch.int64, device=device)
        out.append((x[i], y[i], mask[i], torch.as_tensor(w, device=device)))
    return out


def _reference(run, ref, weights_host, batches, prec):
    params = {n: w.to(run.device) for n, w in weights_host.items()}
    with tf32_matmuls(prec == "tf32"):
        return adam.steps(ref, params, run.cfg, batches, BETA, prec)


def run(run) -> None:
    if run.cfg.get("beta_schedule", "constant") != "constant":
        raise ValueError("the training loop weighs the SBM loss by the "
                         "constant schedule")
    if run.cfg.get("dropout", 0.0):
        raise ValueError("the reference draws no dropout masks")
    dev, cfg, tr = run.device, run.cfg, run.traffic
    batch, rows = tr["batch_rows"] * run.world, tr["rows"]
    if rows // batch < CHECKED_STEPS:
        raise ValueError(f"an epoch needs {CHECKED_STEPS} steps at least")
    ref = run.module("reference")
    run.mark("imports")
    weights = make_weights(cfg, run.seed, dev)
    x, y = make_rows(cfg, rows, run.seed, dev)
    mask = torch.ones(x.shape[:2], device=dev)
    schedule = epoch_schedule(run.seed, 0, rows, batch)
    weights_host = {n: w.cpu() for n, w in weights.items()}
    run.mark("weights and rows")
    if run.control:
        del weights
        batches = _batches(x, y, mask, schedule, dev)
        prog = _reference(run, ref, weights_host, batches,
                          control_of(cfg))
        run.attempted = CHECKED_STEPS
    else:
        prog = _program(run, weights, weights_host, (x, y, mask), schedule)
        if run.rank != 0:
            return
        batches = _batches(x, y, mask, schedule, dev)
    want = _reference(run, ref, weights_host, batches, "f32")
    compared, record = compare.training(prog, want)
    for name, (value, where) in compared.items():
        if name in run.limits:
            run.check(name, value, where)
        else:
            record[name] = (value, where)
    for name, (value, where) in record.items():
        print(f"not compared: {name} {value!r} at {where}", file=sys.stderr)
    run.rec["readings"] = {name: value for name, (value, _) in
                           {**compared, **record}.items()}


def _program(run, weights, before, dev_data, schedule) -> dict:
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.train.trainer import Trainer
    dev, tr = run.device, run.traffic
    batch, rows = tr["batch_rows"] * run.world, tr["rows"]
    per_epoch = rows // batch
    cfg = run.program_config().replace(batch_size=batch)
    mesh = None
    if run.world > 1:
        from sie_tpu_torch.parallel.mesh import make_mesh
        cfg = cfg.replace(mesh_shape=(run.world,), mesh_axes=("data",))
        mesh = make_mesh(cfg)
    model = build_model(cfg, dev)
    load_into(model, weights)
    del weights
    trainer = Trainer(cfg, per_epoch, model=model, device=dev, mesh=mesh)
    staged = trainer.stage_steps(schedule, BETA)
    run.mark("model and trainer")
    start = [t.detach().clone() for t in _moved(trainer)]
    for k in range(WARM_STEPS):
        trainer.train_step_staged(dev_data, staged, k)
        sync(dev)
        run.mark(("eager step (kernel load, warm-up)", "capture")[k])
    _put_back(trainer, start)
    del start
    graphs = len(trainer.captures)
    losses = []
    for k in range(CHECKED_STEPS):
        loss, _ = trainer.train_step_staged(dev_data, staged, k)
        losses.append(loss)
        if k == 0:
            grads = _first_gradients(trainer)
    if len(trainer.captures) != graphs:
        raise RuntimeError("a compared step captured a graph: it is no "
                           "replay of the window's")
    sync(dev)
    run.mark("compared replays")
    after = {n: p.detach().cpu() for n, p in model.named_parameters()}
    prog = {"losses": [float(v) for v in losses], "grads": grads,
            "grad_norms": {n: float(g.norm()) for n, g in grads.items()},
            "change": {n: float((after[n] - before[n]).norm())
                       for n in after}}
    sync(dev)
    run.setup_done()

    run.trace_start()
    t0 = time.perf_counter()
    epoch, k, steps = 0, CHECKED_STEPS, 0
    pending = collections.deque()
    while True:
        if k == per_epoch:
            if run.world > 1 and _closed(run, t0):
                break
            epoch, k = epoch + 1, 0
            staged = run.span("stage_steps", trainer.stage_steps,
                              epoch_schedule(run.seed, epoch, rows, batch),
                              BETA)
        if run.world == 1 and time.perf_counter() - t0 >= run.seconds:
            break
        run.span("train_step_staged", trainer.train_step_staged, dev_data,
                 staged, k)
        k += 1
        steps += 1
        if dev.type == "cuda":
            pending.append(torch.cuda.Event())
            pending[-1].record()
            if len(pending) > AHEAD:
                run.span("wait for the card", pending.popleft().synchronize)
    sync(dev)
    window = time.perf_counter() - t0
    run.trace_stop()
    run.rec.update(window_s=window, steps=steps, rows=steps * batch)
    run.attempted = steps
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if run.world > 1:
        _over_ranks(run)
    del trainer, model, staged
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return prog


def _closed(run, t0) -> bool:
    """Whether a multi-card window has closed at an epoch's end: its
    seconds have passed on rank 0's clock."""
    import torch.distributed as dist
    closed = time.perf_counter() - t0 >= run.seconds
    flag = torch.tensor([float(closed)], device=run.device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _over_ranks(run) -> None:
    """The fullest card's memory peak, and the traced busy and window
    seconds averaged over the cards, on every rank; then the process
    group ends."""
    import torch.distributed as dist
    peak = torch.tensor([float(run.memory_peak_bytes)], device=run.device,
                        dtype=torch.float64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    run.memory_peak_bytes = int(peak.item())
    if run.trace is not None:
        t = torch.tensor([run.trace.busy_s(), run.trace.window_s],
                         device=run.device, dtype=torch.float64)
        dist.all_reduce(t)
        run.rec.update(busy_s=float(t[0]) / run.world,
                       trace_window_s=float(t[1]) / run.world)
    dist.destroy_process_group()


def _moved(trainer) -> list:
    """The tensors a step moves in place: parameters, buffers, the
    optimizer's count and accumulation, then Adam's moments and step
    counts (made at the first step)."""
    opt = trainer.optimizer
    adam = [t for p in opt.params
            for t in opt.adam.state.get(p, {}).values() if torch.is_tensor(t)]
    return (list(trainer.model.parameters()) + list(trainer.model.buffers())
            + [opt.count_t] + list(opt._acc or []) + adam)


def _put_back(trainer, start: list) -> None:
    """The trainer's seeded state before its first step, in place (a
    graph reads these tensors): parameters and buffers as they were, and
    Adam as it starts, its moments and counts nought."""
    opt = trainer.optimizer
    with torch.no_grad():
        moved = _moved(trainer)
        n = len(start)
        for t, s in zip(moved[:n], start):
            t.copy_(s)
        for t in moved[n:]:
            t.zero_()
    opt.count = opt.mini_step = 0
    trainer.step = 0


def _first_gradients(trainer) -> dict:
    """Each leaf's gradient as Adam took it at the first step, on the
    host: its first moment over (1 - b1); nought where Adam holds none."""
    state = trainer.optimizer.adam.state
    return {name: (state[p]["exp_avg"] / (1 - adam.B1)
                   if "exp_avg" in state.get(p, {})
                   else torch.zeros_like(p)).detach().float().cpu()
            for name, p in trainer.model.named_parameters()}
