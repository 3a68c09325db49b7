"""Multi-seed experiment driver over EnsembleTrainer (counterpart of
sie_tpu/train/ensemble_driver.py).

Runs the reference's primary workflow, N seeds of one configuration
(reference run.py:564-625), as one training program (train/ensemble.py)
instead of N sequential runs: per-seed shuffles (`Batcher(seed=s)`, the
JAX package's orders), per-seed early stopping (the alive mask), per-seed
best-variable snapshots, and one test pass at `cfg.gating_value` over
every seed's best variables. The splits are held on the device once; each
epoch stages every seed's (index, weight) schedule there, so a step sends
nothing from the host but the step index (on the card a graph replay).

`scripts/port_uea_ensemble_sweep.py` wraps this over dataset lists; the
sequential `python -m sie_tpu_torch.run` stays the default, because its
skip-train-if-checkpoint and per-seed artifacts are per seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from sie_tpu_torch.compat.from_jax import (load_jax_variables,
                                           to_jax_variables)
from sie_tpu_torch.config import DEFAULT_SEEDS, Config
from sie_tpu_torch.data.loader import Batcher
from sie_tpu_torch.data.provider import data_provider
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.train.ensemble import EnsembleTrainer
from sie_tpu_torch.train.trainer import compute_beta
from sie_tpu_torch.utils.tools import EarlyStopping


def _eval_accuracy(et: EnsembleTrainer, dev_data, ds, batch_size: int,
                   gating_value=None) -> np.ndarray:
    """Weighted accuracy per seed over a whole split: (N,) in [0, 1]."""
    loader = Batcher(ds, batch_size, shuffle=False)
    y_all = np.asarray(ds.y)
    correct = np.zeros((et.n,), np.float64)
    total = 0.0
    for idx, w in loader.epoch_indices(0):
        logits, _ = et.eval_step_indexed(dev_data, idx, gating_value)
        pred = np.argmax(logits.float().cpu().numpy(), -1)     # (N, B)
        correct += ((pred == y_all[idx][None]) * w[None]).sum(axis=1)
        total += w.sum()
    return (correct / max(total, 1.0)).astype(np.float64)


def run_ensemble_experiment(cfg: Config,
                            seeds: Sequence[int] = DEFAULT_SEEDS,
                            verbose: bool = True, device: DeviceLike = None,
                            init_variables: Optional[Mapping[str, Any]] = None
                            ) -> List[Dict]:
    """Train, validate and test every seed in one program. Returns one dict
    per seed: {seed, accuracy, val_accuracy, epoch_stop}. init_variables:
    flax variables stacked on a leading seed axis, in place of the seeds'
    own initial draws (`EnsembleTrainer.init_states`)."""
    device = resolve_device(device)   # without a card, before any data
    train_data, _ = data_provider(cfg, "train")
    val_data, _ = data_provider(cfg, "val")
    test_data, _ = data_provider(cfg, "test")
    cfg = cfg.replace(seq_len=train_data.seq_len, enc_in=train_data.enc_in,
                      num_class=train_data.num_class, pred_len=0,
                      label_len=0)
    seeds = tuple(int(s) for s in seeds)
    n = len(seeds)
    loaders = [Batcher(train_data, cfg.batch_size, shuffle=True, seed=s)
               for s in seeds]
    steps_per_epoch = max(len(loaders[0]), 1)
    et = EnsembleTrainer(cfg, steps_per_epoch, seeds, device=device)
    et.init_states(next(iter(loaders[0].epoch(0))), init_variables)
    dev = {split: et.device_data(split, ds) for split, ds in
           (("train", train_data), ("val", val_data), ("test", test_data))}

    # per-seed EarlyStopping, the class the sequential Experiment uses, so
    # ties and patience behave as in a lone run
    earlies = [EarlyStopping(patience=cfg.patience) for _ in seeds]
    alive = np.ones((n,), np.float32)
    best_val = np.full((n,), -np.inf)
    last_val = np.full((n,), np.nan)   # NaN: no validation epoch ran
    epoch_stop = np.zeros((n,), np.int64)
    best: List[Optional[Dict]] = [None] * n

    def _snapshot(i):
        # to_jax_variables copies: Adam goes on moving the live tensors
        best[i] = to_jax_variables(et.trainers[i].model)

    for epoch in range(cfg.train_epochs):
        beta = compute_beta(epoch, cfg.train_epochs, cfg.beta_schedule)
        staged = et.stage_steps([list(ld.epoch_indices(epoch))
                                 for ld in loaders], beta)
        losses = [et.train_step_staged(dev["train"], staged, k, alive)[0]
                  for k in range(steps_per_epoch)]
        val_acc = _eval_accuracy(et, dev["val"], val_data, cfg.batch_size)
        last_val = val_acc
        if verbose and (epoch + 1) % cfg.log_interval == 0:
            tl = torch.stack(losses).float().mean(0).cpu().numpy()
            print(f"Epoch {epoch + 1}/{cfg.train_epochs} | "
                  f"alive {int(alive.sum())}/{n} | "
                  f"train {np.round(tl, 4).tolist()} | "
                  f"val acc {np.round(val_acc, 4).tolist()}", flush=True)
        if epoch >= cfg.min_epochs:
            for i in range(n):
                if alive[i] == 0.0:
                    continue
                if earlies[i](-val_acc[i]):
                    best_val[i] = val_acc[i]
                    _snapshot(i)
                if earlies[i].early_stop:
                    alive[i] = 0.0
                    epoch_stop[i] = epoch
        epoch_stop[alive > 0] = epoch
        if not alive.any():
            if verbose:
                print(f"all seeds early-stopped by epoch {epoch + 1}",
                      flush=True)
            break

    # seeds that never improved past min_epochs: the final variables
    for i in range(n):
        if best[i] is None:
            _snapshot(i)
        load_jax_variables(et.trainers[i].model, best[i])
    # one test pass over every seed's best variables, gated as the
    # reference gates at test time
    test_acc = _eval_accuracy(et, dev["test"], test_data, cfg.batch_size,
                              gating_value=cfg.gating_value)

    # a seed that never improved reports its last validation accuracy,
    # never the test metric
    return [{"seed": seeds[i],
             "accuracy": 100.0 * float(test_acc[i]),
             "val_accuracy": 100.0 * float(best_val[i])
             if np.isfinite(best_val[i]) else 100.0 * float(last_val[i]),
             "epoch_stop": int(epoch_stop[i])}
            for i in range(n)]
