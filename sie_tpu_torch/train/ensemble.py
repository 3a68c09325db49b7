"""Multi-seed training (counterpart of sie_tpu/train/ensemble.py).

The JAX package trains N seeds of one configuration as one program: a
`vmap` of the train step over a leading seed axis of the state. Here the
state stays per seed: `EnsembleTrainer` composes one `Trainer` per seed,
each built exactly as `Experiment` builds a `--seed i` run's (initial draw
from `torch.Generator().manual_seed(max(seed, 0))`, dropout generator
seed + 17, augmentation generator seed + 17 + 9173), so seed i of the
ensemble is the same experiment as a lone run at seed i, bit for bit (the
JAX package holds its version to a tolerance).

One program for every seed: the body of an ensemble step runs each seed's
`Trainer._device_step` in turn, on that seed's rows, then the `alive`
select below. On the card the body is one CUDA graph (through the
`GraphSteps` machinery that `Trainer` uses), with every seed's generators
registered; on the CPU the same body runs eagerly. Each seed's step
launches the kernels that a lone step launches (K1/K2 per bank, K5/K6 per
layer), unbatched: the port's counterpart of the JAX package's
`sequential_vmap` (ops/shapelet_l1.py and ops/attention.py say why the
seed axis is not folded into a kernel's batch). The card's caching
allocator gives one capture's blocks that seed i has freed to seed i + 1,
so the graph's activations are those of one seed.

Early stopping is the host's decision, as in the JAX package: `alive`
(N,) is a device tensor that the graph reads, so a seed that stops needs
no new capture. After a stopped seed's step its parameters read
old + 0 * (new - old) (the JAX package's `updates * alive`: finite updates
leave them as they were, a non-finite one passes on), and its Adam
moments and counts, the optimizer count, the accumulation mean and its
BatchNorm buffers take their old values (the JAX package's
`where(alive > 0, new, old)`); a live seed keeps the new value exactly.
The host stops counting a stopped seed's optimizer steps and micro-batch
position (optax's frozen `MultiSteps` state), while every seed's step
count advances (the JAX package's `state.step + 1`). The seeds move in
lockstep: one micro-batch position for every seed, baked into the graph.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sie_tpu_torch.compat.from_jax import load_jax_seed_variables
from sie_tpu_torch.config import Config
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.models.info import ModelInfo
from sie_tpu_torch.train.trainer import (GraphSteps, Trainer, _stack_infos,
                                         target_dtype)


class EnsembleStaged(NamedTuple):
    """The seeds' schedules of an epoch on the device: indices (N, n, B)
    int64, weights (N, n, B) f32 and beta (a 0-d f32 tensor)."""
    ia: torch.Tensor
    wa: torch.Tensor
    beta: torch.Tensor


def _start_adam(trainer: Trainer) -> None:
    """Adam's state before its first step (zero moments, step 0), made
    now rather than at the first step, so the alive select has tensors
    to keep from the first step on."""
    opt = trainer.optimizer
    for p in opt.params:
        opt.adam.state[p] = {
            "step": torch.zeros((), dtype=torch.float32, device=p.device),
            "exp_avg": torch.zeros_like(p,
                                        memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(
                p, memory_format=torch.preserve_format)}


def _moved(trainer: Trainer) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(the parameters, the rest of the state) that a train step moves."""
    opt = trainer.optimizer
    adam = [opt.adam.state[p][k] for p in opt.params
            for k in ("exp_avg", "exp_avg_sq", "step")]
    return (list(opt.params), adam + [opt.count_t] + list(opt._acc or [])
            + list(trainer.model.buffers()))


class EnsembleTrainer(GraphSteps):
    """Trains N independently seeded replicas of one model in one program
    (module docstring). `trainers[i]` holds seed i's model, optimizer and
    generators."""

    def __init__(self, cfg: Config, steps_per_epoch: int,
                 seeds: Sequence[int], device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seeds = tuple(int(s) for s in seeds)
        self.n = len(self.seeds)
        self.trainers = [
            Trainer(cfg.replace(seed=s), steps_per_epoch, device=self.device,
                    generator=torch.Generator().manual_seed(max(s, 0)))
            for s in self.seeds]
        for t in self.trainers:
            _start_adam(t)
        self._moved = [_moved(t) for t in self.trainers]
        # the state before a seed's step, one set for all seeds (their
        # shapes are the same), read by the alive select
        params, rest = self._moved[0]
        self._old_p = [torch.empty_like(p) for p in params]
        self._old_r = [torch.empty_like(r) for r in rest]
        self.alive = torch.ones((self.n,), dtype=torch.float32,
                                device=self.device)
        self._alive_host = np.ones((self.n,), np.float32)
        self.step = 0
        self._staged = {}
        self._batches = {}
        self._eval_bufs = {}
        self._idx = {}
        self._k = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._beta_t = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        self._init_graphs()

    def _generators(self) -> List[torch.Generator]:
        return [g for t in self.trainers for g in t._generators()]

    # ---- state ------------------------------------------------------------
    def init_states(self, sample_batch=None, variables=None) -> List[Any]:
        """The seeds' models. They are drawn when the ensemble is built,
        seed i's as a lone `--seed i` run draws them; `sample_batch` (x, y,
        mask, w), the JAX signature's, is checked against the config's
        shape. `variables`, flax {"params", "batch_stats"} stacked on a
        leading seed axis (the JAX EnsembleTrainer's state), replaces them:
        slice i goes into seed i's model."""
        if sample_batch is not None:
            shape = tuple(np.shape(sample_batch[0])[1:])
            if shape != (self.cfg.seq_len, self.cfg.enc_in):
                raise ValueError(f"sample rows of shape {shape}, the config "
                                 f"says {(self.cfg.seq_len, self.cfg.enc_in)}")
        if variables is not None:
            load_jax_seed_variables([t.model for t in self.trainers],
                                    variables)
        return [t.model for t in self.trainers]

    def set_alive(self, alive) -> None:
        """alive (N,): 1 for a seed that trains on, 0 for one that stopped;
        copied to the device only when it changes."""
        alive = np.asarray(alive, np.float32).reshape(self.n)
        if not np.array_equal(alive, self._alive_host):
            self._alive_host = alive.copy()
            self.alive.copy_(torch.from_numpy(self._alive_host))

    # ---- steps ------------------------------------------------------------
    def _device_step(self, batch_of, beta: torch.Tensor, position: int):
        """The device work of one ensemble step: each seed's step on its
        batch `batch_of(i)`, then the alive select -> (losses (N,), logits
        (N, B, C))."""
        losses, logits = [], []
        for i, t in enumerate(self.trainers):
            params, rest = self._moved[i]
            with torch.no_grad():
                torch._foreach_copy_(self._old_p, params)
                torch._foreach_copy_(self._old_r, rest)
            loss, out = t._device_step(batch_of(i), beta, position)
            with torch.no_grad():
                keep = self.alive[i] > 0
                frozen = torch._foreach_sub(params, self._old_p)
                torch._foreach_mul_(frozen, 0.0)
                torch._foreach_add_(frozen, self._old_p)
                for p, f in zip(params, frozen):
                    torch.where(keep, p, f, out=p)
                for r, o in zip(rest, self._old_r):
                    torch.where(keep, r, o, out=r)
            losses.append(loss)
            logits.append(out)
        return torch.stack(losses), torch.stack(logits)

    def _advance(self) -> None:
        for t, a in zip(self.trainers, self._alive_host):
            t.step += 1
            if a > 0:
                t.optimizer.advance()
        self.step += 1

    def _position(self) -> int:
        return self.step % self.trainers[0].optimizer.accum

    def train_step(self, batches, beta: float, alive=None):
        """batches: per-seed stacked (x (N, B, T, C), y (N, B), mask (N, B,
        T), w (N, B)), numpy or tensors; each seed keeps its own rows.
        alive: (N,), default unchanged (all 1 at the start) -> (losses
        (N,), logits (N, B, C)) on the device."""
        if alive is not None:
            self.set_alive(alive)
        x, y, mask, w = batches
        shape = (tuple(np.shape(x)), tuple(np.shape(y)),
                 target_dtype(y))
        if shape not in self._batches:
            self._batches[shape] = tuple(
                torch.empty(s, dtype=d, device=self.device) for s, d in (
                    (shape[0], torch.float32), (shape[1], shape[2]),
                    (np.shape(mask), torch.float32),
                    (np.shape(w), torch.float32)))
        buf = self._batches[shape]
        for b, a in zip(buf, batches):
            b.copy_(torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                    else a))
        self._beta_t.fill_(float(beta))
        position = self._position()
        out = self._run(
            *self._key("train_step", (*buf, self._beta_t, self.alive),
                       position),
            lambda: self._device_step(lambda i: tuple(b[i] for b in buf),
                                      self._beta_t, position))
        self._advance()
        return out

    def device_data(self, tag: str, ds) -> Tuple[torch.Tensor, ...]:
        """(x, y, padding mask) of a dataset held on the device once per
        tag, shared by every seed (`Trainer.device_data`)."""
        return self.trainers[0].device_data(tag, ds)

    def stage_steps(self, schedules, beta: float = 0.0
                    ) -> Optional[EnsembleStaged]:
        """Copies the seeds' schedules of an epoch (a list over seeds of
        (idx (B,), w (B,)) lists of one length, from Batcher.epoch_indices)
        and beta into the buffers of their (N, steps, B) shape; None for an
        empty epoch. A schedule of the same shape reuses the buffers and
        the graphs that read them."""
        if len(schedules) != self.n:
            raise ValueError(f"{len(schedules)} schedules for {self.n} seeds")
        if not schedules[0]:
            return None
        idx = torch.from_numpy(np.stack([np.stack([i for i, _ in s])
                                         for s in schedules]).astype(np.int64))
        w = torch.from_numpy(np.stack([np.stack([v for _, v in s])
                                       for s in schedules]).astype(np.float32))
        shape = tuple(idx.shape)
        if shape not in self._staged:
            self._staged[shape] = EnsembleStaged(
                torch.empty(shape, dtype=torch.int64, device=self.device),
                torch.empty(shape, dtype=torch.float32, device=self.device),
                torch.empty((), dtype=torch.float32, device=self.device))
        buf = self._staged[shape]
        buf.ia.copy_(idx)
        buf.wa.copy_(w)
        buf.beta.fill_(float(beta))
        return buf

    def train_step_staged(self, dev_data, staged: EnsembleStaged, k: int,
                          alive=None):
        """Step `k` of every seed's staged schedule, each on its own rows of
        `dev_data` gathered on the device -> (losses (N,), logits (N, B,
        C)); on the card a replay of one graph for all seeds."""
        if alive is not None:
            self.set_alive(alive)
        self._k.fill_(k)
        position = self._position()

        def batch_of(i):
            idx = staged.ia[i].index_select(0, self._k)[0]
            w = staged.wa[i].index_select(0, self._k)[0]
            return (*(leaf[idx] for leaf in dev_data), w)

        out = self._run(
            *self._key("train_step", (*dev_data, *staged, self._k,
                                      self.alive), position),
            lambda: self._device_step(batch_of, staged.beta, position))
        self._advance()
        return out

    # ---- eval -------------------------------------------------------------
    def _eval_all(self, x, mask, gating_value):
        """Every seed's eval forward of one batch -> (logits (N, B, C), the
        infos stacked on a leading seed axis)."""
        outs = [t._eval_forward(x, mask, gating_value) for t in self.trainers]
        return (torch.stack([o[0] for o in outs]),
                _stack_infos([o[1] for o in outs]))

    def eval_step(self, batch, gating_value: Optional[float] = None
                  ) -> Tuple[torch.Tensor, ModelInfo]:
        """One shared batch (x, y, mask, w) evaluated by every seed in eval
        mode -> (logits (N, B, C), stacked ModelInfo); on the card one
        graph for each gating value and shape."""
        x, _y, mask, _w = batch
        shape = (tuple(np.shape(x)), tuple(np.shape(mask)))
        if shape not in self._eval_bufs:
            self._eval_bufs[shape] = tuple(
                torch.empty(s, dtype=torch.float32, device=self.device)
                for s in shape)
        bx, bm = self._eval_bufs[shape]
        for b, a in ((bx, x), (bm, mask)):
            b.copy_(torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                    else a))
        return self._run(*self._key("eval_step", (bx, bm), gating_value),
                         lambda: self._eval_all(bx, bm, gating_value))

    def eval_step_indexed(self, dev_data, idx, gating_value=None
                          ) -> Tuple[torch.Tensor, ModelInfo]:
        """`eval_step` on rows `idx` of `device_data`, gathered on the
        device; the indices go into a buffer of their batch size."""
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
        b = idx.shape[0]
        if b not in self._idx:
            self._idx[b] = torch.empty((b,), dtype=torch.int64,
                                       device=self.device)
        buf = self._idx[b]
        buf.copy_(idx)

        def body():
            x, _y, mask = (leaf[buf] for leaf in dev_data)
            return self._eval_all(x, mask, gating_value)

        return self._run(*self._key("eval_indexed", (*dev_data, buf),
                                    gating_value), body)


def stack_seed_batches(batcher_steps, data_x, data_y, data_mask):
    """Per-seed (idx, w) schedules -> one stacked batch tuple (N, B, ...)
    for `train_step`. batcher_steps: a list over seeds of (idx, w)."""
    xs, ys, ms, ws = [], [], [], []
    for idx, w in batcher_steps:
        xs.append(data_x[idx])
        ys.append(data_y[idx])
        ms.append(data_mask[idx])
        ws.append(w)
    return (np.stack(xs), np.stack(ys), np.stack(ms),
            np.stack(ws).astype(np.float32))
