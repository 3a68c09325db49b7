"""Training step (counterpart of sie_tpu/train/trainer.py).

One optimizer step is the JAX package's `Trainer._update`: forward in
training mode (dropout on, masks from the trainer's generator), loss =
weighted CE + mean model loss (+ beta * CE of the SBM logits for InterpGN),
backward (through kernels K2 and K6 on the card), then the optimizer of
`make_optimizer` and, under `pos_weight`, the non-negative projection of
the SBM classifier. The model's parameters are the state; the step returns
the loss and logits as device tensors, with no host synchronisation.

The optimizer has optax's semantics, not PyTorch's habits:
- `clip_by_global_norm`: g -> (g / norm) * max_norm when norm >= max_norm
  (`clip_grad_norm_` would divide by norm + 1e-6);
- Adam with b1 0.9, b2 0.999 and eps 1e-8 outside the square root
  (`torch.optim.Adam`, which computes the same update);
- a per-epoch cosine learning rate under `lr_decay` and a linear warm-up;
- `gradient_accumulation_steps` as `optax.MultiSteps`: the micro-batch
  gradients are averaged, clipping and Adam act once per group on the
  average, the schedule counts optimizer steps, and the parameters do not
  move between groups.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.models.layers import not_ported
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.models.sbm import clamp_sbm_weights

_CLAMPED = ("SBM", "LTS", "InterpGN")   # models with an SBM classifier


def compute_beta(epoch: int, max_epoch: int, schedule: str = "cosine") -> float:
    """Weight of the SBM branch's loss in epoch `epoch` of `max_epoch`."""
    if schedule == "cosine":
        return 0.5 * (1 + math.cos(math.pi * epoch / max_epoch))
    if schedule == "linear":
        return 1 - epoch / max_epoch
    return 1.0


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """sum(ce * w) / max(sum(w), 1), ce the softmax cross entropy of f32
    logits against integer labels."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    return (ce * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def make_loss_fn(cfg: Config):
    """loss_fn(model, batch, beta, generator) -> (loss, (logits, info)):
    weighted CE of the logits + the mean model loss (+ beta * weighted CE
    of the SBM logits for InterpGN)."""
    is_interpgn = cfg.model == "InterpGN"

    def loss_fn(model: nn.Module, batch, beta: float,
                generator: Optional[torch.Generator]):
        x, y, mask, w = batch
        logits, info = model(x, mask, generator=generator)
        loss = weighted_ce(logits, y, w)
        if info.loss is not None:
            loss = loss + info.loss.mean()
        if is_interpgn:
            loss = loss + beta * weighted_ce(info.shapelet_preds, y, w)
        return loss, (logits, info)

    return loss_fn


def make_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of optimizer step `count` (from 0). The schedule
    counts optimizer steps: with gradient accumulation an epoch has
    ceil(steps_per_epoch / k) of them."""
    accum = max(cfg.gradient_accumulation_steps, 1)
    per_epoch = max(-(-steps_per_epoch // accum), 1)

    def base(count: int) -> float:
        if not cfg.lr_decay:
            return cfg.lr
        epoch = count // per_epoch
        return cfg.lr * 0.5 * (1 + math.cos(math.pi * epoch / cfg.train_epochs))

    if cfg.lr_warmup_epochs > 0:
        warmup = max(int(cfg.lr_warmup_epochs * per_epoch), 1)
        return lambda count: base(count) * min((count + 1) / warmup, 1.0)
    return base


class Optimizer:
    """Clip-by-global-norm and Adam under gradient accumulation, with
    optax's semantics (module docstring). `step()` consumes the gradients
    that backward left in each parameter's `.grad`."""

    def __init__(self, cfg: Config, steps_per_epoch: int,
                 params: Iterable[nn.Parameter]):
        self.params: List[nn.Parameter] = [p for p in params
                                           if p.requires_grad]
        self.accum = max(cfg.gradient_accumulation_steps, 1)
        self.clip = float(cfg.gradient_clip)
        self.schedule = make_schedule(cfg, steps_per_epoch)
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)
        self.count = 0        # optimizer steps taken
        self.mini_step = 0    # micro-batches in the current group
        self._acc: Optional[List[torch.Tensor]] = None

    def step(self) -> bool:
        """One micro-batch; True when the parameters were updated."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.accum > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            # MultiSteps' running mean: acc + (g - acc) / (n + 1)
            self._acc = [a + (g - a) / (n + 1) for a, g in zip(self._acc,
                                                                grads)]
            self.mini_step += 1
            if self.mini_step < self.accum:
                return False
            grads, self._acc, self.mini_step = self._acc, None, 0
        if self.clip > 0:
            grads = clip_by_global_norm(grads, self.clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1
        return True


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged below max_norm, else each g
    becomes (g / norm) * max_norm; decided on the device, no host sync."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


def make_optimizer(cfg: Config, steps_per_epoch: int,
                   params: Iterable[nn.Parameter]) -> Optimizer:
    return Optimizer(cfg, steps_per_epoch, params)


class Trainer:
    """Owns the model (in training mode on `device`, default the card), its
    optimizer and the dropout generator, seeded from cfg.seed + 17 as the
    JAX package's step rng is; `generator` draws the initial weights when
    the trainer builds the model."""

    def __init__(self, cfg: Config, steps_per_epoch: int,
                 model: Optional[nn.Module] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        if mesh is not None:
            raise not_ported("training on a device mesh")
        if cfg.augment:
            raise not_ported(f"on-device augmentation (augment="
                             f"{cfg.augment!r})")
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = build_model(cfg, self.device, generator)
        self.model = model.to(self.device).train()
        self.optimizer = make_optimizer(cfg, steps_per_epoch,
                                        self.model.parameters())
        self.loss_fn = make_loss_fn(cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 17)
        self.step = 0
        self._dev_data: Dict[str, Tuple[torch.Tensor, ...]] = {}

    # ---- steps ------------------------------------------------------------
    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               dtype=dtype).to(self.device)

    def _device_batch(self, batch):
        x, y, mask, w = batch
        return (self._tensor(x, torch.float32), self._tensor(y, torch.int64),
                self._tensor(mask, torch.float32),
                self._tensor(w, torch.float32))

    def _update(self, batch, beta: float):
        """Loss and gradients, the optimizer step, the pos_weight clamp."""
        cfg = self.cfg
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        loss, (logits, _info) = self.loss_fn(self.model, batch, float(beta),
                                             self.generator)
        loss.backward()
        self.optimizer.step()
        if cfg.pos_weight and cfg.model in _CLAMPED:
            clamp_sbm_weights(self.model)
        self.step += 1
        return loss.detach(), logits.detach()

    def train_step(self, batch, beta: float):
        """batch = (x (B, T, C), y (B,), padding mask (B, T), weights (B,)),
        numpy or tensors -> (loss, logits) on the device."""
        return self._update(self._device_batch(batch), beta)

    def eval_step(self, batch, gating_value: Optional[float] = None):
        """(logits, ModelInfo) in eval mode, without gradients."""
        x, _y, mask, _w = self._device_batch(batch)
        self.model.eval()
        try:
            with torch.no_grad():
                return self.model(x, mask, gating_value=gating_value)
        finally:
            self.model.train()

    # ---- device-resident data ---------------------------------------------
    def device_data(self, tag: str, ds) -> Tuple[torch.Tensor, ...]:
        """(x, y, padding mask) of a dataset with those numpy fields, held
        on the device once per tag; batches are then gathered there."""
        if tag not in self._dev_data:
            self._dev_data[tag] = (self._tensor(ds.x, torch.float32),
                                   self._tensor(ds.y, torch.int64),
                                   self._tensor(ds.padding_mask,
                                                torch.float32))
        return self._dev_data[tag]

    def train_step_indexed(self, dev_data, idx, w, beta: float):
        """A train step on rows `idx` of `device_data`, gathered on the
        device; only idx and w cross from the host."""
        idx = self._tensor(idx, torch.int64)
        x, y, mask = (leaf[idx] for leaf in dev_data)
        return self._update((x, y, mask, self._tensor(w, torch.float32)), beta)

    # ---- not ported --------------------------------------------------------
    def train_step_staged(self, *args, **kwargs):
        raise not_ported("the epoch-staged train step (train_step_staged)")

    def train_epoch_staged(self, *args, **kwargs):
        raise not_ported("the scanned epoch (train_epoch_staged)")

    def eval_epoch_staged_scan(self, *args, **kwargs):
        raise not_ported("the scanned eval pass (eval_epoch_staged_scan)")
