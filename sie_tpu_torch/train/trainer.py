"""Training and evaluation steps (counterpart of sie_tpu/train/trainer.py).

One optimizer step is the JAX package's `Trainer._update`: under
`cfg.augment` the batch augmented on the device (`data/augment.py`, draws
from the trainer's augmentation generator), forward in training mode
(dropout on, masks from the trainer's generator), loss = the loss head
(weighted CE, or the regression's CRPS) + mean model loss (+ beta * the
head of the SBM logits for InterpGN; targets keep the split's type, int64
labels or f32 regression targets), backward (through kernels K2 and K6
on the card), then the optimizer of
`make_optimizer` and, under `pos_weight`, the non-negative projection of
the SBM classifier. The model's parameters are the state; the step returns
the loss and logits as device tensors, with no host synchronisation.
BatchNorm's running statistics (the JAX package's `batch_stats`) are
buffers, not parameters: each train step's forward moves them once, in
place, as `new_stats` replaces them in the JAX package (every micro-step
under accumulation too); the eval paths read them and move nothing; they
are outside Adam and the global-norm clip.

The epoch-staged paths (`stage_steps`, `train_step_staged`,
`train_epoch_staged`, `eval_step_staged`, `eval_step_indexed`,
`eval_epoch_staged_scan`) are, in the JAX package, one jitted program per
step or one `lax.scan` program per epoch. Here each is a CUDA graph on the
card: the first call of a (path, shapes, buffers) key runs eagerly on the
trainer's graph stream (the warm-up, which builds the kernels and lets
cuBLAS and the optimizer allocate their state outside any graph), the
second captures the same work and replays it, and later calls replay. The
graph reads its batch from static buffers that the trainer owns (and the
model's parameters and BatchNorm buffers, whose in-place updates it
captures, so a replay moves them as the eager step does):
`stage_steps` copies an epoch's (index, weight) schedule and beta into the
buffers of its (steps, batch) shape, and a step index goes to the card as a
device scalar. The dropout generator, and the augmentation generator under
augment, are registered with every graph, so a replay draws the masks and
augmentations that the eager step would. A capture that fails
raises; nothing falls back to the eager step. On a CPU tensor each of these
methods runs the same work eagerly.

The optimizer has optax's semantics, not PyTorch's habits:
- `clip_by_global_norm`: g -> (g / norm) * max_norm when norm >= max_norm
  (`clip_grad_norm_` would divide by norm + 1e-6);
- Adam with b1 0.9, b2 0.999 and eps 1e-8 outside the square root
  (`torch.optim.Adam`, which computes the same update, its learning rate
  a tensor; on the card `capturable`, its step counts there too, so an
  update can be captured);
- a per-epoch cosine learning rate under `lr_decay` and a linear warm-up,
  computed in tensor ops from the optimizer count, a tensor beside the
  parameters (on the card inside a captured step);
- `gradient_accumulation_steps` as `optax.MultiSteps`: the micro-batch
  gradients are averaged, clipping and Adam act once per group on the
  average, the schedule counts optimizer steps, and the parameters do not
  move between groups.

NaN checks (`debug_nans`, on for trainers built inside
`utils.profiling.debug_nans()`, which `--debug_nans` sets): the train step,
captured or not, also writes a device flag, whether the loss, the
gradients and the updated parameters are all finite, and the host reads
it after each step (one synchronisation a step). Before each step the
trainer copies its state (parameters, buffers, Adam's state, the count,
the generators); on the first false flag it puts that copy back, re-runs
the step eagerly under `first_nonfinite_op`, and raises FloatingPointError
naming the step and the first operation that made the value. Every eval
pass's outputs are checked on the host the same way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, Hashable, Iterable, List,
                    NamedTuple, Optional, Tuple)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sie_tpu_torch.compat.from_jax import (load_jax_variables, port_layout,
                                           to_jax_tree, to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.augment import apply_augmentations
from sie_tpu_torch.data.augment import draw as draw_augment
from sie_tpu_torch.data.augment import validate as validate_augment
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.models.info import ModelInfo
from sie_tpu_torch.models.layers import not_ported
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.models.sbm import clamp_sbm_weights
from sie_tpu_torch.utils.profiling import (debug_nans_enabled,
                                           first_nonfinite_op)

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


def make_loss_fn(cfg: Config, loss_head: Optional[Callable] = None):
    """loss_fn(model, batch, beta, generator) -> (loss, (logits, info)):
    the head of the logits + the layers' training losses (`info.aux_loss`,
    the MoE load balance; the JAX package's sown "losses") + the mean
    model loss (+ beta * the head of the SBM logits for InterpGN); beta is
    a float or a 0-d f32 tensor on the batch's device. loss_head(logits,
    targets, weights) -> scalar defaults to `weighted_ce`; the regression
    experiment passes a CRPS head."""
    head = loss_head or weighted_ce
    is_interpgn = cfg.model == "InterpGN"

    def loss_fn(model: nn.Module, batch, beta,
                generator: Optional[torch.Generator]):
        x, y, mask, w = batch
        logits, info = model(x, mask, generator=generator)
        loss = head(logits, y, w)
        if info.aux_loss is not None:
            loss = loss + info.aux_loss
        if info.loss is not None:
            loss = loss + info.loss.mean()
        if is_interpgn:
            loss = loss + beta * head(info.shapelet_preds, y, w)
        return loss, (logits, info)

    return loss_fn


def make_schedule(cfg: Config, steps_per_epoch: int) -> Callable:
    """The learning rate of optimizer step `count` (from 0), both 0-d f32
    tensors on the count's device, as the JAX package's schedule computes
    it; the card computes it inside a captured step. The schedule counts
    optimizer steps: with gradient accumulation an epoch has
    ceil(steps_per_epoch / k) of them."""
    accum = max(cfg.gradient_accumulation_steps, 1)
    per_epoch = max(-(-steps_per_epoch // accum), 1)
    warmup = max(int(cfg.lr_warmup_epochs * per_epoch), 1)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        lr = torch.full_like(count, cfg.lr)
        if cfg.lr_decay:
            epoch = torch.div(count, per_epoch, rounding_mode="floor")
            lr = lr * 0.5 * (1 + torch.cos(math.pi * epoch / cfg.train_epochs))
        if cfg.lr_warmup_epochs > 0:
            lr = lr * ((count + 1) / warmup).clamp(max=1.0)
        return lr

    return schedule


class Optimizer:
    """Clip-by-global-norm and Adam under gradient accumulation, with
    optax's semantics (module docstring), on the gradients that backward
    left in each parameter's `.grad`.

    The device work of a micro-batch (`device_step`) is kept apart from
    the host's bookkeeping (`advance`: the optimizer count and the
    micro-batch's place in its group), so a captured step holds the first
    and the host keeps the second across replays. On every device the
    count that drives the learning rate, and the learning rate, are 0-d
    tensors beside the parameters, and the running mean of an
    accumulation group lives in buffers allocated once; only Adam's
    `capturable` (and `foreach`) differ on the card."""

    def __init__(self, cfg: Config, steps_per_epoch: int,
                 params: Iterable[nn.Parameter]):
        self.params: List[nn.Parameter] = [p for p in params
                                           if p.requires_grad]
        self.accum = max(cfg.gradient_accumulation_steps, 1)
        self.clip = float(cfg.gradient_clip)
        self.schedule = make_schedule(cfg, steps_per_epoch)
        dev = self.params[0].device if self.params else torch.device("cpu")
        on_card = dev.type == "cuda"
        self.count_t = torch.zeros((), dtype=torch.float32, device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.adam = torch.optim.Adam(self.params, lr=self.lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     capturable=on_card, foreach=on_card)
        self.count = 0        # optimizer steps taken
        self.mini_step = 0    # micro-batches in the current group
        self._acc = ([torch.zeros_like(p) for p in self.params]
                     if self.accum > 1 else None)

    def device_step(self, position: int) -> bool:
        """The device work of one micro-batch at `position` in its group;
        True when it updates the parameters. Changes no host state."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.accum > 1:
            # MultiSteps' running mean: acc + (g - acc) / (n + 1)
            for a, g in zip(self._acc, grads):
                if position == 0:
                    a.zero_()
                a.add_((g - a) / (position + 1))
            if position < self.accum - 1:
                return False
            grads = self._acc
        if self.clip > 0:
            grads = clip_by_global_norm(grads, self.clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.lr.copy_(self.schedule(self.count_t))
        self.adam.step()
        self.count_t.add_(1)
        return True

    def advance(self, micro_steps: int = 1) -> None:
        """The host's bookkeeping of `micro_steps` micro-batches."""
        for _ in range(micro_steps):
            if self.mini_step == self.accum - 1:
                self.count += 1
            self.mini_step = (self.mini_step + 1) % self.accum

    # ---- snapshot ------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """count, mini_step, and per parameter (in `params` order) Adam's
        first and second moments and the accumulation group's mean."""
        zeros = [torch.zeros_like(p) for p in self.params]
        st = [self.adam.state.get(p, {}) for p in self.params]
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": [s.get("exp_avg", z) for s, z in zip(st, zeros)],
                "nu": [s.get("exp_avg_sq", z) for s, z in zip(st, zeros)],
                "acc": self._acc or zeros}

    def load_state(self, count: int, mini_step: int, mu, nu, acc) -> None:
        """The reverse of `state`, from per-parameter arrays. New state
        tensors: a graph captured before reads the old ones."""
        self.count, self.mini_step = int(count), int(mini_step)
        for i, p in enumerate(self.params):
            as_p = lambda a: torch.as_tensor(np.asarray(a), dtype=p.dtype
                                             ).to(p.device)
            self.adam.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=p.device),
                "exp_avg": as_p(mu[i]), "exp_avg_sq": as_p(nu[i])}
            if self._acc is not None:
                self._acc[i].copy_(as_p(acc[i]))
        self.count_t.fill_(float(count))


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


def per_sample_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy of f32 logits per row. A label outside [0, C)
    gives a meaningless value instead of a device-side assert, as optax
    does: the caller filters such rows out."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    return -logp.gather(-1, safe[:, None])[:, 0]


class Staged(NamedTuple):
    """An epoch's schedule on the device: indices (n, B) int64, weights
    (n, B) f32 and beta (a 0-d f32 tensor)."""
    ia: torch.Tensor
    wa: torch.Tensor
    beta: torch.Tensor


def _all_finite(ts: Iterable[torch.Tensor]) -> torch.Tensor:
    """One device bool: every element of every tensor finite."""
    return torch.stack([torch.isfinite(t).all() for t in ts]).all()


def _float_leaves(out) -> List[torch.Tensor]:
    """The floating tensors of a step's or pass's outputs."""
    if out is None:
        return []
    if torch.is_tensor(out):
        return [out] if out.is_floating_point() else []
    if isinstance(out, ModelInfo):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    return [t for o in out for t in _float_leaves(o)]


def _clone(out):
    """A copy of a captured graph's outputs, which the next replay
    overwrites."""
    if out is None:
        return None
    if torch.is_tensor(out):
        return out.clone()
    if isinstance(out, ModelInfo):
        return dataclasses.replace(out, **{
            f.name: _clone(getattr(out, f.name))
            for f in dataclasses.fields(out)})
    return type(out)(_clone(o) for o in out)


def _stack_infos(infos: List[ModelInfo]) -> ModelInfo:
    """ModelInfo of per-batch infos, each field stacked on a new first axis
    (None stays None)."""
    return ModelInfo(**{
        f.name: (None if getattr(infos[0], f.name) is None else
                 torch.stack([getattr(i, f.name) for i in infos]))
        for f in dataclasses.fields(ModelInfo)})


def target_dtype(y) -> torch.dtype:
    """The device type of a split's or batch's targets: f32 for float
    (regression) targets, int64 for class labels."""
    kind = (y.dtype.is_floating_point if torch.is_tensor(y)
            else np.issubdtype(np.asarray(y).dtype, np.floating))
    return torch.float32 if kind else torch.int64


class Trainer:
    """Owns the model (in training mode on `device`, default the card), its
    optimizer, the dropout generator, seeded from cfg.seed + 17 as the
    JAX package's step rng is, and under `cfg.augment` the augmentation
    generator (cfg.seed + 17 + AUGMENT_OFFSET, as the JAX package folds
    9173 into the step rng), a stream of its own so the dropout masks are
    the same with and without augmentation; `generator` draws the initial
    weights when the trainer builds the model. `loss_head` as in
    `make_loss_fn`. A trainer built inside `utils.profiling.debug_nans()`
    runs the NaN checks of the module docstring."""

    AUGMENT_OFFSET = 9173

    def __init__(self, cfg: Config, steps_per_epoch: int,
                 model: Optional[nn.Module] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 loss_head: Optional[Callable] = None):
        if mesh is not None:
            raise not_ported("training on a device mesh")
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = build_model(cfg, self.device, generator)
        self.model = model.to(self.device).train()
        self.optimizer = make_optimizer(cfg, steps_per_epoch,
                                        self.model.parameters())
        self.loss_fn = make_loss_fn(cfg, loss_head)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 17)
        self.augment_generator = (
            torch.Generator(device=self.device).manual_seed(
                cfg.seed + 17 + self.AUGMENT_OFFSET)
            if validate_augment(tuple(cfg.augment)) else None)
        self.step = 0
        self._dev_data: Dict[str, Tuple[torch.Tensor, ...]] = {}
        # epoch-staged paths: schedule buffers by (steps, batch) shape, the
        # device step index, index buffers by batch size, and the graphs
        self._staged: Dict[Tuple[int, int], Staged] = {}
        self._k = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._idx: Dict[int, torch.Tensor] = {}
        self._beta_t = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        self._graphs: Dict[Hashable, Tuple[Any, Any, Tuple]] = {}
        self._warm: set = set()
        self._stream = None
        self.captures: List[Hashable] = []   # graph keys, in capture order
        self.debug_nans = debug_nans_enabled()
        self._finite = torch.ones((), dtype=torch.bool, device=self.device)
        self._nan_step = 0    # the step a checked re-run is at

    # ---- steps ------------------------------------------------------------
    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               dtype=dtype).to(self.device)

    def _device_batch(self, batch):
        x, y, mask, w = batch
        return (self._tensor(x, torch.float32),
                self._tensor(y, target_dtype(y)),
                self._tensor(mask, torch.float32),
                self._tensor(w, torch.float32))

    def _beta(self, beta) -> torch.Tensor:
        """beta in the eager steps' device scalar (a fill, no copy from
        the host)."""
        return self._beta_t.fill_(float(beta))

    def _device_step(self, batch, beta: torch.Tensor, position: int):
        """The device work of one train step (what a graph captures):
        loss and gradients, the optimizer at micro-batch `position` of its
        group, the pos_weight clamp."""
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        if self.augment_generator is not None:
            x, y, mask, w = batch
            x, mask = apply_augmentations(self.cfg, x, mask, draw_augment(
                self.cfg, tuple(x.shape), self.augment_generator))
            batch = (x, y, mask, w)
        loss, (logits, _info) = self.loss_fn(self.model, batch, beta,
                                             self.generator)
        loss.backward()
        if self.debug_nans:
            self._finite.logical_and_(_all_finite(
                [loss] + [p.grad for p in self.optimizer.params
                          if p.grad is not None]))
        self.optimizer.device_step(position)
        if self.cfg.pos_weight and self.cfg.model in _CLAMPED:
            clamp_sbm_weights(self.model)
        if self.debug_nans:
            self._finite.logical_and_(_all_finite(self.model.parameters()))
            self._nan_step += 1
        return loss.detach(), logits.detach()

    def _advance(self, steps: int = 1) -> None:
        self.optimizer.advance(steps)
        self.step += steps

    def _update(self, batch, beta: torch.Tensor):
        """One eager train step on a device batch."""
        position = self.optimizer.mini_step
        out = self._checked_train(
            lambda: self._device_step(batch, beta, position))
        self._advance()
        return out

    # ---- NaN checks -------------------------------------------------------
    def _state(self) -> List[torch.Tensor]:
        """The device tensors a train step moves, in a fixed order."""
        opt = self.optimizer
        return (list(self.model.parameters()) + list(self.model.buffers())
                + [opt.count_t, opt.lr] + list(opt._acc or []))

    def _snapshot(self):
        """A copy of the trainer's state before a step."""
        gens = [g for g in (self.generator, self.augment_generator)
                if g is not None]
        adam = {p: {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in self.optimizer.adam.state.get(p, {}).items()}
                for p in self.optimizer.params}
        return ([t.detach().clone() for t in self._state()], adam,
                [g.get_state() for g in gens])

    def _restore(self, snap) -> None:
        tensors, adam, gen_states = snap
        with torch.no_grad():
            for t, saved in zip(self._state(), tensors):
                t.copy_(saved)
        live = self.optimizer.adam.state   # only an eager re-run reads it
        for p, st in adam.items():
            if st:
                live[p] = st
            else:
                live.pop(p, None)
        gens = [g for g in (self.generator, self.augment_generator)
                if g is not None]
        for g, st in zip(gens, gen_states):
            g.set_state(st)

    def _checked_train(self, run: Callable[[], Any],
                       body: Optional[Callable[[], Any]] = None):
        """run() (a train step or a staged epoch; on the card a graph replay)
        under the NaN checks: the flag read after it, and on a false flag
        `body` (default run), the same work, re-run eagerly from the state
        before it under `first_nonfinite_op`, which raises."""
        if not self.debug_nans:
            return run()
        snap = self._snapshot()
        first = self.step
        self._finite.fill_(True)
        out = run()
        if bool(self._finite):
            return out
        self._restore(snap)
        self._nan_step = first
        where = lambda: f"--debug_nans: train step {self._nan_step}"
        first_nonfinite_op(body or run, where)
        raise FloatingPointError(
            f"--debug_nans: train step {first} made a non-finite loss, "
            f"gradient or parameter, which its eager re-run did not "
            f"reproduce")

    def _checked_eval(self, out, body: Callable[[], Any], what: str):
        """out, an eval pass's outputs, checked for non-finite values under
        debug_nans; on one, body() (the same pass) re-run eagerly under
        `first_nonfinite_op`, which raises."""
        if not self.debug_nans:
            return out
        leaves = _float_leaves(out)
        if not leaves or bool(_all_finite(leaves)):
            return out
        first_nonfinite_op(body, lambda: f"--debug_nans: {what}")
        raise FloatingPointError(f"--debug_nans: {what} returned a "
                                 f"non-finite value, which its eager "
                                 f"re-run did not reproduce")

    def train_step(self, batch, beta: float):
        """batch = (x (B, T, C), y (B,), padding mask (B, T), weights (B,)),
        numpy or tensors -> (loss, logits) on the device."""
        return self._update(self._device_batch(batch), self._beta(beta))

    def _eval_forward(self, x, mask, gating_value=None):
        """The eval-mode forward every eval path shares: no gradients, no
        dropout."""
        self.model.eval()
        try:
            with torch.no_grad():
                return self.model(x, mask, gating_value=gating_value)
        finally:
            self.model.train()

    def eval_step(self, batch, gating_value: Optional[float] = None):
        """(logits, ModelInfo) in eval mode, without gradients."""
        x, _y, mask, _w = self._device_batch(batch)
        body = lambda: self._eval_forward(x, mask, gating_value)
        return self._checked_eval(body(), body, "an eval step")

    # ---- device-resident data ---------------------------------------------
    def device_data(self, tag: str, ds) -> Tuple[torch.Tensor, ...]:
        """(x, y, padding mask) of a dataset with those numpy fields, held
        on the device once per tag; batches are then gathered there."""
        if tag not in self._dev_data:
            self._dev_data[tag] = (self._tensor(ds.x, torch.float32),
                                   self._tensor(ds.y, target_dtype(ds.y)),
                                   self._tensor(ds.padding_mask,
                                                torch.float32))
        return self._dev_data[tag]

    def train_step_indexed(self, dev_data, idx, w, beta: float):
        """A train step on rows `idx` of `device_data`, gathered on the
        device; only idx, w and beta cross from the host."""
        idx = self._tensor(idx, torch.int64)
        x, y, mask = (leaf[idx] for leaf in dev_data)
        return self._update((x, y, mask, self._tensor(w, torch.float32)),
                            self._beta(beta))

    # ---- graphs -----------------------------------------------------------
    def _run(self, key: Hashable, reads: Tuple[torch.Tensor, ...],
             body: Callable[[], Any]):
        """body() eagerly on the CPU. On the card: the first call of `key`
        runs body() eagerly on the graph stream (the warm-up), the second
        captures it into a CUDA graph and replays it, later calls replay;
        a replay's outputs are copied, as the next replay overwrites them.
        The graph keeps `reads`, the tensors it reads, alive, so their
        memory cannot pass to other tensors under the same key. A failing
        capture raises."""
        if self.device.type != "cuda":
            return body()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        if key not in self._graphs:
            self._stream.wait_stream(current)
            if key not in self._warm:
                with torch.cuda.stream(self._stream):
                    out = body()
                current.wait_stream(self._stream)
                self._warm.add(key)
                return out
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            if self.augment_generator is not None:
                graph.register_generator_state(self.augment_generator)
            with torch.cuda.graph(graph, stream=self._stream):
                out = body()
            self._graphs[key] = (graph, out, reads)
            self.captures.append(key)
        graph, out, _reads = self._graphs[key]
        graph.replay()
        return _clone(out)

    @staticmethod
    def _key(kind: str, reads: Tuple[torch.Tensor, ...], *extra):
        """(a graph's key, the tensors it reads): the key holds the path,
        the address, shape and type of each tensor read, and `extra`."""
        return ((kind, tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                             for t in reads)) + extra, reads)

    # ---- epoch-staged steps -----------------------------------------------
    def stage_steps(self, steps, beta: float = 0.0) -> Optional[Staged]:
        """Copies an epoch's (idx, w) schedule and beta into the trainer's
        buffers of its (steps, batch) shape. steps: list of (idx (B,), w
        (B,)) pairs from Batcher.epoch_indices. Returns the buffers, or None
        for an empty epoch. Staging another schedule of the same shape
        reuses the buffers, and the graphs that read them."""
        if not steps:
            return None
        idx_all = torch.from_numpy(np.stack([i for i, _ in steps])
                                   .astype(np.int64))
        w_all = torch.from_numpy(np.stack([w for _, w in steps])
                                 .astype(np.float32))
        shape = tuple(idx_all.shape)
        if shape not in self._staged:
            self._staged[shape] = Staged(
                torch.empty(shape, dtype=torch.int64, device=self.device),
                torch.empty(shape, dtype=torch.float32, device=self.device),
                torch.empty((), dtype=torch.float32, device=self.device))
        buf = self._staged[shape]
        buf.ia.copy_(idx_all)
        buf.wa.copy_(w_all)
        buf.beta.fill_(float(beta))
        return buf

    def train_step_staged(self, dev_data, staged: Staged, k: int):
        """Train step `k` of a staged schedule -> (loss, logits); on the
        card a replay of the step's graph (one graph per place in an
        accumulation group)."""
        position = self.optimizer.mini_step
        self._k.fill_(k)

        def body():
            idx = staged.ia.index_select(0, self._k)[0]
            w = staged.wa.index_select(0, self._k)[0]
            x, y, mask = (leaf[idx] for leaf in dev_data)
            return self._device_step((x, y, mask, w), staged.beta, position)

        out = self._checked_train(
            lambda: self._run(*self._key("train_step", (*dev_data, *staged,
                                                        self._k), position),
                              body), body)
        self._advance()
        return out

    def train_epoch_staged(self, dev_data, staged: Staged) -> torch.Tensor:
        """Every step of a staged epoch in order -> the per-step losses
        (n_steps,); on the card one graph replay for the whole epoch, the
        counterpart of the JAX package's `lax.scan` over the schedule.
        Equal to looping `train_step_staged`."""
        opt = self.optimizer
        position = opt.mini_step
        n = staged.ia.shape[0]

        def body():
            losses = []
            for i in range(n):
                x, y, mask = (leaf[staged.ia[i]] for leaf in dev_data)
                loss, _ = self._device_step((x, y, mask, staged.wa[i]),
                                            staged.beta,
                                            (position + i) % opt.accum)
                losses.append(loss)
            return torch.stack(losses)

        out = self._checked_train(
            lambda: self._run(*self._key("train_epoch", (*dev_data, *staged),
                                         position), body), body)
        self._advance(n)
        return out

    def eval_epoch_staged_scan(self, dev_data, staged: Staged,
                               gating_value=None, collect: bool = False):
        """The whole eval pass over a staged schedule -> (logits (n, B, C),
        per-sample CE (n, B), per-batch model loss (n,), the stacked
        ModelInfo when `collect`, else None); on the card one graph replay
        per pass (one graph per gating value, collect and schedule), for
        the caller to fetch at once."""
        n = staged.ia.shape[0]

        def body():
            logits_l, ce_l, ml_l, infos = [], [], [], []
            for i in range(n):
                x, y, mask = (leaf[staged.ia[i]] for leaf in dev_data)
                logits, info = self._eval_forward(x, mask, gating_value)
                logits_l.append(logits)
                ce_l.append(per_sample_ce(logits, y))
                ml_l.append(info.loss.mean() if info.loss is not None else
                            torch.zeros((), device=logits.device))
                infos.append(info)
            return (torch.stack(logits_l), torch.stack(ce_l),
                    torch.stack(ml_l), _stack_infos(infos) if collect
                    else None)

        return self._checked_eval(
            self._run(*self._key("eval_epoch", (*dev_data, *staged),
                                 gating_value, bool(collect)), body),
            body, "an eval pass")

    def eval_step_staged(self, dev_data, staged: Staged, k: int,
                         gating_value=None):
        """(logits, ModelInfo) of batch `k` of a staged schedule, in eval
        mode; on the card a graph replay."""
        self._k.fill_(k)

        def body():
            idx = staged.ia.index_select(0, self._k)[0]
            x, _y, mask = (leaf[idx] for leaf in dev_data)
            return self._eval_forward(x, mask, gating_value)

        return self._checked_eval(
            self._run(*self._key("eval_step", (*dev_data, *staged, self._k),
                                 gating_value), body),
            body, f"eval step {k}")

    def eval_step_indexed(self, dev_data, idx, gating_value=None):
        """(logits, ModelInfo) of rows `idx` of `device_data`, in eval mode;
        on the card the indices go into a buffer of their batch size and a
        graph replays."""
        idx = self._tensor(idx, torch.int64)
        b = idx.shape[0]
        if b not in self._idx:
            self._idx[b] = torch.empty((b,), dtype=torch.int64,
                                       device=self.device)
        buf = self._idx[b]
        buf.copy_(idx)

        def body():
            x, _y, mask = (leaf[buf] for leaf in dev_data)
            return self._eval_forward(x, mask, gating_value)

        return self._checked_eval(
            self._run(*self._key("eval_indexed", (*dev_data, buf),
                                 gating_value), body),
            body, "an eval step")

    # ---- snapshot ---------------------------------------------------------
    def _named(self) -> List[str]:
        return [n for n, p in self.model.named_parameters() if p.requires_grad]

    def state_tree(self) -> Dict[str, Any]:
        """The trainer's whole state as a tree of host arrays: step,
        params and batch_stats in the flax layout, the optimizer (count,
        mini_step, Adam's moments and the accumulation mean under the
        flax names), the dropout generator's state and, under augment, the
        augmentation generator's."""
        opt = self.optimizer.state()
        tree = lambda ts: to_jax_tree(self.model, dict(zip(self._named(),
                                                           ts)))
        out = {"step": self.step, **to_jax_variables(self.model),
               "opt_state": {"count": opt["count"],
                             "mini_step": opt["mini_step"],
                             "mu": tree(opt["mu"]), "nu": tree(opt["nu"]),
                             "acc": tree(opt["acc"])},
               "rng": self.generator.get_state().numpy()}
        if self.augment_generator is not None:
            out["augment_rng"] = self.augment_generator.get_state().numpy()
        return out

    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """The reverse of `state_tree`. Drops the captured graphs, which
        read the optimizer state that this replaces."""
        self._graphs.clear()
        self._warm.clear()
        load_jax_variables(self.model, tree)
        opt = tree["opt_state"]
        per_param = {k: port_layout(self.model, opt[k])
                     for k in ("mu", "nu", "acc")}
        names = self._named()
        self.optimizer.load_state(
            opt["count"], opt["mini_step"],
            *([per_param[k][n] for n in names] for k in ("mu", "nu", "acc")))
        self.step = int(tree["step"])
        as_state = lambda a: torch.from_numpy(np.asarray(a, np.uint8).copy())
        self.generator.set_state(as_state(tree["rng"]))
        if self.augment_generator is not None and "augment_rng" in tree:
            self.augment_generator.set_state(as_state(tree["augment_rng"]))
