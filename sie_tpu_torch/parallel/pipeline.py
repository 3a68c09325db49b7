"""GPipe pipeline parallelism over a 'pipe' mesh axis (counterpart of
sie_tpu/parallel/pipeline.py).

Each 'pipe' rank of a process mesh (parallel/mesh.py) holds one stage:
L/S consecutive layers of a homogeneous stack (`encoder_stage` builds
an `Encoder` of them, `compat.from_jax.load_jax_stage` fills it from a
flax `Encoder` tree and `gather_stage_params` gathers the stages back to
that tree). `gpipe` runs the JAX package's schedule in eager PyTorch:
M + S - 1 ticks; at tick t stage 0 ingests microbatch min(t, M - 1)
(ticks past M feed it a repeat whose output is never collected), every
stage applies its layers on every tick, bubble ticks included, and the
outputs rotate one stage forward (`comm.ppermute`, point to point over
the 'pipe' group). The last stage collects the outputs of ticks
t >= S - 1, and `comm.from_last` gives them to every stage. The backward
is autograd's through the same graph: the reverse rotation, the same
bubble. How each gradient is counted once is parallel/comm.py's rule for
'pipe': every 'pipe' rank computes the same loss from the output and
runs its backward; each stage's parameters then hold the gradient of
their layers, the input's gradient lands on stage 0.

The stage runs local (`comm.using(None)`), as `shard_map` runs the JAX
stage per device: a MoE layer's router statistics are per microbatch and
per 'data' shard, and the aux channel takes the mean over 'data' at its
end. Dropout draws from a generator keyed on the tick (the JAX stage
folds the tick into its key), so each microbatch draws its own masks;
the masks are the port's, never JAX's (ROADMAP.md §3).

The pipeline is a library call, as in the JAX package: no entry point
runs it, and it stays eager (no CUDA graph).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import Encoder, layer_norm
from sie_tpu_torch.parallel import comm


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_stage_params(layer_params: list, n_stages: int) -> Any:
    """L per-layer flax trees of one structure (numpy arrays) -> one tree
    of (S, L/S, ...) arrays, stage-major: stage s holds layers
    s·L/S .. (s + 1)·L/S - 1."""
    n_layers = len(layer_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into "
                         f"{n_stages} equal stages")
    return _tree_map(lambda *ls: np.stack([np.asarray(a) for a in ls])
                     .reshape(n_stages, n_layers // n_stages,
                              *np.shape(ls[0])), *layer_params)


class _Pick(torch.autograd.Function):
    """`jnp.where(stage == 0, inp, state)`: `inp` on stage 0, else `state`,
    each in its own dtype; the input not taken gets a zero gradient, so
    both stay in the graph on every stage."""

    @staticmethod
    def forward(ctx, inp, state, first):
        ctx.first = first
        ctx.meta = [(t.shape, t.dtype, t.device) for t in (inp, state)]
        return (inp if first else state).view_as(inp if first else state)

    @staticmethod
    def backward(ctx, g):
        zeros = lambda i: torch.zeros(ctx.meta[i][0], dtype=ctx.meta[i][1],
                                      device=ctx.meta[i][2])
        if ctx.first:
            return g, zeros(1), None
        return zeros(0), g, None


def gpipe(stage_fn: Callable, stage_layers, x: torch.Tensor, mesh, *,
          axis: str = "pipe", n_microbatches: int,
          data_axis: Optional[str] = None, collect_aux: bool = False):
    """Run this rank's stage of a homogeneous layer stack in the pipeline.

    stage_fn(layer, x_mb, tick) -> y_mb applies ONE layer (an element of
    `stage_layers`, this rank's L/S layers in order); tick is the
    schedule step. x: the global batch (B, ...), B divisible by
    n_microbatches; with `data_axis`, this rank runs its block of rows
    over that mesh axis (each block splitting into the microbatches too)
    and the result holds those rows. Every rank returns the last stage's
    output of its rows, of x's leading shape.

    collect_aux=True: stage_fn returns (y_mb, aux scalar); the result is
    (out, aux), aux the mean over microbatches of the layers' summed aux,
    bubble ticks masked out, then the mean over `data_axis`. Every rank
    adds the same aux to its loss; its gradient reaches each stage's
    share once (parallel/comm.py)."""
    n_stages, stage = mesh.size(axis), mesh.index(axis)
    n_micro = n_microbatches
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible into "
                         f"{n_micro} microbatches")
    if data_axis is not None:
        d, i = mesh.size(data_axis), mesh.index(data_axis)
        if x.shape[0] % (d * n_micro):
            raise ValueError(f"batch {x.shape[0]} over {d} {data_axis!r} "
                             f"ranks not divisible into {n_micro} "
                             f"microbatches")
        n = x.shape[0] // d
        x = x[i * n:(i + 1) * n]
    mbs = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:]).unbind(0)
    first = stage == 0
    state = torch.zeros_like(mbs[0])
    outs = []
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    ticks = n_micro + n_stages - 1
    with comm.using(None):
        for t in range(ticks):
            y = _Pick.apply(mbs[min(t, n_micro - 1)], state, first)
            for layer in stage_layers:
                y = stage_fn(layer, y, t)
                if collect_aux:
                    y, a = y
                    # a stage holds a real microbatch on ticks
                    # stage .. stage + M - 1 only
                    if stage <= t <= stage + n_micro - 1:
                        aux_acc = aux_acc + a.float()
            if t >= n_stages - 1:
                outs.append(y)
            if t < ticks - 1:      # the last rotation's result is unread
                state = comm.ppermute(y, mesh, axis)
    out = comm.from_last(torch.stack(outs), mesh, axis)
    out = out.reshape(x.shape[0], *out.shape[2:])
    if not collect_aux:
        return out
    aux = comm.reduce_from(aux_acc, mesh, axis) / n_micro
    if data_axis is not None:
        aux = comm.reduce_from(aux, mesh, data_axis) / mesh.size(data_axis)
    return out, aux


def _tick_seed(base: int, tick: int) -> int:
    return (base + tick * 0x9E3779B97F4A7C15) % (1 << 63)


def encoder_layer_stage_fn(cfg: Config,
                           generator: Optional[torch.Generator] = None,
                           train: bool = False,
                           collect_aux: bool = False) -> Callable:
    """stage_fn running one `EncoderLayer` (an `encoder_stage`'s layer) in
    training or eval mode. In training, the layers of tick t draw their
    dropout masks (and K5/K6's hash seeds) from a generator seeded from
    one draw of `generator` and t, so each microbatch draws its own. With
    collect_aux=True it returns (y, the sum of the layer's appended aux
    losses: the MoE layer's load-balance loss in training)."""
    base = None
    if train and generator is not None:
        base = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                 device=generator.device).item())
    gens = {}

    def tick_generator(t: int):
        if base is None:
            return None
        if t not in gens:
            gens[t] = torch.Generator(device=generator.device).manual_seed(
                _tick_seed(base, t))
        return gens[t]

    def stage_fn(layer: nn.Module, xm: torch.Tensor, t: int):
        layer.train(train)
        if not collect_aux:
            return layer(xm, tick_generator(t))
        sown = []
        y = layer(xm, tick_generator(t), sown)
        aux = torch.zeros((), dtype=torch.float32, device=y.device)
        for s in sown:
            aux = aux + s.float().sum()
        return y, aux

    return stage_fn


def encoder_stage(cfg: Config, n_stages: int = 1,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Encoder:
    """An `Encoder` of cfg.e_layers / n_stages layers (a stage; the whole
    stack at n_stages 1) and the final `norm`, built as the JAX stage
    builds its `EncoderLayer`: the fused attention's gates
    (`use_fused_attention`, `fused_attention_max_len`,
    `fused_attention_min_len`), no flash, the `moe_*` fields; weights
    drawn from `generator` (load them with `load_jax_stage`)."""
    if cfg.e_layers % n_stages:
        raise ValueError(f"{cfg.e_layers} layers do not split into "
                         f"{n_stages} equal stages")
    g = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    enc = Encoder(cfg.e_layers // n_stages, cfg.d_model, d_ff=cfg.d_ff,
                  n_heads=cfg.n_heads, dtype=cfg.compute_dtype, g=g,
                  activation=cfg.activation,
                  use_fused=cfg.use_fused_attention,
                  fused_max_len=cfg.fused_attention_max_len,
                  fused_min_len=cfg.fused_attention_min_len,
                  use_flash=False, dropout=cfg.dropout,
                  moe_experts=cfg.moe_experts,
                  moe_capacity_factor=cfg.moe_capacity_factor,
                  moe_top_k=cfg.moe_top_k,
                  moe_aux_weight=cfg.moe_aux_weight)
    return enc if device is None else enc.to(device)


def pipelined_encoder_apply(cfg: Config, encoder: Encoder, x: torch.Tensor,
                            mesh, *, n_microbatches: int,
                            axis: str = "pipe",
                            data_axis: Optional[str] = None,
                            generator: Optional[torch.Generator] = None,
                            train: bool = False, return_aux: bool = False):
    """This rank's stage of an `Encoder` (`encoder_stage`, its L/S layers)
    run as a pipeline over `axis`, then the trailing `norm` on every rank
    (it is not part of the homogeneous stack). With return_aux=True the
    result is (out, aux), aux the stages' MoE load-balance losses through
    the schedule (`gpipe`). Training a MoE stack without return_aux
    raises, as in the JAX package: the balancing objective would be lost."""
    if cfg.moe_experts > 0 and train and not return_aux:
        raise ValueError(
            "moe_experts > 0 under the pipeline executor with train=True "
            "requires return_aux=True: the router's load-balance loss is "
            "not collectable otherwise, and dropping it silently "
            "un-balances the experts. Pass return_aux=True and add the "
            "returned aux scalar to the objective.")
    n_stages = mesh.size(axis)
    if len(encoder.layers) * n_stages != cfg.e_layers:
        raise ValueError(f"a stage of {len(encoder.layers)} layers over "
                         f"{n_stages} {axis!r} ranks is not the "
                         f"{cfg.e_layers}-layer encoder")
    out = gpipe(encoder_layer_stage_fn(cfg, generator, train, return_aux),
                encoder.layers, x, mesh, axis=axis,
                n_microbatches=n_microbatches, data_axis=data_axis,
                collect_aux=return_aux)
    if return_aux:
        out, aux = out
    out = layer_norm(encoder.norm, out)
    return (out, aux) if return_aux else out
