"""Shapelet Bottleneck Model (SBM) and its distance-threshold variant (LTS)
(counterpart of sie_tpu/models/sbm.py).

- bank i has length L_i = max(3, ceil(frac_i * seq_len)) and stride 1 below
  3000 steps, else log2(L);
- the input is instance-normalized per channel (unbiased std + 1e-8);
- predicates p = RBF(eps * d) reduced by a straight-through max over
  windows ('sbm'), or sigmoid(threshold - straight-through min d) ('lts');
  with gradients off (serving) the same values come from the min distance;
- the classifier reads the predicates of all banks, each bank flattened in
  (n, C) row-major order and the banks concatenated: 'linear' (no bias),
  'bilinear' (linear + bilinear form) or 'attention' (scalar attention over
  the predicates with a learned positional embedding);
- model loss = lambda_reg * mean|W| + lambda_div * sum over banks of the
  diversity loss;
- in training, dropout at `cfg.dropout` on the classifier's input (three
  independent masks for 'bilinear'); `clamp_sbm_weights` is the
  non-negative projection of the classifier after an optimizer step
  (`pos_weight`).

The predicates stay float32; `classify` casts them to the compute dtype.
Under `cfg.fuse_short_banks`, with the metric resolved to 'euclidean' and
at least two stride-1 banks, those banks take one grouped launch (kernels
K3 forward and K4 backward), the others one K1 launch each, as in the JAX
package; the distances are the same either way.

Split over a mesh's 'model' axis (`tp`, parallel/mesh.py `shard_params`),
each bank holds this rank's n/M shapelets (and thresholds): the kernels
run on them, and the predicates and distances of every rank are gathered
back into the global order, bank-major, before the classifier, which is
whole on every rank; the diversity loss reads each bank gathered whole.

On a time block (a step's 'seq' axis, parallel/comm.py) the input is
gathered over time once, before the instance norm, which reads the whole
T: the banks, predicates and losses then run on this rank's rows at the
whole T, every 'seq' rank repeating them, as GSPMD runs the JAX
package's kernels under their partition rules.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.info import ModelInfo
from sie_tpu_torch.models.layers import (dense, dropout, linear, normal_,
                                         uniform_)
from sie_tpu_torch.ops.shapelet import (diversity_loss, instance_norm, rbf,
                                        shapelet_stride, sliding_distance,
                                        ste_max, ste_min)
from sie_tpu_torch.ops.shapelet_l1 import l1_sliding_distance_grouped
from sie_tpu_torch.parallel import comm


def bank_lengths(cfg: Config) -> Tuple[int, ...]:
    return tuple(max(3, int(math.ceil(f * cfg.seq_len)))
                 for f in cfg.shapelet_lengths)


class PredicateAttention(nn.Module):
    """Scalar self-attention over the predicate vector: Q/K are 1 -> dim_attn
    projections plus a positional embedding, V is the predicate itself.
    Above `chunk_threshold` features the queries go in chunks of `chunk`
    rows (exact: the softmax is over keys only), so the (B, F, F) scores of
    the flagship's F = 7320 are never held at once."""

    def __init__(self, dim_feature: int, dtype: torch.dtype,
                 g: torch.Generator, dim_attn: int = 16, chunk: int = 128,
                 chunk_threshold: int = 2048):
        super().__init__()
        self.dtype = dtype
        self.chunk = chunk
        self.chunk_threshold = chunk_threshold
        self.scale = 1.0 / math.sqrt(dim_attn)
        self.pos_embed = nn.Parameter(torch.empty(dim_feature, dim_attn))
        normal_(self.pos_embed, 1.0, g)
        self.q_proj = linear(1, dim_attn, g)    # U(-1, 1): fan_in 1
        self.k_proj = linear(1, dim_attn, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, F)
        xe = x[..., None]
        q = dense(xe, self.q_proj, self.dtype) + self.pos_embed   # f32
        k = dense(xe, self.k_proj, self.dtype) + self.pos_embed
        xv = x.to(self.dtype)[..., None]                           # (B, F, 1)
        kt = k.transpose(1, 2)
        f = x.shape[1]
        step = f if f <= self.chunk_threshold else self.chunk
        outs = []
        for lo in range(0, f, step):
            s = torch.matmul(q[:, lo:lo + step], kt) * self.scale
            a = torch.softmax(s, dim=-1)
            outs.append(torch.matmul(a.to(self.dtype), xv)[..., 0])
        return torch.cat(outs, dim=1)


class ShapeBottleneckModel(nn.Module):
    """variant='sbm' -> RBF-probability predicates; variant='lts' ->
    distance-threshold predicates."""

    takes_time_blocks = True    # gathers its input over 'seq' itself

    def __init__(self, cfg: Config, g: torch.Generator, variant: str = "sbm"):
        super().__init__()
        if variant not in ("sbm", "lts"):
            raise ValueError(f"unknown SBM variant {variant!r}")
        if cfg.sbm_cls not in ("linear", "bilinear", "attention"):
            raise ValueError(f"unknown sbm_cls {cfg.sbm_cls!r}")
        self.cfg = cfg
        self.variant = variant
        c = cfg.enc_in
        self.lengths = bank_lengths(cfg)
        self.strides = tuple(shapelet_stride(cfg.seq_len, l)
                             for l in self.lengths)
        nums = cfg.num_shapelets_per_bank
        for i, l in enumerate(self.lengths):
            bank = nn.Parameter(torch.empty(nums[i], c, l))
            normal_(bank, 1.0, g)
            setattr(self, f"shapelets_{i}", bank)
            if variant == "lts":
                thr = nn.Parameter(torch.empty(nums[i], c))
                with torch.no_grad():
                    thr.uniform_(0.0, 1.0, generator=g)
                setattr(self, f"threshold_{i}", thr)
        total = sum(n * c for n in nums)
        self.output_layer = linear(total, cfg.num_class, g, bias=False)
        if cfg.sbm_cls == "bilinear":
            self.bilinear_w = nn.Parameter(
                torch.empty(cfg.num_class, total, total))
            uniform_(self.bilinear_w, 1.0 / math.sqrt(total), g)
        elif cfg.sbm_cls == "attention":
            self.attention = PredicateAttention(total, cfg.compute_dtype, g)
        self.tp = None

    @property
    def banks(self) -> List[torch.Tensor]:
        return [getattr(self, f"shapelets_{i}")
                for i in range(len(self.lengths))]

    def _metric(self) -> str:
        # LTS keeps sqeuclidean and folds cosine/pearson to mean-|diff|
        metric = self.cfg.distance_func
        if self.variant != "sbm" and metric not in ("euclidean", "sqeuclidean"):
            metric = "euclidean"
        return metric

    def _bank_distances(self, xn: torch.Tensor) -> List[torch.Tensor]:
        """Per-bank (B, n, C, W) distances of xn (B, C, T). Under
        `fuse_short_banks` with the 'euclidean' metric and at least two
        stride-1 banks, those banks go through one grouped launch in
        ascending-L order, mapped back to bank order; every other bank
        through `sliding_distance`. The gate does not depend on the
        device."""
        metric = self._metric()
        per_bank = {}
        fuse = []
        if self.cfg.fuse_short_banks and metric == "euclidean":
            fuse = sorted((i for i, st in enumerate(self.strides) if st == 1),
                          key=lambda i: self.lengths[i])
        if len(fuse) >= 2:
            outs = l1_sliding_distance_grouped(
                xn, tuple(self.banks[i] for i in fuse))
            per_bank.update(zip(fuse, outs))
        return [per_bank[i] if i in per_bank else
                sliding_distance(xn, bank, self.strides[i], metric)
                for i, bank in enumerate(self.banks)]

    def predicates(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, T, C) -> (p, d): each (B, total) float32."""
        x = comm.gather_seq(x)
        xn = instance_norm(x.transpose(1, 2).float()).contiguous()
        ps, ds = [], []
        for i, d_full in enumerate(self._bank_distances(xn)):
            b = d_full.shape[0]
            d_min = d_full.amin(dim=-1)
            # Without a gradient the straight-through reductions are their
            # hard values: the max over windows of rbf(d) is rbf(min d), as
            # the RBF falls with |d| and d >= 0, so no further pass over the
            # (B, n, C, W) distances is needed.
            hard = not torch.is_grad_enabled()
            if self.variant == "sbm":
                p = (rbf(d_min, self.cfg.epsilon) if hard else
                     ste_max(rbf(d_full, self.cfg.epsilon), dim=-1))
            else:
                thr = getattr(self, f"threshold_{i}")
                p = torch.sigmoid(
                    thr[None] - (d_min if hard else ste_min(d_full, dim=-1)))
            ps.append(p.reshape(b, -1))
            ds.append(d_min.reshape(b, -1))
        p, d = torch.cat(ps, dim=-1), torch.cat(ds, dim=-1)
        if self.tp is not None:
            widths = [t.shape[-1] for t in ps]
            p, d = self._gather_banks(p, widths), self._gather_banks(d, widths)
        return p, d

    def _gather_banks(self, t: torch.Tensor, widths) -> torch.Tensor:
        """(B, sum of local bank widths) of every 'model' rank -> (B,
        total) in the global order: bank by bank, each bank's rows in rank
        order (rank r holds shapelets r*n/M ... (r+1)*n/M - 1)."""
        g = comm.gather_model(t, self.tp)                  # (M, B, F_local)
        out, lo = [], 0
        for w in widths:
            out.append(g[:, :, lo:lo + w].transpose(0, 1).reshape(
                g.shape[1], -1))
            lo += w
        return torch.cat(out, dim=-1)

    def classify(self, p: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        pc = p.to(dt)
        drop = lambda z: dropout(z, self.cfg.dropout, generator, self.training)
        if self.cfg.sbm_cls == "linear":
            out = dense(drop(pc), self.output_layer, dt)
        elif self.cfg.sbm_cls == "bilinear":
            # three independent masks, as in the JAX package: one mask for
            # both bilinear arguments would keep the p_i^2 terms correlated
            lin = dense(drop(pc), self.output_layer, dt)
            w = self.bilinear_w.to(dt).float()
            bil = torch.einsum("bi,kij,bj->bk", drop(pc).float(), w,
                               drop(pc).float())
            out = lin + bil
        else:
            out = dense(drop(self.attention(pc)), self.output_layer, dt)
        return out.float()

    def model_loss(self) -> torch.Tensor:
        cfg = self.cfg
        loss = cfg.lambda_reg * self.output_layer.weight.abs().mean()
        if cfg.lambda_div > 0.0:
            banks = (self.banks if self.tp is None else
                     [comm.gather_model_dim(b, self.tp, 0)
                      for b in self.banks])
            loss = loss + cfg.lambda_div * sum(diversity_loss(b)
                                               for b in banks)
        return loss

    def forward(self, x, padding_mask=None, gating_value=None,
                generator: Optional[torch.Generator] = None):
        p, d = self.predicates(x)
        out = self.classify(p, generator)
        return out, ModelInfo(d=d, p=p, shapelet_preds=out, preds=out,
                              loss=self.model_loss()[None])


def clamp_sbm_weights(module: nn.Module) -> None:
    """Clamps every `output_layer.weight` in `module` to >= 0 in place: the
    `pos_weight` projection after an optimizer step (the JAX package's
    `clamp_sbm_weights` on `output_layer/kernel`)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name == "output_layer.weight" or \
                    name.endswith(".output_layer.weight"):
                p.clamp_(min=0.0)
