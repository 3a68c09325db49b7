"""Switch-style mixture-of-experts FFN (counterpart of sie_tpu/models/moe.py).

`MoEFFN` replaces the encoder layer's dense FFN when `moe_experts > 0`:
(B, T, d_model) -> (B, T, d_model) in the layer's dtype.

- The router (`router`, a Dense to E logits) runs in float32 on the
  float32 input, softmax over the experts.
- Routing is per row (one sequence is one group). Each expert takes at
  most `capacity = min(T*k, max(1, ceil(cf*T*k/E)))` tokens of a row, so
  every shape is static. Top-k is iterative: pass i sends each token to
  its i-th choice (argmax, ties to the lowest index), and the slot
  positions accumulate over the passes, so a token's k choices never
  collide in an expert's buffer. Tokens past capacity bypass the experts
  (the residual carries them). Padded steps are routed like real ones and
  take capacity, as in the JAX package.
- dispatch and combine are (B, T, E, capacity) one-hot masks built in
  float32 and cast to the layer's dtype for the two products that move
  tokens in and out of the experts. For k > 1 the surviving gates of a
  token are normalised to sum to 1.
- The experts' stacked weights (`expert_wi` (E, d, d_ff), `expert_bi`,
  `expert_wo` (E, d_ff, d), `expert_bo`) are held in float32 and cast to
  the layer's dtype; relu or tanh-gelu by `activation`, dropout inside the
  expert.
- In training the forward appends the load-balance loss
  `aux_weight * E * sum_e f_e * P_e` (f_e the share of tokens whose first
  choice is e, P_e the mean router probability), plus `zloss_weight *
  mean(logsumexp(logits)^2)` when that weight is > 0, to the `aux` list
  the caller passes (flax's `sow` into "losses"); the model returns their
  sum on `ModelInfo.aux_loss` and the loss adds it. Eval appends nothing.

Under a step's 'seq' axis (parallel/comm.py) the layer gathers its input
over time and runs at the whole T, every 'seq' rank repeating it, then
keeps this rank's time block: the capacity, the cumulative slot count and
the load-balance means read the whole T, as one process reads them.
Split over an 'expert' axis (`ep`, parallel/mesh.py `shard_params`), a
rank holds E/X experts (and, with 'model', its d_ff block of them): the
router and the dispatch and combine masks are computed whole on every
rank, the rank moves tokens into and out of its own experts only, and
the combine's output is summed over 'expert' (`comm.reduce_from`; over
'model' first where d_ff is split). The seam sits after routing: the
tokens the experts read and the combine weights pass `comm.copy_to`, so
their gradients, each rank's from its own experts, are summed over
'expert' and the router's backward runs once, on whole gradients, on
every rank.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sie_tpu_torch.models.layers import (dense, dropout, gelu, lecun_linear,
                                         lecun_normal_)
from sie_tpu_torch.parallel import comm


def capacity(t: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots an expert has for one row of t tokens."""
    return min(t * top_k,
               max(1, math.ceil(capacity_factor * t * top_k / n_experts)))


def route(probs: torch.Tensor, top_k: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch, combine), each (B, T, E, cap) float32, of router
    probabilities `probs` (B, T, E) (the JAX package's iterative top-k)."""
    b, t, e = probs.shape
    avail = torch.ones_like(probs)
    counts = probs.new_zeros(b, 1, e)
    dispatch = probs.new_zeros(b, t, e, cap)
    combine = probs.new_zeros(b, t, e, cap)
    gate_sum = probs.new_zeros(b, t)
    for _ in range(top_k):
        choice = torch.argmax(probs * avail, dim=-1)             # (B, T)
        onehot = F.one_hot(choice, e).to(probs.dtype)
        gate = (probs * onehot).sum(-1)
        pos = torch.cumsum(onehot, dim=1) - onehot + counts
        counts = counts + onehot.sum(dim=1, keepdim=True)
        slot = (pos * onehot).sum(-1)                            # (B, T)
        keep = (slot < cap).to(probs.dtype)
        sel = (onehot[..., None]
               * F.one_hot(torch.clamp(slot, max=cap - 1).long(), cap
                           ).to(probs.dtype)[..., None, :]
               * keep[..., None, None])
        dispatch = dispatch + sel
        combine = combine + sel * gate[..., None, None]
        gate_sum = gate_sum + gate * keep
        avail = avail * (1.0 - onehot)
    if top_k > 1:
        combine = combine / torch.clamp(gate_sum, min=1e-9)[..., None, None]
    return dispatch, combine


class MoEFFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 dtype: torch.dtype, g: torch.Generator,
                 capacity_factor: float = 1.25, top_k: int = 1,
                 dropout: float = 0.0, activation: str = "gelu",
                 aux_weight: float = 0.01, zloss_weight: float = 0.0):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k={top_k} must be in [1, {n_experts}]")
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dropout = dropout
        self.activation = activation
        self.aux_weight, self.zloss_weight = aux_weight, zloss_weight
        self.dtype = dtype
        self.router = lecun_linear(d_model, n_experts, g)
        e = n_experts
        self.expert_wi = nn.Parameter(torch.empty(e, d_model, d_ff))
        self.expert_bi = nn.Parameter(torch.zeros(e, d_ff))
        self.expert_wo = nn.Parameter(torch.empty(e, d_ff, d_model))
        self.expert_bo = nn.Parameter(torch.zeros(e, d_model))
        self.ep = None   # a mesh: this rank's experts (parallel/mesh.py)
        # flax lecun_normal on (E, in, out) takes the expert axis as a
        # receptive field: fan_in = E * in
        lecun_normal_(self.expert_wi, e * d_model, g)
        lecun_normal_(self.expert_wo, e * d_ff, g)

    def routing(self, x: torch.Tensor):
        """(router logits (B, T, E) f32, probs, dispatch, combine)."""
        logits = dense(x.float(), self.router, torch.float32)
        probs = torch.softmax(logits, dim=-1)
        cap = capacity(x.shape[1], self.n_experts, self.top_k,
                       self.capacity_factor)
        return (logits, probs) + route(probs, self.top_k, cap)

    def aux_loss(self, logits: torch.Tensor,
                 probs: torch.Tensor) -> torch.Tensor:
        """The load-balance loss (+ the z-loss), measured on the first
        choice. Under a step's mesh the means are over the global batch
        (the sums over 'data', parallel/comm.py)."""
        e = self.n_experts
        first = F.one_hot(torch.argmax(probs, -1), e).to(probs.dtype)
        if comm.data_size() > 1:
            n = probs.shape[0] * probs.shape[1] * comm.data_size()
            f_e = comm.data_total(first.sum(dim=(0, 1))) / n
            p_e = comm.data_sum(probs.sum(dim=(0, 1))) / n
        else:
            f_e = first.mean(dim=(0, 1))
            p_e = probs.mean(dim=(0, 1))
        aux = self.aux_weight * e * (f_e * p_e).sum()
        if self.zloss_weight > 0.0:
            z2 = torch.logsumexp(logits, dim=-1) ** 2
            if comm.data_size() > 1:
                z2 = comm.data_sum(z2.sum()) / (z2.numel() * comm.data_size())
            aux = aux + self.zloss_weight * z2.mean()
        return aux

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                aux: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        return comm.whole_time(lambda z: self._forward(z, generator, aux),
                               x, keep_block=True)

    def _forward(self, x: torch.Tensor, generator, aux) -> torch.Tensor:
        logits, probs, dispatch, combine = self.routing(x)
        if self.training and aux is not None:
            aux.append(self.aux_loss(logits, probs))
        dt = self.dtype
        act = F.relu if self.activation == "relu" else gelu
        ep = self.ep
        tp = ep if ep is not None and ep.size("model") > 1 else None
        if ep is not None:
            n = self.expert_wi.shape[0]             # this rank's experts
            lo = ep.index("expert") * n
            x = comm.copy_to(x, ep, "expert")
            dispatch = dispatch[:, :, lo:lo + n]
            combine = comm.copy_to(combine, ep, "expert")[:, :, lo:lo + n]
        xin = torch.einsum("btec,btd->ebcd", dispatch.to(dt), x.to(dt))
        if tp is not None:
            xin = comm.copy_to_model(xin, tp)
        h = torch.einsum("ebcd,edf->ebcf", xin, self.expert_wi.to(dt))
        h = act(h + self.expert_bi.to(dt)[:, None, None, :])
        h = dropout(h, self.dropout, generator, self.training, batch_dim=1,
                    model_dim=None if tp is None else -1, mesh=ep,
                    expert_dim=None if ep is None else 0)
        y = torch.einsum("ebcf,efd->ebcd", h, self.expert_wo.to(dt))
        if tp is not None:
            y = comm.reduce_from_model(y, tp)
        y = y + self.expert_bo.to(dt)[:, None, None, :]
        out = torch.einsum("btec,ebcd->btd", combine.to(dt), y)
        if ep is not None:
            out = comm.reduce_from(out, ep, "expert")
        return out.to(dt)
