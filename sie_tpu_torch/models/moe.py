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
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sie_tpu_torch.models.layers import (dense, dropout, gelu, lecun_linear,
                                         lecun_normal_)


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
        choice."""
        e = self.n_experts
        first = F.one_hot(torch.argmax(probs, -1), e).to(probs.dtype)
        f_e = first.mean(dim=(0, 1))
        p_e = probs.mean(dim=(0, 1))
        aux = self.aux_weight * e * (f_e * p_e).sum()
        if self.zloss_weight > 0.0:
            z = torch.logsumexp(logits, dim=-1)
            aux = aux + self.zloss_weight * (z ** 2).mean()
        return aux

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                aux: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        logits, probs, dispatch, combine = self.routing(x)
        if self.training and aux is not None:
            aux.append(self.aux_loss(logits, probs))
        dt = self.dtype
        act = F.relu if self.activation == "relu" else gelu
        xin = torch.einsum("btec,btd->ebcd", dispatch.to(dt), x.to(dt))
        h = torch.einsum("ebcd,edf->ebcf", xin, self.expert_wi.to(dt))
        h = act(h + self.expert_bi.to(dt)[:, None, None, :])
        h = dropout(h, self.dropout, generator, self.training)
        y = torch.einsum("ebcf,efd->ebcd", h, self.expert_wo.to(dt))
        y = y + self.expert_bo.to(dt)[:, None, None, :]
        out = torch.einsum("btec,ebcd->btd", combine.to(dt), y)
        return out.to(dt)
