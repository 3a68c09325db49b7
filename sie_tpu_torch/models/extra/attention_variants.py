"""Attention variants beyond full attention (counterpart of
sie_tpu/models/extra/attention_variants.py): DS, ProbSparse, LSH and
Crossformer's two-stage layer.

Plain PyTorch, as the JAX package leaves them to XLA: no kernel runs here.
Their projections are flax's default `nn.Dense` (lecun_normal kernel, zero
bias), cast to the layer's dtype; scores and the weighted sums accumulate
in float32 as there.

- `DSAttentionLayer`: scores * tau + delta (de-stationary factors; None
  gives full attention), -1e9 above the diagonal when causal.
- `ProbAttentionLayer` (Informer): only the u = factor*ceil(ln L_Q)
  queries of largest sparsity measure max - mean over a deterministic
  strided key sample attend; the others take the mean of V (or its running
  sum when causal). The top-u rows are gathered and scattered back by
  index; indices are distinct within a (row, head), so each backward
  element gets one contribution and the gradients are deterministic.
- `LSHAttentionLayer` (Reformer): shared-QK attention over buckets from
  random rotations, `jax.random.normal(PRNGKey(hash_seed), (dk, n_hashes,
  n_buckets/2))`, drawn again here bit for bit (utils/threefry.py) so a
  JAX-trained model buckets as it did there; sorted by (bucket, position)
  (permutations, so the gathers' backward is deterministic), chunks with
  one chunk of look-back, rounds combined by their log-sum-exp weights.
- `TwoStageAttentionLayer` (Crossformer): attention across segments, then
  across dimensions through `factor` learned router vectors; its three
  `FullAttentionLayer`s are built without `use_fused`, so they take the
  plain branch, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sie_tpu_torch.models.layers import (FullAttentionLayer, dense, dropout,
                                         gelu, layer_norm, layer_norm_module,
                                         lecun_linear, normal_param)
from sie_tpu_torch.utils import threefry

NEG_INF = -1e9


class DSAttentionLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype,
                 g: torch.Generator, attention_dropout: float = 0.0,
                 causal: bool = False):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        self.attention_dropout, self.causal = attention_dropout, causal
        dk = d_model // n_heads
        self.query = lecun_linear(d_model, dk * n_heads, g)
        self.key = lecun_linear(d_model, dk * n_heads, g)
        self.value = lecun_linear(d_model, dk * n_heads, g)
        self.out = lecun_linear(dk * n_heads, d_model, g)

    def forward(self, q_in, k_in, v_in,
                generator: Optional[torch.Generator] = None,
                tau: Optional[torch.Tensor] = None,
                delta: Optional[torch.Tensor] = None) -> torch.Tensor:
        h, dt = self.n_heads, self.dtype
        b, l = q_in.shape[:2]
        split = lambda z, lin: dense(z, lin, dt).unflatten(
            -1, (h, -1)).transpose(1, 2)                    # (B, H, L, dk)
        q, k, v = (split(q_in, self.query), split(k_in, self.key),
                   split(v_in, self.value))
        dk = q.shape[-1]
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if tau is not None:
            scores = scores * tau[:, None, None, None]
        if delta is not None:
            scores = scores + delta[:, None, None, :]
        if self.causal:
            later = torch.ones(scores.shape[-2:], dtype=torch.bool,
                               device=scores.device).triu(1)
            scores = scores.masked_fill(later, NEG_INF)
        a = torch.softmax(scores / math.sqrt(dk), dim=-1)
        a = dropout(a, self.attention_dropout, generator, self.training)
        out = torch.matmul(a.to(v.dtype).float(), v.float())
        out = out.transpose(1, 2).reshape(b, l, h * dk).to(dt)
        return dense(out, self.out, dt)


def sample_index(lq: int, lk: int, sample_k: int) -> np.ndarray:
    """(L_Q, sample_k) key indices of ProbAttention's sparsity estimate: a
    float32 stride lk/sample_k, floored, offset per query by (q * 7919)
    mod the integer stride (the JAX package's arithmetic, float32 as
    there)."""
    stride = lk / sample_k
    base = np.floor(np.arange(sample_k, dtype=np.float32)
                    * np.float32(stride)).astype(np.int64)
    off = (np.arange(lq, dtype=np.int64) * 7919) % max(int(stride), 1)
    return (base[None, :] + off[:, None]) % lk


class ProbAttentionLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype,
                 g: torch.Generator, factor: int = 5,
                 attention_dropout: float = 0.0, causal: bool = False):
        super().__init__()
        self.n_heads, self.dtype, self.factor = n_heads, dtype, factor
        self.attention_dropout, self.causal = attention_dropout, causal
        dk = d_model // n_heads
        self.query = lecun_linear(d_model, dk * n_heads, g)
        self.key = lecun_linear(d_model, dk * n_heads, g)
        self.value = lecun_linear(d_model, dk * n_heads, g)
        self.out = lecun_linear(dk * n_heads, d_model, g)
        self._idx: Dict[Tuple, torch.Tensor] = {}

    def _sample(self, lq: int, lk: int, sample_k: int,
                device) -> torch.Tensor:
        key = (lq, lk, sample_k, device)
        if key not in self._idx:
            self._idx[key] = torch.from_numpy(
                sample_index(lq, lk, sample_k)).to(device)
        return self._idx[key]

    def top_queries(self, q: torch.Tensor, k: torch.Tensor,
                    u: int) -> torch.Tensor:
        """(B, H, u) indices of the queries with the largest sparsity
        measure; no gradient flows through the choice."""
        b, h, lq, _ = q.shape
        lk = k.shape[2]
        sample_k = min(self.factor * int(math.ceil(math.log(lk))), lk)
        with torch.no_grad():
            full = torch.matmul(q.float(), k.float().transpose(-1, -2))
            if sample_k != lk:
                idx = self._sample(lq, lk, sample_k, q.device)
                full = torch.gather(full, 3,
                                    idx[None, None].expand(b, h, lq, -1))
            m = full.amax(-1) - full.mean(-1)                # (B, H, L_Q)
            return torch.topk(m, u, dim=-1).indices

    def forward(self, q_in, k_in, v_in,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, dt = self.n_heads, self.dtype
        b, lq = q_in.shape[:2]
        lk = k_in.shape[1]
        split = lambda z, lin: dense(z, lin, dt).unflatten(
            -1, (h, -1)).transpose(1, 2)                    # (B, H, L, dk)
        q, k, v = (split(q_in, self.query), split(k_in, self.key),
                   split(v_in, self.value))
        dk = q.shape[-1]
        u = min(self.factor * int(math.ceil(math.log(lq))), lq)
        top = self.top_queries(q, k, u)                      # (B, H, u)
        rows = top[..., None].expand(b, h, u, dk)
        q_red = torch.gather(q, 2, rows)
        scores = torch.matmul(q_red.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(dk)
        if self.causal:
            later = (torch.arange(lk, device=q.device)[None, None, None, :]
                     > top[..., None])
            scores = scores.masked_fill(later, NEG_INF)
            context = torch.cumsum(v, dim=2)                 # needs L_Q == L_V
        else:
            context = v.mean(dim=2, keepdim=True).expand(b, h, lq, dk)
        a = torch.softmax(scores, dim=-1)
        a = dropout(a, self.attention_dropout, generator, self.training)
        upd = torch.matmul(a.to(v.dtype).float(), v.float())  # (B, H, u, dk)
        context = context.float().scatter(2, rows, upd)
        out = context.transpose(1, 2).reshape(b, lq, h * dk).to(dt)
        return dense(out, self.out, dt)


class LSHAttentionLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype,
                 g: torch.Generator, bucket_size: int = 4, n_hashes: int = 4,
                 attention_dropout: float = 0.0, causal: bool = False,
                 hash_seed: int = 0):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        self.bucket_size, self.n_hashes = bucket_size, n_hashes
        self.attention_dropout, self.causal = attention_dropout, causal
        self.hash_seed = hash_seed
        dk = d_model // n_heads
        self.qk = lecun_linear(d_model, dk * n_heads, g)
        self.value = lecun_linear(d_model, dk * n_heads, g)
        self.out = lecun_linear(dk * n_heads, d_model, g)
        self._rot: Dict[Tuple, torch.Tensor] = {}

    def rotations(self, dk: int, n_buckets: int, device) -> torch.Tensor:
        """(dk, n_hashes, n_buckets/2) f32: the JAX package's draw."""
        key = (dk, n_buckets, device)
        if key not in self._rot:
            self._rot[key] = threefry.normal(
                self.hash_seed, (dk, self.n_hashes, n_buckets // 2)
            ).to(device)
        return self._rot[key]

    def buckets(self, keys: torch.Tensor, n: int) -> torch.Tensor:
        """(B*H, n_hashes, n) bucket of each position in each round."""
        n_buckets = max(n // self.bucket_size, 2)
        n_buckets += n_buckets % 2
        rot = self.rotations(keys.shape[-1], n_buckets, keys.device)
        rotated = torch.einsum("zle,ero->zlro", keys.float(), rot)
        return torch.argmax(torch.cat([rotated, -rotated], dim=-1),
                            dim=-1).transpose(1, 2)

    def project(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(shared queries-keys, values, unit keys), each (B*H, n, dk), of
        x (B, n_in, d_model) zero-padded to n, a multiple of
        2 * bucket_size."""
        h, dt = self.n_heads, self.dtype
        b, n_in = x.shape[:2]
        step = 2 * self.bucket_size
        n = -(-n_in // step) * step
        if n != n_in:
            x = torch.nn.functional.pad(x, (0, 0, 0, n - n_in))
        qk = dense(x, self.qk, dt)
        v = dense(x, self.value, dt)
        dk = qk.shape[-1] // h
        fold = lambda z: z.view(b, n, h, dk).transpose(1, 2).reshape(
            b * h, n, dk)
        qk, v = fold(qk), fold(v)
        # sqrt(ss + eps): the zero vectors of length padding keep a
        # finite gradient
        ss = qk.square().sum(-1, keepdim=True)
        return qk, v, qk * torch.rsqrt(ss + 1e-12)

    def buckets_of(self, x: torch.Tensor) -> torch.Tensor:
        """(B*H, n_hashes, n) buckets that `forward` sorts x's positions
        into."""
        keys = self.project(x)[2]
        return self.buckets(keys, keys.shape[1])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, r, bs, dt = self.n_heads, self.n_hashes, self.bucket_size, \
            self.dtype
        b, n_in = x.shape[:2]
        qk, v, keys = self.project(x)
        z, n, dk = qk.shape
        buckets = self.buckets(keys, n)                      # (Z, R, L)
        pos = torch.arange(n, device=x.device)
        sidx = torch.argsort(buckets * n + pos, dim=-1)      # (Z, R, L)
        take = lambda t: t[:, None].expand(z, r, n, dk).gather(
            2, sidx[..., None].expand(z, r, n, dk))
        sq, sk, sv = take(qk), take(keys), take(v)
        sb = torch.gather(buckets, 2, sidx)
        sp = sidx                        # the position each sorted slot holds
        nc = n // bs
        chunk = lambda t: t.reshape(z, r, nc, bs, *t.shape[3:])
        cq, ck, cv = chunk(sq), chunk(sk), chunk(sv)
        cb, cp = chunk(sb), chunk(sp)
        look = lambda t: torch.cat([t, torch.roll(t, 1, dims=2)], dim=3)
        kk, vv, bb, pp = look(ck), look(cv), look(cb), look(cp)
        scores = torch.einsum("zrcqe,zrcke->zrcqk", cq.float(),
                              kk.float()) / math.sqrt(dk)
        scores = torch.where(cb[..., :, None] == bb[..., None, :], scores,
                             torch.full((), NEG_INF, device=x.device))
        if self.causal:
            scores = torch.where(cp[..., :, None] >= pp[..., None, :],
                                 scores,
                                 torch.full((), NEG_INF, device=x.device))
        # attending to itself only as a last resort (Reformer's convention)
        scores = torch.where(cp[..., :, None] == pp[..., None, :],
                             scores - 1e5, scores)
        lse = torch.logsumexp(scores, dim=-1)                # (Z, R, nc, bs)
        probs = torch.exp(scores - lse[..., None])
        # dropout after the softmax; the rounds' weights keep the lse
        probs = dropout(probs, self.attention_dropout, generator,
                        self.training)
        o = torch.einsum("zrcqk,zrcke->zrcqe", probs, vv.float())
        inv = torch.argsort(sidx, dim=-1)
        o = o.reshape(z, r, n, dk).gather(
            2, inv[..., None].expand(z, r, n, dk))
        lse = torch.gather(lse.reshape(z, r, n), 2, inv)
        w = torch.softmax(lse, dim=1)[..., None]
        out = (o * w).sum(dim=1)                             # (Z, L, dk)
        out = out.reshape(b, h, n, dk).transpose(1, 2)[:, :n_in]
        return dense(out.reshape(b, n_in, h * dk).to(dt), self.out, dt)


class TwoStageAttentionLayer(nn.Module):
    """Input (B, D, S, d_model): attention across the S segments of each
    dimension, then across the D dimensions through `factor` router
    vectors (`router`, (seg_num, factor, d_model), N(0, 1)); each stage
    post-norm with a tanh-gelu MLP (`mlp1_*`, `mlp2_*`)."""

    def __init__(self, seg_num: int, factor: int, d_model: int,
                 n_heads: int, g: torch.Generator, d_ff: int = 0,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.dropout, self.dtype = dropout, dtype
        attn = lambda: FullAttentionLayer(d_model, n_heads, dtype, g,
                                          attention_dropout=dropout)
        self.time_attention = attn()
        self.dim_sender = attn()
        self.dim_receiver = attn()
        self.mlp1_1 = lecun_linear(d_model, d_ff, g)
        self.mlp1_2 = lecun_linear(d_ff, d_model, g)
        self.mlp2_1 = lecun_linear(d_model, d_ff, g)
        self.mlp2_2 = lecun_linear(d_ff, d_model, g)
        for i in range(1, 5):
            setattr(self, f"norm{i}", layer_norm_module(d_model))
        self.router = normal_param((seg_num, factor, d_model), 1.0, g)

    def _mlp(self, first: nn.Linear, second: nn.Linear, z):
        return dense(gelu(dense(z, first, self.dtype)), second, self.dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = lambda z: dropout(z, self.dropout, generator, self.training)
        bsz, ts_d, seg, dm = x.shape
        time_in = x.reshape(bsz * ts_d, seg, dm)
        t = self.time_attention(time_in, time_in, time_in, generator)
        dim_in = layer_norm(self.norm1, time_in + drop(t))
        dim_in = layer_norm(self.norm2, dim_in + drop(
            self._mlp(self.mlp1_1, self.mlp1_2, dim_in)))
        dim_send = dim_in.reshape(bsz, ts_d, seg, dm).transpose(1, 2) \
            .reshape(bsz * seg, ts_d, dm)
        batch_router = self.router.repeat(bsz, 1, 1)     # (B*seg, factor, dm)
        buffer = self.dim_sender(batch_router, dim_send, dim_send, generator)
        receive = self.dim_receiver(dim_send, buffer, buffer, generator)
        dim_enc = layer_norm(self.norm3, dim_send + drop(receive))
        dim_enc = layer_norm(self.norm4, dim_enc + drop(
            self._mlp(self.mlp2_1, self.mlp2_2, dim_enc)))
        return dim_enc.reshape(bsz, seg, ts_d, dm).transpose(1, 2)
