"""Shapelet sliding-window distance ops (counterpart of sie_tpu/ops/shapelet.py).

    x: (B, C, T)  instance-normalized series
    s: (n, C, L)  shapelet bank
    d[b, n, c, w] = dist(x[b, c, w*stride : w*stride+L],  s[n, c, :])

with the JAX package's four metrics:
    'euclidean'   mean_l |x - s|
    'sqeuclidean' mean_l (x - s)^2
    'cosine'      1 - cos(x_win, s)
    'pearson'     1 - corr(x_win, s)

The window axis is last, (B, n, C, W), as in the JAX package, so the
flattened (n, C) feature order and the classifier weights correspond one to
one. 'euclidean' and 'sqeuclidean' go through kernel K1 (`shapelet_l1`),
stride 1 directly and stride k as k stride-1 calls over the polyphase
components; 'cosine' and 'pearson' are grouped convolutions, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from sie_tpu_torch.ops.shapelet_l1 import l1_sliding_distance


def instance_norm(x: torch.Tensor, eps: float = 1e-8,
                  ddof: int = 1) -> torch.Tensor:
    """Per-channel z-score over time of x (B, C, T); eps is added to the
    std (ddof=1 by default, the unbiased estimator)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    if ddof:
        t = x.shape[-1]
        var = var * (t / max(t - ddof, 1))
    return (x - mean) / (torch.sqrt(var) + eps)


def _depthwise_corr(x: torch.Tensor, s: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """out[b, n, c, w] = sum_l x[b, c, w*stride + l] * s[n, c, l]."""
    b, c, _ = x.shape
    n, _, l = s.shape
    # out channel (c*n + j) reads group c
    weight = s.float().transpose(0, 1).reshape(c * n, 1, l)
    out = F.conv1d(x.float(), weight, stride=stride, groups=c)  # (B, C*n, W)
    return out.reshape(b, c, n, -1).transpose(1, 2)


def _sliding_sum(x: torch.Tensor, l: int, stride: int) -> torch.Tensor:
    """Per-channel sliding sum over windows of length l: (B, C, T) -> (B, C, W)."""
    c = x.shape[1]
    ones = torch.ones((c, 1, l), dtype=torch.float32, device=x.device)
    return F.conv1d(x.float(), ones, stride=stride, groups=c)


def sliding_distance(x: torch.Tensor, s: torch.Tensor, stride: int = 1,
                     metric: str = "euclidean") -> torch.Tensor:
    """All-window shapelet distances. x (B, C, T), s (n, C, L) -> d (B, n, C, W) f32."""
    n, _, l = s.shape
    if metric in ("euclidean", "sqeuclidean"):
        fn = functools.partial(l1_sliding_distance, metric=metric)
        if stride == 1:
            return fn(x, s)
        return _l1_polyphase(x, s, stride, fn)
    if metric == "cosine":
        xs = _depthwise_corr(x, s, stride)
        x2 = _sliding_sum(x.float().square(), l, stride)
        s2 = s.float().square().sum(dim=-1)
        denom = torch.sqrt(x2[:, None] * s2[None, :, :, None])
        # torch cosine_similarity clamps the denominator at eps=1e-8
        return 1.0 - xs / torch.clamp(denom, min=1e-8)
    if metric == "pearson":
        xs = _depthwise_corr(x, s, stride)
        x1 = _sliding_sum(x, l, stride)
        x2 = _sliding_sum(x.float().square(), l, stride)
        s32 = s.float()
        s_mean = s32.mean(dim=-1)
        s_cent2 = (s32 - s_mean[..., None]).square().sum(dim=-1)
        x_mean = x1 / l
        num = xs - l * x_mean[:, None] * s_mean[None, :, :, None]
        x_cent2 = torch.clamp(x2 - l * x_mean.square(), min=0.0)
        denom = torch.sqrt(x_cent2[:, None] * s_cent2[None, :, :, None]) + 1e-8
        return 1.0 - num / denom
    raise ValueError(f"unknown metric: {metric!r}")


def _l1_polyphase(x: torch.Tensor, s: torch.Tensor, k: int,
                  stride1_fn) -> torch.Tensor:
    """Stride-k distance as a sum of k stride-1 distances over the polyphase
    components (valid for any per-tap-additive metric): with l = q*k + r,
    x[w*k + l] is x_r[w + q] for x_r = x[..., r::k], so phase r adds the
    unnormalized stride-1 distance between x_r and s_r = s[..., r::k]."""
    t = x.shape[2]
    l = s.shape[2]
    w = (t - l) // k + 1
    total = None
    for r in range(k):
        s_r = s[:, :, r::k]
        l_r = s_r.shape[2]
        if l_r == 0:   # k > L leaves later phases empty
            continue
        x_r = x[:, :, r::k][:, :, : w + l_r - 1]
        d_r = stride1_fn(x_r.contiguous(), s_r.contiguous()) * float(l_r)
        total = d_r if total is None else total + d_r
    return total / l


# --------------------------------------------------------------------------
# straight-through window reductions
# --------------------------------------------------------------------------

def _one_hot(idx: torch.Tensor, like: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.zeros_like(like).scatter_(dim, idx.unsqueeze(dim), 1.0)


def ste_max(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Straight-through hard max: value = p[argmax]; grad = one-hot +
    softmax Jacobian."""
    hard = _one_hot(p.argmax(dim=dim), p, dim)
    soft = torch.softmax(p, dim=dim)
    onehot = hard + soft - soft.detach()
    return (onehot * p).sum(dim=dim)


def ste_min(d: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Straight-through hard min via softmin."""
    hard = _one_hot(d.argmin(dim=dim), d, dim)
    soft = torch.softmax(-d, dim=dim)
    onehot = hard + soft - soft.detach()
    return (onehot * d).sum(dim=dim)


def rbf(d: torch.Tensor, eps: float) -> torch.Tensor:
    """p = exp(-(eps*d)^2)."""
    return torch.exp(-torch.square(eps * d))


def diversity_loss(bank: torch.Tensor) -> torch.Tensor:
    """Mean over (C, n, n) of exp(-||s_i - s_j + 1e-6||_2) off the diagonal,
    for bank (n, C, L)."""
    n = bank.shape[0]
    sh = bank.float().transpose(0, 1)                      # (C, n, L)
    diff = sh[:, :, None, :] - sh[:, None, :, :] + 1e-6
    dist = torch.sqrt(diff.square().sum(dim=-1))
    mask = 1.0 - torch.eye(n, dtype=dist.dtype, device=dist.device)
    return (torch.exp(-dist) * mask[None]).mean()


def shapelet_stride(seq_len: int, shapelet_len: int) -> int:
    """Stride 1 below 3000 steps, else log2(L)."""
    if seq_len < 3000:
        return 1
    return max(1, int(math.log2(shapelet_len)))
