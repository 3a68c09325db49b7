"""Kernel K1: the L1 / squared sliding shapelet distance forward.

`l1_sliding_distance` is the wrapper: a CPU tensor goes to the plain
version `l1_sliding_distance_plain`, a CUDA tensor to the hand-written
kernel in `csrc/shapelet_l1_fwd.cu` (which replaces the Pallas kernel
`_fwd_kernel` of sie_tpu/ops/pallas/shapelet_pallas.py; the source says what
bounds it and how it is laid out). There is no other route.
"""

from __future__ import annotations

import torch

from sie_tpu_torch.ops import build

METRICS = ("euclidean", "sqeuclidean")


def l1_sliding_distance_plain(x: torch.Tensor, s: torch.Tensor,
                              metric: str = "euclidean") -> torch.Tensor:
    """x (B, C, T), s (n, C, L) -> d (B, n, C, T - L + 1) float32, a loop
    over taps like the JAX package's scan `_l1_forward` (stride 1)."""
    _check_metric(metric)
    x = x.float()
    s = s.float()
    l = s.shape[2]
    w = x.shape[2] - l + 1
    acc = torch.zeros((x.shape[0], s.shape[0], x.shape[1], w),
                      dtype=torch.float32, device=x.device)
    for li in range(l):
        d = x[:, None, :, li:li + w] - s[None, :, :, li, None]
        acc.add_(d.abs_() if metric == "euclidean" else d.square_())
    return acc / l


def l1_sliding_distance(x: torch.Tensor, s: torch.Tensor,
                        metric: str = "euclidean") -> torch.Tensor:
    """x (B, C, T), s (n, C, L) float32 -> d (B, n, C, T - L + 1) float32,
    d = mean over taps of |x - s| ('euclidean') or (x - s)^2
    ('sqeuclidean'), stride 1."""
    _check_metric(metric)
    if x.dim() != 3 or s.dim() != 3 or x.shape[1] != s.shape[1]:
        raise ValueError(f"x must be (B, C, T) and s (n, C, L) with the same "
                         f"C; got {tuple(x.shape)} and {tuple(s.shape)}")
    b, c, t = x.shape
    n, _, l = s.shape
    if not 1 <= l <= t:
        raise ValueError(f"shapelet length {l} must be in [1, T={t}]")
    if not (x.is_contiguous() and s.is_contiguous()):
        raise ValueError("K1 takes contiguous x and s")
    if x.device.type == "cpu" and s.device.type == "cpu":
        return l1_sliding_distance_plain(x, s, metric)
    if x.device.type != "cuda" or s.device != x.device:
        raise ValueError(f"x and s must both be on one CUDA device or both "
                         f"on the CPU; got {x.device} and {s.device}")
    if x.dtype != torch.float32 or s.dtype != torch.float32:
        raise ValueError(f"K1 takes float32; got {x.dtype} and {s.dtype}")
    if c > 65535:
        raise ValueError(f"K1 launches one grid row per channel; C={c} "
                         f"exceeds 65535")
    out = torch.empty((b, n, c, t - l + 1), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("shapelet_l1_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.shapelet_l1_fwd(x.data_ptr(), s.data_ptr(), out.data_ptr(),
                                   b, c, t, n, l,
                                   int(metric == "sqeuclidean"), stream)
    build.check(code, "shapelet_l1_fwd")
    l1_sliding_distance.launches += 1
    return out


l1_sliding_distance.launches = 0   # kernel launches in this process


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"K1 computes {METRICS}; got {metric!r}")
