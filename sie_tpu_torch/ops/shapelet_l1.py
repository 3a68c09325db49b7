"""Kernels K1 to K4: the L1 / squared sliding shapelet distance, forward
and backward, one bank at a time (K1, K2) or several stride-1 banks in one
launch (K3, K4).

`l1_sliding_distance` is the entry: the autograd function `L1Distance`,
whose forward is K1 and whose backward with respect to the bank is K2
(`l1_sliding_distance_bwd`). Each wrapper sends a CPU tensor to its plain
version (`l1_sliding_distance_plain`, `l1_sliding_distance_bwd_plain`) and
a CUDA tensor to its hand-written kernel, `csrc/shapelet_l1_fwd.cu` and
`csrc/shapelet_l1_bwd.cu` (which replace the Pallas kernels `_fwd_kernel`
and `_bwd_kernel` of sie_tpu/ops/pallas/shapelet_pallas.py; the sources say
what bounds them and how they are laid out). There is no other route.

`l1_sliding_distance_grouped` is the same for a tuple of banks sorted by
ascending length, 'euclidean' only, as `fuse_short_banks` uses it: the
autograd function `GroupedL1Distance`, forward K3
(`csrc/shapelet_l1_grouped_fwd.cu`) and backward K4
(`l1_sliding_distance_grouped_bwd`, `csrc/shapelet_l1_grouped_bwd.cu`),
which replace `_fwd_kernel_grouped` and `_bwd_kernel_grouped` of
shapelet_pallas.py. They run K1's and K2's per-block code
(`csrc/shapelet_common.cuh`) over one grid for all banks, so their results
are the per-bank kernels' bit for bit; the plain versions are the per-bank
plain versions.

The forwards K1 and K3 are registered PyTorch ops, `sie_tpu_torch::l1_fwd`
and `sie_tpu_torch::l1_grouped_fwd` (`torch.library.custom_op`): the CPU
implementation is the plain version, the CUDA implementation the kernel's
launch (which counts it), and a fake implementation gives the output
shapes, so `torch.export` keeps each launch as one node of the graph. The
autograd functions call these ops in their forward, so training, serving
and an exported program take one path. The backwards need no op: export
is inference only.

The gradient with respect to x is None: the JAX package returns zeros, and
the input is always instance-normalised data with no parameters upstream.

Under the multi-seed ensemble (train/ensemble.py) each seed's step calls
these wrappers as a lone step does, one K1/K2 launch per bank and seed:
the counterpart of the JAX package's `sequential_vmap`
(sie_tpu/ops/pallas/seq_vmap.py), which maps the unbatched Pallas op over
the seed axis. There is nothing to fold: each seed has its own banks (n,
C, L) and its own batch rows, while a launch takes one bank against one x.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from sie_tpu_torch.ops import build

METRICS = ("euclidean", "sqeuclidean")
_BLOCKS = 2048   # K2 splits the batch until its grid has about this many blocks
_K2_ROWS = 5     # shapelet rows per K2 block at most (NSB_MAX in the source)
MAX_GROUPED_BANKS = 8   # banks in one K3/K4 launch (its argument table)


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


def l1_sliding_distance_bwd_plain(x: torch.Tensor, s: torch.Tensor,
                                  g: torch.Tensor,
                                  metric: str = "euclidean") -> torch.Tensor:
    """The gradient of `l1_sliding_distance_plain` with respect to s, for
    the output gradient g (B, n, C, W): a loop over taps like the JAX scan
    rule `_l1_bwd_rule`, with the Pallas kernel's select: an exact tie
    s == x adds -g (the scan's sign would add 0)."""
    _check_metric(metric)
    x, s, g = x.float(), s.float(), g.float()
    l = s.shape[2]
    w = g.shape[3]
    out = torch.empty_like(s)
    for li in range(l):
        xl = x[:, None, :, li:li + w]          # (B, 1, C, W)
        sl = s[None, :, :, li, None]           # (1, n, C, 1)
        t = torch.where(sl > xl, g, -g) if metric == "euclidean" else g * (sl - xl)
        out[:, :, li] = t.sum(dim=(0, 3))
    return out * ((2.0 if metric == "sqeuclidean" else 1.0) / l)


@torch.library.custom_op("sie_tpu_torch::l1_fwd", mutates_args=(),
                         device_types="cpu")
def l1_fwd(x: torch.Tensor, s: torch.Tensor, metric: str) -> torch.Tensor:
    """K1 as a registered op; on the CPU its plain version."""
    return l1_sliding_distance_plain(x, s, metric)


@l1_fwd.register_kernel("cuda")
def _l1_fwd_cuda(x, s, metric):
    return _k1(x, s, metric)


@l1_fwd.register_fake
def _l1_fwd_fake(x, s, metric):
    return x.new_empty((x.shape[0], s.shape[0], x.shape[1],
                        x.shape[2] - s.shape[2] + 1), dtype=torch.float32)


class L1Distance(torch.autograd.Function):
    """d = l1_sliding_distance(x, s, metric) through the op `l1_fwd`; the
    backward gives s its gradient through K2 (or its plain version) and x
    none."""

    @staticmethod
    def forward(ctx, x, s, metric):
        ctx.metric = metric
        ctx.save_for_backward(x, s)
        return l1_fwd(x, s, metric)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        grad_s = None
        if ctx.needs_input_grad[1]:
            grad_s = l1_sliding_distance_bwd(x, s, g.contiguous(), ctx.metric)
        return None, grad_s, None


def _check_inputs(x: torch.Tensor, s: torch.Tensor, what: str) -> None:
    if x.dim() != 3 or s.dim() != 3 or x.shape[1] != s.shape[1]:
        raise ValueError(f"x must be (B, C, T) and s (n, C, L) with the same "
                         f"C; got {tuple(x.shape)} and {tuple(s.shape)}")
    t, l = x.shape[2], s.shape[2]
    if not 1 <= l <= t:
        raise ValueError(f"shapelet length {l} must be in [1, T={t}]")
    if not (x.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{what} takes contiguous x and s")


def _on_card(what: str, *ts: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU; True when all lie on one
    CUDA device and are float32; raises otherwise."""
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or ts[0].device.type != "cuda":
        raise ValueError(f"{what}: inputs must all be on one CUDA device or "
                         f"all on the CPU; got {sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"{what} takes float32; got "
                         f"{[str(t.dtype) for t in ts]}")
    if ts[0].shape[1] > 65535:
        raise ValueError(f"{what} launches one grid row per channel; "
                         f"C={ts[0].shape[1]} exceeds 65535")
    return True


def l1_sliding_distance(x: torch.Tensor, s: torch.Tensor,
                        metric: str = "euclidean") -> torch.Tensor:
    """x (B, C, T), s (n, C, L) float32 -> d (B, n, C, T - L + 1) float32,
    d = mean over taps of |x - s| ('euclidean') or (x - s)^2
    ('sqeuclidean'), stride 1. Differentiable in s."""
    _check_metric(metric)
    _check_inputs(x, s, "K1")
    _on_card("K1", x, s)
    return L1Distance.apply(x, s, metric)


def _k1(x: torch.Tensor, s: torch.Tensor, metric: str) -> torch.Tensor:
    b, c, t = x.shape
    n, _, l = s.shape
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


l1_sliding_distance.launches = 0   # K1 launches in this process


def _batch_chunk(b: int, c: int, n: int) -> int:
    """Batch rows per K2 block: the batch is split into chunks until the
    grid (C x shapelet chunks x batch chunks, times the tap tiles of long
    banks) has about `_BLOCKS` blocks; each chunk adds one partial-sum
    slice."""
    per_chunk = c * -(-n // _K2_ROWS)
    parts = max(1, min(b, -(-_BLOCKS // per_chunk)))
    return -(-b // parts)


def l1_sliding_distance_bwd(x: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                            metric: str = "euclidean") -> torch.Tensor:
    """Kernel K2: the gradient (n, C, L) float32 of `l1_sliding_distance`
    with respect to s, for x (B, C, T), s (n, C, L) and the output gradient
    g (B, n, C, T - L + 1), all contiguous."""
    _check_metric(metric)
    _check_inputs(x, s, "K2")
    b, c, t = x.shape
    n, _, l = s.shape
    if tuple(g.shape) != (b, n, c, t - l + 1) or not g.is_contiguous():
        raise ValueError(f"K2 takes a contiguous g of shape "
                         f"{(b, n, c, t - l + 1)}; got {tuple(g.shape)}")
    if not _on_card("K2", x, s, g):
        return l1_sliding_distance_bwd_plain(x, s, g, metric)
    out = torch.empty_like(s)
    if b == 0:
        return out.zero_()
    if out.numel() == 0:
        return out
    chunk = _batch_chunk(b, c, n)
    ws = torch.empty((-(-b // chunk), n, c, l), dtype=torch.float32,
                     device=x.device)
    lib = build.load("shapelet_l1_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.shapelet_l1_bwd(x.data_ptr(), s.data_ptr(), g.data_ptr(),
                                   ws.data_ptr(), out.data_ptr(), b, c, t, n,
                                   l, chunk, int(metric == "sqeuclidean"),
                                   stream)
    build.check(code, "shapelet_l1_bwd")
    l1_sliding_distance_bwd.launches += 1
    return out


l1_sliding_distance_bwd.launches = 0   # K2 launches in this process


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"K1/K2 compute {METRICS}; got {metric!r}")


# --------------------------------------------------------------------------
# several stride-1 'euclidean' banks in one launch: K3 and K4
# --------------------------------------------------------------------------

def l1_sliding_distance_grouped_plain(
        x: torch.Tensor, banks: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """The plain version of K3: `l1_sliding_distance_plain` of each bank."""
    return tuple(l1_sliding_distance_plain(x, s) for s in banks)


def l1_sliding_distance_grouped_bwd_plain(
        x: torch.Tensor, banks: Sequence[torch.Tensor],
        gs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The plain version of K4: `l1_sliding_distance_bwd_plain` of each bank
    for its output gradient (an exact tie adds -g)."""
    return tuple(l1_sliding_distance_bwd_plain(x, s, g)
                 for s, g in zip(banks, gs))


@torch.library.custom_op("sie_tpu_torch::l1_grouped_fwd", mutates_args=(),
                         device_types="cpu")
def l1_grouped_fwd(x: torch.Tensor,
                   banks: List[torch.Tensor]) -> List[torch.Tensor]:
    """K3 as a registered op; on the CPU its plain version."""
    return list(l1_sliding_distance_grouped_plain(x, banks))


@l1_grouped_fwd.register_kernel("cuda")
def _l1_grouped_fwd_cuda(x, banks):
    return list(_k3(x, banks))


@l1_grouped_fwd.register_fake
def _l1_grouped_fwd_fake(x, banks):
    return [x.new_empty((x.shape[0], s.shape[0], x.shape[1],
                         x.shape[2] - s.shape[2] + 1), dtype=torch.float32)
            for s in banks]


class GroupedL1Distance(torch.autograd.Function):
    """ds = l1_sliding_distance_grouped(x, banks) through the op
    `l1_grouped_fwd`; the backward gives every bank its gradient through K4
    (or its plain version) and x none."""

    @staticmethod
    def forward(ctx, x, *banks):
        ctx.save_for_backward(x, *banks)
        return tuple(l1_grouped_fwd(x, list(banks)))

    @staticmethod
    def backward(ctx, *gs):
        x, *banks = ctx.saved_tensors
        if not any(ctx.needs_input_grad[1:]):
            return (None,) * (1 + len(banks))
        grads = l1_sliding_distance_grouped_bwd(
            x, banks, [g.contiguous() for g in gs])
        return (None, *(g if need else None for g, need in
                        zip(grads, ctx.needs_input_grad[1:])))


def _check_grouped(x: torch.Tensor, banks: Sequence[torch.Tensor],
                   what: str) -> None:
    if not 2 <= len(banks) <= MAX_GROUPED_BANKS:
        raise ValueError(f"{what} takes 2 to {MAX_GROUPED_BANKS} banks; got "
                         f"{len(banks)}")
    lengths = [s.shape[-1] for s in banks]
    if lengths != sorted(lengths):
        raise ValueError(f"{what} takes banks sorted by ascending length; "
                         f"got lengths {lengths}")
    for s in banks:
        _check_inputs(x, s, what)
        if s.shape[0] < 1:
            raise ValueError(f"{what} takes banks of at least one shapelet")


def l1_sliding_distance_grouped(
        x: torch.Tensor, banks: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """x (B, C, T) float32 and 2 to 8 banks (n_g, C, L_g) float32 sorted by
    ascending L -> one d_g (B, n_g, C, T - L_g + 1) float32 per bank, d_g =
    mean over taps of |x - s_g|, stride 1 (the 'euclidean' metric).
    Differentiable in every bank."""
    banks = tuple(banks)
    _check_grouped(x, banks, "K3")
    _on_card("K3", x, *banks)
    return GroupedL1Distance.apply(x, *banks)


def _ptrs(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _ints(vals: Sequence[int]):
    return (ctypes.c_int * len(vals))(*vals)


def _k3(x: torch.Tensor, banks: Sequence[torch.Tensor]
        ) -> Tuple[torch.Tensor, ...]:
    b, c, t = x.shape
    outs = tuple(torch.empty((b, s.shape[0], c, t - s.shape[2] + 1),
                             dtype=torch.float32, device=x.device)
                 for s in banks)
    if b == 0 or c == 0:
        return outs
    lib = build.load("shapelet_l1_grouped_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.shapelet_l1_grouped_fwd(
            x.data_ptr(), b, c, t, len(banks), _ptrs(banks), _ptrs(outs),
            _ints([s.shape[0] for s in banks]),
            _ints([s.shape[2] for s in banks]), stream)
    build.check(code, "shapelet_l1_grouped_fwd")
    l1_sliding_distance_grouped.launches += 1
    return outs


l1_sliding_distance_grouped.launches = 0   # K3 launches in this process


def l1_sliding_distance_grouped_bwd(
        x: torch.Tensor, banks: Sequence[torch.Tensor],
        gs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Kernel K4: the gradient (n_g, C, L_g) float32 of
    `l1_sliding_distance_grouped` with respect to each bank, for x (B, C, T)
    and the output gradients g_g (B, n_g, C, T - L_g + 1), all contiguous.
    One call is one K4 launch (a partial-sum launch and a reduce launch)."""
    banks, gs = tuple(banks), tuple(gs)
    _check_grouped(x, banks, "K4")
    b, c, t = x.shape
    if len(gs) != len(banks):
        raise ValueError(f"K4 takes one output gradient per bank; got "
                         f"{len(gs)} for {len(banks)} banks")
    for s, g in zip(banks, gs):
        want = (b, s.shape[0], c, t - s.shape[2] + 1)
        if tuple(g.shape) != want or not g.is_contiguous():
            raise ValueError(f"K4 takes a contiguous g of shape {want}; got "
                             f"{tuple(g.shape)}")
    if not _on_card("K4", x, *banks, *gs):
        return l1_sliding_distance_grouped_bwd_plain(x, banks, gs)
    outs = tuple(torch.empty_like(s) for s in banks)
    if b == 0 or c == 0:
        return tuple(o.zero_() for o in outs)
    # each bank's batch chunk is K2's for that bank alone: the same partial
    # sums, so the same roundings
    chunks = [_batch_chunk(b, c, s.shape[0]) for s in banks]
    ws = torch.empty(sum(-(-b // ch) * s.numel()
                         for ch, s in zip(chunks, banks)),
                     dtype=torch.float32, device=x.device)
    lib = build.load("shapelet_l1_grouped_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.shapelet_l1_grouped_bwd(
            x.data_ptr(), b, c, t, len(banks), _ptrs(banks), _ptrs(gs),
            _ptrs(outs), ws.data_ptr(), _ints([s.shape[0] for s in banks]),
            _ints([s.shape[2] for s in banks]), _ints(chunks), stream)
    build.check(code, "shapelet_l1_grouped_bwd")
    l1_sliding_distance_grouped_bwd.launches += 1
    return outs


l1_sliding_distance_grouped_bwd.launches = 0   # K4 launches in this process
