"""The collectives of a step on a device mesh (parallel/mesh.py), which the
JAX package leaves to GSPMD.

Under GSPMD the sharded step is the single-device step over the global
batch. Here each process runs its rows (and its 'model' shard) and these
helpers put the global arithmetic back:

- `data_total`: a sum over the 'data' axis without a gradient (the
  loss's weight sum, the reported loss);
- `data_sum`: the same with a gradient, whose backward is again the sum
  over 'data' (BatchNorm's statistics, the MoE router's means): each
  rank's backward of its share of a global term then adds up to the
  term's gradient;
- `sum_grads`: each parameter's gradient summed (not averaged) over
  'data', one flat buffer a step;
- `gather_data`: eval outputs in global row order;
- Megatron's pair over 'model': `copy_to_model` (identity forward,
  all-reduce backward) in front of a column-parallel product, and
  `reduce_from_model` (all-reduce forward, identity backward) behind a
  row-parallel one; `gather_model` concatenates shards along a dimension,
  its backward keeps this rank's slice (the work after it is repeated on
  every 'model' rank, so its gradient is already whole there).

The trainer sets the mesh of a step (`using`); with no mesh every helper
is the identity and launches nothing. Collectives go through
torch.distributed on the mesh's per-axis groups: NCCL on the cards, where
a captured step holds them, or gloo, through which a card's tensors are
staged on the host (processes that share one card).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_CURRENT: List = [None]


@contextlib.contextmanager
def using(mesh):
    """The mesh the helpers below read while a step runs (None: no mesh)."""
    prev = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield mesh
    finally:
        _CURRENT[0] = prev


def current():
    return _CURRENT[0]


def data_size(mesh=None) -> int:
    mesh = mesh if mesh is not None else current()
    return 1 if mesh is None else mesh.size("data")


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group` (through the host for a card's tensor
    under gloo)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """(size, *t.shape): every rank's t in group-rank order."""
    if dist.get_backend(group) == "gloo":
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(size)]
        dist.all_gather(parts, host, group=group)
        return torch.stack(parts).to(t.device)
    out = torch.empty((size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


# ---------------------------------------------------------------- 'data'
def data_total(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """t summed over the 'data' axis, without a gradient."""
    mesh = mesh if mesh is not None else current()
    if mesh is None:
        return t
    return all_reduce_(t.detach().clone(), mesh.group("data"))


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def data_sum(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """t summed over the 'data' axis, with a gradient (the sum's)."""
    mesh = mesh if mesh is not None else current()
    if mesh is None:
        return t
    return _Sum.apply(t, mesh.group("data"))


def sum_grads(params: Sequence[torch.nn.Parameter], mesh) -> None:
    """Each parameter's `.grad` (zeros where None) summed over 'data', in
    one flat buffer; every rank passes the same parameters in the same
    order."""
    if mesh is None:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(flat, mesh.group("data"))
    for p, piece in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = piece.view_as(p).to(p.dtype)


def gather_data(t: Optional[torch.Tensor], mesh, dim: int = 0):
    """The global tensor of each rank's rows along `dim` (rank order is
    row order); None stays None."""
    if mesh is None or t is None:
        return t
    size = mesh.size("data")
    g = all_gather(t, mesh.group("data"), size)        # (size, ...)
    return torch.cat(g.unbind(0), dim=dim)


# --------------------------------------------------------------- 'model'
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.index = index
        return all_gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.group("model"))


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every 'model' rank's partial x; f32 on the wire."""
    return _ReduceFromModel.apply(x.float(), mesh.group("model")).to(x.dtype)


def gather_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """(M, *x.shape): every 'model' rank's shard; the backward keeps this
    rank's slice of the gradient."""
    return _GatherModel.apply(x, mesh.group("model"), mesh.size("model"),
                              mesh.index("model"))


def gather_model_dim(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The shards of every 'model' rank concatenated along `dim`."""
    return torch.cat(gather_model(x, mesh).unbind(0), dim=dim)
