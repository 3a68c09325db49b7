"""The collectives of a step on a device mesh (parallel/mesh.py), which the
JAX package leaves to GSPMD.

Under GSPMD the sharded step is the single-device step over the global
batch. Here each process runs its rows (its 'data' block), its time block
(its 'seq' block), its 'model' shard and its experts (its 'expert'
block), and these helpers put the global arithmetic back:

- `data_total`: a sum over the 'data' axis without a gradient (the
  loss's weight sum, the reported loss);
- `data_sum`: the same with a gradient, whose backward is again the sum
  over 'data' (BatchNorm's statistics, the MoE router's means): each
  rank's backward of its share of a global term then adds up to the
  term's gradient;
- `sum_grads`: each parameter's gradient summed (not averaged) over
  'data' and 'seq', one flat buffer an axis;
- `gather_data`: eval outputs in global row order;
- Megatron's pair over 'model': `copy_to_model` (identity forward,
  all-reduce backward) in front of a column-parallel product, and
  `reduce_from_model` (all-reduce forward, identity backward) behind a
  row-parallel one; `gather_model` concatenates shards along a dimension,
  its backward keeps this rank's slice (the work after it is repeated on
  every 'model' rank, so its gradient is already whole there);
- over 'seq': `gather_seq` (the time blocks concatenated), `seq_block`
  (this rank's block of a whole-time tensor), `halo_seq` (the
  neighbours' edge steps for a conv), `seq_sum` (the counterpart of
  `data_sum`), `whole_time` (a layer or model that reads across time
  run on the gathered input);
- the same pair over 'expert' (`copy_to`, `reduce_from` with the axis):
  in front of a rank's experts (their tokens and combine weights) and
  behind them (the sum of every rank's experts' output).
- over 'pipe' (parallel/pipeline.py, which the JAX package runs inside
  `shard_map`): `ppermute`, the ring rotation of `lax.ppermute` (every
  stage sends to the next and receives from the previous; the backward
  rotates the other way), and `from_last`, the masked `psum` that gives
  every stage the last stage's output.

How each leaf's gradient is counted once. 'model' and 'expert' keep
Megatron's rule: the work after a seam is repeated on every such rank,
whose gradients there are whole, so a replicated leaf is not summed over
the axis; the router, run whole on every 'expert' rank, gets its
gradient once, whole, through the pair. 'seq' takes the other standard
rule, the one of autodiff through an SPMD program: a rank's loss, which
is the same on every 'seq' rank, enters the backward as 1/S of itself
(the trainer divides it), every 'seq' collective's backward is its true
adjoint (the gather's a reduce-scatter, a sum's a sum), and every leaf's
gradient is summed over 'seq' (`sum_grads`). So work repeated on every
'seq' rank (the SBM after its gather, attention at the whole T)
contributes S shares of 1/S, time-sharded work (the embedding, the FFN,
the LayerNorms, the head's rows) its blocks' partial sums, and the summed
gradient equals the single-device gradient of the global batch
(tests/test_torch_port_mesh_seq.py and test_torch_port_mesh_expert.py
hold it to `jax.grad`).

'pipe' takes Megatron's rule too. Every 'pipe' rank computes the same
loss from `from_last`'s output and runs its backward, so each stage's
backward receives the whole cotangent of the output: `from_last` hands
it on only on the last stage (zeros on the others), where one copy
reaches the outputs it collected, and never S copies. The pipeline's aux
loss is summed over 'pipe' by `reduce_from` (identity backward), so each
stage's share gets its gradient once. The input's gradient lands on
stage 0, zeros on the others. Every rank issues the same exchanges in
the same order in both passes: the stages run the same schedule, and
stage 0 keeps what it received in the graph (it reads its microbatch
instead, with a zero gradient for the received state), so its reverse
rotation runs like every other stage's (tests/test_torch_port_pipeline.py
holds each stage's gradients to `jax.grad`).

The trainer sets the mesh of a step (`using`); with no mesh every helper
is the identity and launches nothing, as is every 'seq' or 'expert'
helper on an axis of one member. Inside `full_time` (a layer run on the
whole T, which every 'seq' rank repeats) the 'seq' helpers are the
identity too. Collectives go through torch.distributed on the mesh's
per-axis groups: NCCL on the cards, where a captured step holds them, or
gloo, through which a card's tensors are staged on the host (processes
that share one card).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_CURRENT: List = [None]
_FULL_TIME: List[bool] = [False]


@contextlib.contextmanager
def using(mesh):
    """The mesh the helpers below read while a step runs (None: no mesh)."""
    prev, prev_full = _CURRENT[0], _FULL_TIME[0]
    _CURRENT[0], _FULL_TIME[0] = mesh, False
    try:
        yield mesh
    finally:
        _CURRENT[0], _FULL_TIME[0] = prev, prev_full


@contextlib.contextmanager
def full_time():
    """A block whose tensors hold the whole time axis (a layer after
    `gather_seq`): the 'seq' helpers are the identity inside it."""
    prev = _FULL_TIME[0]
    _FULL_TIME[0] = True
    try:
        yield
    finally:
        _FULL_TIME[0] = prev


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


def broadcast_(t: torch.Tensor, group, index: int) -> torch.Tensor:
    """In place: the tensor of `group`'s rank `index` on every rank
    (through the host for a card's tensor under gloo)."""
    src = dist.get_global_rank(group, index) \
        if group is not dist.group.WORLD else index
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.detach().cpu()
        dist.broadcast(host, src=src, group=group)
        return t.copy_(host)
    dist.broadcast(t, src=src, group=group)
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
    """Each parameter's `.grad` (zeros where None) summed over 'data' and,
    on an axis of more than one member, over 'seq', in one flat buffer;
    every rank passes the same parameters in the same order."""
    if mesh is None:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(flat, mesh.group("data"))
    if mesh.size("seq") > 1:
        all_reduce_(flat, mesh.group("seq"))
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
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
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


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x as it is; its gradient summed over `axis` (Megatron's f)."""
    if mesh.size(axis) <= 1:
        return x
    return _CopyTo.apply(x, mesh.group(axis))


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every `axis` rank's partial x, f32 on the wire; its
    gradient as it is (Megatron's g)."""
    if mesh.size(axis) <= 1:
        return x
    return _ReduceFrom.apply(x.float(), mesh.group(axis)).to(x.dtype)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return copy_to(x, mesh, "model")


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every 'model' rank's partial x; f32 on the wire."""
    return reduce_from(x, mesh, "model")


def gather_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """(M, *x.shape): every 'model' rank's shard; the backward keeps this
    rank's slice of the gradient."""
    return _GatherModel.apply(x, mesh.group("model"), mesh.size("model"),
                              mesh.index("model"))


def gather_model_dim(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The shards of every 'model' rank concatenated along `dim`."""
    return torch.cat(gather_model(x, mesh).unbind(0), dim=dim)


# ----------------------------------------------------------------- 'seq'
def seq_size() -> int:
    """The 'seq' size of the step's mesh: 1 without one, inside
    `full_time`, or on an axis of one member."""
    mesh = current()
    return 1 if mesh is None or _FULL_TIME[0] else mesh.size("seq")


def seq_index() -> int:
    """This rank's 'seq' block (0 where `seq_size` is 1)."""
    return 0 if seq_size() <= 1 else current().index("seq")


class _GatherAxis(torch.autograd.Function):
    """(size, *t.shape): every rank's t; the backward is the true adjoint,
    a reduce-scatter (the gradients every rank holds for this rank's t,
    summed)."""

    @staticmethod
    def forward(ctx, t, group, size, index):
        ctx.group, ctx.index = group, index
        return all_gather(t, group, size)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_(g.contiguous().clone(), ctx.group)[ctx.index],
                None, None, None)


def _gather_seq_parts(t: torch.Tensor) -> torch.Tensor:
    mesh = current()
    return _GatherAxis.apply(t, mesh.group("seq"), mesh.size("seq"),
                             mesh.index("seq"))


def gather_seq(t: Optional[torch.Tensor], dim: int = 1):
    """The whole time axis (`dim`) of every 'seq' rank's block, in rank
    order; None stays None."""
    if t is None or seq_size() <= 1:
        return t
    return torch.cat(_gather_seq_parts(t).unbind(0), dim=dim)


def seq_block(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block of a tensor that holds the whole time axis."""
    s = seq_size()
    if s <= 1:
        return t
    n = t.shape[dim] // s
    return t.narrow(dim, seq_index() * n, n)


def halo_seq(t: torch.Tensor, before: int, after: int, circular: bool,
             dim: int = 1) -> torch.Tensor:
    """Under a step's 'seq' axis: t with the `before` last steps of the
    previous rank's block in front and the `after` first steps of the
    next one's behind (zeros past either end of time, or with `circular`
    the other end's steps). Each block must hold at least `before` and
    `after` steps."""
    n = t.shape[dim]
    zeros = lambda k: t.new_zeros(t.shape[:dim] + (k,) + t.shape[dim + 1:])
    s = seq_size()
    if n < max(before, after):
        raise ValueError(f"a time block of {n} steps is narrower than the "
                         f"halo of {max(before, after)} steps a layer "
                         f"reads; use fewer 'seq' ranks")
    edges = torch.cat([t.narrow(dim, n - before, before),
                       t.narrow(dim, 0, after)], dim=dim)
    parts = _gather_seq_parts(edges)            # (S, ..., before + after)
    i = seq_index()
    prev, nxt = (i - 1) % s, (i + 1) % s
    head = parts[prev].narrow(dim, 0, before)
    tail = parts[nxt].narrow(dim, before, after)
    if not circular:
        head = head if i > 0 else zeros(before)
        tail = tail if i < s - 1 else zeros(after)
    return torch.cat([head, t, tail], dim=dim)


def seq_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the 'seq' axis, with a gradient (the sum's)."""
    if seq_size() <= 1:
        return t
    return _Sum.apply(t, current().group("seq"))


def whole_time(call, *ts, keep_block: bool = False):
    """call(*ts) on the whole time axis: each of ts gathered over 'seq'
    (None stays None) and the call run under `full_time`, every 'seq'
    rank repeating it; with `keep_block`, this rank's time block of its
    output (a layer inside a time-sharded model), else its output whole
    (a model's per-row outputs)."""
    if seq_size() <= 1:
        return call(*ts)
    full = [gather_seq(t) for t in ts]
    with full_time():
        out = call(*full)
    return seq_block(out) if keep_block else out


# ---------------------------------------------------------------- 'pipe'
def _exchange(t: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Sends t to group rank `to` and returns what group rank `frm` sends
    (a tensor of t's shape and dtype), the send and the receive posted
    together (a blocking send on every rank of a ring would wait
    forever); through the host for a card's tensor under gloo."""
    glob = (lambda i: i) if group is dist.group.WORLD else (
        lambda i: dist.get_global_rank(group, i))
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    src = (t.detach().cpu() if staged else t.detach()).contiguous()
    buf = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, glob(to), group),
        dist.P2POp(dist.irecv, buf, glob(frm), group)])
    for r in reqs:
        r.wait()
    return buf.to(t.device) if staged else buf


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, shift):
        ctx.args = (group, size, index, shift)
        return _exchange(x, group, (index + shift) % size,
                         (index - shift) % size)

    @staticmethod
    def backward(ctx, g):
        group, size, index, shift = ctx.args
        return (_exchange(g, group, (index - shift) % size,
                          (index + shift) % size), None, None, None, None)


def ppermute(x: torch.Tensor, mesh, axis: str = "pipe",
             shift: int = 1) -> torch.Tensor:
    """`lax.ppermute(x, axis, [(i, (i + shift) % S)])`: what the `axis`
    rank `shift` places before this one holds; the gradient rotates back.
    Every rank of the axis calls it, with tensors of one shape and
    dtype."""
    size = mesh.size(axis)
    if size <= 1 or shift % size == 0:
        return x
    return _Rotate.apply(x, mesh.group(axis), size, mesh.index(axis), shift)


class _FromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, last):
        ctx.last = last
        return broadcast_(x.detach().clone(), group, size - 1)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


def from_last(x: torch.Tensor, mesh, axis: str = "pipe") -> torch.Tensor:
    """The last `axis` rank's x on every rank (the pipeline's masked
    `psum`); the gradient reaches the last rank's x once and the other
    ranks' x not at all (the rule of the module docstring)."""
    size = mesh.size(axis)
    if size <= 1:
        return x
    return _FromLast.apply(x, mesh.group(axis), size,
                           mesh.index(axis) == size - 1)
