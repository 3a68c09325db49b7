"""Device meshes (counterpart of sie_tpu/parallel/mesh.py): data
parallelism over the 'data' axis, tensor parallelism over 'model',
sequence parallelism over 'seq', expert parallelism over 'expert' and
the pipeline stages of parallel/pipeline.py over 'pipe'.

A process mesh has one process a card (parallel/multihost.py starts them)
laid out in `cfg.mesh_axes` order: rank = the row-major index of its mesh
coordinates, with one torch.distributed group per axis (the ranks that
differ only along it). A mesh built from `devices=[...]` is a
single-process mesh over this process's devices, for serving
(serve.Predictor).

The rules of the JAX package (`params_partition_specs`, unchanged) say
which parameters GSPMD shards. The port's shards give the same numbers
without copying that layout: under 'model' it splits
- each SBM bank `shapelets_<i>` and `threshold_<i>` on n (K1/K2, or K3/K4,
  over this rank's n/M shapelets of every bank; the predicates are
  gathered back into bank-major order);
- the full attention's `query`, `key`, `value` column-parallel (H/M heads
  a rank, K5/K6 over B·H/M rows) and `out` row-parallel;
- the dense encoder FFN's `conv1` column-parallel and `conv2`
  row-parallel;
under 'expert' it gives each rank E/X of the MoE experts (`expert_wi`,
`expert_bi`, `expert_wo`, `expert_bo` on their expert axis; with 'model'
too, d_ff split as `expert_wi` P('expert', None, 'model'), `expert_bi`
P('expert', 'model'), `expert_wo` P('expert', 'model', None));
and replicates everything else (under 'seq' and 'pipe' nothing is
split: as in the JAX Trainer, 'pipe' is replication there, and only
parallel/pipeline.py gives its ranks different work).
`shard_params` makes the split in place and records it in the model's
`tp_shards` ({parameter name: Shard}), which compat/from_jax.py reads: a
checkpoint is gathered to the full flax layout (`gather_params`) and read
back by slicing, so it crosses between the packages as before. Adam's
state takes the shards' shapes because the trainer builds its optimizer
after sharding.

Batches: `cfg.batch_size` is the global batch, as in the JAX package; a
rank takes its row block (B divisible by the 'data' size) and, under
'seq', the block of axis 1 (time) of every array of rank 2 or more (T
divisible by the 'seq' size, where the JAX package's `device_put`
raises too): `shard_batch`, `data_block`, `seq_block`. 'model',
'expert' and 'pipe' ranks take the same rows.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.parallel import comm

AXES = ("data", "model", "seq", "expert", "pipe")


class PartitionSpec(tuple):
    """A tuple of axis names (or None) per array dimension, as
    jax.sharding.PartitionSpec lists them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """`shape` over `axis_names`. Without `devices`: a process mesh over
    the initialised torch.distributed world, which must hold exactly
    prod(shape) processes. With `devices`: a single-process mesh over the
    first prod(shape) of them (no groups)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence[Any]] = None):
        shape = tuple(int(s) for s in shape)
        axes = tuple(axis_names)[: len(shape)]
        if len(axes) != len(shape):
            raise ValueError(f"mesh {shape} needs {len(shape)} axis names; "
                             f"got {tuple(axis_names)}")
        for a in axes:
            if a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r}; one of {AXES}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        n = int(np.prod(shape))
        self._groups: Dict[str, Any] = {}
        self._coords: Dict[str, int] = {a: 0 for a in axes}
        if devices is not None:
            if n > len(devices):
                raise ValueError(f"mesh {shape} needs {n} devices, have "
                                 f"{len(devices)}")
            flat = np.empty(n, dtype=object)
            flat[:] = [torch.device(d) for d in list(devices)[:n]]
            self.devices = flat.reshape(shape)
            self.world = 1
            return
        self.devices = None
        if not dist.is_initialized():
            raise ValueError(f"a process mesh {shape} needs torch.distributed "
                             f"initialised (parallel/multihost.py "
                             f"init_distributed) with {n} processes")
        self.world = dist.get_world_size()
        if self.world != n:
            raise ValueError(f"mesh {shape} needs {n} processes (one a "
                             f"device), have {self.world}")
        rank = dist.get_rank()
        grid = np.arange(n).reshape(shape)
        self._coords = dict(zip(axes, (int(c) for c in
                                       np.unravel_index(rank, shape))))
        # every rank creates every group, in the same order
        for name in AXES:
            if name not in axes:
                rows = grid.reshape(-1, 1)
            else:
                i = axes.index(name)
                rows = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
            if rows.shape[1] == n:
                self._groups[name] = dist.group.WORLD
                continue
            for row in rows:
                g = dist.new_group(ranks=[int(r) for r in row])
                if rank in row:
                    self._groups[name] = g

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This process's coordinate along `axis` (0 when absent)."""
        return self._coords.get(axis, 0)

    def group(self, axis: str):
        if self.devices is not None:
            raise ValueError("a single-process mesh has no process groups")
        return self._groups[axis]

    @property
    def backend(self) -> str:
        return dist.get_backend() if self.devices is None else "none"

    def __deepcopy__(self, memo):
        return self     # groups are not copied with a module that holds one

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(cfg: Config, devices: Optional[Sequence[Any]] = None
              ) -> Optional[Mesh]:
    """None when prod(cfg.mesh_shape) <= 1; else the process mesh over the
    torch.distributed world, or with `devices` a single-process mesh over
    them. Too few devices (processes) raise ValueError, as in the JAX
    package."""
    shape = tuple(cfg.mesh_shape)
    if not shape or int(np.prod(shape)) <= 1:
        return None
    n = int(np.prod(shape))
    if devices is None:
        have = dist.get_world_size() if dist.is_initialized() else 1
        if n > have:
            raise ValueError(f"mesh {shape} needs {n} devices, have {have}")
    return Mesh(shape, cfg.mesh_axes, devices=devices)


def _axis(mesh, name: str) -> Optional[str]:
    return name if name in mesh.axis_names else None


def params_partition_specs(params: Any, mesh) -> Any:
    """The JAX package's rule-based PartitionSpec tree for a flax-layout
    params tree (nested dicts, e.g. `to_jax_params(model)`)."""
    model = _axis(mesh, "model")
    expert = _axis(mesh, "expert")

    def rule(names: Tuple[str, ...], leaf) -> PartitionSpec:
        ndim = np.ndim(leaf)
        joined = "/".join(names)
        if expert is not None and names and names[-1].startswith(
                "expert_") and ndim >= 1:
            last = names[-1]
            if last == "expert_wi" and ndim == 3:
                return P(expert, None, model)
            if last == "expert_wo" and ndim == 3:
                return P(expert, model, None)
            if last == "expert_bi" and ndim == 2:
                return P(expert, model)
            return P(*([expert] + [None] * (ndim - 1)))
        if model is None or ndim == 0:
            return P()
        if "shapelets_" in joined and ndim == 3:
            return P(model, None, None)
        if "threshold_" in joined and ndim == 2:
            return P(model, None)
        if names and names[-1] == "kernel" and ndim == 2:
            parent = names[-2] if len(names) >= 2 else ""
            if parent in ("conv1", "query", "key", "value", "q", "k", "v",
                          "linear1"):
                return P(None, model)
            if parent in ("conv2", "out", "out_proj", "linear2",
                          "output_layer"):
                return P(model, None)
        return P()

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        return rule(path, tree)

    return walk(params, ())


# ------------------------------------------------------------ the shards
class Shard(NamedTuple):
    """A parameter split over mesh axes: `cuts` lists (axis, dim) pairs,
    each splitting `dim` in `mesh.size(axis)` equal blocks of which this
    rank holds block `mesh.index(axis)`, applied in order."""
    cuts: Tuple[Tuple[str, int], ...]
    mesh: Mesh

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.cuts)

    def local(self, a: np.ndarray) -> np.ndarray:
        """This rank's block of the full array `a` (port layout)."""
        for axis, dim in self.cuts:
            m, i = self.mesh.size(axis), self.mesh.index(axis)
            n = a.shape[dim]
            if n % m:
                raise ValueError(f"dimension {dim} of size {n} does not "
                                 f"split over {m} {axis!r} ranks")
            a = np.take(a, np.arange(i * (n // m), (i + 1) * (n // m)),
                        axis=dim)
        return a

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of every rank's block (a collective)."""
        with torch.no_grad():
            for axis, dim in reversed(self.cuts):
                parts = comm.all_gather(t.detach(), self.mesh.group(axis),
                                        self.mesh.size(axis))
                t = torch.cat(parts.unbind(0), dim=dim)
        return t


def _split(module: nn.Module, attr: str, dim: int, mesh: Mesh,
           prefix: str, shards: Dict[str, Shard],
           axes: Tuple[str, ...] = ("model",)) -> None:
    """Parameter `attr` of `module` cut to this rank's block over each of
    `axes` (all along `dim`, or with dims given as (axis, dim) pairs)."""
    p = getattr(module, attr)
    cuts = tuple(a if isinstance(a, tuple) else (a, dim) for a in axes)
    block = p.detach()
    for axis, d in cuts:
        m, i = mesh.size(axis), mesh.index(axis)
        n = block.shape[d]
        if n % m:
            raise ValueError(f"{prefix}{attr} has {n} rows along dimension "
                             f"{d}, which do not split over {m} {axis!r} "
                             f"ranks")
        block = block.narrow(d, i * (n // m), n // m)
    setattr(module, attr, nn.Parameter(block.clone(),
                                       requires_grad=p.requires_grad))
    shards[f"{prefix}{attr}"] = Shard(cuts, mesh)


def _split_linear(lin: nn.Linear, dim: int, mesh: Mesh, prefix: str,
                  shards: Dict[str, Shard], bias: bool) -> None:
    _split(lin, "weight", dim, mesh, prefix, shards)
    if bias and lin.bias is not None:
        _split(lin, "bias", 0, mesh, prefix, shards)
    lin.out_features, lin.in_features = lin.weight.shape


def shard_params(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Splits, in place, the parameters of the layers the port runs over
    'model' or 'expert' (module docstring) into this rank's blocks; sets
    each such layer's `tp` (or a MoE layer's `ep`) to the mesh and the
    model's `tp_shards`. The identity when the mesh has no 'model' or
    'expert' axis of more than one member."""
    from sie_tpu_torch.models.layers import EncoderLayer, FullAttentionLayer
    from sie_tpu_torch.models.moe import MoEFFN
    from sie_tpu_torch.models.sbm import ShapeBottleneckModel
    if mesh is None or (mesh.size("model") <= 1
                        and mesh.size("expert") <= 1):
        return model
    m = mesh.size("model")
    shards: Dict[str, Shard] = {}
    for name, mod in list(model.named_modules()):
        pre = f"{name}." if name else ""
        if isinstance(mod, MoEFFN):
            if "expert" in mesh.axis_names:
                _split_experts(mod, mesh, pre, shards)
            continue
        if m <= 1:
            continue
        if isinstance(mod, ShapeBottleneckModel):
            for i in range(len(mod.lengths)):
                _split(mod, f"shapelets_{i}", 0, mesh, pre, shards)
                if mod.variant == "lts":
                    _split(mod, f"threshold_{i}", 0, mesh, pre, shards)
            mod.tp = mesh
        elif isinstance(mod, FullAttentionLayer):
            if mod.n_heads % m:
                raise ValueError(f"{mod.n_heads} heads do not split over "
                                 f"{m} 'model' ranks")
            for lin in ("query", "key", "value"):
                _split_linear(getattr(mod, lin), 0, mesh, f"{pre}{lin}.",
                              shards, bias=True)
            _split_linear(mod.out, 1, mesh, f"{pre}out.", shards, bias=False)
            mod.tp = mesh
        elif isinstance(mod, EncoderLayer) and hasattr(mod, "conv1"):
            _split_linear(mod.conv1, 0, mesh, f"{pre}conv1.", shards,
                          bias=True)
            _split_linear(mod.conv2, 1, mesh, f"{pre}conv2.", shards,
                          bias=False)
            mod.tp = mesh
    model.tp_shards = shards
    return model


def _split_experts(mod, mesh: Mesh, pre: str,
                   shards: Dict[str, Shard]) -> None:
    """A MoE layer's expert stacks cut to this rank's E/X experts and,
    with 'model' too, its d_ff block (the JAX package's rules)."""
    x, m = mesh.size("expert"), mesh.size("model")
    if mod.n_experts % x:
        raise ValueError(f"{mod.n_experts} experts do not split over {x} "
                         f"'expert' ranks")
    ff = m > 1
    for attr, cuts in (
            ("expert_wi", (("expert", 0),) + ((("model", 2),) if ff else ())),
            ("expert_bi", (("expert", 0),) + ((("model", 1),) if ff else ())),
            ("expert_wo", (("expert", 0),) + ((("model", 1),) if ff else ())),
            ("expert_bo", (("expert", 0),))):
        _split(mod, attr, 0, mesh, pre, shards, axes=cuts)
    mod.ep = mesh


def _broadcast(tensors, mesh: Mesh, axis: str) -> None:
    with torch.no_grad():
        for t in tensors:
            comm.broadcast_(t.data, mesh.group(axis), 0)


def replicate(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Every parameter and buffer broadcast from index 0 of its 'data'
    group (and of its 'seq' and 'pipe' groups; over 'expert', every one
    but the experts), so that every replica starts from the same state."""
    if mesh is None or mesh.devices is not None:
        return model
    tensors = list(model.parameters()) + list(model.buffers())
    _broadcast(tensors, mesh, "data")
    for axis in ("seq", "pipe"):
        if mesh.size(axis) > 1:
            _broadcast(tensors, mesh, axis)
    if mesh.size("expert") > 1:
        shards = getattr(model, "tp_shards", {})
        local = {id(p) for n, p in model.named_parameters()
                 if n in shards and "expert" in shards[n].axes}
        _broadcast([t for t in tensors if id(t) not in local], mesh,
                   "expert")
    return model


def shard_state(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """A freshly built model made ready for `mesh`: parameters split over
    'model' and 'expert' (`shard_params`), then replicated over the other
    axes. Build the optimizer afterwards, so its state takes the shards'
    shapes."""
    return replicate(shard_params(model, mesh), mesh)


def gather_params(model: nn.Module) -> Dict[str, Any]:
    """The full flax params tree of a (possibly 'model'- or
    'expert'-sharded) model: a collective on every such rank."""
    from sie_tpu_torch.compat.from_jax import to_jax_params
    return to_jax_params(model)


# ------------------------------------------------------------ batches
class LocalBatch(tuple):
    """A batch that already holds only this rank's rows
    (`Trainer.device_batch_from_local`)."""


def data_block(b: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of b."""
    if mesh is None:
        return slice(0, b)
    dp, i = mesh.size("data"), mesh.index("data")
    if b % dp:
        raise ValueError(f"a batch of {b} rows does not split over {dp} "
                         f"'data' ranks; make the batch size a multiple")
    return slice(i * (b // dp), (i + 1) * (b // dp))


def seq_block(t: int, mesh: Optional[Mesh]) -> slice:
    """This rank's steps of a time axis of t (all of them without 'seq')."""
    s = 1 if mesh is None else mesh.size("seq")
    if s <= 1:
        return slice(0, t)
    if t % s:
        raise ValueError(f"a time axis of {t} steps should be divisible by "
                         f"{s}, the 'seq' size of the mesh")
    i = mesh.index("seq")
    return slice(i * (t // s), (i + 1) * (t // s))


def cut_time(a, mesh: Optional[Mesh]):
    """This rank's time block (axis 1) of an array of rank 2 or more; a
    rank-1 array as it is (the JAX package's `_batch_specs`)."""
    if mesh is None or mesh.size("seq") <= 1 or np.ndim(a) < 2:
        return a
    return a[:, seq_block(a.shape[1], mesh)]


def shard_batch(batch: Tuple, mesh: Optional[Mesh]) -> Tuple:
    """This rank's row block, and under 'seq' its time block, of every
    array of a global batch."""
    if mesh is None or isinstance(batch, LocalBatch):
        return tuple(batch)
    sl = data_block(len(batch[0]), mesh)
    return LocalBatch(cut_time(b[sl], mesh) for b in batch)


def mesh_spans_processes(mesh: Optional[Mesh]) -> bool:
    """True when the mesh is a process mesh of several processes: each one
    feeds only its rows."""
    return mesh is not None and mesh.devices is None and mesh.world > 1


def is_writer(mesh: Optional[Mesh]) -> bool:
    """True on the process that writes files (checkpoints, CSVs, pickles):
    process 0 of a process mesh, and the only process otherwise."""
    return mesh is None or mesh.devices is not None or dist.get_rank() == 0
