"""Carry variables between the JAX package's flax trees and the port's
modules, in both directions.

The port names its submodules after the flax scopes, so a flax path maps
to a PyTorch parameter or buffer name by a few renames (`TokenEmbedding_0`
-> `token_embedding`; `FullAttentionLayer_0`, and the encoder layer's
variants `DSAttentionLayer_0`, `ProbAttentionLayer_0` and
`LSHAttentionLayer_0` -> `attention`; `layer_<i>` -> `layers.<i>`) and by
the leaf's kind:

- Dense `kernel` (in, out)            -> Linear `weight`, transposed;
- Conv `kernel` (k, C_in, C_out)      -> Conv1d `weight`, transpose(2, 1, 0);
- Conv `kernel` (kh, kw, C_in/groups, C_out)
                                      -> Conv2d `weight`, transpose(3, 2, 0, 1);
- LayerNorm and BatchNorm `scale`     -> `weight`;
- `bias`, and the raw parameters `shapelets_<i>` (n, C, L),
  `threshold_<i>`, `bilinear_w`, `pos_embed`, the MoE experts'
  `expert_wi`/`expert_bi`/`expert_wo`/`expert_bo`, the Fourier and
  multiwavelet `weights_real`/`weights_imag`, ETSformer's
  `smoothing_weight`, `v0`, `z0` and `damping_factor`, the two-stage
  layer's `router` and Crossformer's `enc_pos_embedding` and
  `dec_pos_embedding` -> as they are;
- `batch_stats` `mean` and `var`      -> the BatchNorm's buffers.

The task heads' scopes need no rename: `dec_embedding`, each embedding's
`temporal_embedding` (a bias-free Dense), `decoder/layer_<i>/
{self_attention, cross_attention, norm1, norm2, norm3, conv1, conv2}`,
`decoder/{norm, projection}`, TimesNet's `predict_linear`, PatchTST's
`head`, and every scope of the extra families (models/extra; the seasonal
norm's auto-named `LayerNorm_0` included) are the port's attribute names
too.

`load_jax_variables` fills a module from {"params", "batch_stats"};
`load_jax_params` is its params-only case; `load_jax_seed_variables` fills
one module per seed from variables stacked on a leading seed axis (the JAX
package's EnsembleTrainer state). Every flax leaf is consumed
exactly once and every PyTorch parameter (and every BatchNorm buffer) is
filled: an unknown, duplicate or missing leaf, or a shape that differs,
raises `ParamLoadError`. Values are copied in place, so a captured CUDA
graph that reads them stays valid. `to_jax_params` and
`to_jax_variables` are the reverse: the same renames and transposes
undone, every tensor consumed exactly once, so a flax tree survives a load
and the reverse unchanged.

A params leaf may be a `quant.QTensor` (int8 `q`, f32 per-channel `scale`
along flax's last axis). Its q and scale take the f32 leaf's layout, so the
scale keeps broadcasting along the same axis (dim 0 of a Linear or Conv
weight, L of a shapelet bank), and the parameter becomes a `Dequantize`
parametrization: q and scale are what the module holds, and each use of
the weight computes q.float() * scale, the JAX package's
`dequantize_tensor`. Such a module has no f32 copy of the weight and is for
inference only.

A model split over a mesh's 'model' or 'expert' axis (parallel/mesh.py
`shard_params`) lists its split parameters in `tp_shards`: the flax tree
stays the full one (every expert, the whole d_ff). Loading (`_fill`,
`port_layout`) keeps this rank's block of each such leaf, and
`to_jax_tree` gathers every rank's blocks (a collective on every rank
of those axes), so checkpoints cross between the packages as before.

A pipeline stage (parallel/pipeline.py `encoder_stage`: L/S layers of
an `Encoder` and its `norm`) takes its layers from a flax `Encoder` tree
with `load_jax_stage` (stage s reads `layer_{s·L/S + i}` into its layer
i, and `norm`), and `gather_stage_params` gathers every stage back to
that tree (a collective over the 'pipe' axis).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Mapping as MappingT, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from sie_tpu_torch.models.layers import BatchNorm
from sie_tpu_torch.quant import QTensor


class ParamLoadError(ValueError):
    pass


_RENAMES = {"TokenEmbedding_0": "token_embedding",
            "FullAttentionLayer_0": "attention",
            "DSAttentionLayer_0": "attention",
            "ProbAttentionLayer_0": "attention",
            "LSHAttentionLayer_0": "attention"}


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    if isinstance(tree, QTensor):
        return {prefix: tree}
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def _scope(part: str) -> str:
    m = re.fullmatch(r"layer_(\d+)", part)
    if m:
        return f"layers.{m.group(1)}"
    return _RENAMES.get(part, part)


def _target(module: nn.Module, path: Tuple[str, ...],
            value: Any) -> Tuple[str, Any]:
    """The PyTorch parameter name for a flax leaf, and the value (an array
    or a QTensor, whose q and scale alike) laid out for it."""
    owner_name = ".".join(_scope(p) for p in path[:-1])
    leaf = path[-1]
    try:
        owner = module.get_submodule(owner_name) if owner_name else module
    except AttributeError:
        raise ParamLoadError(f"flax leaf {path} has no module "
                             f"{owner_name!r} in the port") from None
    if leaf == "kernel":
        if isinstance(owner, nn.Linear):
            lay = lambda v: v.T
        elif isinstance(owner, nn.Conv1d):
            lay = lambda v: v.transpose(2, 1, 0)
        elif isinstance(owner, nn.Conv2d):
            lay = lambda v: v.transpose(3, 2, 0, 1)
        else:
            raise ParamLoadError(f"flax kernel {path} maps to "
                                 f"{type(owner).__name__}, not a Linear or "
                                 f"Conv1d/Conv2d")
        value = (QTensor(lay(value.q), lay(value.scale))
                 if isinstance(value, QTensor) else lay(value))
        leaf = "weight"
    elif leaf == "scale":
        if not isinstance(owner, (nn.LayerNorm, BatchNorm)):
            raise ParamLoadError(f"flax scale {path} maps to "
                                 f"{type(owner).__name__}, not a LayerNorm "
                                 f"or BatchNorm")
        leaf = "weight"
    return (f"{owner_name}.{leaf}" if owner_name else leaf), value


def batch_stats_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: buffer} of every BatchNorm's running `mean` and `var` in
    `module`: the port's counterpart of flax's `batch_stats`."""
    return {f"{m}.{leaf}" if m else leaf: getattr(bn, leaf)
            for m, bn in module.named_modules() if isinstance(bn, BatchNorm)
            for leaf in ("mean", "var")}


class Dequantize(nn.Module):
    """Parametrization of a weight held as int8 `q` and f32 `scale` laid
    out like it: the weight is q.float() * scale, computed at each use."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self._pending = (q, scale)

    def forward(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return q.float() * scale

    def right_inverse(self, _):
        """The (q, scale) to hold, once, at registration: the weight cannot
        be assigned afterwards."""
        pending, self._pending = self._pending, None
        if pending is None:
            raise RuntimeError("a quantised weight cannot be assigned")
        return pending


def _hold_int8(module: nn.Module, name: str, value: QTensor) -> None:
    """Replaces parameter `name` by a `Dequantize` parametrization of
    value's q and scale; the f32 parameter is dropped."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    getattr(owner, leaf).requires_grad_(False)
    parametrize.register_parametrization(owner, leaf, Dequantize(
        torch.from_numpy(np.ascontiguousarray(value.q, np.int8)),
        torch.from_numpy(np.ascontiguousarray(value.scale, np.float32))))


def is_quantized(module: nn.Module) -> bool:
    """True when a weight of `module` is held as int8 (`Dequantize`)."""
    return any(isinstance(m, Dequantize) for m in module.modules())


def _local(module: nn.Module, name: str, value: Any) -> Any:
    """This rank's block of a full leaf laid out for parameter `name`, when
    `module` splits it over 'model' or 'expert'; else the value as it
    is."""
    shard = getattr(module, "tp_shards", {}).get(name)
    if shard is None:
        return value
    if isinstance(value, QTensor):
        raise ParamLoadError(f"{name!r} is split over a mesh; an int8 "
                             f"leaf cannot be loaded into it")
    return shard.local(value)


def _fill(module: nn.Module, tree: Any, targets: Dict[str, torch.Tensor],
          what: str) -> None:
    """Copies every leaf of the flax tree into its target tensor in place
    (a QTensor leaf becomes a `Dequantize` parametrization); each target
    filled exactly once."""
    filled: Dict[str, Tuple[str, ...]] = {}
    with torch.no_grad():
        for path, value in _flatten(tree).items():
            name, value = _target(module, path, value)
            value = _local(module, name, value)
            if name not in targets:
                raise ParamLoadError(f"flax leaf {path} has no {what} "
                                     f"{name!r} in the port")
            if name in filled:
                raise ParamLoadError(f"flax leaves {filled[name]} and {path} "
                                     f"both map to {name!r}")
            t = targets[name]
            if tuple(value.shape) != tuple(t.shape):
                raise ParamLoadError(f"flax leaf {path} has shape "
                                     f"{value.shape}; {name!r} has "
                                     f"{tuple(t.shape)}")
            if isinstance(value, QTensor):
                if not isinstance(t, nn.Parameter):
                    raise ParamLoadError(f"flax leaf {path} is quantised; "
                                         f"only parameters can be")
                _hold_int8(module, name, value)
            else:
                t.copy_(torch.tensor(value, dtype=torch.float32))
            filled[name] = path
    missing = sorted(set(targets) - set(filled))
    if missing:
        raise ParamLoadError(f"no flax leaf filled {len(missing)} {what}s, "
                             f"e.g. {missing[:6]}")


def load_jax_params(module: nn.Module, params: Any) -> nn.Module:
    """Fill `module`'s parameters from the flax parameter tree `params`
    (the value of `variables["params"]`, as numpy arrays or anything numpy
    reads). BatchNorm buffers are left as they are."""
    _fill(module, params, dict(module.named_parameters()), "parameter")
    return module


def load_jax_variables(module: nn.Module, variables: MappingT[str, Any]
                       ) -> nn.Module:
    """Fill `module` from flax variables {"params": ..., "batch_stats":
    ...}: the parameters, and every BatchNorm's running mean and variance
    (a model without BatchNorm takes an empty or absent batch_stats)."""
    load_jax_params(module, variables["params"])
    _fill(module, variables.get("batch_stats", {}),
          batch_stats_buffers(module), "batch_stats buffer")
    return module


def _seed_slice(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _seed_slice(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def load_jax_seed_variables(modules, variables: MappingT[str, Any]) -> None:
    """Flax variables {"params", "batch_stats"} stacked on a leading seed
    axis (the JAX package's EnsembleTrainer state, N seeds) into
    `modules`, slice i into modules[i] by `load_jax_variables`: every leaf
    must hold N slices, and each slice is consumed exactly once."""
    n = len(modules)
    for part in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(part, {})).items():
            if np.ndim(leaf) == 0 or np.shape(leaf)[0] != n:
                raise ParamLoadError(f"{part} leaf {path} of shape "
                                     f"{np.shape(leaf)} holds no {n} seeds")
    for i, module in enumerate(modules):
        load_jax_variables(module, _seed_slice(variables, i))


def port_layout(module: nn.Module, tree: Any) -> Dict[str, np.ndarray]:
    """{PyTorch parameter name: array laid out for it} of a flax-shaped
    tree (params, or a per-parameter state such as Adam's moments)."""
    out = dict(_target(module, path, np.asarray(v))
               for path, v in _flatten(tree).items())
    return {k: _local(module, k, v) for k, v in out.items()}


# the port's module class behind each renamed flax scope
_KINDS = {"TokenEmbedding_0": "TokenEmbedding",
          "FullAttentionLayer_0": "FullAttentionLayer",
          "DSAttentionLayer_0": "DSAttentionLayer",
          "ProbAttentionLayer_0": "ProbAttentionLayer",
          "LSHAttentionLayer_0": "LSHAttentionLayer"}


def _flax_scope(part: str, child: nn.Module) -> str:
    """The flax scope name of the port's submodule `part` (`child`)."""
    for flax_name, port_name in _RENAMES.items():
        if part == port_name and type(child).__name__ == _KINDS[flax_name]:
            return flax_name
    return part


def to_jax_tree(module: nn.Module,
                tensors: MappingT[str, torch.Tensor]) -> Dict[str, Any]:
    """The flax-layout tree (nested dicts of float32 numpy arrays) of
    tensors keyed by `module`'s parameter or buffer names: the parameters
    themselves, state of the same shapes, or the BatchNorm buffers."""
    tree: Dict[str, Any] = {}
    shards = getattr(module, "tp_shards", {})
    for name, value in tensors.items():
        if name in shards:
            value = shards[name].gather(value)
        parts = name.split(".")
        owner, path = module, []
        for part in parts[:-1]:
            child = getattr(owner, part)
            if isinstance(owner, nn.ModuleList):
                path[-1] = f"layer_{part}"    # "layers", "<i>" -> "layer_<i>"
            else:
                path.append(_flax_scope(part, child))
            owner = child
        leaf = parts[-1]
        value = value.detach().float().cpu().numpy()
        if leaf == "weight" and isinstance(owner, nn.Linear):
            leaf, value = "kernel", value.T
        elif leaf == "weight" and isinstance(owner, nn.Conv1d):
            leaf, value = "kernel", value.transpose(2, 1, 0)
        elif leaf == "weight" and isinstance(owner, nn.Conv2d):
            leaf, value = "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "weight" and isinstance(owner, (nn.LayerNorm,
                                                     BatchNorm)):
            leaf = "scale"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if leaf in node:
            raise ParamLoadError(f"{name!r} maps to the flax leaf "
                                 f"{tuple(path) + (leaf,)} twice")
        # a copy: on the CPU .numpy() shares the tensor's memory, which the
        # optimizer then moves in place
        node[leaf] = np.array(value, order="C", copy=True)
    return _sorted(tree)


def _sorted(tree):
    """Nested dicts with their keys in sorted order, as a flax tree holds
    them after any jax.tree operation: a checkpoint written from it then
    has the JAX package's bytes."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def to_jax_params(module: nn.Module) -> Dict[str, Any]:
    """`module`'s parameters as the flax `params` tree that
    `load_jax_params` reads and the JAX package's models apply."""
    return to_jax_tree(module, dict(module.named_parameters()))


def to_jax_variables(module: nn.Module) -> Dict[str, Any]:
    """`module`'s variables as the flax tree {"params": ..., "batch_stats":
    ...} that `load_jax_variables` reads and the JAX package's models
    apply; batch_stats is {} for a model without BatchNorm, as the JAX
    package writes it."""
    return {"params": to_jax_params(module),
            "batch_stats": to_jax_tree(module, batch_stats_buffers(module))}


def _stage_layers(encoder_params: MappingT[str, Any], n_stages: int) -> int:
    names = set(encoder_params)
    n = sum(1 for k in names if re.fullmatch(r"layer_\d+", k))
    want = {f"layer_{i}" for i in range(n)} | {"norm"}
    if names != want:
        raise ParamLoadError(f"an Encoder tree holds layer_0..layer_<L-1> "
                             f"and norm; got {sorted(names)}")
    if n % n_stages:
        raise ParamLoadError(f"{n} layers do not split into {n_stages} "
                             f"equal stages")
    return n // n_stages


def load_jax_stage(stage: nn.Module, encoder_params: MappingT[str, Any],
                   stage_index: int, n_stages: int) -> nn.Module:
    """Fill a pipeline stage (an `Encoder` of L/S layers) from the params
    of a flax `Encoder` of L layers: layer_{s·L/S + i} into its layer i,
    and `norm`. Every leaf of those scopes is consumed exactly once and
    every parameter of the stage filled (`load_jax_params`)."""
    per = _stage_layers(encoder_params, n_stages)
    if len(stage.layers) != per:
        raise ParamLoadError(f"a stage of {len(stage.layers)} layers; the "
                             f"tree gives {per} a stage")
    sub = {f"layer_{i}": encoder_params[f"layer_{stage_index * per + i}"]
           for i in range(per)}
    return load_jax_params(stage, dict(sub, norm=encoder_params["norm"]))


def gather_stage_params(stage: nn.Module, mesh, axis: str = "pipe"
                        ) -> Dict[str, Any]:
    """The flax `Encoder` params of every `axis` rank's stage: stage s's
    layer i becomes layer_{s·L/S + i}; `norm` is this rank's (the same on
    every rank). A collective on every rank of the axis."""
    from sie_tpu_torch.parallel import comm
    own = to_jax_params(stage)
    per, n = len(stage.layers), mesh.size(axis)
    leaves = _flatten({k: v for k, v in own.items() if k != "norm"})
    keys = sorted(leaves)
    flat = torch.from_numpy(np.concatenate(
        [leaves[k].reshape(-1) for k in keys]).astype(np.float32)).to(
            next(stage.parameters()).device)
    parts = (comm.all_gather(flat, mesh.group(axis), n) if n > 1
             else flat[None]).cpu().numpy()
    out: Dict[str, Any] = {"norm": own["norm"]}
    sizes = np.cumsum([0] + [leaves[k].size for k in keys])
    for s in range(n):
        for k, lo, hi in zip(keys, sizes[:-1], sizes[1:]):
            i = int(k[0][len("layer_"):])
            node = out.setdefault(f"layer_{s * per + i}", {})
            for p in k[1:-1]:
                node = node.setdefault(p, {})
            node[k[-1]] = parts[s, lo:hi].reshape(leaves[k].shape).copy()
    return _sorted(out)
