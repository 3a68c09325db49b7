"""Import reference PyTorch checkpoints into the port's models: a copy of
sie_tpu/compat/torch_import.py on the port's flax-layout trees.

The reference saves ``model.state_dict()`` as ``checkpoint.pth``
(reference utils/tools.py:34-38) and reloads it at test time (reference
run.py:580-585). `convert_state_dict` turns such a state_dict into the flax
variables tree {"params", "batch_stats"} of the matching model by the JAX
package's per-model converters (key layouts cited there: the SBM with its
linear, bilinear and attention heads and LTS thresholds; InterpGN; FCN;
ResNet; the Transformer; TimesNet, whose per-branch Inception Conv2d
kernels are repacked into the tap table, one tap per (branch, dr, dc);
PatchTST, whose shared encoder sits under ``enc_scan/encoder``; EEGCNN
with its packed ``in_proj`` split into q/k/v),
checks it leaf for leaf against a template (`to_jax_variables(model)`):
every target leaf covered, each shape equal; and `load_into_model` loads it
with `load_jax_variables`, so ``python -m sie_tpu_torch.run
--import_torch_ckpt checkpoint.pth`` evaluates reference-trained weights.

Array layouts: Linear (out, in) -> Dense kernel (in, out); Conv1d (out, in,
K) -> (K, in, out); Conv2d (out, in/g, Kh, Kw) -> (Kh, Kw, in/g, out);
BatchNorm weight/bias/running_mean/running_var -> params scale/bias and
batch_stats mean/var. Source keys with no counterpart (sinusoidal position
tables, BN ``num_batches_tracked``, the temporal-embedding branch that the
classification forward never reads) are reported as ``unused``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from sie_tpu_torch.compat.from_jax import (_flatten, load_jax_variables,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.timesnet import _inception_taps

Array = np.ndarray
Flat = Dict[Tuple[str, ...], Array]   # ("params", "sbm", "shapelets_0") -> arr


class TorchImportError(ValueError):
    pass


# ---------------------------------------------------------------- primitives

def _linear(dst: Flat, scope: Tuple[str, ...], sd: Dict[str, Array],
            src: str, bias: bool = True) -> None:
    dst[scope + ("kernel",)] = sd.pop(src + ".weight").T
    if bias:
        dst[scope + ("bias",)] = sd.pop(src + ".bias")


def _conv1d(dst: Flat, scope: Tuple[str, ...], sd: Dict[str, Array],
            src: str, bias: bool = True) -> None:
    dst[scope + ("kernel",)] = sd.pop(src + ".weight").transpose(2, 1, 0)
    if bias:
        dst[scope + ("bias",)] = sd.pop(src + ".bias")


def _conv2d(dst: Flat, scope: Tuple[str, ...], sd: Dict[str, Array],
            src: str, bias: bool = False) -> None:
    dst[scope + ("kernel",)] = sd.pop(src + ".weight").transpose(2, 3, 1, 0)
    if bias:
        dst[scope + ("bias",)] = sd.pop(src + ".bias")


def _norm(dst: Flat, scope: Tuple[str, ...], sd: Dict[str, Array],
          src: str) -> None:
    """LayerNorm (weight/bias -> scale/bias)."""
    dst[scope + ("scale",)] = sd.pop(src + ".weight")
    dst[scope + ("bias",)] = sd.pop(src + ".bias")


def _batchnorm(dst: Flat, params_scope: Tuple[str, ...], sd: Dict[str, Array],
               src: str) -> None:
    """params_scope is under 'params'; the running stats go to batch_stats at
    the same sub-path."""
    _norm(dst, params_scope, sd, src)
    stats = ("batch_stats",) + params_scope[1:]
    dst[stats + ("mean",)] = sd.pop(src + ".running_mean")
    dst[stats + ("var",)] = sd.pop(src + ".running_var")
    sd.pop(src + ".num_batches_tracked", None)


# ------------------------------------------------------------------- models

def _convert_sbm(dst: Flat, sd: Dict[str, Array], cfg: Config,
                 scope: Tuple[str, ...], prefix: str) -> None:
    banks = [k for k in sd if re.fullmatch(
        re.escape(prefix) + r"shapelets\.\d+\.weights", k)]
    for key in banks:
        i = int(key[len(prefix):].split(".")[1])
        dst[scope + (f"shapelets_{i}",)] = sd.pop(key)
        thr = f"{prefix}shapelets.{i}.threshold"
        if thr in sd:  # LTS (reference Shapelet.py:94): (1, n, C) -> (n, C)
            dst[scope + (f"threshold_{i}",)] = sd.pop(thr)[0]
    _linear(dst, scope + ("output_layer",), sd, prefix + "output_layer",
            bias=False)
    if prefix + "output_bilinear.weight" in sd:
        # nn.Bilinear weight (out, in1, in2) == our (C, total, total)
        dst[scope + ("bilinear_w",)] = sd.pop(prefix + "output_bilinear.weight")
    if prefix + "attention.q_proj.weight" in sd:
        att = scope + ("attention",)
        _linear(dst, att + ("q_proj",), sd, prefix + "attention.q_proj")
        _linear(dst, att + ("k_proj",), sd, prefix + "attention.k_proj")
        dst[att + ("pos_embed",)] = sd.pop(prefix + "attention.pos_embed.weight")


def _convert_fcn(dst: Flat, sd: Dict[str, Array], scope: Tuple[str, ...],
                 prefix: str) -> None:
    for k in (1, 2, 3):
        _conv1d(dst, scope + (f"conv{k}",), sd, f"{prefix}block{k}.0")
        _batchnorm(dst, scope + (f"bn{k}",), sd, f"{prefix}block{k}.1")
    _linear(dst, scope + ("fc",), sd, prefix + "fc")


def _convert_resnet(dst: Flat, sd: Dict[str, Array], scope: Tuple[str, ...],
                    prefix: str) -> None:
    _conv1d(dst, scope + ("conv1",), sd, prefix + "conv1", bias=False)
    _batchnorm(dst, scope + ("bn1",), sd, prefix + "bn1")
    for k in (1, 2, 3):
        blk = f"{prefix}layer{k}.0."
        lscope = scope + (f"layer{k}",)
        for c in ("conv1", "conv2"):
            _conv1d(dst, lscope + (c,), sd, blk + c, bias=False)
        for b in ("bn1", "bn2"):
            _batchnorm(dst, lscope + (b,), sd, blk + b)
        if blk + "shortcut.0.weight" in sd:
            _conv1d(dst, lscope + ("short_conv",), sd, blk + "shortcut.0",
                    bias=False)
            _batchnorm(dst, lscope + ("short_bn",), sd, blk + "shortcut.1")
    _linear(dst, scope + ("fc",), sd, prefix + "fc")


def _convert_encoder(dst: Flat, sd: Dict[str, Array], scope: Tuple[str, ...],
                     prefix: str, e_layers: int) -> None:
    """TSlib Encoder stack (reference Transformer_EncDec.py:27-80 +
    SelfAttention_Family.py:179-213). scope points at our `encoder`."""
    for i in range(e_layers):
        lt = f"{prefix}attn_layers.{i}."
        ls = scope + (f"layer_{i}",)
        att = ls + ("FullAttentionLayer_0",)
        for ours, theirs in (("query", "query_projection"),
                             ("key", "key_projection"),
                             ("value", "value_projection"),
                             ("out", "out_projection")):
            _linear(dst, att + (ours,), sd, lt + "attention." + theirs)
        for c in ("conv1", "conv2"):  # kernel-1 Conv1d == Dense
            w = sd.pop(lt + c + ".weight")
            dst[ls + (c, "kernel")] = w[:, :, 0].T
            dst[ls + (c, "bias")] = sd.pop(lt + c + ".bias")
        _norm(dst, ls + ("norm1",), sd, lt + "norm1")
        _norm(dst, ls + ("norm2",), sd, lt + "norm2")
    _norm(dst, scope + ("norm",), sd, prefix + "norm")


def _drop_unreachable_embedding(sd: Dict[str, Array], prefix: str,
                                unused: List[str]) -> None:
    """Temporal-embedding params are saved by the reference but unreachable
    from the classification forward (x_mark is None — reference
    model/Transformer.py:101); position tables are buffers."""
    for k in list(sd):
        if k.startswith(prefix + "enc_embedding.temporal_embedding.") or \
                k.endswith("position_embedding.pe") or k.endswith(".pe"):
            sd.pop(k)
            unused.append(k)


def _convert_transformer(dst: Flat, sd: Dict[str, Array], cfg: Config,
                         scope: Tuple[str, ...], prefix: str,
                         unused: List[str]) -> None:
    _conv1d(dst, scope + ("enc_embedding", "TokenEmbedding_0", "tokenConv"),
            sd, prefix + "enc_embedding.value_embedding.tokenConv", bias=False)
    _drop_unreachable_embedding(sd, prefix, unused)
    _convert_encoder(dst, sd, scope + ("encoder",), prefix + "encoder.",
                     cfg.e_layers)
    _linear(dst, scope + ("projection",), sd, prefix + "projection")


def _convert_eegcnn(dst: Flat, sd: Dict[str, Array], cfg: Config,
                    unused: List[str]) -> None:
    cnn = ("params", "eegcnn")
    pre = "eegcnn."
    _conv2d(dst, cnn + ("block1_conv1",), sd, pre + "block1_conv1")
    _batchnorm(dst, cnn + ("block1_bn1",), sd, pre + "block1_bn1")
    _conv2d(dst, cnn + ("block1_depthwise",), sd, pre + "block1_depthwise")
    _batchnorm(dst, cnn + ("block1_bn2",), sd, pre + "block1_bn2")
    _conv2d(dst, cnn + ("block2_conv1",), sd, pre + "block2_conv1")
    _conv2d(dst, cnn + ("block2_conv2",), sd, pre + "block2_conv2")
    _batchnorm(dst, cnn + ("block2_bn",), sd, pre + "block2_bn")
    if "cnn_projection.weight" in sd:
        _linear(dst, ("params", "cnn_projection"), sd, "cnn_projection")
    for i in range(cfg.eegcnn_layers):
        lt = f"transformer_encoder.layers.{i}."
        ls = ("params", f"encoder_{i}")
        inw, inb = sd.pop(lt + "self_attn.in_proj_weight"), \
            sd.pop(lt + "self_attn.in_proj_bias")
        d = inw.shape[1]
        for j, name in enumerate(("q", "k", "v")):
            dst[ls + (name, "kernel")] = inw[j * d:(j + 1) * d].T
            dst[ls + (name, "bias")] = inb[j * d:(j + 1) * d]
        _linear(dst, ls + ("out_proj",), sd, lt + "self_attn.out_proj")
        _linear(dst, ls + ("linear1",), sd, lt + "linear1")
        _linear(dst, ls + ("linear2",), sd, lt + "linear2")
        _norm(dst, ls + ("norm1",), sd, lt + "norm1")
        _norm(dst, ls + ("norm2",), sd, lt + "norm2")
    _linear(dst, ("params", "classifier"), sd, "classifier")
    for k in list(sd):  # sinusoidal pos-encoding buffer
        if "pos_encoder" in k or k.endswith(".pe"):
            sd.pop(k)
            unused.append(k)


def _convert_timesnet(dst: Flat, sd: Dict[str, Array], cfg: Config,
                      scope: Tuple[str, ...], prefix: str,
                      unused: List[str]) -> None:
    taps = _inception_taps(cfg.num_kernels)
    _conv1d(dst, scope + ("enc_embedding", "TokenEmbedding_0", "tokenConv"),
            sd, prefix + "enc_embedding.value_embedding.tokenConv", bias=False)
    _drop_unreachable_embedding(sd, prefix, unused)
    for b in range(cfg.e_layers):
        for ours, theirs in (("conv1", "conv.0"), ("conv2", "conv.2")):
            branches = [sd.pop(f"{prefix}model.{b}.{theirs}.kernels.{ki}.weight")
                        for ki in range(cfg.num_kernels)]
            biases = [sd.pop(f"{prefix}model.{b}.{theirs}.kernels.{ki}.bias")
                      for ki in range(cfg.num_kernels)]
            # every (dr, dc) of every odd kernel is one tap: a bijection
            tap_w = np.stack([
                branches[ki][:, :, dr + ki, dc + ki].T
                for ki, dr, dc in taps])
            cscope = scope + (f"block_{b}", ours)
            dst[cscope + ("tap_weights",)] = tap_w
            dst[cscope + ("bias",)] = np.stack(biases)
    _norm(dst, scope + ("layer_norm",), sd, prefix + "layer_norm")
    _linear(dst, scope + ("projection",), sd, prefix + "projection")


def _convert_patchtst(dst: Flat, sd: Dict[str, Array], cfg: Config,
                      scope: Tuple[str, ...], prefix: str,
                      unused: List[str]) -> None:
    _linear(dst, scope + ("value_embedding",), sd,
            prefix + "patch_embedding.value_embedding", bias=False)
    _drop_unreachable_embedding(sd, prefix, unused)
    _convert_encoder(dst, sd, scope + ("enc_scan", "encoder"),
                     prefix + "encoder.", cfg.e_layers)
    _linear(dst, scope + ("projection",), sd, prefix + "projection")


_DNN_CONVERTERS = {
    "FCN": lambda dst, sd, cfg, scope, prefix, unused:
        _convert_fcn(dst, sd, scope, prefix),
    "ResNet": lambda dst, sd, cfg, scope, prefix, unused:
        _convert_resnet(dst, sd, scope, prefix),
    "Transformer": _convert_transformer,
    "TimesNet": _convert_timesnet,
    "PatchTST": _convert_patchtst,
}


# --------------------------------------------------------------- entry point

def _numpy(v) -> Array:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def convert_state_dict(state_dict, cfg: Config, variables):
    """Convert a reference state_dict into the flax variables tree of the
    matching model.

    state_dict: torch name -> tensor/ndarray (a ``module.`` DataParallel
    prefix is stripped). variables: the template, a nested dict such as
    `to_jax_variables(model)`; every leaf must be produced by the
    conversion with an identical shape. Returns (new_variables,
    unused_source_keys).
    """
    sd = {k[len("module."):] if k.startswith("module.") else k: _numpy(v)
          for k, v in state_dict.items()}
    dst: Flat = {}
    unused: List[str] = []

    def dnn(scope: Tuple[str, ...], prefix: str) -> None:
        if cfg.dnn_type not in _DNN_CONVERTERS:
            raise TorchImportError(
                f"no torch importer for dnn_type={cfg.dnn_type!r} "
                f"(reference backbones: {sorted(_DNN_CONVERTERS)})")
        _DNN_CONVERTERS[cfg.dnn_type](dst, sd, cfg, scope, prefix, unused)

    if cfg.model in ("SBM", "LTS"):
        _convert_sbm(dst, sd, cfg, ("params",), "")
    elif cfg.model == "InterpGN":
        _convert_sbm(dst, sd, cfg, ("params", "sbm"), "sbm.")
        dnn(("params", "deep_model"), "deep_model.")
    elif cfg.model == "DNN":
        dnn(("params", "backbone"), "")
    elif cfg.model == "EEGCNN":
        _convert_eegcnn(dst, sd, cfg, unused)
    else:
        raise TorchImportError(f"no torch importer for model={cfg.model!r}")

    flat_t = _flatten(variables)
    missing = [p for p in flat_t if p not in dst]
    if missing:
        raise TorchImportError(
            f"torch checkpoint did not cover {len(missing)} target leaves, "
            f"e.g. {sorted(missing)[:6]}; source keys left: {sorted(sd)[:6]}")
    out: Dict[str, Any] = {}
    for path, arr in dst.items():
        if path not in flat_t:
            raise TorchImportError(
                f"converted leaf {path} does not exist in the target model "
                f"(template has e.g. {sorted(flat_t)[:4]})")
        want = flat_t[path]
        if tuple(arr.shape) != tuple(want.shape):
            raise TorchImportError(
                f"shape mismatch at {path}: torch {tuple(arr.shape)} vs "
                f"model {tuple(want.shape)}")
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr.astype(want.dtype)
    for top in variables:   # an empty collection (batch_stats) stays
        out.setdefault(top, {})
    unused.extend(sorted(sd))
    return out, sorted(unused)


def load_torch_checkpoint(path: str, cfg: Config, variables):
    """torch.load a reference ``checkpoint.pth`` (tensors only) and convert
    it. Returns (variables, unused_keys)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_state_dict(sd, cfg, variables)


def load_into_model(model: nn.Module, cfg: Config, path: str) -> List[str]:
    """Import a checkpoint.pth into `model` in place (classification and
    regression share it: the regression model is the same with num_class =
    nbins, reference exp_regression.py:95-102). Returns the unused source
    keys."""
    new_vars, unused = load_torch_checkpoint(path, cfg,
                                             to_jax_variables(model))
    load_jax_variables(model, new_vars)
    return unused
