"""Export the port's models as reference-layout torch state_dicts: a copy of
sie_tpu/compat/torch_export.py on the port's flax-layout trees.

The inverse of `torch_import.py`: the variables tree of a model
(`to_jax_variables(model)`) converts to the key layout the reference trains
and loads (``model.state_dict()`` / ``load_state_dict``, reference
utils/tools.py:34-38, run.py:599-602), so a model trained on the card can
be evaluated or served by the original PyTorch code (``python -m
sie_tpu_torch.run --export_torch_ckpt PATH``). Key layouts and transposes
are the JAX package's, so the two exporters give the same state_dict from
the same variables, key for key and bit for bit.

The export covers every learnable parameter the reference forward reads,
and every leaf of the tree must be consumed. Reference-side state the model
does not carry (sinusoidal position buffers, the unreachable
temporal-embedding branch; BN ``num_batches_tracked`` is written as 0) is
left to the reference model's own initialisation: load with
``strict=False``.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from sie_tpu_torch.compat.from_jax import _flatten
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.timesnet import _inception_taps

Array = np.ndarray
Flat = Dict[Tuple[str, ...], Array]


class TorchExportError(ValueError):
    pass


# ---------------------------------------------------------------- primitives

def _pop(flat: Flat, path: Tuple[str, ...]) -> Array:
    try:
        return flat.pop(path)
    except KeyError:
        raise TorchExportError(
            f"model variables have no leaf at {path}; present keys e.g. "
            f"{sorted(flat)[:6]}") from None


def _linear(sd, flat: Flat, scope, dst: str, bias: bool = True) -> None:
    sd[dst + ".weight"] = _pop(flat, scope + ("kernel",)).T
    if bias:
        sd[dst + ".bias"] = _pop(flat, scope + ("bias",))


def _conv1d(sd, flat: Flat, scope, dst: str, bias: bool = True) -> None:
    sd[dst + ".weight"] = _pop(flat, scope + ("kernel",)).transpose(2, 1, 0)
    if bias:
        sd[dst + ".bias"] = _pop(flat, scope + ("bias",))


def _conv2d(sd, flat: Flat, scope, dst: str, bias: bool = False) -> None:
    sd[dst + ".weight"] = _pop(flat, scope + ("kernel",)).transpose(3, 2, 0, 1)
    if bias:
        sd[dst + ".bias"] = _pop(flat, scope + ("bias",))


def _norm(sd, flat: Flat, scope, dst: str) -> None:
    sd[dst + ".weight"] = _pop(flat, scope + ("scale",))
    sd[dst + ".bias"] = _pop(flat, scope + ("bias",))


def _batchnorm(sd, flat: Flat, params_scope, dst: str) -> None:
    _norm(sd, flat, params_scope, dst)
    stats = ("batch_stats",) + params_scope[1:]
    sd[dst + ".running_mean"] = _pop(flat, stats + ("mean",))
    sd[dst + ".running_var"] = _pop(flat, stats + ("var",))
    sd[dst + ".num_batches_tracked"] = np.zeros((), np.int64)


# ------------------------------------------------------------------- models

def _export_sbm(sd, flat: Flat, cfg: Config, scope, prefix: str) -> None:
    banks = [p for p in flat
             if p[:len(scope)] == scope and len(p) == len(scope) + 1
             and re.fullmatch(r"shapelets_\d+", p[-1])]
    for path in banks:
        i = int(path[-1].split("_")[1])
        sd[f"{prefix}shapelets.{i}.weights"] = flat.pop(path)
        thr = scope + (f"threshold_{i}",)
        if thr in flat:  # LTS: flax (n, C) -> reference (1, n, C)
            sd[f"{prefix}shapelets.{i}.threshold"] = flat.pop(thr)[None]
    _linear(sd, flat, scope + ("output_layer",), prefix + "output_layer",
            bias=False)
    bil = scope + ("bilinear_w",)
    if bil in flat:
        sd[prefix + "output_bilinear.weight"] = flat.pop(bil)
    att = scope + ("attention",)
    if att + ("pos_embed",) in flat:
        _linear(sd, flat, att + ("q_proj",), prefix + "attention.q_proj")
        _linear(sd, flat, att + ("k_proj",), prefix + "attention.k_proj")
        sd[prefix + "attention.pos_embed.weight"] = flat.pop(
            att + ("pos_embed",))


def _export_fcn(sd, flat: Flat, scope, prefix: str) -> None:
    for k in (1, 2, 3):
        _conv1d(sd, flat, scope + (f"conv{k}",), f"{prefix}block{k}.0")
        _batchnorm(sd, flat, scope + (f"bn{k}",), f"{prefix}block{k}.1")
    _linear(sd, flat, scope + ("fc",), prefix + "fc")


def _export_resnet(sd, flat: Flat, scope, prefix: str) -> None:
    _conv1d(sd, flat, scope + ("conv1",), prefix + "conv1", bias=False)
    _batchnorm(sd, flat, scope + ("bn1",), prefix + "bn1")
    for k in (1, 2, 3):
        blk = f"{prefix}layer{k}.0."
        lscope = scope + (f"layer{k}",)
        for c in ("conv1", "conv2"):
            _conv1d(sd, flat, lscope + (c,), blk + c, bias=False)
        for b in ("bn1", "bn2"):
            _batchnorm(sd, flat, lscope + (b,), blk + b)
        if lscope + ("short_conv", "kernel") in flat:
            _conv1d(sd, flat, lscope + ("short_conv",), blk + "shortcut.0",
                    bias=False)
            _batchnorm(sd, flat, lscope + ("short_bn",), blk + "shortcut.1")
    _linear(sd, flat, scope + ("fc",), prefix + "fc")


def _export_encoder(sd, flat: Flat, scope, prefix: str, e_layers: int) -> None:
    for i in range(e_layers):
        lt = f"{prefix}attn_layers.{i}."
        ls = scope + (f"layer_{i}",)
        att = ls + ("FullAttentionLayer_0",)
        for ours, theirs in (("query", "query_projection"),
                             ("key", "key_projection"),
                             ("value", "value_projection"),
                             ("out", "out_projection")):
            _linear(sd, flat, att + (ours,), lt + "attention." + theirs)
        for c in ("conv1", "conv2"):  # Dense -> kernel-1 Conv1d
            sd[lt + c + ".weight"] = _pop(flat, ls + (c, "kernel")).T[:, :, None]
            sd[lt + c + ".bias"] = _pop(flat, ls + (c, "bias"))
        _norm(sd, flat, ls + ("norm1",), lt + "norm1")
        _norm(sd, flat, ls + ("norm2",), lt + "norm2")
    _norm(sd, flat, scope + ("norm",), prefix + "norm")


def _export_transformer(sd, flat: Flat, cfg: Config, scope,
                        prefix: str) -> None:
    _conv1d(sd, flat, scope + ("enc_embedding", "TokenEmbedding_0", "tokenConv"),
            prefix + "enc_embedding.value_embedding.tokenConv", bias=False)
    _export_encoder(sd, flat, scope + ("encoder",), prefix + "encoder.",
                    cfg.e_layers)
    _linear(sd, flat, scope + ("projection",), prefix + "projection")


def _export_eegcnn(sd, flat: Flat, cfg: Config) -> None:
    cnn = ("params", "eegcnn")
    pre = "eegcnn."
    _conv2d(sd, flat, cnn + ("block1_conv1",), pre + "block1_conv1")
    _batchnorm(sd, flat, cnn + ("block1_bn1",), pre + "block1_bn1")
    _conv2d(sd, flat, cnn + ("block1_depthwise",), pre + "block1_depthwise")
    _batchnorm(sd, flat, cnn + ("block1_bn2",), pre + "block1_bn2")
    _conv2d(sd, flat, cnn + ("block2_conv1",), pre + "block2_conv1")
    _conv2d(sd, flat, cnn + ("block2_conv2",), pre + "block2_conv2")
    _batchnorm(sd, flat, cnn + ("block2_bn",), pre + "block2_bn")
    if ("params", "cnn_projection", "kernel") in flat:
        _linear(sd, flat, ("params", "cnn_projection"), "cnn_projection")
    for i in range(cfg.eegcnn_layers):
        lt = f"transformer_encoder.layers.{i}."
        ls = ("params", f"encoder_{i}")
        qkv_w = [_pop(flat, ls + (n, "kernel")).T for n in ("q", "k", "v")]
        qkv_b = [_pop(flat, ls + (n, "bias")) for n in ("q", "k", "v")]
        sd[lt + "self_attn.in_proj_weight"] = np.concatenate(qkv_w, axis=0)
        sd[lt + "self_attn.in_proj_bias"] = np.concatenate(qkv_b, axis=0)
        _linear(sd, flat, ls + ("out_proj",), lt + "self_attn.out_proj")
        _linear(sd, flat, ls + ("linear1",), lt + "linear1")
        _linear(sd, flat, ls + ("linear2",), lt + "linear2")
        _norm(sd, flat, ls + ("norm1",), lt + "norm1")
        _norm(sd, flat, ls + ("norm2",), lt + "norm2")
    _linear(sd, flat, ("params", "classifier"), "classifier")


def _export_timesnet(sd, flat: Flat, cfg: Config, scope, prefix: str) -> None:
    taps = _inception_taps(cfg.num_kernels)
    _conv1d(sd, flat, scope + ("enc_embedding", "TokenEmbedding_0", "tokenConv"),
            prefix + "enc_embedding.value_embedding.tokenConv", bias=False)
    for b in range(cfg.e_layers):
        for ours, theirs in (("conv1", "conv.0"), ("conv2", "conv.2")):
            tap_w = _pop(flat, scope + (f"block_{b}", ours, "tap_weights"))
            bias = _pop(flat, scope + (f"block_{b}", ours, "bias"))
            c_in, c_out = tap_w.shape[1], tap_w.shape[2]
            ws = [np.zeros((c_out, c_in, 2 * ki + 1, 2 * ki + 1),
                           tap_w.dtype) for ki in range(cfg.num_kernels)]
            # exact inverse of the import repack: taps enumerate every
            # (dr, dc) of every odd kernel (`_inception_taps`)
            for tap_idx, (ki, dr, dc) in enumerate(taps):
                ws[ki][:, :, dr + ki, dc + ki] = tap_w[tap_idx].T
            for ki in range(cfg.num_kernels):
                key = f"{prefix}model.{b}.{theirs}.kernels.{ki}."
                sd[key + "weight"] = ws[ki]
                sd[key + "bias"] = bias[ki]
    _norm(sd, flat, scope + ("layer_norm",), prefix + "layer_norm")
    _linear(sd, flat, scope + ("projection",), prefix + "projection")


def _export_patchtst(sd, flat: Flat, cfg: Config, scope, prefix: str) -> None:
    _linear(sd, flat, scope + ("value_embedding",),
            prefix + "patch_embedding.value_embedding", bias=False)
    _export_encoder(sd, flat, scope + ("enc_scan", "encoder"),
                    prefix + "encoder.", cfg.e_layers)
    _linear(sd, flat, scope + ("projection",), prefix + "projection")


_DNN_EXPORTERS = {
    "FCN": lambda sd, flat, cfg, scope, prefix: _export_fcn(sd, flat, scope,
                                                            prefix),
    "ResNet": lambda sd, flat, cfg, scope, prefix: _export_resnet(sd, flat,
                                                                  scope,
                                                                  prefix),
    "Transformer": _export_transformer,
    "TimesNet": _export_timesnet,
    "PatchTST": _export_patchtst,
}


# --------------------------------------------------------------- entry point

def export_state_dict(variables, cfg: Config) -> Dict[str, Array]:
    """Convert a variables tree (nested dicts of arrays, as
    `to_jax_variables(model)` gives) into the matching reference state_dict
    (torch name -> float32 ndarray). Every leaf of ``variables`` must be
    consumed, so a new or renamed parameter fails loudly instead of being
    dropped."""
    flat: Flat = dict(_flatten(variables))
    sd: Dict[str, Array] = {}

    def dnn(scope, prefix: str) -> None:
        if cfg.dnn_type not in _DNN_EXPORTERS:
            raise TorchExportError(
                f"no torch exporter for dnn_type={cfg.dnn_type!r} "
                f"(reference backbones: {sorted(_DNN_EXPORTERS)})")
        _DNN_EXPORTERS[cfg.dnn_type](sd, flat, cfg, scope, prefix)

    if cfg.model in ("SBM", "LTS"):
        _export_sbm(sd, flat, cfg, ("params",), "")
    elif cfg.model == "InterpGN":
        _export_sbm(sd, flat, cfg, ("params", "sbm"), "sbm.")
        dnn(("params", "deep_model"), "deep_model.")
    elif cfg.model == "DNN":
        dnn(("params", "backbone"), "")
    elif cfg.model == "EEGCNN":
        _export_eegcnn(sd, flat, cfg)
    else:
        raise TorchExportError(f"no torch exporter for model={cfg.model!r}")

    if flat:
        raise TorchExportError(
            f"exporter did not consume {len(flat)} variable leaves, "
            f"e.g. {sorted(flat)[:6]}")
    return {k: np.asarray(v, np.float32) if v.dtype != np.int64 else v
            for k, v in sd.items()}


def save_torch_checkpoint(path: str, variables, cfg: Config) -> None:
    """Write a reference-loadable ``checkpoint.pth``. Load into the reference
    model with ``load_state_dict(..., strict=False)`` (position buffers and
    the unreachable temporal-embedding branch keep their own init there)."""
    sd = export_state_dict(variables, cfg)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
