"""Plain reference of InterpGN's training loss, with the Transformer or
the FCN expert (`dnn_type`), in PyTorch.

Written from the model's description (a shapelet bottleneck gated by the
Gini index of its own softmax against a deep classifier), with no
kernel, cache or batching of the program under test, and importing
nothing of it. Parameters are a dict of float32 tensors under the
program's state-dict names, so one set of weights made by the benchmark
goes to both sides.

The forward, for x (B, T, C) and a padding mask (B, T):
- SBM: x normalised per channel over time (unbiased std + 1e-8); for each
  bank i of length L_i = max(3, ceil(frac_i T)) and stride s_i (1 below
  3000 steps, else int(log2 L_i)), the distances
  d[b, n, c, w] = mean_l |x[b, c, w s_i + l] - S_i[n, c, l]|; predicates
  p = max_w exp(-(eps d)^2) with a straight-through gradient (the hard
  one-hot plus the softmax over windows); logits = p W^T over the banks' predicates
  flattened bank by bank in (n, C) order; its loss lambda_reg mean|W| +
  lambda_div sum_i mean over (C, n, n) of exp(-||S_i[j] - S_i[k] +
  1e-6||) off the diagonal.
- Transformer: a circular k=3 convolution and the sinusoidal positions,
  post-norm encoder layers (multi-head attention, GELU (tanh) FFN,
  LayerNorm eps 1e-6), a final LayerNorm, GELU, the padding mask, the
  flattened (T d) projection to the classes.
- FCN: three VALID convolutions over time, kernels (8, 5, 3) ((3, 3, 2)
  at 10 steps or fewer), widths 128, 256, 128, each followed by
  BatchNorm with the batch's statistics (biased variance, eps 1e-5) and
  a ReLU; the mean over time; a linear head. The padding mask is not
  read.
- Gate: eta = (K sum softmax(sbm)^2 - 1) / (K - 1), out = eta sbm + (1 -
  eta) deep.
- Loss: weighted cross-entropy of out (sum(ce w) / max(sum w, 1)) + the
  SBM loss + beta times the weighted cross-entropy of the SBM logits.
  The configuration's `gating_value` acts in evaluation only, which no
  training step reaches.

Memory at the benchmark's sizes: the distances are computed in blocks of
taps with a hand-written backward (the bank's gradient only: the input
has no parameters upstream), and attention in blocks of queries with its
log-sum-exp kept and the scores recomputed in the backward.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import matmul, rnd, rounds

LN_EPS = 1e-6
BN_EPS = 1e-5
FCN_WIDTHS = (128, 256, 128)
BLOCK_ELEMS = 1 << 27      # elements of one block of taps or scores


# ------------------------------------------------------------ shapes
def bank_shapes(cfg: Dict) -> List[Tuple[int, int]]:
    """(length, stride) of each shapelet bank."""
    t = cfg["seq_len"]
    out = []
    for frac in cfg["shapelet_lengths"]:
        length = max(3, int(math.ceil(frac * t)))
        stride = 1 if t < 3000 else max(1, int(math.log2(length)))
        out.append((length, stride))
    return out


def param_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter: init "normal" (std
    scale), "uniform" (in [-scale, scale]) or "const" (the value scale)."""
    c, t, k = cfg["enc_in"], cfg["seq_len"], cfg["num_class"]
    n = cfg["num_shapelet"]
    spec = []
    banks = bank_shapes(cfg)
    for i, (length, _stride) in enumerate(banks):
        spec.append((f"sbm.shapelets_{i}", (n, c, length), "normal", 1.0))
    total = n * c * len(banks)
    spec.append(("sbm.output_layer.weight", (k, total), "uniform",
                 1 / math.sqrt(total)))
    if cfg["dnn_type"] == "FCN":
        _fcn_spec(cfg, spec)
        return spec
    if cfg["dnn_type"] != "Transformer":
        raise ValueError(f"no reference of the {cfg['dnn_type']} expert")
    d, f, pre = cfg["d_model"], cfg["d_ff"], "deep_model."
    spec.append((pre + "enc_embedding.token_embedding.tokenConv.weight",
                 (d, c, 3), "normal",
                 math.sqrt(2.0 / (1 + 0.01 ** 2) / (3 * c))))

    def lin(name, n_in, n_out):
        b = 1 / math.sqrt(n_in)
        spec.append((name + ".weight", (n_out, n_in), "uniform", b))
        spec.append((name + ".bias", (n_out,), "uniform", b))

    def norm(name):
        spec.append((name + ".weight", (d,), "const", 1.0))
        spec.append((name + ".bias", (d,), "const", 0.0))

    for j in range(cfg["e_layers"]):
        lp = f"{pre}encoder.layers.{j}."
        for proj in ("query", "key", "value", "out"):
            lin(lp + "attention." + proj, d, d)
        norm(lp + "norm1")
        lin(lp + "conv1", d, f)
        lin(lp + "conv2", f, d)
        norm(lp + "norm2")
    norm(pre + "encoder.norm")
    lin(pre + "projection", t * d, k)
    return spec


def fcn_kernels(cfg: Dict) -> Tuple[int, ...]:
    return (3, 3, 2) if cfg["seq_len"] <= 10 else (8, 5, 3)


def _fcn_spec(cfg: Dict, spec: List) -> None:
    c_in, pre = cfg["enc_in"], "deep_model."
    for i, (k, f) in enumerate(zip(fcn_kernels(cfg), FCN_WIDTHS), start=1):
        b = 1 / math.sqrt(c_in * k)
        spec.append((f"{pre}conv{i}.weight", (f, c_in, k), "uniform", b))
        spec.append((f"{pre}conv{i}.bias", (f,), "uniform", b))
        spec.append((f"{pre}bn{i}.weight", (f,), "const", 1.0))
        spec.append((f"{pre}bn{i}.bias", (f,), "const", 0.0))
        c_in = f
    b = 1 / math.sqrt(c_in)
    spec.append((pre + "fc.weight", (cfg["num_class"], c_in), "uniform", b))
    spec.append((pre + "fc.bias", (cfg["num_class"],), "uniform", b))


# ------------------------------------------------------------ SBM
class SlidingL1(torch.autograd.Function):
    """d[b, n, c, w] = mean_l |x[b, c, w s + l] - S[n, c, l]|, computed in
    blocks of taps; the backward gives S's gradient."""

    @staticmethod
    def forward(ctx, x, s, stride):
        xu = x.unfold(2, s.shape[2], stride)              # (B, C, W, L)
        b, c, w, length = xu.shape
        n = s.shape[0]
        chunk = max(1, BLOCK_ELEMS // (b * n * c * w))
        acc = torch.zeros((b, n, c, w), dtype=torch.float32, device=x.device)
        for lo in range(0, length, chunk):
            xs = xu[:, None, :, :, lo:lo + chunk]
            ss = s[None, :, :, None, lo:lo + chunk]
            acc += (xs - ss).abs_().sum(-1)
        ctx.save_for_backward(x, s)
        ctx.stride = stride
        return acc / length

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        xu = x.unfold(2, s.shape[2], ctx.stride)
        b, c, w, length = xu.shape
        n = s.shape[0]
        chunk = max(1, BLOCK_ELEMS // (b * n * c * w))
        gs = torch.empty_like(s)
        for lo in range(0, length, chunk):
            # d|x - s|/ds = sign(s - x)
            diff = s[None, :, :, None, lo:lo + chunk] - xu[:, None, :, :,
                                                           lo:lo + chunk]
            gs[:, :, lo:lo + chunk] = (diff.sign_() * g[..., None]).sum(
                dim=(0, 3))
        return None, gs / length, None


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """x (B, C, T): per-channel (x - mean) / (unbiased std + 1e-8)."""
    mean = x.mean(-1, keepdim=True)
    std = x.var(-1, keepdim=True, unbiased=True).sqrt()
    return (x - mean) / (std + 1e-8)


def straight_through_max(p: torch.Tensor) -> torch.Tensor:
    """max over the last axis; gradient: the one-hot of the argmax plus
    the softmax's Jacobian applied to p."""
    hard = F.one_hot(p.argmax(-1), p.shape[-1]).to(p.dtype)
    soft = torch.softmax(p, -1)
    return ((hard + soft - soft.detach()) * p).sum(-1)


def diversity(bank: torch.Tensor) -> torch.Tensor:
    sh = bank.transpose(0, 1)                               # (C, n, L)
    diff = sh[:, :, None, :] - sh[:, None, :, :] + 1e-6
    dist = diff.square().sum(-1).sqrt()
    n = bank.shape[0]
    off = 1.0 - torch.eye(n, dtype=dist.dtype, device=dist.device)
    return (torch.exp(-dist) * off).mean()


def sbm(params, cfg, x, prec: str):
    """(logits (B, K), SBM loss) of x (B, T, C)."""
    xn = instance_norm(x.transpose(1, 2).float()).contiguous()
    eps = cfg["epsilon"]
    ps = []
    for i, (_length, stride) in enumerate(bank_shapes(cfg)):
        s = params[f"sbm.shapelets_{i}"]
        d = SlidingL1.apply(xn, s, stride)
        p = straight_through_max(torch.exp(-(eps * d).square()))
        ps.append(p.reshape(x.shape[0], -1))
    p = torch.cat(ps, -1)
    w = params["sbm.output_layer.weight"]
    logits = matmul(p, w.t(), prec)
    loss = cfg["lambda_reg"] * w.abs().mean()
    if cfg["lambda_div"] > 0:
        loss = loss + cfg["lambda_div"] * sum(
            diversity(params[f"sbm.shapelets_{i}"])
            for i in range(len(bank_shapes(cfg))))
    return logits, loss


# ------------------------------------------------------------ Transformer
class BlockedAttention(torch.autograd.Function):
    """softmax(q k^T scale) v over (BH, T, dk), in blocks of queries; the
    backward recomputes each block's probabilities from the kept
    log-sum-exp. Products round their operands to `prec`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, prec):
        bh, t, _dk = q.shape
        step = max(1, BLOCK_ELEMS // (bh * k.shape[1]))
        kt = rnd(k, prec).transpose(1, 2)
        vr = rnd(v, prec)
        out = torch.empty_like(q)
        lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
        for lo in range(0, t, step):
            s = torch.matmul(rnd(q[:, lo:lo + step], prec), kt) * scale
            m = s.logsumexp(-1, keepdim=True)
            a = torch.exp(s - m)
            out[:, lo:lo + step] = torch.matmul(rnd(a, prec), vr)
            lse[:, lo:lo + step] = m[..., 0]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.prec, ctx.step = scale, prec, step
        return out

    @staticmethod
    def backward(ctx, go):
        q, k, v, out, lse = ctx.saved_tensors
        scale, prec, step = ctx.scale, ctx.prec, ctx.step
        kr, vr = rnd(k, prec), rnd(v, prec)
        gq = torch.empty_like(q)
        gk = torch.zeros_like(k)
        gv = torch.zeros_like(v)
        delta = (go * out).sum(-1)                            # (BH, T)
        for lo in range(0, q.shape[1], step):
            qb = rnd(q[:, lo:lo + step], prec)
            gob = rnd(go[:, lo:lo + step], prec, grad=True)
            s = torch.matmul(qb, kr.transpose(1, 2)) * scale
            a = torch.exp(s - lse[:, lo:lo + step, None])
            gv += torch.matmul(rnd(a, prec).transpose(1, 2), gob)
            ga = torch.matmul(gob, vr.transpose(1, 2))
            gs = a * (ga - delta[:, lo:lo + step, None]) * scale
            gsr = rnd(gs, prec, grad=True)
            gq[:, lo:lo + step] = torch.matmul(gsr, kr)
            gk += torch.matmul(gsr.transpose(1, 2), qb)
        return gq, gk, gv, None, None


def dense(x, params, name, prec, bias=True):
    y = matmul(x, params[name + ".weight"].t(), prec)
    return y + params[name + ".bias"] if bias else y


def layer_norm(x, params, name):
    return F.layer_norm(x, (x.shape[-1],), params[name + ".weight"],
                        params[name + ".bias"], LN_EPS)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def positions(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros((t, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: pe[:, 1::2].shape[1]])
    return pe


def transformer(params, cfg, x, mask, prec):
    b, t, c = x.shape
    d, h = cfg["d_model"], cfg["n_heads"]
    pre = "deep_model."
    xp = torch.cat([x[:, -1:], x, x[:, :1]], 1)               # circular pad
    taps = torch.stack([xp[:, j:j + t] for j in range(3)], -1)  # (B,T,C,3)
    w = params[pre + "enc_embedding.token_embedding.tokenConv.weight"]
    z = matmul(taps.reshape(b, t, c * 3), w.reshape(d, c * 3).t(), prec)
    z = z + positions(t, d, x.device)
    dk = d // h
    for j in range(cfg["e_layers"]):
        lp = f"{pre}encoder.layers.{j}."
        heads = lambda u: u.reshape(b, t, h, dk).transpose(1, 2).reshape(
            b * h, t, dk)
        q = heads(dense(z, params, lp + "attention.query", prec))
        k = heads(dense(z, params, lp + "attention.key", prec))
        v = heads(dense(z, params, lp + "attention.value", prec))
        o = BlockedAttention.apply(q, k, v, 1.0 / math.sqrt(dk), prec)
        o = o.reshape(b, h, t, dk).transpose(1, 2).reshape(b, t, d)
        z = layer_norm(z + dense(o, params, lp + "attention.out", prec),
                       params, lp + "norm1")
        y = dense(gelu(dense(z, params, lp + "conv1", prec)), params,
                  lp + "conv2", prec)
        z = layer_norm(z + y, params, lp + "norm2")
    z = layer_norm(z, params, pre + "encoder.norm")
    z = gelu(z) * mask[..., None]
    return dense(z.reshape(b, t * d), params, pre + "projection", prec)


# ------------------------------------------------------------ FCN
def fcn(params, cfg, x, mask, prec):
    if rounds(prec):
        raise ValueError("the FCN expert is referenced in float32 and TF32")
    pre = "deep_model."
    h = x.transpose(1, 2)                                    # (B, C, T)
    for i in range(1, len(FCN_WIDTHS) + 1):
        h = F.conv1d(h, params[f"{pre}conv{i}.weight"],
                     params[f"{pre}conv{i}.bias"])
        mean = h.mean((0, 2), keepdim=True)
        var = h.var((0, 2), unbiased=False, keepdim=True)
        h = torch.relu((h - mean) / torch.sqrt(var + BN_EPS)
                       * params[f"{pre}bn{i}.weight"][:, None]
                       + params[f"{pre}bn{i}.bias"][:, None])
    return dense(h.mean(2), params, pre + "fc", prec)


# ------------------------------------------------------------ model
EXPERTS = {"Transformer": transformer, "FCN": fcn}


def forward(params: Dict[str, torch.Tensor], cfg: Dict, x: torch.Tensor,
            mask: torch.Tensor, prec: str = "f32"):
    """(out, sbm logits, SBM loss) of x (B, T, C) f32, in training."""
    s_logits, s_loss = sbm(params, cfg, x, prec)
    deep = EXPERTS[cfg["dnn_type"]](params, cfg, x, mask, prec)
    k = s_logits.shape[-1]
    gini = torch.softmax(s_logits, -1).square().sum(-1, keepdim=True)
    eta = (k * gini - 1.0) / (k - 1.0)
    return eta * s_logits + (1.0 - eta) * deep, s_logits, s_loss


def loss(params, cfg, x, y, mask, w, beta: float, prec: str = "f32"):
    """The training loss of a batch."""
    out, s_logits, s_loss = forward(params, cfg, x, mask, prec)
    total = w.sum().clamp(min=1.0)
    ce = lambda z: (F.cross_entropy(z, y.long(), reduction="none")
                    * w).sum() / total
    return ce(out) + beta * ce(s_logits) + s_loss
