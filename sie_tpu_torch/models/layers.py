"""Embeddings, attention, the encoder and decoder stacks and batch norm
(counterpart of sie_tpu/models/layers.py), as the Transformer (its
classifier and its forecast, imputation and anomaly heads), the FCN,
ResNet, EEGCNN, TimesNet and PatchTST backbones use them.

Numerics follow flax's dtype rules, so that the port and the JAX package
round at the same places under `amp` (bf16 compute):
- a Dense/Conv with `dtype` casts its input, kernel and bias to that dtype
  (`dense`, `TokenEmbedding`); parameters are stored in float32;
- flax `LayerNorm` has no dtype, computes in float32 and returns float32
  from a bf16 input (`layer_norm`), with eps 1e-6;
- flax `BatchNorm` (`BatchNorm`) computes its statistics in float32 and
  returns `dtype`;
- `jax.nn.gelu` is the tanh approximation (`gelu`).

Parameters are initialised from an explicit `torch.Generator` with the
distributions the JAX package uses (PyTorch's own defaults). Dropout, at
the JAX package's places, draws its masks from another explicit generator
that the caller passes to `forward` (flax's `rngs={"dropout": ...}`); in
eval mode or at rate 0 it draws nothing. A block recomputed in the
backward pass takes a `ReplayDropout` in the generator's place.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sie_tpu_torch.ops.attention import fused_attention
from sie_tpu_torch.ops.flash import FLASH_DKS, flash_attention
from sie_tpu_torch.parallel import comm
from sie_tpu_torch.utils.masking import triangular_causal_mask

_LN_EPS = 1e-6   # flax LayerNorm default
_SKINNY = 16     # `dense` computes products with fewer outputs in f32


# ------------------------------------------------------------------ init
def uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=g)


def linear(in_features: int, out_features: int, g: torch.Generator,
           bias: bool = True) -> nn.Linear:
    """nn.Linear with U(-b, b) weight and bias, b = 1/sqrt(in_features)
    (PyTorch's default, and the JAX package's
    `torch_default_kernel_init`/`torch_default_bias_init`)."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features, bias=bias)
    b = 1.0 / math.sqrt(in_features)
    uniform_(lin.weight, b, g)
    if bias:
        uniform_(lin.bias, b, g)
    return lin


# std of the unit normal truncated to [-2, 2]: flax's lecun_normal divides
# by it so that the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's `lecun_normal` (the default kernel init of `nn.Dense` and
    `nn.Conv`): a normal of std sqrt(1/fan_in)/0.8796 truncated at 2 std."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=g)


def lecun_linear(in_features: int, out_features: int, g: torch.Generator,
                 bias: bool = True) -> nn.Linear:
    """nn.Linear initialised as flax's default `nn.Dense`: a lecun_normal
    kernel and a zero bias."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features, bias=bias)
    lecun_normal_(lin.weight, in_features, g)
    if bias:
        with torch.no_grad():
            lin.bias.zero_()
    return lin


def lecun_conv(cls, in_channels: int, out_channels: int, kernel_size,
               g: torch.Generator, bias: bool = True, stride: int = 1):
    """nn.Conv1d or nn.Conv2d (`cls`) initialised as flax's default
    `nn.Conv`: a lecun_normal kernel (fan_in = in_channels x taps) and a
    zero bias."""
    c = nn.utils.skip_init(cls, in_channels, out_channels, kernel_size,
                           stride=stride, bias=bias)
    lecun_normal_(c.weight, c.weight[0].numel(), g)
    if bias:
        with torch.no_grad():
            c.bias.zero_()
    return c


def normal_param(shape, std: float, g: torch.Generator) -> nn.Parameter:
    """A raw parameter drawn from N(0, std^2) (flax `initializers.normal`)."""
    p = nn.Parameter(torch.empty(shape))
    normal_(p, std, g)
    return p


def layer_norm_module(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=_LN_EPS)


def conv(cls, in_channels: int, out_channels: int, kernel_size,
         g: torch.Generator, bias: bool = True, groups: int = 1,
         bias_fan_in: Optional[int] = None):
    """nn.Conv1d or nn.Conv2d (`cls`) with U(-b, b) weight, b =
    1/sqrt(fan_in), fan_in = in_channels/groups x the kernel's taps
    (PyTorch's default and the JAX package's `torch_default_kernel_init`),
    and a bias bounded by 1/sqrt(`bias_fan_in`, default fan_in)."""
    c = nn.utils.skip_init(cls, in_channels, out_channels, kernel_size,
                           groups=groups, bias=bias)
    fan_in = c.weight[0].numel()
    uniform_(c.weight, 1.0 / math.sqrt(fan_in), g)
    if bias:
        uniform_(c.bias, 1.0 / math.sqrt(max(bias_fan_in or fan_in, 1)), g)
    return c


def same_pads(kernel: Tuple[int, ...]) -> Tuple[int, ...]:
    """F.pad's pads (last axis first) of flax's stride-1 "SAME" padding:
    k - 1 taps per axis, (k - 1) // 2 of them before the input."""
    pads: Tuple[int, ...] = ()
    for k in reversed(kernel):
        pads += ((k - 1) // 2, k - 1 - (k - 1) // 2)
    return pads


def conv_forward(c: nn.Module, x: torch.Tensor, dtype: torch.dtype,
                 stride: int = 1, padding: int = 0,
                 same: bool = False) -> torch.Tensor:
    """flax `nn.Conv(dtype=dtype)` on a channels-first x: input, kernel and
    bias cast to dtype; `padding` zeros on both sides of each axis, or
    flax's "SAME" split (`same_pads`) when `same`."""
    fn = F.conv1d if isinstance(c, nn.Conv1d) else F.conv2d
    x = x.to(dtype)
    if same:
        x = F.pad(x, same_pads(c.kernel_size))
    bias = None if c.bias is None else c.bias.to(dtype)
    return fn(x, c.weight.to(dtype), bias, stride, padding, 1, c.groups)


# ------------------------------------------------------------ dropout
class ReplayDropout:
    """Stands in for the dropout generator inside a block whose forward is
    recomputed in the backward pass (PatchTST's encoder chunks under
    `patch_remat`). `torch.utils.checkpoint` restores only the global
    generators' states, so a recompute that drew from the model's
    generator again would draw other masks. The first pass through the
    block draws from `generator` exactly as `dropout` and `dropout_seed`
    would, and keeps each keep mask and attention seed; `rewind()` starts
    the next pass, which replays them in the same order. The masks live
    until the block's backward has run (bool, one byte an element), as
    the JAX package's recompute keys them on the same rng. On the card the
    draws are part of a captured step like any other."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.draws = []
        self.pos = 0

    def rewind(self) -> "ReplayDropout":
        self.pos = 0
        return self

    def _next(self, draw, shape):
        if self.pos == len(self.draws):
            self.draws.append(draw())
        out = self.draws[self.pos]
        if tuple(out.shape) != tuple(shape):
            raise RuntimeError(f"a replayed pass asked for a draw of shape "
                               f"{tuple(shape)} where the first drew "
                               f"{tuple(out.shape)}")
        self.pos += 1
        return out

    def keep(self, shape, rate: float) -> torch.Tensor:
        g = self.generator
        return self._next(lambda: torch.rand(shape, generator=g,
                                             device=g.device) < 1.0 - rate,
                          shape)

    def seed_int32(self) -> torch.Tensor:
        return self._next(lambda: _draw_seed(self.generator), (1,))

    @property
    def device(self) -> torch.device:
        return self.generator.device


def _draw_seed(generator: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


Stream = Union[torch.Generator, ReplayDropout]


def _global_draw(shape, batch_dim: int, model_dim: Optional[int], mesh,
                 seq_dim: Optional[int] = None,
                 expert_dim: Optional[int] = None):
    """(the shape the mask is drawn at, the cut that keeps this rank's
    part): under a step's mesh (parallel/comm.py) the global batch along
    `batch_dim`, with a 'model'-sharded `model_dim` the full width there,
    with a time-sharded `seq_dim` (outside `comm.full_time`) the whole
    time axis, and with an 'expert'-sharded `expert_dim` every expert, so
    every rank draws what one process would and keeps its block."""
    full, cuts = list(shape), []
    data = comm.current()
    if data is not None and data.size("data") > 1:
        full[batch_dim] *= data.size("data")
        cuts.append((batch_dim, data.index("data"), shape[batch_dim]))
    if model_dim is not None and mesh is not None:
        full[model_dim] *= mesh.size("model")
        cuts.append((model_dim, mesh.index("model"), shape[model_dim]))
    if seq_dim is not None and comm.seq_size() > 1:
        full[seq_dim] *= comm.seq_size()
        cuts.append((seq_dim, comm.seq_index(), shape[seq_dim]))
    if expert_dim is not None and mesh is not None:
        full[expert_dim] *= mesh.size("expert")
        cuts.append((expert_dim, mesh.index("expert"), shape[expert_dim]))

    def cut(t: torch.Tensor) -> torch.Tensor:
        for dim, i, n in cuts:
            t = t.narrow(dim, i * n, n)
        return t
    return tuple(full), cut


def dropout(x: torch.Tensor, rate: float, generator: Optional[Stream],
            training: bool, batch_dim: int = 0,
            model_dim: Optional[int] = None, mesh=None,
            seq_dim: Optional[int] = None,
            expert_dim: Optional[int] = None) -> torch.Tensor:
    """flax `nn.Dropout(rate)`: keep each element with probability
    1 - rate and scale the kept ones by 1/(1 - rate), the mask drawn from
    `generator` (on x's device; a `ReplayDropout` draws or replays it).
    The identity when not training or at rate 0. Under a mesh the mask is
    drawn at the global shape and cut (`_global_draw`): `batch_dim` is
    x's batch-major axis, `model_dim` an axis split over `mesh`'s
    'model', `seq_dim` x's time axis where the step's mesh splits it over
    'seq', `expert_dim` an axis split over `mesh`'s 'expert'."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError(f"dropout at rate {rate} in training needs a "
                         f"torch.Generator")
    full, cut = _global_draw(tuple(x.shape), batch_dim % x.ndim,
                             None if model_dim is None else model_dim % x.ndim,
                             mesh,
                             None if seq_dim is None else seq_dim % x.ndim,
                             expert_dim)
    if isinstance(generator, ReplayDropout):
        keep = cut(generator.keep(full, rate))
    else:
        keep = cut(torch.rand(full, generator=generator,
                              device=x.device) < 1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def dropout_seed(generator: Optional[Stream]) -> torch.Tensor:
    """One int32 in [0, 2^31 - 1) drawn from `generator`, on its device: the
    seed of the fused attention's dropout hash (the JAX package draws
    `randint(make_rng("dropout"), (1,), 0, int32 max)`)."""
    if generator is None:
        raise ValueError("attention dropout in training needs a "
                         "torch.Generator")
    if isinstance(generator, ReplayDropout):
        return generator.seed_int32()
    return _draw_seed(generator)


# ------------------------------------------------------------ numerics
def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)`: input, kernel and bias cast to dtype,
    the product accumulated in f32 and rounded to dtype, then the bias."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    if dtype != torch.bfloat16 or lin.out_features >= _SKINNY:
        return F.linear(x.to(dtype), lin.weight.to(dtype), bias)
    # A head with a few outputs over a long input (the Transformer's
    # (B, 845*512) -> 3 projection): with bf16 reductions disallowed cuBLAS
    # runs it without split-K, one tile walking all of K (72 ms on an H100
    # at B=64). The same bf16 operands multiplied in f32 give the same
    # f32-accumulated sum.
    y = F.linear(x.to(dtype).float(), lin.weight.to(dtype).float()).to(dtype)
    return y if bias is None else y + bias


def row_parallel(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype,
                 mesh) -> torch.Tensor:
    """`dense` of a row-parallel layer: this rank's input block times its
    rows of the kernel, summed over 'model' (`comm.reduce_from_model`),
    then the whole bias once."""
    y = comm.reduce_from_model(F.linear(x.to(dtype), lin.weight.to(dtype)),
                               mesh)
    return y if lin.bias is None else y + lin.bias.to(dtype)


def copy_inputs(mesh, *xs):
    """`comm.copy_to_model` of each distinct input (the same tensor given
    twice is copied once)."""
    seen = {}
    for x in xs:
        if id(x) not in seen:
            seen[id(x)] = comm.copy_to_model(x, mesh)
    return tuple(seen[id(x)] for x in xs)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax `nn.LayerNorm()`: float32 statistics and float32 result."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def sinusoidal_embedding(length: int, d_model: int) -> np.ndarray:
    """Classic sin/cos position table (length, d_model) float32."""
    pe = np.zeros((length, d_model), dtype=np.float32)
    position = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return pe


# ------------------------------------------------------------ embedding
class TokenEmbedding(nn.Module):
    """Circular pad of 1 on each side of time, then a k=3 conv, no bias.
    On a time block (a step's 'seq' axis) the pads are the neighbouring
    blocks' edge steps, the wrap-around joining the last block to the
    first (`comm.halo_seq`)."""

    def __init__(self, c_in: int, d_model: int, dtype: torch.dtype,
                 g: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.tokenConv = nn.utils.skip_init(nn.Conv1d, c_in, d_model, 3,
                                            bias=False)
        # kaiming normal, fan_in, leaky_relu(0.01) gain
        normal_(self.tokenConv.weight,
                math.sqrt(2.0 / (1 + 0.01 ** 2) / (3 * c_in)), g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, T, C)
        if comm.seq_size() > 1:
            xp = comm.halo_seq(x, 1, 1, circular=True).to(self.dtype)
        else:
            xp = torch.cat([x[:, -1:, :], x, x[:, :1, :]],
                           dim=1).to(self.dtype)
        w = self.tokenConv.weight.to(self.dtype)
        return F.conv1d(xp.transpose(1, 2), w).transpose(1, 2)  # (B, T, d)


# time-feature columns the temporal embedding reads, by `freq`
FREQ_MAP = {"h": 4, "t": 5, "s": 6, "m": 1, "a": 1, "w": 2, "d": 3, "b": 3}


def mark_width(freq: str, marks_width: int) -> int:
    """Input width of the temporal embedding over marks of `marks_width`
    columns: the first FREQ_MAP[freq] of them (flax infers it from the
    marks at init; torch needs it at construction)."""
    return min(FREQ_MAP[freq], marks_width)


class DataEmbedding(nn.Module):
    """Token + sinusoidal position embedding (no position table when
    `positional` is False: the reference's DataEmbedding_wo_pos, which the
    Autoformer family uses), + with `mark_width` > 0 the temporal embedding
    (`temporal_embedding`, a bias-free dense layer on the marks' first
    `mark_width` columns), then dropout. The classification models and the
    anomaly heads pass no marks and have no temporal embedding, as their
    flax trees have none. On a time block (a step's 'seq' axis) the
    positions are those of the block's global steps."""

    def __init__(self, c_in: int, d_model: int, dtype: torch.dtype,
                 g: torch.Generator, dropout: float = 0.0,
                 mark_width: int = 0, positional: bool = True):
        super().__init__()
        self.d_model = d_model
        self.positional = positional
        self.dropout = dropout
        self.dtype = dtype
        self.token_embedding = TokenEmbedding(c_in, d_model, dtype, g)
        self.temporal_embedding = (linear(mark_width, d_model, g, bias=False)
                                   if mark_width > 0 else None)
        self._pe: Dict[Tuple, torch.Tensor] = {}

    def _position(self, length: int, like: torch.Tensor) -> torch.Tensor:
        key = (length, like.device, like.dtype)
        if key not in self._pe:
            self._pe[key] = torch.from_numpy(
                sinusoidal_embedding(length, self.d_model)).to(
                    device=like.device, dtype=like.dtype)
        return self._pe[key]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x_mark: Optional[torch.Tensor] = None) -> torch.Tensor:
        v = self.token_embedding(x)
        n, s = x.shape[1], comm.seq_size()
        out = v + self._position(n * s, v)[comm.seq_index() * n:][:n][None] \
            if self.positional else v
        if x_mark is not None:
            if self.temporal_embedding is None:
                raise ValueError("time marks passed to a DataEmbedding built "
                                 "without a temporal embedding (mark_width 0)")
            lin = self.temporal_embedding
            out = out + dense(x_mark[..., :lin.in_features], lin, self.dtype)
        return dropout(out, self.dropout, generator, self.training,
                       seq_dim=1)


# ------------------------------------------------------------ attention
def on_accelerator(x: torch.Tensor) -> bool:
    """The flash gate's "on the accelerator", the JAX package's
    `jax.default_backend() == "tpu"`: the layer's tensors lie on a CUDA
    device. The CPU tests replace it to run the flash branch there, where
    `flash_attention` takes its plain versions."""
    return x.device.type == "cuda"


class FullAttentionLayer(nn.Module):
    """QKV projections + scaled dot-product full attention. Three
    branches, the JAX package's gate (sie_tpu/models/layers.py:150-161):
    the flash branch runs kernels K9, K10b and K10a (the JAX package's
    stock flash kernels, ops/flash.py) when `use_flash` is set, the layer
    is bf16, not causal, with no attention dropout in this pass, equal
    query and key lengths, dk in {64, 128, 256} and the tensors on the
    card (`on_accelerator`), at any T and ahead of the fused branch; off
    the card the JAX package and this layer take the other two. The fused
    branch runs kernels K5 and K6 (dropout by their hash, seeded per call
    from the generator); the plain branch is `torch.matmul` with dropout
    on the probabilities, as the JAX package leaves it to XLA. With
    `fused_max_len=0` a sequence longer than 4096 takes the fused branch
    too, where the JAX package runs its kv-blocked kernels (K7, K8a, K8b)
    and this port the same K5 and K6. `causal` (the decoder's
    self-attention) scores -inf where the key comes after the query and
    always takes the plain branch, as a cross-attention (query and key
    lengths differ) does.

    Split over a mesh's 'model' axis (`tp`, parallel/mesh.py
    `shard_params`), `query`, `key` and `value` hold this rank's H/M heads
    (column-parallel: K9/K10 or K5/K6 run on B·H/M rows) and `out` their
    rows of the output kernel (row-parallel, summed over 'model')."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype,
                 g: torch.Generator, use_fused: bool = False,
                 fused_max_len: int = 4096, fused_min_len: int = 256,
                 use_flash: bool = False, attention_dropout: float = 0.0,
                 causal: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.attention_dropout = attention_dropout
        self.dtype = dtype
        self.causal = causal
        self.use_flash = use_flash
        self.use_fused = use_fused
        self.fused_max_len = fused_max_len
        self.fused_min_len = fused_min_len
        dk = d_model // n_heads
        self.query = linear(d_model, dk * n_heads, g)
        self.key = linear(d_model, dk * n_heads, g)
        self.value = linear(d_model, dk * n_heads, g)
        self.out = linear(dk * n_heads, d_model, g)
        self.tp = None

    def uses_flash(self, q_len: int, k_len: int, dk: int,
                   x: torch.Tensor) -> bool:
        """Whether a pass over inputs like x takes the flash branch."""
        rate = self.attention_dropout if self.training else 0.0
        return (self.use_flash and not self.causal
                and self.dtype == torch.bfloat16 and rate == 0.0
                and q_len == k_len and dk in FLASH_DKS
                and on_accelerator(x))

    def uses_kernel(self, q_len: int, k_len: int, dk: int) -> bool:
        """The fused gate, which the flash branch goes before."""
        return (self.use_fused and not self.causal and q_len == k_len
                and (self.fused_max_len == 0 or q_len <= self.fused_max_len)
                and q_len >= self.fused_min_len
                and dk <= 128)

    def forward(self, q_in, k_in, v_in,
                generator: Optional[torch.Generator] = None):
        tp = self.tp
        h = self.n_heads if tp is None else self.n_heads // tp.size("model")
        if tp is not None:
            q_in, k_in, v_in = copy_inputs(tp, q_in, k_in, v_in)
        b, l = q_in.shape[:2]
        dt = self.dtype
        q = dense(q_in, self.query, dt).unflatten(-1, (h, -1))   # (B, L, H, dk)
        k = dense(k_in, self.key, dt).unflatten(-1, (h, -1))
        v = dense(v_in, self.value, dt).unflatten(-1, (h, -1))
        dk = q.shape[-1]
        # bh = b * H + h, as the JAX package folds (the dropout hash's bh)
        fold = lambda z: z.transpose(1, 2).contiguous().view(b * h, l, dk)
        if self.uses_flash(l, k_in.shape[1], dk, q):
            o = flash_attention(fold(q), fold(k), fold(v), 1.0 / math.sqrt(dk))
            out = o.view(b, h, l, dk).transpose(1, 2)
        elif self.uses_kernel(l, k_in.shape[1], dk):
            rate = self.attention_dropout if self.training else 0.0
            seed = dropout_seed(generator) if rate > 0.0 else 0
            o = fused_attention(fold(q), fold(k), fold(v), 1.0 / math.sqrt(dk),
                                rate, seed)
            out = o.view(b, h, l, dk).transpose(1, 2)
        else:
            qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))  # (B, H, L, dk)
            if dt == torch.bfloat16:
                # the score matrix is stored bf16 (f32 accumulation)
                scores = torch.matmul(qh, kh.transpose(-1, -2)).float()
            else:
                scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
            if self.causal:
                later = triangular_causal_mask(1, l, scores.device)[0, 0]
                scores = scores.masked_fill(later, float("-inf"))
            a = torch.softmax(scores / math.sqrt(dk), dim=-1)
            a = dropout(a, self.attention_dropout, generator, self.training,
                        model_dim=None if tp is None else 1, mesh=tp)
            out = torch.matmul(a.to(vh.dtype), vh).transpose(1, 2)
        out = out.reshape(b, l, h * dk).to(dt)
        if tp is not None:
            return row_parallel(out, self.out, dt, tp)
        return dense(out, self.out, dt)


class EncoderLayer(nn.Module):
    """Post-norm attention + pointwise FFN. `variant` picks the attention:
    'full' (`FullAttentionLayer`, kernels K5/K6 behind its gate), or the
    JAX package's extra variants 'ds', 'prob' and 'lsh'
    (models/extra/attention_variants.py; plain PyTorch, as the JAX package
    leaves them to XLA; 'lsh' is shared-QK self-attention). With
    `moe_experts` > 0 a Switch mixture of expert FFNs (`moe_ffn`,
    models/moe.py) replaces the dense one (`conv1`, `conv2`); its training
    forward appends its load-balance loss to the `aux` list."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 dtype: torch.dtype, g: torch.Generator,
                 activation: str = "gelu", use_fused: bool = False,
                 fused_max_len: int = 4096, fused_min_len: int = 256,
                 use_flash: bool = False, variant: str = "full",
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25,
                 moe_top_k: int = 1, moe_aux_weight: float = 0.01,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.activation = activation
        self.dropout = dropout
        self.variant = variant
        if variant == "full":
            self.attention = FullAttentionLayer(
                d_model, n_heads, dtype, g, use_fused=use_fused,
                fused_max_len=fused_max_len, fused_min_len=fused_min_len,
                use_flash=use_flash, attention_dropout=dropout)
        else:
            from sie_tpu_torch.models.extra import attention_variants as av
            cls = {"ds": av.DSAttentionLayer, "prob": av.ProbAttentionLayer,
                   "lsh": av.LSHAttentionLayer}.get(variant)
            if cls is None:
                raise ValueError(f"unknown attention_variant {variant!r}")
            self.attention = cls(d_model, n_heads, dtype, g,
                                 attention_dropout=dropout)
        self.norm1 = layer_norm_module(d_model)
        if moe_experts > 0:
            from sie_tpu_torch.models.moe import MoEFFN
            self.moe_ffn = MoEFFN(d_model, d_ff, moe_experts, dtype, g,
                                  moe_capacity_factor, moe_top_k, dropout,
                                  activation, moe_aux_weight)
        else:
            self.conv1 = linear(d_model, d_ff, g)
            self.conv2 = linear(d_ff, d_model, g)
        self.norm2 = layer_norm_module(d_model)
        self.tp = None   # a mesh: conv1 column-, conv2 row-parallel

    def _attend(self, x, generator):
        """The attention of x. On a time block (a step's 'seq' axis) the
        layer input is gathered over time, the attention runs at the whole
        T (kernels K5/K6 on this rank's batch and head rows; every 'seq'
        rank repeats it, where GSPMD runs the JAX package's kernels) and
        this rank keeps its block of queries."""
        if self.variant == "lsh":
            attend = lambda z: self.attention(z, generator)
        else:
            attend = lambda z: self.attention(z, z, z, generator)
        return comm.whole_time(attend, x, keep_block=True)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                aux: Optional[list] = None):
        drop = lambda z: dropout(z, self.dropout, generator, self.training,
                                 seq_dim=1)
        x = x + drop(self._attend(x, generator))
        x = y = layer_norm(self.norm1, x)
        act = F.relu if self.activation == "relu" else gelu
        if hasattr(self, "moe_ffn"):
            y = drop(self.moe_ffn(y, generator, aux))
        elif self.tp is not None:
            (y,) = copy_inputs(self.tp, y)
            y = dropout(act(dense(y, self.conv1, self.dtype)), self.dropout,
                        generator, self.training, model_dim=-1, mesh=self.tp,
                        seq_dim=1)
            y = drop(row_parallel(y, self.conv2, self.dtype, self.tp))
        else:
            y = drop(act(dense(y, self.conv1, self.dtype)))
            y = drop(dense(y, self.conv2, self.dtype))
        return layer_norm(self.norm2, x + y)


class Encoder(nn.Module):
    """Stack of EncoderLayers + final LayerNorm. `aux` collects the MoE
    layers' training losses (EncoderLayer)."""

    def __init__(self, e_layers: int, d_model: int, **kw):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, **kw) for _ in range(e_layers))
        self.norm = layer_norm_module(d_model)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                aux: Optional[list] = None):
        for layer in self.layers:
            x = layer(x, generator, aux)
        return layer_norm(self.norm, x)


class ConvLayer(nn.Module):
    """The distil downsampling between encoder layers (the JAX package's
    `ConvLayer`): circular pad of 2 on each side of time, a k=3 conv
    (`downConv`, PyTorch's default init), BatchNorm (`norm`), ELU, then
    max-pool k=3, stride 2, pad 1 (-inf padding). (B, T, D) ->
    (B, floor((T+1)/2) + 1, D). No model of either package reaches it."""

    def __init__(self, d_model: int, dtype: torch.dtype, g: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.downConv = conv(nn.Conv1d, d_model, d_model, 3, g,
                             bias_fan_in=3 * d_model)
        self.norm = BatchNorm(d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = torch.cat([x[:, -2:], x, x[:, :2]], dim=1).transpose(1, 2)
        h = F.elu(self.norm(conv_forward(self.downConv, xp, self.dtype)))
        h = F.max_pool1d(F.pad(h, (1, 1), value=float("-inf")), 3, 2)
        return h.transpose(1, 2)


class DecoderLayer(nn.Module):
    """Post-norm causal self-attention, cross-attention over the encoder's
    output, and the pointwise FFN (`conv1`, `conv2`; relu or tanh-gelu by
    `activation`), each followed by dropout and a LayerNorm (`norm1`,
    `norm2`, `norm3`). Both attentions take the plain branch."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 dtype: torch.dtype, g: torch.Generator,
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.activation = activation
        self.dropout = dropout
        self.self_attention = FullAttentionLayer(
            d_model, n_heads, dtype, g, attention_dropout=dropout,
            causal=True)
        self.cross_attention = FullAttentionLayer(
            d_model, n_heads, dtype, g, attention_dropout=dropout)
        self.conv1 = linear(d_model, d_ff, g)
        self.conv2 = linear(d_ff, d_model, g)
        self.norm1 = layer_norm_module(d_model)
        self.norm2 = layer_norm_module(d_model)
        self.norm3 = layer_norm_module(d_model)

    def forward(self, x, cross,
                generator: Optional[torch.Generator] = None):
        drop = lambda z: dropout(z, self.dropout, generator, self.training)
        x = layer_norm(self.norm1, x + drop(
            self.self_attention(x, x, x, generator)))
        x = y = layer_norm(self.norm2, x + drop(
            self.cross_attention(x, cross, cross, generator)))
        act = F.relu if self.activation == "relu" else gelu
        y = drop(act(dense(y, self.conv1, self.dtype)))
        y = drop(dense(y, self.conv2, self.dtype))
        return layer_norm(self.norm3, x + y)


class Decoder(nn.Module):
    """Stack of DecoderLayers, a final LayerNorm (`norm`) and the
    `projection` to c_out."""

    def __init__(self, d_layers: int, d_model: int, c_out: int,
                 dtype: torch.dtype, g: torch.Generator, **kw):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, dtype=dtype, g=g, **kw)
            for _ in range(d_layers))
        self.norm = layer_norm_module(d_model)
        self.projection = linear(d_model, c_out, g)

    def forward(self, x, cross, generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = layer(x, cross, generator)
        return dense(layer_norm(self.norm, x), self.projection, self.dtype)


class TorchTransformerEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer's defaults as the EEGCNN head uses
    them (the JAX package's `TorchTransformerEncoderLayer`): post-norm,
    ReLU FFN, separate `q`/`k`/`v`/`out_proj` projections, `norm1`/`norm2`
    and `linear1`/`linear2`, dropout at `dropout` after the softmax, the
    attention and each FFN linear. A key with mask 0 scores -1e30 (not
    -inf), so a fully masked row stays a uniform softmax. Plain torch
    attention: the JAX package runs no kernel here either.

    Init: q/k/v xavier-uniform with zero bias, out_proj PyTorch's Linear
    default with zero bias, linear1/linear2 PyTorch's Linear defaults."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dropout: float, dtype: torch.dtype, g: torch.Generator):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = dropout
        self.dtype = dtype
        for name in ("q", "k", "v", "out_proj"):
            lin = linear(d_model, d_model, g)
            if name != "out_proj":
                uniform_(lin.weight, math.sqrt(3.0 / d_model), g)
            with torch.no_grad():
                lin.bias.zero_()
            setattr(self, name, lin)
        self.norm1 = layer_norm_module(d_model)
        self.linear1 = linear(d_model, d_ff, g)
        self.linear2 = linear(d_ff, d_model, g)
        self.norm2 = layer_norm_module(d_model)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, L, d_model); mask (B, L) bool, True where a key is kept."""
        drop = lambda z: dropout(z, self.dropout, generator, self.training)
        dt = self.dtype
        b, l, d = x.shape
        split = lambda z: z.unflatten(-1, (self.n_heads, -1)).transpose(1, 2)
        q, k, v = (split(dense(x, lin, dt)) for lin in (self.q, self.k,
                                                        self.v))
        dk = q.shape[-1]
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)
                              ) / math.sqrt(dk)            # (B, H, L, L)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
        a = drop(torch.softmax(scores, dim=-1))
        out = torch.matmul(a.to(dt).float(), v.float())    # (B, H, L, dk)
        out = out.transpose(1, 2).reshape(b, l, d).to(dt)
        x = layer_norm(self.norm1, x + drop(dense(out, self.out_proj, dt)))
        y = drop(F.relu(dense(x, self.linear1, dt)))
        y = dense(y, self.linear2, dt)
        return layer_norm(self.norm2, x + drop(y))


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` as the JAX package configures it (momentum 0.9,
    epsilon 1e-5), over a channels-first input: the features on axis 1,
    statistics over every other axis.

    In training mode it normalises with the batch's statistics, computed
    in float32 as flax's fast variance does (mean(x^2) - mean(x)^2,
    clamped at 0: the biased variance), and moves the running buffers in
    place, without gradient: mean <- 0.9 mean + 0.1 batch mean, var <-
    0.9 var + 0.1 batch variance. torch.nn.BatchNorm* would move `var`
    by the unbiased variance (x n/(n-1)), so it is not used. In eval mode
    it normalises with the buffers and moves nothing. The normalisation is
    float32, (x - mean) * (rsqrt(var + eps) * weight) + bias, returned in
    `dtype`. Parameters `weight` and `bias` are flax's `scale` and `bias`
    (1 and 0); buffers `mean` and `var` its `batch_stats` (0 and 1).
    Under a step's mesh with more than one 'data' or 'seq' rank the
    statistics are the global batch's: the f32 sums of x and x^2 are
    summed over 'data' and 'seq' (`comm.data_sum`, `comm.seq_sum`, with
    their gradient) before the division. `valid`, a (T,) mask along the
    last axis, leaves the steps where it is 0 out of the statistics (a
    time block's steps past the end of a VALID conv's output), and `n`
    is then the global count of the steps it keeps."""

    def __init__(self, features: int, dtype: torch.dtype,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                n: Optional[int] = None) -> torch.Tensor:
        xf = x.float()
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            axes = (0,) + tuple(range(2, x.ndim))
            dp = comm.data_size()
            if dp > 1 or comm.seq_size() > 1 or valid is not None:
                xs = xf if valid is None else xf * valid
                sums = torch.stack([xs.sum(axes), (xs * xf).sum(axes)])
                sums = comm.seq_sum(comm.data_sum(sums) if dp > 1 else sums)
                if n is None:
                    n = (xf.numel() // xf.shape[1]) * dp * comm.seq_size()
                mean = sums[0] / n
                var = torch.clamp(sums[1] / n - mean.square(), min=0.0)
            else:
                mean = xf.mean(axes)
                var = torch.clamp(xf.square().mean(axes) - mean.square(),
                                  min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean * (1.0 - m))
                self.var.mul_(m).add_(var * (1.0 - m))
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)
