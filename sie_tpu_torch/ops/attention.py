"""Kernels K5 and K6: the fused full softmax attention, forward and
backward, with the Pallas kernels' attention dropout.

`fused_attention` is the entry: the autograd function `FusedAttention`,
whose forward is K5 and whose backward is K6 (`attention_bwd`). For CPU
tensors they run the plain versions `attention_plain` and
`attention_bwd_plain`; for CUDA tensors the hand-written kernels in
`csrc/attention_fwd.cu` and `csrc/attention_bwd.cu` (which replace the
Pallas kernels `_fwd_kernel` and `_bwd_kernel` of
sie_tpu/ops/pallas/attention_pallas.py; the sources say what bounds them
and how they are laid out). There is no other route.

The forward K5 is the registered PyTorch op `sie_tpu_torch::attention_fwd`
(`torch.library.custom_op`, returning the output and the row log-sum-exp,
empty when not wanted): the CPU implementation is the plain version, the
CUDA implementation the kernel's launch (which counts it), and a fake
implementation gives the output shapes, so `torch.export` keeps each
launch as one node of the graph. `FusedAttention` calls it in its forward.
The dropout seed goes to the op as one int32 tensor, or None at rate 0.

Dropout follows the Pallas kernels: a keep mask from a murmur3 counter hash
of (seed, bh, global query row, global key column) (`dropout_keep`), the
same bits in the forward and the backward, the kernels and the plain
versions, and in the JAX package for the same int32 seed.

Long sequences. The JAX package sends T > 4096 (or any T with `block_kv`)
to three kv-blocked Pallas kernels of the same function:
`_fwd_kv_kernel` (K7, attention_pallas.py:163), an online softmax over key
blocks that also writes the row log-sum-exp; `_dq_kv_kernel` (K8a, :202),
dQ over key blocks from that LSE; and `_dkv_kv_kernel` (K8b, :236), dK and
dV over query blocks; both recompute delta = rowsum(dO * O). The kernels
here already have that structure at every T: K5 walks 64-key tiles with an
online softmax and writes the row LSE when a gradient is wanted (K7's
contract: dropout after the row-sum update, keyed on global (row, column)),
and K6 runs a delta pass, a dK/dV pass over query tiles (K8b) and a dQ pass
over key tiles (K8a) from that LSE. Nothing in them is sized by T (shared
memory holds fixed tiles, the grid is T / 64 tiles times BH, with no
limit on BH but BH * T < 2^31), so K5 and K6 are the
port's K7 and K8a/K8b too; there is no second variant and no block-size
argument. At long T the (BH, T, T) plain versions cannot be held, so
`attention_plain_chunked` and `attention_bwd_plain_chunked` compute the same
values over chunks of query rows (exact: the softmax is over keys), with the
global rows and columns and the index of the first (batch, head) row in the
hash, so that a slice of heads can be checked against a full launch.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from sie_tpu_torch.ops import build

_DTYPES = (torch.bfloat16, torch.float32)
_M32 = 0xFFFFFFFF

Seed = Union[int, torch.Tensor]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and c < 2^32, in 16-bit
    halves so that no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _keep_threshold(rate: float) -> int:
    """A hash at or above this keeps its element: P(keep) = 1 - rate."""
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep(seed: Seed, bh, rows, cols, rate: float) -> torch.Tensor:
    """The keep mask (True = kept) of the Pallas kernels' `_dropout_mask`
    (attention_pallas.py:73-94), bit for bit: key = seed * 0x9E3779B9 ^
    bh * 0x85EBCA6B; x = (row * 0x27D4EB2F + col) ^ key; three murmur3
    finaliser rounds; keep = x >= min(rate * 2^32, 2^32 - 1). uint32
    arithmetic is done in int64, masked to 32 bits after every step.
    `bh` is the index into the folded (B * H) axis, b * H + h; `rows` and
    `cols` are global query and key indices; the arguments broadcast."""
    dev = next((t.device for t in (rows, cols, bh) if torch.is_tensor(t)),
               None)
    seed, bh, rows, cols = (torch.as_tensor(z, device=dev).to(torch.int64)
                            & _M32 for z in (seed, bh, rows, cols))
    key = _mul32(seed, 0x9E3779B9) ^ _mul32(bh, 0x85EBCA6B)
    x = ((_mul32(rows, 0x27D4EB2F) + cols) & _M32) ^ key
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= _keep_threshold(rate)


def _keep(seed: Seed, bh: int, t: int, rate: float, device: torch.device,
          rows: Optional[Tuple[int, int]] = None,
          bh0: int = 0) -> torch.Tensor:
    """(BH, rows, T) keep mask of one attention call: query rows
    [r0, r1) (all T by default) of (batch, head) rows bh0 ... bh0 + bh - 1."""
    r0, r1 = rows if rows is not None else (0, t)
    return dropout_keep(
        seed, torch.arange(bh0, bh0 + bh, device=device)[:, None, None],
        torch.arange(r0, r1, device=device)[:, None],
        torch.arange(t, device=device)[None, :], rate)


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(scale * Q K^T) in f32 with `_score_block`'s rounding: f32
    scores, rounded to bf16 before the scale when the inputs are bf16."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if q.dtype == torch.bfloat16:
        s = s.to(torch.bfloat16).float()
    return torch.softmax(s * scale, dim=-1)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, rate: float = 0.0,
                    seed: Seed = 0) -> torch.Tensor:
    """softmax(scale * Q K^T) V with the Pallas kernel's roundings and
    dropout: f32 softmax, then where(keep, a / (1 - rate), 0), cast to v's
    dtype, f32 accumulation of P V."""
    a = _probs(q, k, scale)
    if rate > 0.0:
        keep = _keep(seed, q.shape[0], q.shape[1], rate, q.device)
        a = torch.where(keep, a * (1.0 / (1.0 - rate)), 0.0)
    out = torch.matmul(a.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, scale: float, rate: float = 0.0,
                        seed: Seed = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of `attention_plain`, as the Pallas `_bwd_kernel`
    computes them (not autograd of the plain forward, whose roundings
    differ): a = softmax; ad = keep ? a/(1-rate) : 0; dV = ad^T dO with ad
    in dO's dtype; dA = keep ? dO V^T/(1-rate) : 0; dS = (dA a - a
    rowsum(dA a)) scale, rounded to q's dtype; dQ = dS K; dK = dS^T Q."""
    a = _probs(q, k, scale)
    d32 = do.float()
    da = torch.matmul(d32, v.float().transpose(-1, -2))
    ad = a
    if rate > 0.0:
        keep = _keep(seed, q.shape[0], q.shape[1], rate, q.device)
        inv = 1.0 / (1.0 - rate)
        ad = torch.where(keep, a * inv, 0.0)
        da = torch.where(keep, da * inv, 0.0)
    dv = torch.matmul(ad.to(do.dtype).float().transpose(-1, -2), d32)
    tmp = da * a
    ds = (tmp - a * tmp.sum(dim=-1, keepdim=True)) * scale
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_plain_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float, rate: float = 0.0,
                            seed: Seed = 0, bh0: int = 0,
                            chunk: int = 1024) -> torch.Tensor:
    """`attention_plain` over chunks of `chunk` query rows, holding (BH,
    chunk, T) scores at a time; q, k, v are (batch, head) rows bh0 ...
    bh0 + BH - 1 of a launch, which the dropout hash keys on."""
    bh, t, _ = q.shape
    out = torch.empty_like(q)
    for r0 in range(0, t, chunk):
        r1 = min(t, r0 + chunk)
        a = _probs(q[:, r0:r1], k, scale)
        if rate > 0.0:
            keep = _keep(seed, bh, t, rate, q.device, (r0, r1), bh0)
            a = torch.where(keep, a * (1.0 / (1.0 - rate)), 0.0)
        out[:, r0:r1] = torch.matmul(a.to(v.dtype).float(),
                                     v.float()).to(q.dtype)
    return out


def attention_bwd_plain_chunked(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                scale: float, rate: float = 0.0,
                                seed: Seed = 0, bh0: int = 0,
                                chunk: int = 1024
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """`attention_bwd_plain` over chunks of `chunk` query rows: dQ of a
    chunk from its rows alone, dK and dV summed over the chunks in f32;
    (batch, head) rows as in `attention_plain_chunked`."""
    bh, t, _ = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k32, v32 = k.float(), v.float()
    for r0 in range(0, t, chunk):
        r1 = min(t, r0 + chunk)
        a = _probs(q[:, r0:r1], k, scale)
        d32 = do[:, r0:r1].float()
        da = torch.matmul(d32, v32.transpose(-1, -2))
        ad = a
        if rate > 0.0:
            keep = _keep(seed, bh, t, rate, q.device, (r0, r1), bh0)
            inv = 1.0 / (1.0 - rate)
            ad = torch.where(keep, a * inv, 0.0)
            da = torch.where(keep, da * inv, 0.0)
        dv += torch.matmul(ad.to(do.dtype).float().transpose(-1, -2), d32)
        tmp = da * a
        ds = (tmp - a * tmp.sum(dim=-1, keepdim=True)) * scale
        ds = ds.to(q.dtype).float()
        dq[:, r0:r1] = torch.matmul(ds, k32)
        dk += torch.matmul(ds.transpose(-1, -2), q[:, r0:r1].float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           what: str, *more: torch.Tensor) -> bool:
    """Validates (BH, T, dk) inputs; True when they lie on a CUDA device,
    False when all lie on the CPU."""
    ts = (q, k, v) + more
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{what}: q, k, v{', ...' if more else ''} must "
                         f"share one (BH, T, dk) shape; got "
                         f"{[tuple(t.shape) for t in ts]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{what}: inputs must all be bf16 or all float32; "
                         f"got {[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous inputs")
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"{what}: inputs must all be on one CUDA device or "
                         f"all on the CPU; got {sorted(map(str, devices))}")
    bh, t, dk = q.shape
    if not 1 <= dk <= 128:
        raise ValueError(f"{what} takes 1 <= dk <= 128; got dk={dk}")
    if bh * t > 2 ** 31 - 1:
        raise ValueError(f"{what} indexes the BH * T rows with 32-bit ints; "
                         f"BH * T = {bh * t}")
    return True


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must be in [0, 1); got "
                         f"{rate}")


def _dropout_args(rate: float, seed: Seed, device: torch.device):
    """(dropout flag, seed tensor or None, keep threshold, 1/(1-rate)) for a
    kernel's C entry; the seed goes to the card as one int32."""
    if rate == 0.0:
        return 0, None, 0, 1.0
    if torch.is_tensor(seed):
        if seed.numel() != 1 or seed.dtype != torch.int32:
            raise ValueError(f"the dropout seed must be one int32; got "
                             f"{seed.dtype} of shape {tuple(seed.shape)}")
        seed_t = seed.to(device).contiguous()
    else:
        seed_t = torch.tensor([seed], dtype=torch.int32, device=device)
    return 1, seed_t, _keep_threshold(rate), 1.0 / (1.0 - rate)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, rate: float = 0.0, seed: Seed = 0,
                  want_lse: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launches K5 on CUDA tensors that `fused_attention` has checked;
    returns (out, its row log-sum-exp (BH, T) f32 when want_lse, else
    None)."""
    bh, t, dk = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bh, t), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0:
        return out, lse
    drop, seed_t, thresh, inv = _dropout_args(rate, seed, q.device)
    lib = build.load("attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if seed_t is None else seed_t.data_ptr(), bh, t, dk,
            float(scale), drop, thresh, inv, int(q.dtype == torch.bfloat16),
            stream)
    build.check(code, "attention_fwd")
    fused_attention.launches += 1
    return out, lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: Optional[torch.Tensor], do: torch.Tensor,
                  lse: Optional[torch.Tensor], scale: float,
                  rate: float = 0.0, seed: Seed = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K6: (dQ, dK, dV) of `fused_attention` for the output gradient
    do, from the forward's output o and row log-sum-exp lse (BH, T) f32,
    which only the kernel reads. CPU tensors go to `attention_bwd_plain`."""
    _check_rate(rate)
    if not _check(q, k, v, "K6", do):
        return attention_bwd_plain(q, k, v, do, scale, rate, seed)
    bh, t, dk = q.shape
    if o is None or lse is None or o.shape != q.shape or \
            o.dtype != q.dtype or not o.is_contiguous() or \
            tuple(lse.shape) != (bh, t) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or {o.device, lse.device} != {q.device}:
        raise ValueError("K6 needs the forward's output o (like q) and its "
                         "contiguous f32 row log-sum-exp lse (BH, T) on the "
                         "same card")
    dq, dkk, dv = (torch.empty_like(z) for z in (q, k, v))
    if q.numel() == 0:
        return dq, dkk, dv
    delta = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    drop, seed_t, thresh, inv = _dropout_args(rate, seed, q.device)
    lib = build.load("attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dkk.data_ptr(), dv.data_ptr(),
            None if seed_t is None else seed_t.data_ptr(), bh, t, dk,
            float(scale), drop, thresh, inv, int(q.dtype == torch.bfloat16),
            stream)
    build.check(code, "attention_bwd")
    attention_bwd.launches += 1
    return dq, dkk, dv


attention_bwd.launches = 0   # K6 launches in this process


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """The row log-sum-exp (BH, T) f32 of scale * Q K^T, with `_probs`'s
    rounding of the scores."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if q.dtype == torch.bfloat16:
        s = s.to(torch.bfloat16).float()
    return torch.logsumexp(s * scale, dim=-1)


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty((0,), dtype=torch.float32)


@torch.library.custom_op("sie_tpu_torch::attention_fwd", mutates_args=(),
                         device_types="cpu")
def attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, rate: float, seed: Optional[torch.Tensor],
                     want_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 as a registered op: (out, row log-sum-exp (BH, T) f32, or an
    empty tensor unless want_lse); on the CPU the plain versions."""
    out = attention_plain(q, k, v, scale, rate, 0 if seed is None else seed)
    return out, (attention_lse_plain(q, k, scale) if want_lse
                 else _no_lse(q))


@attention_fwd_op.register_kernel("cuda")
def _attention_fwd_cuda(q, k, v, scale, rate, seed, want_lse):
    out, lse = attention_fwd(q, k, v, scale, rate,
                             0 if seed is None else seed, want_lse)
    return out, (lse if want_lse else _no_lse(q))


@attention_fwd_op.register_fake
def _attention_fwd_fake(q, k, v, scale, rate, seed, want_lse):
    lse = (q.new_empty(q.shape[:2], dtype=torch.float32) if want_lse
           else _no_lse(q))
    return torch.empty_like(q), lse


class FusedAttention(torch.autograd.Function):
    """out = fused_attention(q, k, v, scale, rate, seed) through the op
    `attention_fwd` (K5); backward K6 (or the plain versions for CPU
    tensors). The forward writes K5's row log-sum-exp only when a gradient
    is wanted and the kernel reads it."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rate, seed):
        ctx.scale, ctx.rate, ctx.seed = scale, rate, seed
        want_lse = q.device.type != "cpu" and any(ctx.needs_input_grad[:3])
        seed_t = None
        if rate > 0.0:   # an int seed as the int32 of its low 32 bits
            seed_t = seed if torch.is_tensor(seed) else torch.tensor(
                [(int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31],
                dtype=torch.int32, device=q.device)
        out, lse = attention_fwd_op(q, k, v, scale, rate, seed_t, want_lse)
        ctx.save_for_backward(q, k, v, out, lse if want_lse else None)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, g.contiguous(), lse,
                                   ctx.scale, ctx.rate, ctx.seed)
        return dq, dk, dv, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, rate: float = 0.0,
                    seed: Seed = 0) -> torch.Tensor:
    """q, k, v (BH, T, dk), all bf16 or all float32 -> (BH, T, dk) of the
    same dtype: softmax(scale * Q K^T) V with attention dropout at `rate`
    (the hash keyed on `seed`, an int or one int32 tensor). Differentiable
    in q, k and v."""
    _check_rate(rate)
    _check(q, k, v, "K5")
    return FusedAttention.apply(q, k, v, float(scale), float(rate), seed)


fused_attention.launches = 0   # K5 launches in this process
