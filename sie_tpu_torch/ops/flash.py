"""Kernels K9, K10b and K10a: the JAX package's stock flash attention,
forward and backward, as `FullAttentionLayer`'s `use_flash` branch runs it
(sie_tpu/models/layers.py `_flash`, through
jax/experimental/pallas/ops/tpu/flash_attention.py).

`flash_attention` is the entry: the autograd function `FlashAttention`,
whose forward is K9 (the registered op `sie_tpu_torch::flash_fwd`) and
whose backward launches K10b (`flash_attention_bwd_dkv`: each row's di =
sum(o * dO), then dK and dV) and then K10a (`flash_attention_bwd_dq`: dQ),
in the order of the stock kernel's custom VJP (flash_attention.py:254-315).
For CPU tensors they run the plain versions `flash_attention_plain` and
`flash_attention_bwd_plain`; for CUDA tensors the hand-written kernels,
which are the bf16 warpgroup-MMA bodies of K5 and K6 instantiated with the
stock kernels' numerics (`flash_fwd` in csrc/attention_fwd.cu,
`flash_bwd_dkv` and `flash_bwd_dq` in csrc/attention_bwd.cu; the sources
say what bounds them and how dk 256 is split). There is no other route.

Numerics (no dropout, not causal), those of the stock kernels: s = Q K^T
accumulates in f32 from bf16 and is scaled in f32, not rounded to bf16
(K5 rounds it); the forward's unnormalised probabilities exp(s - m) are
rounded to bf16 for P V, which accumulates in f32, and the output is
rounded to bf16 once. The backward recomputes p in f32, then dV +=
bf16(p)^T dO, dP = dO V^T, dS = (dP - di) p scale, dK += bf16(dS)^T Q, dQ +=
bf16(dS) K, all sums in f32, the gradients rounded to bf16. The forward
saves each row's natural log-sum-exp for the kernels' backward (p = exp(s
- lse)), where the stock kernel saves its running max m and sum l (p =
exp(s - m) / l): the same probabilities up to f32 rounding.

The JAX package pads T to a multiple of 128 and masks the padding by
segment ids. Padded keys get p = 0 for the real rows, and the padded rows
get dO = 0 (their outputs are sliced off) and so di = 0 and dS = 0: they
change nothing, and the port needs no padding. The kernels mask keys at or
past T, at any T.

The plain versions hold (BH, chunk, T) f32 scores at a time, over chunks
of query rows (exact: the softmax is over keys), so that they run at the
long T that this branch is documented for.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sie_tpu_torch.ops import build

FLASH_DKS = (64, 128, 256)   # the head widths of the JAX package's gate
CHUNK = 1024                 # query rows of the plain versions at a time


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * Q K^T in f32, the scores not rounded to bf16."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, chunk: int = CHUNK) -> torch.Tensor:
    """softmax(scale * Q K^T) V with the stock forward's roundings: p =
    exp(s - max s) rounded to v's dtype, f32 P V, divided by the f32 row
    sum, rounded to q's dtype once."""
    out = torch.empty_like(q)
    v32 = v.float()
    for r0 in range(0, q.shape[1], chunk):
        s = _scores(q[:, r0:r0 + chunk], k, scale)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        pv = torch.matmul(p.to(v.dtype).float(), v32)
        out[:, r0:r0 + chunk] = (pv / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    return out


def flash_lse_plain(q: torch.Tensor, k: torch.Tensor, scale: float,
                    chunk: int = CHUNK) -> torch.Tensor:
    """The row log-sum-exp (BH, T) f32 of the f32 scores."""
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    for r0 in range(0, q.shape[1], chunk):
        lse[:, r0:r0 + chunk] = torch.logsumexp(
            _scores(q[:, r0:r0 + chunk], k, scale), dim=-1)
    return lse


def flash_delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = sum(o * dO) of each row (BH, T) in f32, as the stock VJP takes
    it from the bf16 output."""
    return (o.float() * do.float()).sum(dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              delta: torch.Tensor, scale: float,
                              chunk: int = CHUNK
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dQ, dK, dV) of `flash_attention_plain` for the output gradient do,
    as the stock backward kernels compute them (not autograd of the plain
    forward, whose roundings differ), from di = `flash_delta_plain(o,
    do)`: p in f32; dV = bf16(p)^T dO; dS = (dO V^T - di) p scale; dQ =
    bf16(dS) K; dK = bf16(dS)^T Q; f32 sums over chunks of query rows."""
    t = q.shape[1]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k32, v32 = k.float(), v.float()
    for r0 in range(0, t, chunk):
        r1 = min(t, r0 + chunk)
        p = torch.softmax(_scores(q[:, r0:r1], k, scale), dim=-1)
        d32 = do[:, r0:r1].float()
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), d32)
        dp = torch.matmul(d32, v32.transpose(-1, -2))
        ds = ((dp - delta[:, r0:r1, None]) * p * scale).to(q.dtype).float()
        dq[:, r0:r1] = torch.matmul(ds, k32)
        dk += torch.matmul(ds.transpose(-1, -2), q[:, r0:r1].float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(what: str, q: torch.Tensor, *more: torch.Tensor) -> bool:
    """Validates (BH, T, dk) bf16 inputs, dk in FLASH_DKS; True when they
    lie on a CUDA device, False when all lie on the CPU."""
    ts = (q,) + more
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{what}: inputs must share one (BH, T, dk) shape; "
                         f"got {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise ValueError(f"{what} takes bf16 inputs; got "
                         f"{[str(t.dtype) for t in ts]}")
    if q.shape[-1] not in FLASH_DKS:
        raise ValueError(f"{what} takes dk in {FLASH_DKS}; got "
                         f"dk={q.shape[-1]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous inputs")
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"{what}: inputs must all be on one CUDA device or "
                         f"all on the CPU; got {sorted(map(str, devices))}")
    if q.shape[0] * q.shape[1] > 2 ** 31 - 1:
        raise ValueError(f"{what} indexes the BH * T rows with 32-bit ints; "
                         f"BH * T = {q.shape[0] * q.shape[1]}")
    return True


def _check_rows(what: str, q: torch.Tensor,
                *rows: Optional[torch.Tensor]) -> None:
    """The (BH, T) f32 row vectors (lse, delta) that a backward kernel
    reads, contiguous on q's card."""
    for r in rows:
        if r is None or tuple(r.shape) != tuple(q.shape[:2]) or \
                r.dtype != torch.float32 or not r.is_contiguous() or \
                r.device != q.device:
            raise ValueError(f"{what} needs the forward's row log-sum-exp "
                             f"(and K10b's di) as contiguous f32 (BH, T) "
                             f"tensors on q's card")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy where its data is not 16-byte aligned: the kernels
    stage every tile by TMA, which needs aligned tensors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, want_lse: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launches K9 on CUDA tensors that `flash_attention` has checked;
    returns (out, its row log-sum-exp (BH, T) f32 when want_lse, else
    None)."""
    bh, t, dk = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bh, t), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0:
        return out, lse
    q, k, v = (_aligned(z) for z in (q, k, v))
    lib = build.load("attention_fwd")
    with torch.cuda.device(q.device):
        code = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, t, dk, float(scale),
            _stream(q.device))
    build.check(code, "flash_fwd (K9)")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: Optional[torch.Tensor],
                            scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Kernel K10b: (dK, dV, di) for the output gradient do, from the
    forward's output o and row log-sum-exp lse (BH, T) f32, which only the
    kernel reads; di (BH, T) f32 goes on to K10a. CPU tensors go to the
    plain versions."""
    if not _check("K10b", q, k, v, o, do):
        delta = flash_delta_plain(o, do)
        _, dk, dv = flash_attention_bwd_plain(q, k, v, do, delta, scale)
        return dk, dv, delta
    _check_rows("K10b", q, lse)
    bh, t, dkd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dk, dv, delta
    q, k, v, o, do = (_aligned(z) for z in (q, k, v, o, do))
    lib = build.load("attention_bwd")
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, t, dkd, float(scale), _stream(q.device))
    build.check(code, "flash_bwd_dkv (K10b)")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv, delta


flash_attention_bwd_dkv.launches = 0   # K10b launches in this process


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: Optional[torch.Tensor], delta: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Kernel K10a: dQ for the output gradient do, from the forward's row
    log-sum-exp and K10b's di. CPU tensors go to the plain version."""
    if not _check("K10a", q, k, v, do):
        return flash_attention_bwd_plain(q, k, v, do, delta, scale)[0]
    _check_rows("K10a", q, lse, delta)
    bh, t, dkd = q.shape
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    q, k, v, do = (_aligned(z) for z in (q, k, v, do))
    lib = build.load("attention_bwd")
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, dkd,
            float(scale), _stream(q.device))
    build.check(code, "flash_bwd_dq (K10a)")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0   # K10a launches in this process


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty((0,), dtype=torch.float32)


@torch.library.custom_op("sie_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, want_lse: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 as a registered op: (out, row log-sum-exp (BH, T) f32, or an
    empty tensor unless want_lse); on the CPU the plain versions."""
    out = flash_attention_plain(q, k, v, scale)
    return out, (flash_lse_plain(q, k, scale) if want_lse else _no_lse(q))


@flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, scale, want_lse):
    out, lse = flash_fwd(q, k, v, scale, want_lse)
    return out, (lse if want_lse else _no_lse(q))


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, scale, want_lse):
    lse = (q.new_empty(q.shape[:2], dtype=torch.float32) if want_lse
           else _no_lse(q))
    return torch.empty_like(q), lse


class FlashAttention(torch.autograd.Function):
    """out = flash_attention(q, k, v, scale) through the op `flash_fwd`
    (K9); backward K10b, then K10a (or the plain versions for CPU
    tensors). The forward writes K9's row log-sum-exp only when a gradient
    is wanted and the kernels read it."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        want_lse = q.device.type != "cpu" and any(ctx.needs_input_grad[:3])
        out, lse = flash_fwd_op(q, k, v, scale, want_lse)
        ctx.save_for_backward(q, k, v, out, lse if want_lse else None)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        dk, dv, delta = flash_attention_bwd_dkv(q, k, v, out, g, lse,
                                                ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q, k, v (BH, T, dk) bf16, dk in {64, 128, 256}, any T -> (BH, T, dk)
    bf16: softmax(scale * Q K^T) V in the stock flash kernels' numerics.
    Differentiable in q, k and v."""
    _check("K9", q, k, v)
    return FlashAttention.apply(q, k, v, float(scale))


flash_attention.launches = 0   # K9 launches in this process
