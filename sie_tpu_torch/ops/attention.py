"""Kernel K5: the fused full softmax attention forward.

`fused_attention` is the wrapper: a CPU tensor goes to the plain version
`attention_plain`, a CUDA tensor to the hand-written kernel in
`csrc/attention_fwd.cu` (which replaces the Pallas kernel `_fwd_kernel` of
sie_tpu/ops/pallas/attention_pallas.py; the source says what bounds it and
how it is laid out). There is no other route.

Only `rate == 0` is ported: attention dropout (the Pallas kernel's murmur3
counter hash) arrives with the training slice and its backward kernel.
"""

from __future__ import annotations

import torch

from sie_tpu_torch.ops import build

_DTYPES = (torch.bfloat16, torch.float32)


def _check_rate(rate: float) -> None:
    if rate != 0.0:
        raise ValueError(f"attention dropout (rate={rate}) is not ported yet; "
                         f"only rate=0 is supported")


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, rate: float = 0.0) -> torch.Tensor:
    """softmax(scale * Q K^T) V with the Pallas kernel's roundings: f32
    scores, rounded to bf16 before the scale when the inputs are bf16, f32
    softmax, probabilities cast to v's dtype, f32 accumulation of P V."""
    _check_rate(rate)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if q.dtype == torch.bfloat16:
        s = s.to(torch.bfloat16).float()
    a = torch.softmax(s * scale, dim=-1)
    out = torch.matmul(a.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, rate: float = 0.0) -> torch.Tensor:
    """q, k, v (BH, T, dk), all bf16 or all float32 -> (BH, T, dk) of the
    same dtype: exact softmax(scale * Q K^T) V."""
    _check_rate(rate)
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (BH, T, dk) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bf16 or all float32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("K5 takes contiguous q, k, v")
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return attention_plain(q, k, v, scale)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"q, k, v must all be on one CUDA device or all on "
                         f"the CPU; got {sorted(map(str, devices))}")
    bh, t, dk = q.shape
    if not 1 <= dk <= 128:
        raise ValueError(f"K5 takes 1 <= dk <= 128; got dk={dk}")
    if bh > 65535:
        raise ValueError(f"K5 launches one grid row per (batch, head); "
                         f"BH={bh} exceeds 65535")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.load("attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), bh, t, dk, float(scale),
                                 int(q.dtype == torch.bfloat16), stream)
    build.check(code, "attention_fwd")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0   # kernel launches in this process
