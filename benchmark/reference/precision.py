"""Operand rounding of the plain reference's products.

`prec` names the arithmetic of every matrix product the configuration runs
in its compute type:
- "f32": float32 operands, TF32 off (the reference proper);
- "tf32": float32 operands, TF32 on (the control of a float32
  configuration; the caller turns TF32 on, `tf32_matmuls`);
- "bf16": operands rounded to bfloat16, products accumulated in float32;
- "fp8": operands rounded to float8 e4m3 with a per-tensor scale, the
  gradients' operands to e5m2 (the control of a bfloat16 configuration).
Rounded products run through `Product`, whose backward rounds its
operands in the same way.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def rnd(t: torch.Tensor, prec: str, grad: bool = False) -> torch.Tensor:
    """t rounded to `prec` and back to float32."""
    if prec == "bf16":
        return t.to(torch.bfloat16).float()
    if prec == "fp8":
        fmt = torch.float8_e5m2 if grad else torch.float8_e4m3fn
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX[fmt]
        return (t / scale).to(fmt).float() * scale
    return t


def rounds(prec: str) -> bool:
    return prec in ("bf16", "fp8")


def control_of(cfg) -> str:
    """The precision of the control: the nearest below the
    configuration's (fp8 under amp's bf16, TF32 for float32)."""
    return "fp8" if cfg["amp"] else "tf32"


class Product(torch.autograd.Function):
    """a @ b with both operands rounded to `prec`; the backward's products
    round theirs too (the incoming gradient as a gradient)."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        return torch.matmul(rnd(a, prec), rnd(b, prec))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        prec = ctx.prec
        gq = rnd(g, prec, grad=True)
        ga = torch.matmul(gq, rnd(b, prec).transpose(-1, -2))
        gb = torch.matmul(rnd(a, prec).transpose(-1, -2), gq)
        # broadcast batch dimensions back to each operand's shape
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if rounds(prec):
        return Product.apply(a, b, prec)
    return torch.matmul(a, b)


@contextlib.contextmanager
def tf32_matmuls(on: bool):
    """TF32 products on or off inside the block; the previous settings
    return after it."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
