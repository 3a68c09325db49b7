"""The program's kernels by name, as the device trace shows them: the
`__global__` functions of sie_tpu_torch/csrc/, in the trace with their
namespace and template arguments ("void (anonymous namespace)::
l1_fwd_kernel<10, false>(...)")."""

import re

_L1 = re.compile(r"(^|[\s:])l1_(fwd|bwd)")
_ATTN = re.compile(r"(^|[\s:])attn_")
_CONV = re.compile(r"cudnn|implicit_gemm")


def is_l1(name: str) -> bool:
    """K1-K4: l1_fwd_kernel, l1_fwd_grouped, l1_bwd_partial,
    l1_bwd_reduce, l1_bwd_grouped_partial, l1_bwd_grouped_reduce."""
    return bool(_L1.search(name))


def is_attention(name: str) -> bool:
    """K5-K10: attn_fwd_*, attn_bwd_dkv_*, attn_bwd_dq_*, attn_flash_*."""
    return bool(_ATTN.search(name))


def is_conv(name: str) -> bool:
    """cuDNN's convolutions (the FCN expert's): "cudnn::cnn::..." and
    "sm80_xmma_{fprop,dgrad,wgrad}_implicit_gemm_..."."""
    return bool(_CONV.search(name))
