"""Device choice for the port's entry points.

Every entry point takes a `device`; None means the card. Without a card
that default raises instead of quietly running the plain versions on the
CPU: pass `device="cpu"` for those.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        # f32 paths mean f32, and bf16 products accumulate in f32, as in the
        # JAX package: no TF32 matmuls or convolutions, no bf16 reductions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        # convolutions take deterministic algorithms, so a train step, eager
        # or replayed as a CUDA graph, repeats bit for bit
        torch.backends.cudnn.deterministic = True
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
