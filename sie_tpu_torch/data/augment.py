"""Training-time data augmentation on the device (counterpart of
sie_tpu/data/augment.py): opt-in, beyond the reference, off by default.

Selected by name with `--augment` (comma-separated), applied in that order
inside the train step (`Trainer._device_step`), so on the card it is part
of the captured CUDA graph; the eval paths never augment:

- `noise`:  additive Gaussian noise, sigma = augment_noise_std times the
            per-sample std over the valid (mask = 1) region, added at valid
            steps only (padding stays exactly zero, a padded sample's sigma
            is not diluted by its padding);
- `scale`:  per-sample amplitude scaling by 1 + augment_scale_std * N(0, 1);
- `chdrop`: per-sample channel dropout with probability augment_chdrop_prob,
            the kept channels scaled by 1/(1 - p);
- `tshift`: circular time shift by a per-sample integer offset in
            [-augment_tshift_max, augment_tshift_max] (a gather; the padding
            mask is rolled with the data).

The random draws (`draw`) are kept apart from the arithmetic
(`apply_augmentations`), so the tests hand the JAX package's draws to the
port's arithmetic. The JAX package draws from threefry keys folded per
step; the port draws from a torch generator of its own (the trainer's
`augment_generator`), so the streams differ and the arithmetic is what is
held equal. Every step is a tensor op on the batch's device: no host
synchronisation, nothing that a CUDA graph cannot capture.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

KNOWN = ("noise", "scale", "chdrop", "tshift")


def validate(names: Tuple[str, ...]) -> Tuple[str, ...]:
    bad = [n for n in names if n not in KNOWN]
    if bad:
        raise ValueError(f"unknown augmentations {bad}; known: {KNOWN}")
    return names


def draw(cfg, shape: Tuple[int, int, int],
         generator: torch.Generator) -> List[torch.Tensor]:
    """The draws of each augmentation of cfg.augment, in its order, for a
    batch of `shape` (B, T, C), on the generator's device: `noise` a normal
    (B, T, C), `scale` a normal (B, 1, 1), `chdrop` a keep mask (B, 1, C)
    that is True with probability 1 - p, `tshift` an int64 offset (B,) in
    [-m, m]."""
    b, t, c = shape
    dev = generator.device
    out = []
    for name in validate(tuple(cfg.augment)):
        if name == "noise":
            out.append(torch.randn((b, t, c), generator=generator,
                                   device=dev))
        elif name == "scale":
            out.append(torch.randn((b, 1, 1), generator=generator,
                                   device=dev))
        elif name == "chdrop":
            out.append(torch.rand((b, 1, c), generator=generator, device=dev)
                       < 1.0 - cfg.augment_chdrop_prob)
        else:
            m = int(cfg.augment_tshift_max)
            out.append(torch.randint(-m, m + 1, (b,), generator=generator,
                                     device=dev))
    return out


def apply_augmentations(cfg, x: torch.Tensor, mask: torch.Tensor,
                        draws: Sequence[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, C) f32 and the padding mask (B, T), augmented by cfg.augment
    with `draws` (from `draw`, or the JAX package's at the same shapes):
    the JAX function's arithmetic, step by step."""
    names = validate(tuple(cfg.augment))
    _b, t, c = x.shape
    for name, d in zip(names, draws):
        if name == "noise":
            m = mask[:, :, None].to(x.dtype)
            n_valid = torch.clamp(m.sum(dim=(1, 2), keepdim=True) * c,
                                  min=1.0)
            mean = (x * m).sum(dim=(1, 2), keepdim=True) / n_valid
            var = ((x - mean).square() * m).sum(dim=(1, 2),
                                                keepdim=True) / n_valid
            x = x + cfg.augment_noise_std * torch.sqrt(var) * m * d.to(
                x.dtype)
        elif name == "scale":
            x = x * (1.0 + cfg.augment_scale_std * d.to(x.dtype))
        elif name == "chdrop":
            p = cfg.augment_chdrop_prob
            x = torch.where(d, x / (1.0 - p),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        else:
            idx = (torch.arange(t, device=x.device)[None, :]
                   - d.to(x.device, torch.int64)[:, None]) % t
            x = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, c))
            mask = torch.gather(mask, 1, idx)
    return x, mask
