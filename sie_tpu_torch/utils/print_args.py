"""Pretty config dump: a copy of sie_tpu/utils/print_args.py (reference
utils/print_args.py:1-59 and Experiment.print_args, exp:285-293)."""

from __future__ import annotations

import dataclasses


def print_args(cfg) -> None:
    print("=" * 50)
    print("Experiment configuration:")
    print("=" * 50)
    if dataclasses.is_dataclass(cfg):
        items = dataclasses.asdict(cfg).items()
    else:
        items = vars(cfg).items()
    for k, v in items:
        print(f"  {k}: {v}")
    print("=" * 50)
