"""The numbers that decide `correct`, each a gap between what the timed
path produced and what the plain reference gives for the same inputs.

Training (three steps from the same weights on the same rows):
- loss_gap: the relative gap of the first step's loss;
- grad_gap: over the leaves, the largest gap between the norms of the
  program's and the reference's first gradient, over the reference's
  norm of that leaf or of the median leaf, whichever is larger;
- change_gap: the median over the leaves of the same gap of each leaf's
  change after the three steps, leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (nought to
  rounding, as a key's bias under softmax: Adam moves them by round-off
  alone);
- grad_diff_gap: the median over the leaves of the norm of the
  difference of the two first gradients, over the same denominator,
  leaving out the same leaves as change_gap: a gap of norms
  averages rounding away, so a product one precision down can leave
  every gap of norms within what sound runs read (PERF.md), while the
  difference keeps it.
A cell compares the numbers its limits name (`cells/<cell>.json`); the
others are printed for the record. The later steps' losses and the
worst leaf's change are never compared:
Adam's first step at the configurations' rate moves every weight of the
flattened projection by about the rate whatever its gradient's size, so
the signs of gradients nought to rounding set the later losses, and
they swing from seed to seed in any precision (PERF.md, Findings). They are
returned for the record.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

LEAF_FLOOR = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               names: List[str]) -> List[Tuple[float, str]]:
    med = statistics.median(ref[n] for n in names)
    return sorted((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n)
                  for n in names)


def training(prog: Dict, ref: Dict):
    """prog and ref as `reference.adam.steps` returns them -> ({number:
    (value, where)} compared, {reading: (value, where)} for the
    record)."""
    names = sorted(ref["grad_norms"])
    if sorted(prog["grad_norms"]) != names:
        raise ValueError("the program's leaves differ from the reference's")
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    grad = _leaf_gaps(prog["grad_norms"], ref["grad_norms"], names)[-1]
    med = statistics.median(ref["grad_norms"][n] for n in names)
    moved = [n for n in names if ref["grad_norms"][n] >= LEAF_FLOOR * med]
    grad_diff = statistics.median(
        float((prog["grads"][n] - ref["grads"][n]).norm())
        / max(ref["grad_norms"][n], med, 1e-30) for n in moved)
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    mid = statistics.median(g for g, _ in change)
    where = f"median of {len(moved)} leaves"
    compared = {"loss_gap": (steps[0], "step 1"), "grad_gap": grad,
                "grad_diff_gap": (grad_diff, where),
                "change_gap": (mid, where)}
    record = {"later_loss_gap": (max(steps[1:], default=0.0),
                                 " ".join(f"{g:.3g}" for g in steps)),
              "worst_change_gap": change[-1]}
    return compared, record
