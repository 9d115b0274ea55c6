"""The comparison that decides `correct`: the program's first training
steps against the plain reference's replay of them.

Four numbers; a workload file states the limits of those its cell
compares:

- `loss_gap`: the largest relative gap between the program's world-mean
  loss and the reference's, over the first steps;
- `grad_gap`: over the leaves, the gap between the norm of the first
  averaged gradient as the program's optimizer holds it and the
  reference's, relative to the larger of the reference's norm of that
  leaf and the median leaf's;
- `change_gap`: the same of each leaf's change over the first steps
  (parameters and the buffers the step updates). A parameter whose
  reference gradient stays under a thousandth of the median leaf's at
  every step is left out: only round-off moves it;
- `median_change_gap`: the median leaf's gap of the change, steady from
  seed to seed where the widest gap is one small leaf's noise (ResNet,
  whose first gradients are zero in every residual branch behind its
  zero-initialised last norm, and nearly cancel in a bias before a norm).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

RULE = 1e-3  # a leaf under this share of the median gradient norm moves by round-off


def _gaps(program: Dict[str, float], reference: Dict[str, float], keys: List[str]) -> List[float]:
    """Each leaf's gap of norms, relative to the larger of the reference's
    norm of that leaf and of the median leaf."""
    if not keys:
        return [0.0]
    floor = statistics.median(reference[k] for k in keys)
    gaps = []
    for k in keys:
        gap = abs(program.get(k, 0.0) - reference[k]) / max(reference[k], floor, 1e-30)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """program: {"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}; the reference's has "max_grad_norms"
    too, each leaf's largest gradient norm over the steps."""
    loss_gap = 0.0
    for p, r in zip(program["losses"], reference["losses"]):
        gap = abs(p - r) / max(abs(r), 1e-30)
        loss_gap = max(loss_gap, gap if math.isfinite(gap) else math.inf)
    if len(program["losses"]) != len(reference["losses"]):
        loss_gap = math.inf
    grads = reference["grad_norms"]
    out = set(left_out(reference))
    moved = [k for k in reference["change_norms"] if k not in out]
    change = _gaps(program["change_norms"], reference["change_norms"], moved)
    return {
        "loss_gap": loss_gap,
        "grad_gap": max(_gaps(program["grad_norms"], grads, list(grads))),
        "change_gap": max(change),
        "median_change_gap": statistics.median(change),
    }


def left_out(reference: Dict) -> List[str]:
    """The parameters `numbers` leaves out of the change by the rule."""
    grads = reference["max_grad_norms"]
    median = statistics.median(grads.values()) if grads else 0.0
    return [k for k, g in grads.items() if g < RULE * median]


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(values[k]) and values[k] <= limits[k] for k in limits)
