"""The numbers that decide ``correct``, each beside its limit.

Training: each of the first steps' loss, its gradient as the outer
optimizer takes it, and the change of every trainable. A gradient or a
change is compared leaf by leaf by its norm: the gap between the
program's norm and the reference's, over the reference's norm of that leaf
or of the median leaf, whichever is larger (some gradients are all but
zero); the worst leaf's gap and the median leaf's are read. Leaves whose
gradient in the reference is under a thousandth of the median leaf's (a
bias before batch norm, the learning rate of such a bias) move under Adam
by round-off alone: they are left out of the change.

Serving: each sampled request's largest gap between a probability the
program answered and the reference's; the worst request's and the median
request's are read.

A cell's limits file names the numbers it compares (``set_limits.py``).
"""

import statistics
from typing import Dict, List, Optional

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the change
ROUNDING_LEAF_SHARE = 1e-3


def loss_gap(program: List[float], reference: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float], keys: Optional[List[str]] = None) -> List[float]:
    """Every leaf's ``|‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖)``, sorted."""
    keys = list(reference) if keys is None else keys
    median = statistics.median(reference.values())
    return sorted(abs(program[k] - reference[k]) / max(reference[k], median) for k in keys)


def moved_leaves(first_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(first_grad.values())
    return [k for k, v in first_grad.items() if v >= ROUNDING_LEAF_SHARE * median]


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` for every number the cell's limits
    name (the readings may hold more, for the calibration)."""
    missing = sorted(set(limits) - set(readings))
    if missing:
        raise KeyError(f"limits of numbers the driver does not read: {missing}")
    return {name: {"value": readings[name], "limit": limits[name]} for name in limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
