"""Tails and rates, as the end-to-end metrics take them."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile (0-100) with linear interpolation between the
    two nearest ranks (numpy's default); NaN for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    return float(count) / float(seconds)
