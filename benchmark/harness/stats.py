"""Frozen statistics: percentiles of a whole window's samples."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default). An infinite sample (a failed
    answer) sorts last. Empty input gives nan."""
    s = sorted(values)
    if not s:
        return math.nan
    pos = (len(s) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    if s[hi] == math.inf:
        return math.inf if pos > lo or s[lo] == math.inf else s[lo]
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def mean(values: Sequence[float]) -> float:
    return sum(values) / len(values) if values else math.nan
