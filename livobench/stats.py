"""The benchmark's arithmetic on samples."""

from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence

import numpy as np


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile by linear interpolation between order statistics
    (numpy's default): position q * (n - 1) in the sorted samples. None
    without samples."""
    v = sorted(values)
    if not v:
        return None
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median, quartiles as `statistics.quantiles(values, n=4)` gives
    them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def ate_rmse(est_pos, gt_pos) -> float:
    """Absolute trajectory error, the RMSE of position residuals, without
    alignment (a copy of the port's utils/metrics.ate_rmse)."""
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))
