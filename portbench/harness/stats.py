"""The arithmetic of the metrics."""
from __future__ import annotations

import math

import numpy as np


def rank_percentile(values, q: float) -> float:
    """The ``q``-th percentile of every value by nearest rank: the
    smallest value with at least ``q`` percent of the values at or below
    it.  ``inf`` stands for a query never answered and sorts last."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        return math.nan
    return float(v[max(0, math.ceil(q / 100.0 * v.size) - 1)])


def bucket_percentile(cumulative: dict, q: float):
    """The upper bound of the histogram bucket that holds the ``q``-th
    percentile, from cumulative counts by bucket bound (``le``); None
    when the histogram is empty or the percentile lies past the last
    finite bound."""
    bounds = sorted((float(le), n) for le, n in cumulative.items())
    if not bounds or bounds[-1][1] <= 0:
        return None
    want = q / 100.0 * bounds[-1][1]
    for le, n in bounds:
        if n >= want:
            return None if math.isinf(le) else le
    return None


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, by ``statistics.quantiles(values, n=4)``."""
    import statistics
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
