"""The end-to-end arithmetic, frozen with the benchmark.

A rate is all the work completed in the window over the window's
seconds; a tail is the nearest-rank percentile of every call's latency
in the window.  ``spread`` is the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the
median: what the bounds in ``BENCHMARK.json`` were set from.
"""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """``work`` per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return work / seconds


def percentile(values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``pct``
    percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(pct / 100.0 * len(ordered)))
    return ordered[rank - 1]


def beyond(n: int, pct: float) -> int:
    """How many of ``n`` values lie above the nearest-rank ``pct``
    percentile."""
    return n - max(1, math.ceil(pct / 100.0 * n))


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median of ``values``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
