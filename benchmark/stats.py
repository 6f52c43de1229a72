"""Percentiles and means over a run's requests."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence


def percentile(values: Sequence[float], q: float, misses: int = 0,
               miss_value: Optional[float] = None) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``
    and ``misses`` further samples that rank above every value. When the
    rank falls on a miss, ``miss_value`` (which the caller chooses above
    every possible value) is returned. None for no sample at all."""
    n = len(values) + misses
    if n == 0:
        return None
    rank = max(1, math.ceil(q / 100.0 * n))
    ordered = sorted(values)
    if rank <= len(ordered):
        return ordered[rank - 1]
    return miss_value


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
