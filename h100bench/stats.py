"""Statistics over a measured window."""

from __future__ import annotations

import statistics


def rate(units: float, seconds: float) -> float:
    """Units completed over the window's wall time (every stall included)."""
    if seconds <= 0:
        raise ValueError("an empty window has no rate")
    return units / seconds


def p95(values) -> float:
    """The 95th percentile of every value (``statistics.quantiles``'
    inclusive method: linear between the closest ranks)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def intervals_union(spans) -> float:
    """Total length covered by (start, end) spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
