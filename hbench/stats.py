"""The end-to-end arithmetic of a window, kept apart so that tests can
hold it to hand counts."""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def itl_p95_ms(step_seconds: Sequence[float], tokens: Sequence[int]) -> float:
    """The 95th percentile of every gap between consecutive tokens of a
    sequence: a step of ``dt`` seconds that gave ``n`` slots a token gives
    n gaps of dt.  Taken over all gaps, not over medians of chunks."""
    gaps = np.repeat(np.asarray(step_seconds, np.float64), np.asarray(tokens, np.int64))
    return 1e3 * float(np.percentile(gaps, 95)) if gaps.size else float("nan")


def rate(tokens: Iterable[int], seconds: Iterable[float]) -> float:
    """Tokens over the seconds that made them (whole steps only)."""
    return float(sum(tokens)) / float(sum(seconds))


def busy_and_gaps(intervals: Iterable[Tuple[float, float]], w0: float,
                  w1: float) -> Tuple[float, List[Tuple[float, float]]]:
    """(the length of the union of ``intervals`` clipped to [w0, w1], the
    idle gaps of the window between them)."""
    busy, gaps, end = 0.0, [], w0
    for a, b in sorted(intervals):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps
