"""Percentiles and censored tails, in plain Python."""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0..100), linear between order statistics
    (numpy's default); None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def censored(events: Iterable[tuple], close: float) -> List[float]:
    """Ages from (start, end or None): ``end - start`` where the event came
    by ``close``, else ``close - start``, so a stall stays in the tail."""
    out = []
    for start, end in events:
        if end is not None and end <= close:
            out.append(end - start)
        else:
            out.append(close - start)
    return out

