"""The traced run's device timeline: profiler sub-windows and their reading.

``torch.profiler`` records kernels (CUPTI) and the benchmark's own host
annotations (``record_function``) in one clock.  A sub-window opens and
closes between engine ticks, when the device is idle (each tick ends in a
read-back), so it holds whole calls.  After the measured window has
closed each sub-window is reduced to plain lists:

* ``kernels``: (name, start_us, end_us) of every device operation
  (kernels, copies, sets);
* ``spans``: (name, start_us, end_us) of the host annotations;
* ``start_us``, ``end_us``: the sub-window.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

SUBWINDOW = "bench.subwindow"
# prefixes of the benchmark's own host annotations
OURS = ("bench.", "engine.", "group.", "model.")


def _ns(ev, what: str) -> Optional[float]:
    for attr, scale in ((f"{what}_ns", 1e-3), (f"{what}_us", 1.0)):
        fn = getattr(ev, attr, None)
        if fn is not None:
            return fn() * scale
    return None


def extract(prof) -> dict:
    """Plain lists from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    kernels, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        if start is None or dur is None:
            continue
        item = (ev.name(), start, start + dur)
        if ev.name().startswith(OURS):
            # the host annotations; their device-side copies
            # (gpu_user_annotation) are no device operation
            if ev.device_type() != DeviceType.CUDA:
                spans.append(item)
        elif ev.device_type() == DeviceType.CUDA:
            kernels.append(item)
    win = [s for s in spans if s[0] == SUBWINDOW]
    if not win:
        return {"kernels": [], "spans": [], "start_us": 0.0, "end_us": 0.0}
    lo, hi = win[0][1], win[0][2]
    kernels = [(n, max(s, lo), min(e, hi)) for n, s, e in kernels
               if e > lo and s < hi]
    return {"kernels": kernels, "spans": spans, "start_us": lo,
            "end_us": hi}


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_window_us(sub: dict) -> Tuple[float, float]:
    """(microseconds in which a device operation ran, sub-window length)."""
    busy = sum(e - s for s, e in union([(s, e) for _, s, e in
                                         sub["kernels"]]))
    return busy, sub["end_us"] - sub["start_us"]


def gaps(sub: dict) -> List[Tuple[float, float]]:
    """The idle intervals of the device inside the sub-window."""
    out, at = [], sub["start_us"]
    for s, e in union([(s, e) for _, s, e in sub["kernels"]]):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if sub["end_us"] > at:
        out.append((at, sub["end_us"]))
    return out


def label_at(spans: Sequence[Tuple[str, float, float]], t: float) -> str:
    """The innermost host annotation open at ``t`` (shortest covering)."""
    best, width = "harness", float("inf")
    for name, s, e in spans:
        if s <= t <= e and e - s < width and name != SUBWINDOW:
            best, width = name, e - s
    return best


def breakdown(subs: Sequence[dict], top: int = 10) -> dict:
    """The device operations that took most time, and idle time by what
    the host was doing, over every sub-window (seconds)."""
    ops: Dict[str, float] = collections.defaultdict(float)
    idle: Dict[str, float] = collections.defaultdict(float)
    for sub in subs:
        for name, s, e in sub["kernels"]:
            ops[name[:120]] += (e - s) * 1e-6
        spans = sorted(sub["spans"], key=lambda x: x[1])
        for s, e in gaps(sub):
            idle[label_at(spans, 0.5 * (s + e))] += (e - s) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def kernel_seconds(subs: Sequence[dict], needle: str) -> float:
    """Seconds of the device operations whose name contains ``needle``."""
    return sum((e - s) * 1e-6 for sub in subs
               for name, s, e in sub["kernels"] if needle in name)
