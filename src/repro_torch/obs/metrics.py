"""Counters, gauges, and histograms sampled per tick.

Where :class:`~repro_torch.obs.events.EventLog` answers *what happened*, the
:class:`MetricsRegistry` answers *what the fleet looked like* while it
happened: queue depth, live load, and per-tier transfer bytes, sampled
once per wall tick by the engine when ``FleetConfig.obs == "full"``.

Histograms are streaming power-of-two bucket counts (no sample
retention), so a 100k-tick run costs a fixed few dicts.  Everything
feeding the registry is shared control-plane state, so the object and
vec engines produce identical snapshots.

Counterpart of ``repro/obs/metrics.py``; snapshots are equal to the
reference's on the same run.
"""
from __future__ import annotations

from typing import Any, Dict


def _bucket(value: float) -> int:
    """Power-of-two bucket index: 0 for <=0, else bit_length(ceil(v))."""
    iv = int(value)
    if iv <= 0:
        return 0
    return iv.bit_length()


class Histogram:
    """Streaming histogram: count/sum/min/max plus log2 buckets."""

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets: Dict[int, int] = {}

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        b = _bucket(v)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": round(self.sum / self.count, 3),
            "min": self.min, "max": self.max,
            # bucket b holds values in [2^(b-1), 2^b); keys sorted for
            # stable JSON output
            "log2_buckets": {str(b): self.buckets[b]
                             for b in sorted(self.buckets)},
        }


class MetricsRegistry:
    """Named counters, last-value gauges, and streaming histograms."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    def count(self, name: str, delta: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.observe(value)

    # -- per-tick fleet sampling ----------------------------------------------

    def sample_fleet(self, tick: int, groups, planner=None,
                     live: int = None) -> None:
        """One wall tick's worth of fleet-shape samples.

        ``groups`` supply queue depth and live load (via the shared
        ``live_count`` hook); a cluster planner contributes per-tier
        cumulative byte gauges when present.  Callers that can compute
        the fleet-wide live count cheaper than a per-group scan (the
        vec engine's flat arrays) pass it via ``live``.
        """
        qd = sum(len(g.queue) for g in groups)
        if live is None:
            live = sum(g.live_count() for g in groups)
        self.observe("fleet.queue_depth", qd)
        self.observe("fleet.live", live)
        self.gauge("fleet.queue_depth", qd)
        self.gauge("fleet.live", live)
        self.gauge("fleet.tick", tick)
        tier_bytes = getattr(planner, "tier_bytes", None)
        if tier_bytes:
            for tier in sorted(tier_bytes):
                self.gauge(f"tier.{tier}.bytes", tier_bytes[tier])

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
            "histograms": {k: self.histograms[k].snapshot()
                           for k in sorted(self.histograms)},
        }
