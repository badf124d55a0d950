"""Straggler detection for the synchronous training loop.

Counterpart of ``repro/train/stragglers.py``, on the port's ``control``.

At 1000-node scale one slow host gates every step (synchronous SPMD).  The
monitor tracks a robust EWMA of step wall-time and flags steps beyond
``threshold`` x the moving estimate.  On a real fleet the flag feeds the
control plane (re-shard input files away from the slow host, evict it, or
let the elastic restore shrink the mesh); here it records and reports, and
the trainer exposes the hook.

The *decision* of when a straggling phase warrants a mesh reconfiguration
is not hand-rolled here: each step's excess-time fraction (how much of
the step ran beyond the EWMA — the training analogue of the divergent
slot fraction) feeds a shared :class:`repro_torch.control.GroupController`
running the same :class:`~repro_torch.control.ThresholdPolicy` hysteresis the
serving engine uses.  ``recommend_scale_out`` is True while the
controller holds the split state: sustained straggling past the
threshold, with dwell so one slow step never triggers a reshard.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.control import (ConfigSpace, FeatureVector,
                                 GroupController, ThresholdPolicy)


@dataclass
class StragglerMonitor:
    threshold: float = 2.0          # x EWMA that counts as a straggle
    alpha: float = 0.1              # EWMA factor
    warmup: int = 3                 # ignore compile/first steps
    dwell: int = 4                  # controller dwell between recommendations
    on_straggle: Optional[Callable[[int, float, float], None]] = None

    ewma: float = 0.0
    seen: int = 0
    events: List[dict] = field(default_factory=list)
    _t0: float = 0.0

    def __post_init__(self):
        # excess fraction 1 - ewma/dt crosses this exactly when
        # dt > threshold * ewma — the same trigger as the event log,
        # but run through the shared hysteresis+dwell state machine
        split_at = 1.0 - 1.0 / max(self.threshold, 1.0 + 1e-9)
        self.controller = GroupController(
            policy=ThresholdPolicy(split_threshold=split_at,
                                   fuse_threshold=0.5 * split_at),
            space=ConfigSpace(capacity=2, max_ways=2),
            dwell=self.dwell)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        self.seen += 1
        if self.seen <= self.warmup:
            self.ewma = dt
            return dt
        if dt > self.threshold * self.ewma and self.ewma > 0:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
            if self.on_straggle:
                self.on_straggle(step, dt, self.ewma)
        excess = max(0.0, 1.0 - self.ewma / dt) if dt > 0 else 0.0
        self.controller.observe(FeatureVector(divergence=excess))
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt

    @property
    def recommend_scale_out(self) -> bool:
        """True while sustained straggling says: shrink/re-split the mesh."""
        return self.controller.state.split

    @property
    def straggle_rate(self) -> float:
        denom = max(self.seen - self.warmup, 1)
        return len(self.events) / denom
