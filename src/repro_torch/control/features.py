"""Telemetry feature extraction for the reconfiguration policies.

The paper's controller samples §4.1.2 hardware metrics from a short
profiling window and feeds them to the scalability predictor.  The serving
analogue samples the live state of one reconfigurable group each wall
tick: how divergent the decode batch is, how deep the admission queue is,
how fast work is arriving, and how spread-out the remaining lengths are.
Every policy in :mod:`repro.control.policies` consumes the same
:class:`FeatureVector`; the gpusim level keeps its own 11-metric vector
(``repro_torch.core.gpusim.sim.FEATURE_NAMES``) but flows through the same
policy objects.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Deque, Optional, Sequence, Tuple

import numpy as np

# canonical serve-level feature order (mirrors §4.1.2's sampled metrics)
SERVE_FEATURES = (
    "divergence",        # 1 - mean(remaining)/max(remaining) of the live batch
    "spread",            # std(remaining)/mean(remaining) — tail heaviness
    "queue_frac",        # queue depth / capacity — backfill availability
    "arrival_rate",      # recent admissions per tick
    "live_frac",         # live requests / capacity — how full the batch is
)


@dataclass
class FeatureVector:
    """One decision point's worth of live telemetry."""
    divergence: float = 0.0
    spread: float = 0.0
    queue_frac: float = 0.0
    arrival_rate: float = 0.0
    live_frac: float = 0.0
    # raw remaining lengths: the oracle and the regroup gain need the true
    # per-request state, not just its summary statistics
    remaining: Optional[np.ndarray] = None

    def to_array(self) -> np.ndarray:
        return np.array([self.divergence, self.spread, self.queue_frac,
                         self.arrival_rate, self.live_frac], np.float64)

    @staticmethod
    def from_group(remaining: Sequence[float], queue_depth: int,
                   arrival_rate: float, capacity: int) -> "FeatureVector":
        # keep already-drained rows as zeros: a fused batch whose short
        # members finished is *exactly* the divergence signal (those slots
        # run for nothing until the longest member drains)
        r = np.maximum(np.asarray(remaining, np.float64), 0.0)
        if r.size == 0 or r.max() <= 0:
            return FeatureVector(queue_frac=queue_depth / max(capacity, 1),
                                 arrival_rate=arrival_rate,
                                 remaining=r)
        mean = float(r.mean())
        return FeatureVector(
            divergence=float(1.0 - mean / r.max()),
            spread=float(r.std() / mean) if mean > 0 else 0.0,
            queue_frac=queue_depth / max(capacity, 1),
            arrival_rate=arrival_rate,
            live_frac=float((r > 0).sum()) / max(capacity, 1),
            remaining=r,
        )


class ArrivalRateTracker:
    """Rolling admissions-per-tick estimate over a short window."""

    def __init__(self, window: int = 32):
        self.window = window
        self._events: Deque[Tuple[int, int]] = collections.deque()

    def record(self, tick: int, n: int) -> None:
        if n:
            self._events.append((tick, n))
        while self._events and self._events[0][0] < tick - self.window:
            self._events.popleft()

    def rate(self, tick: int) -> float:
        while self._events and self._events[0][0] < tick - self.window:
            self._events.popleft()
        if not self._events:
            return 0.0
        return sum(n for _, n in self._events) / float(self.window)


class ReplayBuffer:
    """Bounded FIFO of (features, realized-win label) decision samples.

    The fleet telemetry logs one sample per decision tick; the
    :class:`~repro.control.policies.OnlinePolicy` periodically refits its
    logistic model from the buffer — the online-retraining loop the paper
    leaves as future work ("the model could be retrained on-line").

    Two staleness controls keep a regime change (bursty -> steady) from
    dominating the fit for ``maxlen`` samples: :meth:`weighted_dataset`
    decays each sample's fit weight exponentially with its age, and
    :meth:`reset` is the drift-reset hook that drops everything but the
    newest window outright.
    """

    def __init__(self, maxlen: int = 4096):
        self.maxlen = maxlen
        self._x: Deque[np.ndarray] = collections.deque(maxlen=maxlen)
        self._y: Deque[float] = collections.deque(maxlen=maxlen)
        # lifetime add count: sample i's absolute index survives eviction,
        # so the decision audit (repro.obs.audit) can map an event's
        # replay_idx back to a retained row via total_added - len(self)
        self.total_added = 0

    def add(self, features: np.ndarray, label: float) -> int:
        """Append a sample; returns its absolute (lifetime) index."""
        self._x.append(np.asarray(features, np.float64))
        self._y.append(float(label))
        idx = self.total_added
        self.total_added += 1
        return idx

    def __len__(self) -> int:
        return len(self._x)

    def dataset(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._x:
            return np.zeros((0, len(SERVE_FEATURES))), np.zeros((0,))
        return np.stack(list(self._x)), np.asarray(list(self._y))

    def weighted_dataset(self, half_life: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(X, y, w) with recency weights ``w = 0.5 ** (age / half_life)``.

        The newest sample has age 0 (weight 1.0); a sample one half-life
        older counts half as much in the refit.  ``half_life=None``
        returns uniform weights (the legacy FIFO behavior).
        """
        X, y = self.dataset()
        n = X.shape[0]
        if half_life is None or n == 0:
            return X, y, np.ones(n)
        age = np.arange(n - 1, -1, -1, dtype=np.float64)
        return X, y, 0.5 ** (age / max(half_life, 1))

    def tail(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """The newest ``n`` samples — the drift-detection window."""
        X, y = self.dataset()
        return X[-n:], y[-n:]

    def reset(self, keep_last: int = 0) -> None:
        """Drift-reset hook: forget everything but the newest samples."""
        if keep_last <= 0:
            self._x.clear()
            self._y.clear()
            return
        xs, ys = list(self._x)[-keep_last:], list(self._y)[-keep_last:]
        self._x.clear()
        self._y.clear()
        self._x.extend(xs)
        self._y.extend(ys)

    def label_balance(self) -> float:
        """Fraction of positive (split-wins) labels — refit gate."""
        if not self._y:
            return 0.0
        return float(np.mean(list(self._y)))
