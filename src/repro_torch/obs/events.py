"""Structured event stream for the fleet/control/cluster stack.

AMOEBA's runtime is a monitor -> predict -> reconfigure loop; end-of-run
aggregates (:mod:`repro.fleet.telemetry`) can say *how often* the loop
fired but not *why* any individual firing happened.  The
:class:`EventLog` records every control-plane decision as a typed,
tick-stamped record so a run can be replayed decision by decision:

========== =================================================================
kind        emitted when
========== =================================================================
reconfig    a group changes topology (``ReconfigurableGroup.step``)
steal       a queued request moves between groups (``MigrationPlanner``)
migrate     an in-flight request moves with its KV rows
spill       the router reroutes a pinned admission off a hot group
region_grab a cluster region gathers or releases groups
admission   a prefill wave admits requests into a part
policy_decision  a ``GroupController`` resolves a topology proposal
refit       an online policy refits (or drift-resets) its predictor
stall       a part burns a tick paying a KV-transfer stall
lease       a slot lease is granted / revoked / expired (``LeasePlanner``)
========== =================================================================

Every event stamps ``gid`` with the *acting* group (the spill source,
the lease lender, the reconfiguring group); counterpart addresses ride
the payload (``dst``).

The log has three modes (``FleetConfig.obs``):

* ``off`` — ``emit`` returns immediately; hot paths guard on
  ``log.enabled`` before building payloads, so the only cost is one
  attribute check.  Summaries are bit-identical to a build without the
  log.
* ``summary`` — per-kind counters only; no ring, no payload retention.
* ``full`` — counters plus a bounded ring of :class:`Event` records and
  per-tick :class:`~repro.obs.metrics.MetricsRegistry` sampling.

Every emission site lives in *shared control-plane code* (never inside a
``VecGroup`` data-plane override), so the object and vec engines produce
identical event streams — asserted by ``tests/test_vec_equivalence.py``,
which makes the trace itself a correctness oracle for the control plane.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np

EVENT_KINDS = (
    "reconfig", "steal", "migrate", "spill", "region_grab",
    "admission", "policy_decision", "refit", "stall", "lease",
)

OBS_MODES = ("off", "summary", "full")


def jsonable(v: Any) -> Any:
    """Normalize a payload value to the JSON-stable fixed point.

    Tuples become lists and numpy scalars become native Python numbers,
    so a trace written to JSONL and read back compares equal to the
    in-memory event — the round-trip check in
    ``benchmarks/trace_report.py`` relies on this.  Normalization runs
    lazily on first *view* (:meth:`Event.as_dict`), not at emit time:
    the hot path just stores the payload dict, and a 30k-event run pays
    the recursive walk only for the events something actually reads.
    """
    if isinstance(v, (tuple, list)):
        return [jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: jsonable(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return [jsonable(x) for x in v.tolist()]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


@dataclass
class Event:
    """One typed control-plane record: what happened, where, and when.

    The payload is stored exactly as emitted (tuples, numpy scalars and
    all) and normalized to the JSON fixed point on first view — always
    read it through :meth:`as_dict`.
    """
    seq: int
    tick: int
    kind: str
    gid: int
    part: Optional[int] = None
    payload: Dict[str, Any] = field(default_factory=dict)
    _normalized: bool = field(default=False, repr=False, compare=False)

    def as_dict(self) -> Dict[str, Any]:
        if not self._normalized:
            self.payload = {k: jsonable(v) for k, v in self.payload.items()}
            self._normalized = True
        return {"seq": self.seq, "tick": self.tick, "kind": self.kind,
                "gid": self.gid, "part": self.part, "payload": self.payload}


class EventLog:
    """Ring-buffered structured event stream; near-zero cost when off.

    The engine owns the clock: :meth:`set_tick` is called once per wall
    tick, and emitters that have no tick in scope (policy refits, the
    controller's observe path) stamp records with ``self.now``.
    """

    def __init__(self, mode: str = "off", capacity: int = 65536):
        if mode not in OBS_MODES:
            raise ValueError(
                f"unknown obs mode {mode!r}; expected one of {OBS_MODES}")
        self.mode = mode
        self.enabled = mode != "off"
        self.full = mode == "full"
        self.capacity = int(capacity)
        self.counts: Dict[str, int] = {k: 0 for k in EVENT_KINDS}
        self.dropped = 0
        self.now = 0
        self._seq = 0
        self._ring: Deque[Event] = collections.deque(maxlen=self.capacity)
        # run-level context for exporters (mesh layout, wall ticks, ...)
        self.meta: Dict[str, Any] = {}

    def set_tick(self, tick: int) -> None:
        self.now = tick

    def emit(self, kind: str, gid: int = -1, part: Optional[int] = None,
             tick: Optional[int] = None, **payload: Any) -> None:
        if not self.enabled:
            return
        self.counts[kind] += 1
        self._seq += 1
        if not self.full:
            return
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(Event(
            seq=self._seq, tick=self.now if tick is None else int(tick),
            kind=kind, gid=int(gid),
            part=None if part is None else int(part),
            payload=payload))

    # -- views -----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def total(self) -> int:
        return self._seq

    def events(self, kind: Optional[str] = None) -> List[Event]:
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e.kind == kind]

    def count(self, kind: str) -> int:
        return self.counts[kind]

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "mode": self.mode,
            "total_events": self._seq,
            "by_kind": {k: self.counts[k] for k in EVENT_KINDS
                        if self.counts[k]},
        }
        if self.full:
            out["retained"] = len(self._ring)
            out["dropped"] = self.dropped
        return out

    def clear(self) -> None:
        self.counts = {k: 0 for k in EVENT_KINDS}
        self.dropped = 0
        self._seq = 0
        self._ring.clear()


#: Shared disabled log: every component that *may* be observed defaults to
#: this, so instrumented code never branches on ``obs is None``.
NULL_LOG = EventLog(mode="off")
