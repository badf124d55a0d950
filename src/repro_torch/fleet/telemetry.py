"""Per-group and fleet-wide serving telemetry.

The fleet's wall clock is the tick; every tick the engine reports which
groups decoded.  From those samples plus the per-group ``ServeStats`` and
the completion stamps on the requests themselves, this module derives the
quantities the benchmarks compare:

* slot-step efficiency (useful tokens / slot-steps) — the paper's
  utilization metric lifted to the fleet,
* request latency percentiles (p50/p95/p99, per tenant too),
* throughput (tokens and requests per wall tick, plus a rolling window),
* reconfiguration churn (splits+fuses per kilotick),
* utilization (fraction of group-ticks that decoded),
* migration traffic (queue steals, live migrations, KV-transfer stall
  ticks — per group in :class:`GroupSnapshot` and fleet-wide in the
  ``migration`` summary block when a planner is wired).

It also hosts the control plane's :class:`~repro_torch.control.ReplayBuffer`:
every group's ``GroupController`` logs one (features, realized-win)
sample per decision tick into it, and an ``online`` policy refits its
logistic model from the same buffer — telemetry is the training-data
pipe of the monitor -> predict -> reconfigure loop.

Telemetry is the *aggregate* view; the per-decision view lives in
:mod:`repro_torch.obs` — a structured :class:`~repro_torch.obs.events.EventLog`
(reconfig/steal/migrate/... records with tick + (gid, part) address) and
a per-tick :class:`~repro_torch.obs.metrics.MetricsRegistry`.  When
``FleetConfig.obs`` is enabled, :meth:`summary` carries the event counts
under an ``"obs"`` block.  The reference's decision audit, exporters and
text reports (``repro/obs/{audit,export,report}.py``) are not ported yet.

Counterpart of ``repro/fleet/telemetry.py``; summaries are equal to the
reference's on the same run.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control import ReplayBuffer
from repro_torch.serve.engine import Request, ServeStats


class RollingWindow:
    """Cumulative-counter samples over a sliding window of wall ticks."""

    def __init__(self, window: int = 256):
        self.window = window
        self._samples: Deque[Tuple[int, float]] = collections.deque()

    def push(self, tick: int, cumulative: float) -> None:
        self._samples.append((tick, cumulative))
        while self._samples and self._samples[0][0] < tick - self.window:
            self._samples.popleft()

    def push_gap(self, ticks: int) -> None:
        """Carry the last cumulative value across an idle fast-forward.

        Idle ticks produce no tokens/completions, so the counter is flat
        across the gap; pushing a boundary sample at the far edge keeps
        the rate window honest (and expires samples older than the
        window) instead of computing over a stale pre-gap span.  No-op
        before the first real sample — an all-idle prefix has no counter
        to carry.
        """
        if ticks <= 0 or not self._samples:
            return
        t1, v1 = self._samples[-1]
        self.push(t1 + ticks, v1)

    def rate(self) -> float:
        """Mean increase per tick across the retained window."""
        if len(self._samples) < 2:
            return 0.0
        (t0, v0), (t1, v1) = self._samples[0], self._samples[-1]
        return (v1 - v0) / max(t1 - t0, 1)


@dataclass
class GroupSnapshot:
    gid: int
    mode: str
    is_split: bool
    queue_depth: int
    live: int
    stats: ServeStats
    topology: Optional[Tuple[int, ...]] = None

    def as_dict(self) -> Dict:
        return {
            "gid": self.gid, "mode": self.mode, "is_split": self.is_split,
            "topology": list(self.topology) if self.topology else None,
            "queue_depth": self.queue_depth, "live": self.live,
            "ticks": self.stats.ticks, "slot_steps": self.stats.slot_steps,
            "useful_tokens": self.stats.useful_tokens,
            "efficiency": round(self.stats.efficiency, 4),
            "splits": self.stats.splits, "fuses": self.stats.fuses,
            "resizes": self.stats.resizes,
            "completed": self.stats.completed,
            # cross-group migration (repro_torch.fleet.migrate)
            "stall_ticks": self.stats.stall_ticks,
            "steals_in": self.stats.steals_in,
            "steals_out": self.stats.steals_out,
            "migrations_in": self.stats.migrations_in,
            "migrations_out": self.stats.migrations_out,
            # slack leases (repro_torch.fleet.lease): slots granted, cumulative
            "leases_out": self.stats.leases_out,
            "leases_in": self.stats.leases_in,
        }


def percentile(values: Sequence[float], q: float) -> float:
    if not len(values):
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


class FleetTelemetry:
    """Collects tick samples during a run and summarizes at the end."""

    def __init__(self, window: int = 256, replay_capacity: int = 4096):
        self.window = window
        self.wall_ticks = 0
        self.idle_ticks = 0
        self.active_group_ticks = 0
        self.group_tick_slots = 0
        self.tokens_window = RollingWindow(window)
        self.done_window = RollingWindow(window)
        self.queue_depths: List[int] = []
        # (features, realized-win) decision log; see module docstring
        self.replay = ReplayBuffer(maxlen=replay_capacity)

    # -- during the run --------------------------------------------------------

    def on_tick(self, tick: int, groups, ticked: int,
                all_idle: bool = False) -> None:
        self.wall_ticks = tick + 1
        self.active_group_ticks += ticked
        self.group_tick_slots += len(groups)
        if all_idle:
            # a reconfig-only tick (ticked == 0 but not idle) is churn, not
            # idleness — only a fleet-wide IDLE probe counts here
            self.idle_ticks += 1
        self.tokens_window.push(
            tick, sum(g.stats.useful_tokens for g in groups))
        self.done_window.push(
            tick, sum(g.stats.completed for g in groups))
        self.queue_depths.append(sum(len(g.queue) for g in groups))

    def on_idle_gap(self, ticks: int, n_groups: int) -> None:
        """Account for wall ticks the engine fast-forwarded while idle,
        so utilization/idle_ticks/queue depth stay consistent with
        wall_ticks."""
        if ticks <= 0:
            return
        self.wall_ticks += ticks
        self.idle_ticks += ticks
        self.group_tick_slots += ticks * n_groups
        self.queue_depths.extend([0] * ticks)
        # rolling counters are flat across an idle gap; push the boundary
        # so post-gap rates don't average over a stale pre-gap window
        self.tokens_window.push_gap(ticks)
        self.done_window.push_gap(ticks)

    # -- at the end -------------------------------------------------------------

    @staticmethod
    def latencies(requests: Sequence[Request],
                  tenant: Optional[str] = None) -> np.ndarray:
        lats = [r.latency for r in requests
                if r.finish is not None
                and (tenant is None or r.tenant == tenant)]
        return np.asarray(lats, np.float64)

    def summary(self, groups, requests: Sequence[Request],
                policy=None, fleet_controller=None,
                router_state: Optional[Dict] = None,
                obs=None, metrics=None) -> Dict:
        snaps = [GroupSnapshot(
            gid=g.gid, mode=g.mode, is_split=g.is_split,
            queue_depth=len(g.queue), live=len(g.live_requests()),
            stats=g.stats, topology=getattr(g, "topology", None))
            for g in groups]
        slot_steps = sum(g.stats.slot_steps for g in groups)
        useful = sum(g.stats.useful_tokens for g in groups)
        completed = sum(g.stats.completed for g in groups)
        churn = sum(g.stats.splits + g.stats.fuses + g.stats.resizes
                    for g in groups)
        lats = self.latencies(requests)
        wall = max(self.wall_ticks, 1)
        out = {
            "wall_ticks": self.wall_ticks,
            "idle_ticks": self.idle_ticks,
            "slot_steps": slot_steps,
            "useful_tokens": useful,
            "completed": completed,
            "submitted": len(requests),
            "efficiency": round(useful / max(slot_steps, 1), 4),
            "throughput_tokens_per_tick": round(useful / wall, 3),
            "throughput_requests_per_tick": round(completed / wall, 4),
            "rolling_tokens_per_tick": round(self.tokens_window.rate(), 3),
            "rolling_requests_per_tick": round(self.done_window.rate(), 4),
            "utilization": round(
                self.active_group_ticks / max(self.group_tick_slots, 1), 4),
            "mean_queue_depth": round(float(np.mean(self.queue_depths)), 2)
            if self.queue_depths else 0.0,
            "churn_per_kilotick": round(1000.0 * churn / wall, 2),
            "latency": {
                "mean": round(float(lats.mean()), 2) if lats.size else 0.0,
                "p50": round(percentile(lats, 50), 1),
                "p95": round(percentile(lats, 95), 1),
                "p99": round(percentile(lats, 99), 1),
                "max": round(float(lats.max()), 1) if lats.size else 0.0,
            },
            "groups": [s.as_dict() for s in snaps],
        }
        control: Dict = {"replay_samples": len(self.replay)}
        visited = set()
        for g in groups:
            ctl = getattr(g, "controller", None)
            if ctl is not None:
                for _, _frm, to, _, _ in ctl.state.transitions:
                    visited.add(tuple(to))
        if visited:
            control["topologies_visited"] = [
                list(t) for t in sorted(visited, key=lambda t: (len(t), t))]
            control["hetero_topologies_visited"] = sum(
                1 for t in visited if len(set(t)) > 1)
        if self.replay:
            control["replay_positive_frac"] = round(
                self.replay.label_balance(), 3)
        if policy is not None:
            control["policy"] = getattr(policy, "name", str(policy))
            refits = getattr(policy, "refits", None)
            if refits is not None:
                control["refits"] = refits
                if getattr(policy, "refit_info", None):
                    control["last_refit"] = policy.refit_info[-1]
        if fleet_controller is not None:
            control["fleet_rebalances"] = fleet_controller.rebalances
            reserved = getattr(fleet_controller, "reserved_parts", None)
            if reserved is not None and fleet_controller.quarantine is not None:
                control["reserved_parts"] = sorted(
                    list(a) for a in reserved(groups))
        if router_state is not None and "planner" in router_state:
            # the router/planner loop: pinned admissions rerouted off hot
            # groups via the planner's pressure view (scheduler._spill)
            control["admission_spills"] = router_state.get("spills", 0)
        out["control"] = control
        planner = getattr(fleet_controller, "planner", None)
        if planner is not None:
            mig = planner.summary()
            mig["stall_ticks"] = sum(g.stats.stall_ticks for g in groups)
            out["migration"] = mig
        # slack leases (repro_torch.fleet.lease): grant/revoke/expire counters
        # plus the zero-stall contract counter
        leases = getattr(fleet_controller, "leases", None)
        if leases is not None:
            out["lease"] = leases.summary()
        # the cluster layer (not ported yet): per-chip pressure, regions,
        # and per-tier byte/stall traffic from the tiered planner
        cluster_summary = getattr(fleet_controller, "cluster_summary", None)
        if cluster_summary is not None:
            out["cluster"] = cluster_summary(groups)
        # the per-decision record (repro_torch.obs): event counts only — full
        # event dumps go through the exporters, not the summary.  Absent
        # entirely when obs is off so summaries stay bit-identical.
        if obs is not None and obs.enabled:
            out["obs"] = obs.summary()
            if metrics is not None:
                out["obs"]["metrics"] = metrics.snapshot()
        tenants = sorted({r.tenant for r in requests})
        if len(tenants) > 1:
            out["per_tenant"] = {}
            for t in tenants:
                tl = self.latencies(requests, tenant=t)
                out["per_tenant"][t] = {
                    "n": int(tl.size),
                    "p50": round(percentile(tl, 50), 1),
                    "p99": round(percentile(tl, 99), 1),
                }
        return out
