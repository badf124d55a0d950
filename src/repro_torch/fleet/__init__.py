"""Multi-group reconfigurable serving: the chip-level AMOEBA layer.

``repro_torch.serve`` models one SM pair; this package scales it to a fleet of
N independently reconfigurable pairs behind a request router, fed by
trace-driven workloads, rebalanced by cross-group work stealing and
KV-costed live migration (``repro_torch.fleet.migrate``), topped up by
bounded slot leases (``repro_torch.fleet.lease``), and measured by
fleet-wide telemetry.  Counterpart of ``repro/fleet``; the cluster layer
built on it (``repro/cluster``) is not ported yet.
"""
from repro_torch.fleet.lease import Lease, LeasePlanner
from repro_torch.fleet.migrate import (KVTransferCost, Migration,
                                       MigrationPlanner)
from repro_torch.fleet.scheduler import (DEFAULT_MODES, ROUTERS,
                                         FleetEngine, replay_modes,
                                         replay_policies)
from repro_torch.fleet.telemetry import FleetTelemetry, RollingWindow
from repro_torch.fleet.traffic import (TenantProfile,
                                       bursty_longtail_trace,
                                       imbalanced_trace, make_trace,
                                       multichip_imbalanced_trace,
                                       poisson_trace, skewed_longtail_trace,
                                       transient_burst_trace, uniform_trace)
from repro_torch.fleet.vec import TrackedQueue, VecGroup, VecState

__all__ = [
    "FleetEngine", "ROUTERS", "DEFAULT_MODES", "replay_modes",
    "replay_policies", "FleetTelemetry", "RollingWindow",
    "VecState", "VecGroup", "TrackedQueue",
    "KVTransferCost", "Migration", "MigrationPlanner",
    "Lease", "LeasePlanner",
    "TenantProfile", "make_trace", "poisson_trace",
    "bursty_longtail_trace", "skewed_longtail_trace",
    "imbalanced_trace", "multichip_imbalanced_trace",
    "transient_burst_trace", "uniform_trace",
]
