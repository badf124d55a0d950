"""Hierarchical fleet-of-fleets on a 2D chip mesh with tiered costs.

The layer above ``repro_torch.fleet``: groups sit at 2D coordinates,
partitioned into chips (and chips into nodes), and moving state between
two groups is priced by the *tier* of the pair — intra-chip NoC,
inter-chip link, inter-node network — with per-hop latency.  A
:class:`ClusterController` steers each chip's split-mix against its own
pressure, gathers regions of adjacent groups for long-context tail
mass, and authorizes cross-chip steals and live migrations only when
the tiered cost amortizes; a :class:`ClusterEngine` drives it all with
the unchanged ``FleetEngine`` loop.

Counterpart of ``repro/cluster``: numpy and plain Python, the reference's
operations in its order, so plans, summaries and event streams are
bit-identical to the reference's on the same run.
"""
from repro_torch.cluster.controller import (ChipPressure,
                                            ClusterController,
                                            ClusterPlanner)
from repro_torch.cluster.engine import ClusterEngine
from repro_torch.cluster.mesh import (TIERS, ClusterMesh,
                                      TieredTransferCost)
from repro_torch.cluster.regions import Region, RegionManager

__all__ = [
    "TIERS", "ClusterMesh", "TieredTransferCost",
    "ClusterPlanner", "ClusterController", "ChipPressure",
    "ClusterEngine", "Region", "RegionManager",
]
