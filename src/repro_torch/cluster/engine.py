"""ClusterEngine: a FleetEngine whose control plane is the cluster stack.

The wiring is deliberately thin: ``FleetEngine.run`` already drives a
controller (``rebalance`` / ``take_plans``) and a planner (``execute``)
between decode ticks, so swapping the flat
:class:`~repro_torch.control.FleetController` for a
:class:`~repro_torch.cluster.ClusterController` — which presents the same
surface — re-uses the whole loop.  Only two hooks differ:

* ``_deliver`` also lands in-flight cross-chip steals whose transfer
  time has elapsed (the slow-link ticks a stolen request spends in the
  air before it can even queue at its recipient);
* ``_next_event`` folds the earliest in-flight landing into the idle
  fast-forward horizon, so an otherwise-idle fleet never terminates
  with requests still on the wire.

Counterpart of ``repro/cluster/engine.py``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ClusterConfig, FleetConfig, ModelConfig
from repro_torch.cluster.controller import ClusterController
from repro_torch.cluster.mesh import ClusterMesh
from repro_torch.fleet.scheduler import FleetEngine


class ClusterEngine(FleetEngine):
    """N groups on a 2D chip mesh under hierarchical, tiered control.

    ``cluster`` may come as an argument or as ``fleet.cluster``; the
    cluster layer needs a dynamic fleet with migration enabled (its
    planner *is* the migration planner, tiered).
    """

    def __init__(self, model_cfg: ModelConfig, params, *,
                 fleet: FleetConfig = FleetConfig(),
                 cluster: Optional[ClusterConfig] = None, **kw):
        cluster = cluster or fleet.cluster or ClusterConfig()
        fleet = fleet.replace(cluster=cluster)
        if fleet.mode != "dynamic" or not fleet.migrate.enabled:
            raise ValueError(
                "ClusterEngine needs mode='dynamic' and "
                "fleet.migrate.enabled (the cluster planner is the "
                "tiered migration planner)")
        super().__init__(model_cfg, params, fleet=fleet, **kw)
        self.mesh = ClusterMesh(
            num_groups=fleet.num_groups,
            groups_per_chip=cluster.groups_per_chip,
            chips_per_node=cluster.chips_per_node)
        self.cluster = ClusterController(self.mesh, cluster, fleet,
                                         model_cfg)
        # swap the flat chip-level control plane for the cluster stack;
        # run()/telemetry drive .controller/.planner exactly as before
        self.controller = self.cluster
        self.planner = self.cluster.planner
        if self.leases is not None:
            # cross-group leases now confine to adjacent same-chip pairs
            # and price their NoC tax with the *physical* tiered cost
            self.leases.mesh = self.mesh
            self.leases.cost = self.cluster.cost
            self.cluster.leases = self.leases
        # the router's admission-spill pressure view rides the tiered
        # planner now
        self._router_state["planner"] = self.planner
        # one event stream for the whole hierarchy: the tiered planner's
        # steals/migrations and the region gathers land in the same log,
        # and exporters get the mesh layout for chip-grouped rendering
        self.planner.obs = self.obs
        self.cluster.obs = self.obs
        self.obs.meta["mesh"] = self.mesh.layout()

    def _deliver(self) -> None:
        self.planner.deliver_in_flight(self.wall, self.groups)
        super()._deliver()

    def _next_event(self) -> Optional[int]:
        events = [t for t in (super()._next_event(),
                              self.planner.next_arrival())
                  if t is not None]
        return min(events) if events else None
