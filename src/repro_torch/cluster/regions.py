"""Region gather: adjacent same-chip groups fused into one deep tail unit.

The zamlet mesh-of-Amlets design gathers a *region* — a connected patch
of the mesh — into one larger logical processor while a workload needs
it, and releases the patch when it drains.  The serving translation:
when a chip's outstanding work turns long-heavy
(``ClusterConfig.region_long_frac``), the :class:`RegionManager` picks a
connected set of adjacent same-chip groups carrying the most long mass
and drives each of them — through the *existing* composition API,
:meth:`repro_torch.control.GroupController.request_topology` — to its deepest
legal balanced composition.  The region then acts as one deep logical
group for the long-context tail: many narrow slices, each quarantining
one long request at minimal slot-step waste, and the cluster planner
boosts region groups as steal recipients so tail work actually lands
there.  When the chip's long fraction falls back under
``region_release_frac`` (and the region has dwelt ``region_dwell``
ticks), the member groups are hinted back to fused and returned to
their own policy's control.

Hints, not force: every gather/release flows through the per-part dwell
clocks and legality checks of the group controller, exactly like a
fleet-level mix nudge — a region can never bypass a group's pacing.

Counterpart of ``repro/cluster/regions.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ClusterConfig
from repro_torch.cluster.mesh import ClusterMesh
from repro_torch.control.space import Topology, balanced


@dataclass
class Region:
    """One gathered patch: adjacent groups on one chip, plus its clock."""
    chip: int
    groups: Tuple[int, ...]
    opened: int                    # tick the gather was issued


class RegionManager:
    """Opens, maintains, and releases at most one region per chip."""

    def __init__(self, mesh: ClusterMesh, ccfg: ClusterConfig,
                 long_threshold: int = 24):
        self.mesh = mesh
        self.ccfg = ccfg
        self.long_threshold = long_threshold
        self.active: Dict[int, Region] = {}      # chip -> region
        self.gathered = 0
        self.released = 0

    # -- queries ---------------------------------------------------------------

    def region_groups(self) -> FrozenSet[int]:
        """Every group currently inside a gathered region."""
        return frozenset(g for r in self.active.values() for g in r.groups)

    def summary(self) -> Dict:
        return {"gathered": self.gathered, "released": self.released,
                "active": [list(r.groups)
                           for _, r in sorted(self.active.items())]}

    # -- the deep target -------------------------------------------------------

    @staticmethod
    def deep_topology(space) -> Topology:
        """Deepest legal balanced composition of a group's space."""
        for ways in range(min(space.max_ways, space.capacity), 1, -1):
            t = balanced(space.capacity, ways)
            if space.legal(t):
                return t
        return (space.capacity,)

    # -- long-mass scoring -----------------------------------------------------

    def _long_mass(self, g) -> int:
        thr = self.long_threshold
        return (sum(1 for r in g.live_requests() if r.remaining >= thr)
                + sum(1 for r in g.queue if r.max_new_tokens >= thr))

    def _pick(self, ci: int, groups: Sequence,
              quarantine: Optional[int]) -> List[int]:
        """A connected, adjacency-grown set of the chip's longest groups."""
        cands = [g for g in self.mesh.chip_groups(ci)
                 if g < len(groups) and g != quarantine]
        score = {g: self._long_mass(groups[g]) for g in cands}
        if not cands or max(score.values()) <= 0:
            return []
        seed = max(cands, key=lambda g: (score[g], -g))
        region = [seed]
        while len(region) < self.ccfg.region_max_groups:
            adj = [g for g in cands if g not in region
                   and any(self.mesh.adjacent(g, m) for m in region)]
            if not adj:
                break
            region.append(max(adj, key=lambda g: (score[g], -g)))
        return sorted(region)

    # -- the control tick ------------------------------------------------------

    def _assert_deep(self, region: Region, groups: Sequence) -> int:
        """(Re-)hint every member toward its deep target; returns hints."""
        issued = 0
        for gi in region.groups:
            ctl = groups[gi].controller
            target = self.deep_topology(ctl.space)
            if ctl.state.topology != target:
                ctl.request_topology(target)
                issued += 1
        return issued

    def step(self, tick: int, groups: Sequence,
             long_fracs: Dict[int, float],
             quarantine: Optional[int] = None) -> int:
        """One cluster control tick of gather/maintain/release decisions.

        ``long_fracs`` maps chip -> fraction of its outstanding work
        past ``long_threshold`` (the tail-mass half of the chip
        pressure the :class:`~repro_torch.cluster.ClusterController` tracks).
        Re-asserting the deep hints each tick keeps a region's members
        from being re-absorbed by the chip's split-mix nudging while
        the region is open.
        """
        issued = 0
        for ci in range(self.mesh.num_chips):
            frac = long_fracs.get(ci, 0.0)
            region = self.active.get(ci)
            if region is not None:
                drained = frac <= self.ccfg.region_release_frac
                if drained and tick - region.opened >= self.ccfg.region_dwell:
                    for gi in region.groups:
                        ctl = groups[gi].controller
                        ctl.request_topology((ctl.space.capacity,))
                    del self.active[ci]
                    self.released += 1
                    issued += 1
                else:
                    issued += self._assert_deep(region, groups)
            elif frac >= self.ccfg.region_long_frac:
                picked = self._pick(ci, groups, quarantine)
                if picked:
                    region = Region(ci, tuple(picked), tick)
                    self.active[ci] = region
                    issued += max(self._assert_deep(region, groups), 1)
                    self.gathered += 1
        return issued
