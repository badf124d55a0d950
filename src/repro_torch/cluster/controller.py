"""Chip-level control: the tiered planner and the cluster controller.

The hierarchy mirrors the paper's levels.  A
:class:`repro_torch.control.GroupController` reconfigures one group (one SM
pair); a :class:`repro_torch.control.FleetController` manages one chip's mix
of groups; the :class:`ClusterController` here does to *chips* what the
fleet controller does to groups:

* **per-chip pressure** — each cluster tick it folds every chip's live
  remaining-lengths, queue depth, and completion rate into the same
  :class:`repro_torch.control.FeatureVector` the policy stack consumes
  (divergence = tail mass, queue_frac = queue mass) plus a drain rate,
  kept as :class:`ChipPressure`;

* **split-mix steering** — one chip-scoped
  :class:`~repro_torch.control.FleetController` per chip nudges that chip's
  fused/split mix against its *own* long fraction (a hot chip deepens
  while a cold one stays fused), with the quarantine reservation
  maintained on whichever chip hosts it;

* **region gather** — the :class:`repro_torch.cluster.regions.RegionManager`
  fuses adjacent same-chip groups into a deep tail unit when a chip
  turns long-heavy (see :mod:`repro_torch.cluster.regions`);

* **tiered migration** — a :class:`ClusterPlanner` plans steals
  chip-first and authorizes cross-chip steals/live-migrations only when
  the *tiered* cost amortizes on the same ``move_gain`` scale the
  topology lattice uses.

:class:`ClusterPlanner` extends the flat
:class:`repro_torch.fleet.migrate.MigrationPlanner`.  Planning: steals are
matched within each chip first (the NoC is near-free), then residual
backlog may cross chips, each candidate vetoed unless the transfer
arrives before the donor would have locally started the request
(normalized margin > ``min_gain``); live migrations inherit the flat
planner's amortization check but with a per-destination *tiered* stall,
so a same-chip move can clear the bar where the identical cross-node
move fails it.  Execution always charges the **true** tiered cost —
also under ``ClusterConfig.distance_blind``, where planning prices
every pair at the flat link bandwidth (the A/B baseline): a blind plan
cashes out at physical prices, which is exactly how distance-blind
stealing thrashes slow links.  Cross-chip steals travel as in-flight
transfers delivered ``steal_ticks`` later; an unreachable transfer
(zero bandwidth on its tier) is vetoed at plan time and dropped at
execution, so zero inter-chip bandwidth stops every cross-chip move
while intra-chip traffic keeps flowing.

Counterpart of ``repro/cluster/controller.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, \
    Set, Tuple

from repro_torch.configs.base import ClusterConfig, FleetConfig, \
    MigrationConfig, ModelConfig
from repro_torch.cluster.mesh import TIERS, TOKEN_BYTES, ClusterMesh, \
    TieredTransferCost
from repro_torch.cluster.regions import RegionManager
from repro_torch.control.controller import FleetController
from repro_torch.control.features import FeatureVector
from repro_torch.obs.events import NULL_LOG
from repro_torch.fleet.migrate import Addr, KVTransferCost, Migration, \
    MigrationPlanner, STEAL, _GroupView, charge_ticks
from repro_torch.serve.engine import Request


# -- the tiered planner --------------------------------------------------------

class ClusterPlanner(MigrationPlanner):
    """Tier-aware work mover: chip-first steals, amortized crossings."""

    def __init__(self, cfg: MigrationConfig, model_cfg: ModelConfig,
                 mesh: ClusterMesh, cost: TieredTransferCost,
                 ccfg: ClusterConfig, long_threshold: int = 24,
                 window: Optional[int] = None):
        # the *planning* cost: tiered normally, flat under the
        # distance-blind baseline (plans priced as if all links were
        # MigrationConfig.link_bandwidth)
        plan_cost = KVTransferCost(
            link_bandwidth=cfg.link_bandwidth,
            dtype_bytes=cfg.kv_dtype_bytes,
            quantized=cfg.quantized_kv) if ccfg.distance_blind else cost
        super().__init__(cfg, model_cfg, long_threshold=long_threshold,
                         window=window, cost=plan_cost)
        self.mesh = mesh
        self.ccfg = ccfg
        # the *physical* cost every executed move is charged at
        self.true_cost = cost
        self._region_groups: FrozenSet[int] = frozenset()
        # cross-chip steals in the air: (arrive_tick, seq, request, dst)
        self._in_flight: List[Tuple[int, int, Request, Addr]] = []
        self._flight_seq = 0
        # per-tier traffic counters (fleet telemetry's cluster block)
        self.tier_bytes: Dict[str, int] = {t: 0 for t in TIERS}
        self.tier_stall_ticks: Dict[str, int] = {t: 0 for t in TIERS}
        self.intra_chip_steals = 0
        self.cross_chip_steals = 0
        self.intra_chip_live = 0
        self.cross_chip_live = 0
        self.vetoed_cross_chip = 0     # crossings rejected at plan time
        self.dropped_unreachable = 0   # plans priced at inf at execution

    # -- region interplay ------------------------------------------------------

    def set_regions(self, region_groups: Iterable[int]) -> None:
        self._region_groups = frozenset(region_groups)

    def _recip_priority(self, v: _GroupView) -> Tuple:
        # gathered region groups first: their deep splits exist to host
        # the tail mass steals redistribute
        return (v.gi in self._region_groups, v.total_free)

    # -- planning --------------------------------------------------------------

    def plan(self, tick: int, groups: Sequence,
             reserved: Optional[Iterable[Addr]] = None) -> List[Migration]:
        if self.ccfg.distance_blind:
            # one global distance-blind pool — the flat baseline
            return super().plan(tick, groups, reserved)
        self.plan_ticks += 1
        res: Set[Addr] = set(reserved or ())
        views = [self._view(tick, gi, g, res)
                 for gi, g in enumerate(groups)]
        self._pressure = {v.gi: v.queue_len / max(v.drain_rate, 1e-3)
                          if v.queue_len else 0.0 for v in views}
        plans: List[Migration] = []
        # chip-first: each chip resolves what its own NoC can absorb
        for ci in range(self.mesh.num_chips):
            gids = set(self.mesh.chip_groups(ci))
            plans += self._plan_steals(
                [v for v in views if v.gi in gids], groups)
        # only the residual backlog may cross chips, and only amortized;
        # victims the chip phase already claimed stay claimed
        claimed = {id(m.request) for m in plans}
        plans += self._plan_cross_steals(views, groups, claimed)
        if self.cfg.live:
            plans += self._plan_live(views, groups, res)
        self.planned += len(plans)
        return plans

    def _plan_cross_steals(self, views: List[_GroupView],
                           groups: Sequence,
                           claimed: Set[int]) -> List[Migration]:
        """Cross-chip steals that clear the tiered amortization bar.

        A steal's benefit is the queue wait it skips: the donor's
        expected ticks-to-drain.  Its tiered cost is the in-flight
        transfer time.  On the same normalized scale as
        ``ConfigSpace.move_gain`` — saving over the cost of staying put
        — the move must clear ``min_gain``:

        ``(wait - transfer) / max(wait, 1) > min_gain``

        so an unreachable pair (infinite transfer) or a slow link under
        a shallow backlog is vetoed, while a deep backlog amortizes even
        a multi-hop crossing.
        """
        thresh = self.cfg.steal_threshold
        budget = self.ccfg.max_cross_steals
        donors = sorted(
            (v for v in views if v.queue_len > thresh),
            key=lambda v: v.queue_len / max(v.drain_rate, 1e-3),
            reverse=True)
        recips = sorted(
            (v for v in views
             if v.total_free > 0 and v.queue_len < v.total_free
             and v.queue_len <= thresh),
            key=self._recip_priority, reverse=True)
        plans: List[Migration] = []
        for donor in donors:
            if budget <= 0:
                break
            wait = donor.queue_len / max(donor.drain_rate, 1e-3)
            queue = [q for q in groups[donor.gi].queue
                     if id(q) not in claimed]
            queue.reverse()        # steal from the tail, like the base
            for recip in recips:
                if budget <= 0 or not queue:
                    break
                if self.mesh.chip_of(recip.gi) == self.mesh.chip_of(donor.gi):
                    continue       # same chip was the chip-first phase
                while (budget > 0 and queue
                       and donor.queue_len > thresh
                       and recip.total_free > 0):
                    victim = queue[0]
                    part = self._fit_part(recip, victim)
                    if part is None:
                        break
                    ticks = self.true_cost.steal_ticks(
                        len(victim.prompt), donor.gi, recip.gi)
                    # price at the whole-tick charge the transfer will
                    # actually pay (ceil past a tick boundary, sub-tick
                    # free) so the amortization check matches the bill
                    charged = 0 if math.isinf(ticks) else charge_ticks(ticks)
                    gain = -math.inf if math.isinf(ticks) \
                        else (wait - charged) / max(wait, 1.0)
                    if gain <= self.cfg.min_gain:
                        # every victim of this pair prices the same tier:
                        # move on to the next recipient
                        self.vetoed_cross_chip += 1
                        break
                    queue.pop(0)
                    plans.append(Migration(STEAL, victim,
                                           src=(donor.gi, None),
                                           dst=(recip.gi, part),
                                           stall=charged, gain=gain))
                    recip.free[part] -= 1
                    donor.queue_len -= 1
                    budget -= 1
        return plans

    # -- execution (always at physical prices) ---------------------------------

    def _account(self, tier: str, nbytes: int, ticks: int) -> None:
        if tier in self.tier_bytes:
            self.tier_bytes[tier] += int(nbytes)
            self.tier_stall_ticks[tier] += int(ticks)

    def _execute_steal(self, m: Migration, groups: Sequence,
                       now: int) -> int:
        src_gi, dst_gi = m.src[0], m.dst[0]
        nbytes = max(len(m.request.prompt), 1) * TOKEN_BYTES
        ticks = self.true_cost.steal_ticks(
            len(m.request.prompt), src_gi, dst_gi)
        if math.isinf(ticks):
            # a blind plan across a dead link: physically impossible
            self.dropped_unreachable += 1
            return 0
        tier = self.mesh.tier(src_gi, dst_gi)
        charged = charge_ticks(ticks)
        if charged <= 0:
            done = super()._execute_steal(m, groups, now)
        else:
            src = groups[src_gi]
            idx = next((i for i, q in enumerate(src.queue)
                        if q is m.request), None)
            if idx is None:
                return 0
            del src.queue[idx]
            src.stats.steals_out += 1
            self.steals += 1
            # in the air until the transfer lands (deliver_in_flight)
            self._flight_seq += 1
            self._in_flight.append(
                (now + charged, self._flight_seq, m.request, m.dst))
            if self.obs.enabled:
                self.obs.emit("steal", gid=m.dst[0], part=m.dst[1],
                              tick=now, rid=m.request.rid,
                              src=m.src, dst=m.dst, gain=float(m.gain),
                              in_flight=True, arrive=now + charged,
                              tier=tier)
            done = 1
        if done:
            if tier == "noc":
                self.intra_chip_steals += 1
            else:
                self.cross_chip_steals += 1
            self._account(tier, nbytes, charged)
        return done

    def _execute_live(self, m: Migration, groups: Sequence) -> int:
        src_gi, dst_gi = m.src[0], m.dst[0]
        seq_len = len(m.request.prompt) + len(m.request.generated)
        true = self.true_cost.stall_ticks(
            seq_len, self.model_cfg, self.window, src=src_gi, dst=dst_gi)
        if math.isinf(true):
            self.dropped_unreachable += 1
            return 0
        # the destination part stalls for the *physical* transfer, not
        # whatever a (possibly blind) plan assumed
        m.stall = charge_ticks(true)
        done = super()._execute_live(m, groups)
        if done:
            tier = self.mesh.tier(src_gi, dst_gi)
            if tier == "noc":
                self.intra_chip_live += 1
            else:
                self.cross_chip_live += 1
            self._account(tier, self.true_cost.kv_bytes(
                seq_len, self.model_cfg, self.window), m.stall)
        return done

    # -- in-flight transfers ---------------------------------------------------

    def deliver_in_flight(self, now: int, groups: Sequence) -> int:
        """Land every transfer whose arrival tick has passed."""
        if not self._in_flight:
            return 0
        ready = sorted(e for e in self._in_flight if e[0] <= now)
        if not ready:
            return 0
        self._in_flight = [e for e in self._in_flight if e[0] > now]
        for _, _, req, (gi, pi) in ready:
            groups[gi].submit([req], now=now, part=pi)
            groups[gi].stats.steals_in += 1
        return len(ready)

    def next_arrival(self) -> Optional[int]:
        """Earliest in-flight landing tick (the engine's idle horizon)."""
        return min((e[0] for e in self._in_flight), default=None)

    def in_flight_requests(self) -> List[Request]:
        """Requests currently in the air — part of conservation books."""
        return [e[2] for e in self._in_flight]

    # -- telemetry -------------------------------------------------------------

    def summary(self) -> Dict:
        s = super().summary()
        s.update({
            "intra_chip_steals": self.intra_chip_steals,
            "cross_chip_steals": self.cross_chip_steals,
            "intra_chip_live": self.intra_chip_live,
            "cross_chip_live": self.cross_chip_live,
            "vetoed_cross_chip": self.vetoed_cross_chip,
            "dropped_unreachable": self.dropped_unreachable,
            "in_flight": len(self._in_flight),
            "tier_bytes": dict(self.tier_bytes),
            "tier_stall_ticks": dict(self.tier_stall_ticks),
        })
        return s


# -- per-chip pressure ---------------------------------------------------------

@dataclass
class ChipPressure:
    """One chip's pressure sample on the shared feature scale."""
    chip: int
    fv: FeatureVector              # divergence=tail mass, queue_frac=queue mass
    drain_rate: float              # completions per tick since last sample
    long_frac: float               # fraction of outstanding work past threshold

    def as_dict(self) -> Dict:
        return {"divergence": round(self.fv.divergence, 3),
                "spread": round(self.fv.spread, 3),
                "queue_frac": round(self.fv.queue_frac, 3),
                "live_frac": round(self.fv.live_frac, 3),
                "drain_rate": round(self.drain_rate, 3),
                "long_frac": round(self.long_frac, 3)}


# -- the cluster controller ----------------------------------------------------

class ClusterController:
    """One control plane above the fleet: chips are its unit of steering.

    Presents the same surface ``FleetEngine.run`` drives on a
    :class:`~repro_torch.control.FleetController` — ``rebalance(tick,
    groups)``, ``take_plans()``, ``planner``, ``rebalances``,
    ``quarantine``, ``reserved_parts(groups)`` — so the engine loop
    does not change; plus :meth:`cluster_summary` for the telemetry
    block.
    """

    def __init__(self, mesh: ClusterMesh, ccfg: ClusterConfig,
                 fleet: FleetConfig, model_cfg: ModelConfig,
                 cost: Optional[TieredTransferCost] = None):
        self.mesh = mesh
        self.ccfg = ccfg
        self.fleet = fleet
        self.cost = cost or TieredTransferCost.from_config(
            mesh, ccfg, dtype_bytes=fleet.migrate.kv_dtype_bytes,
            quantized=fleet.migrate.quantized_kv)
        self.every = fleet.rebalance_every if fleet.rebalance_every > 0 \
            else max(fleet.migrate.every, 1)
        self.long_threshold = fleet.long_threshold
        self.quarantine = fleet.quarantine_group
        self.planner = ClusterPlanner(
            fleet.migrate, model_cfg, mesh=mesh, cost=self.cost,
            ccfg=ccfg, long_threshold=fleet.long_threshold,
            window=fleet.window)
        # optional repro_torch.fleet.lease.LeasePlanner, wired (with the mesh
        # and the physical cost) by ClusterEngine when leases are on
        self.leases = None
        # one chip-scoped mix controller per chip: each chip's
        # fused/split mix tracks its *own* long fraction (gated here,
        # so every=1; no planner — migration is the cluster's job)
        self.chip_controllers = [
            FleetController(long_threshold=fleet.long_threshold, every=1,
                            planner=None,
                            quarantine=self._local_quarantine(ci),
                            mix=True)
            for ci in range(mesh.num_chips)]
        self.regions = RegionManager(
            mesh, ccfg, long_threshold=fleet.long_threshold) \
            if ccfg.region_gather else None
        self.rebalances = 0
        self._plans: List[Migration] = []
        self.chip_pressure: Dict[int, ChipPressure] = {}
        self._chip_done: Dict[int, Tuple[int, int]] = {}  # ci -> (tick, done)
        # event stream (repro_torch.obs); the cluster engine wires its log in
        self.obs = NULL_LOG

    def _local_quarantine(self, ci: int) -> Optional[int]:
        q = self.quarantine
        if q is None or self.mesh.chip_of(q) != ci:
            return None
        return self.mesh.chip_groups(ci).index(q)

    # -- engine surface --------------------------------------------------------

    def take_plans(self) -> List[Migration]:
        plans, self._plans = self._plans, []
        return plans

    def reserved_parts(self, groups: Sequence) -> set:
        """The quarantine reservation, in global group indices."""
        out = set()
        q = self.quarantine
        if q is not None and 0 <= q < len(groups):
            topo = groups[q].controller.state.topology
            if len(topo) >= 2 and topo[-1] == 1:
                out.add((q, len(topo) - 1))
        return out

    # -- pressure --------------------------------------------------------------

    def _pressure_sample(self, ci: int, tick: int,
                         cgroups: Sequence) -> ChipPressure:
        remaining = [r.remaining for g in cgroups
                     for r in g.live_requests()]
        queue_depth = sum(len(g.queue) for g in cgroups)
        capacity = sum(sum(getattr(g, "topology", (1,))) for g in cgroups)
        fv = FeatureVector.from_group(remaining, queue_depth,
                                      arrival_rate=0.0,
                                      capacity=max(capacity, 1))
        done = sum(g.stats.completed for g in cgroups)
        prev = self._chip_done.get(ci)
        self._chip_done[ci] = (tick, done)
        rate = 0.0 if prev is None or tick <= prev[0] \
            else (done - prev[1]) / (tick - prev[0])
        total, long_n = 0, 0
        for g in cgroups:
            for r in g.live_requests():
                total += 1
                long_n += r.remaining >= self.long_threshold
            for r in g.queue:
                total += 1
                long_n += r.max_new_tokens >= self.long_threshold
        return ChipPressure(chip=ci, fv=fv, drain_rate=rate,
                            long_frac=long_n / total if total else 0.0)

    # -- the control tick ------------------------------------------------------

    def rebalance(self, tick: int, groups: Sequence) -> int:
        if tick % self.every != 0:
            return 0
        issued = 0
        long_fracs: Dict[int, float] = {}
        for ci, fc in enumerate(self.chip_controllers):
            gids = [g for g in self.mesh.chip_groups(ci)
                    if g < len(groups)]
            if not gids:
                continue
            cgroups = [groups[g] for g in gids]
            p = self._pressure_sample(ci, tick, cgroups)
            self.chip_pressure[ci] = p
            long_fracs[ci] = p.long_frac
            issued += fc.rebalance(tick, cgroups)
        if self.regions is not None:
            before = {ci: tuple(r.groups)
                      for ci, r in self.regions.active.items()} \
                if self.obs.enabled else {}
            # gather first would fight this tick's mix nudges; stepping
            # after lets the re-asserted deep hints win (last hint wins)
            issued += self.regions.step(tick, groups, long_fracs,
                                        quarantine=self.quarantine)
            if self.obs.enabled:
                after = {ci: tuple(r.groups)
                         for ci, r in self.regions.active.items()}
                for ci in sorted(set(before) | set(after)):
                    b, a = before.get(ci), after.get(ci)
                    if b == a:
                        continue
                    action = ("gather" if b is None
                              else "release" if a is None else "resize")
                    gids = a if a is not None else b
                    self.obs.emit("region_grab", gid=gids[0], tick=tick,
                                  chip=ci, action=action,
                                  groups=list(gids))
            self.planner.set_regions(self.regions.region_groups())
        self._plans = self.planner.plan(
            tick, groups, reserved=self.reserved_parts(groups))
        if self.leases is not None:
            self.leases.step(tick, groups,
                             reserved=self.reserved_parts(groups))
        self.rebalances += issued > 0
        return issued

    # -- telemetry -------------------------------------------------------------

    def cluster_summary(self, groups: Optional[Sequence] = None) -> Dict:
        out = {
            "chips": self.mesh.num_chips,
            "groups_per_chip": self.mesh.groups_per_chip,
            "nodes": self.mesh.num_nodes,
            "distance_blind": self.ccfg.distance_blind,
            "chip_pressure": {str(ci): p.as_dict()
                              for ci, p in sorted(self.chip_pressure.items())},
            "tier_bytes": dict(self.planner.tier_bytes),
            "tier_stall_ticks": dict(self.planner.tier_stall_ticks),
        }
        if self.regions is not None:
            out["regions"] = self.regions.summary()
        return out
