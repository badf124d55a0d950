"""Slack leases: bounded slot borrowing below the reconfiguration layer.

AMOEBA's lattice moves capacity by *re-cutting* a group — merge the live
parts, re-partition, pay the dwell clock and (across groups) the KV
transfer stall.  That price is right when the imbalance is persistent,
and exactly wrong for a transient burst: by the time the cut amortizes,
the burst is gone.  The fleet's work stealing covers part of the gap,
but a steal needs a *free slot on an idle part* at the recipient — a hot
group whose parts are all full can watch a neighbor idle without being
able to use it.

A **slack lease** fills that gap: a part with idle slots lends them to a
sibling part — same group, or an adjacent same-chip group over the NoC —
for a bounded term.  No topology move, no dwell clock, no
reconfiguration stall; the borrowed slots simply widen the borrower
part's next admission wave while the lender's resident budget shrinks by
the same amount, so fleet-wide effective capacity is conserved
(``lent + resident = partition budget``, always).  When the term expires
— or the lender's own queue heats up — the slots go home; rows admitted
into borrowed slots finish where they are (the transient overhang is
charged honestly by ``ReconfigurableGroup._slot_charge``).

Pricing rides the same normalized amortization scale as the topology
lattice (:meth:`repro_torch.control.ConfigSpace.move_gain`) and the migration
planner: the gain of a grant is the borrowed-queue drain it buys, minus
the lender's expected backfill loss over the term, minus any NoC
transfer tax, normalized by the lender group's fused drain cost — and it
must clear ``LeaseConfig.min_gain``.  The lender's loss model is the
*stranded-slot* story: an idle slot on a partially-live part is stranded
until the part's slowest member finishes (admission is per-part, on
drain), so lending it for that window costs nothing — which is what
makes intra-group leases (wide part lends to the quarantine slice's
overflow) profitable at all.

The planner is pure decision logic over the same group protocol the
migration planner uses, plus four lease mutators
(``lease_out`` / ``lease_back`` / ``lease_in`` / ``lease_return``) and
``effective_slots``.  It owns the lease book: outstanding lent/borrowed
totals per part are derived from its active leases, never read from
group internals, and every grant is returned — on expiry, on early
revoke, or force-revoked when a party reconfigures
(``ReconfigurableGroup._reconfigure`` calls :meth:`force_revoke` before
re-cutting, because leases are defined against the current composition).

Counterpart of ``repro/fleet/lease.py``, with the same grant, revoke and
expiry rules.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.configs.base import LeaseConfig
from repro_torch.fleet.migrate import Addr, fit_part
from repro_torch.obs.events import NULL_LOG


@dataclass
class Lease:
    """One outstanding grant: ``slots`` slots from lender to borrower."""
    lid: int
    lender: Addr                   # (group, part) the slots came from
    borrower: Addr                 # (group, part) they widen
    slots: int
    granted: int                   # grant tick
    expires: int                   # tick at which the slots go home
    gain: float                    # normalized amortization gain at grant

    def as_dict(self) -> Dict:
        return {"lid": self.lid, "lender": list(self.lender),
                "borrower": list(self.borrower), "slots": self.slots,
                "granted": self.granted, "expires": self.expires,
                "gain": round(self.gain, 4)}


class LeasePlanner:
    """Grants, revokes, and expires slack leases each rebalance tick.

    ``step`` runs inside the controller's rebalance gate, *after* the
    migration planner (steals are strictly cheaper — a lease only pays
    when stealing can't: no free slot anywhere, or the burst sits on
    admissions rather than a stealable backlog).  One step is:

    1. **expire** — every lease past its term goes home.
    2. **revoke** — a lender whose expected ticks-to-drain exceeds
       ``revoke_threshold`` takes its slots back early; a lease whose
       borrower went idle (empty queue, borrowed width unused) is
       returned rather than held to term.
    3. **grant** — borrowers ranked by pressure; for each, every
       eligible lender part is priced and the best positive-gain grant
       (if any) is taken, up to ``max_grants`` per step.

    ``mesh``/``cost`` are optionally wired by the cluster engine: with a
    mesh, cross-group leases are confined to *adjacent same-chip* pairs
    and priced with the tiered transfer cost (a dead link prices at
    infinity and is vetoed); without one, the flat fleet treats every
    pair as NoC-close and transfer-free.
    """

    def __init__(self, cfg: LeaseConfig, long_threshold: int = 24):
        self.cfg = cfg
        self.long_threshold = long_threshold
        self.active: List[Lease] = []
        # wired by ClusterEngine: adjacency confinement + tiered pricing
        self.mesh = None
        self.cost = None
        self.obs = NULL_LOG
        # counters surfaced in FleetTelemetry.summary
        self.plan_ticks = 0
        self.grants = 0
        self.revokes = 0
        self.expires = 0
        self.rejected_amortization = 0
        self.slot_ticks_lent = 0       # accrued slot·ticks out on lease
        # the contract counter: leases never pay a reconfiguration stall
        # (they move admission capacity, not KV state), so this stays 0
        self.stall_ticks_charged = 0
        self._next_lid = 0
        self._drain: Dict[int, Tuple[int, int]] = {}   # gi -> (tick, done)
        self._pressure: Dict[int, float] = {}
        # bound on first step so force_revoke (called from a group's
        # _reconfigure, outside any step) can reach the counterparties
        self._groups: Optional[Sequence] = None
        self._now = 0

    # -- wiring ----------------------------------------------------------------

    def bind(self, groups: Sequence) -> None:
        """Attach the planner as every group's lease book."""
        self._groups = groups
        for g in groups:
            g._lease_book = self

    # -- telemetry -------------------------------------------------------------

    def summary(self) -> Dict:
        return {
            "plan_ticks": self.plan_ticks,
            "grants": self.grants,
            "revokes": self.revokes,
            "expires": self.expires,
            "active": len(self.active),
            "rejected_amortization": self.rejected_amortization,
            "slot_ticks_lent": self.slot_ticks_lent,
            "stall_ticks_charged": self.stall_ticks_charged,
        }

    # -- book views (the planner's records, never group internals) -------------

    def lent_at(self, addr: Addr) -> int:
        return sum(l.slots for l in self.active if l.lender == addr)

    def borrowed_at(self, addr: Addr) -> int:
        return sum(l.slots for l in self.active if l.borrower == addr)

    # -- pressure (same signal the migration planner ranks donors by) ----------

    def _drain_rate(self, tick: int, gi: int, completed: int) -> float:
        prev = self._drain.get(gi)
        self._drain[gi] = (tick, completed)
        if prev is None or tick <= prev[0]:
            return 0.0
        return (completed - prev[1]) / (tick - prev[0])

    def _refresh_pressure(self, tick: int, groups: Sequence) -> None:
        self._pressure = {}
        for gi, g in enumerate(groups):
            rate = self._drain_rate(tick, gi, g.stats.completed)
            qn = len(g.queue)
            self._pressure[gi] = qn / max(rate, 1e-3) if qn else 0.0

    # -- one rebalance tick ----------------------------------------------------

    def step(self, tick: int, groups: Sequence,
             reserved: Optional[Sequence[Addr]] = None) -> None:
        self._groups = groups
        self._now = tick
        self.plan_ticks += 1
        res: Set[Addr] = set(reserved or ())
        self._refresh_pressure(tick, groups)
        for l in [l for l in self.active if tick >= l.expires]:
            self._release(l, tick, groups, action="expire", reason="term")
        self._revoke(tick, groups)
        self._grant(tick, groups, res)

    # -- revocation ------------------------------------------------------------

    def _revoke(self, tick: int, groups: Sequence) -> None:
        for l in list(self.active):
            gl, _ = l.lender
            gb, pb = l.borrower
            # intra-group leases are exempt from the lender-heat revoke:
            # the "lender's queue" is the borrower's own hot queue, and
            # the widened part is what's draining it
            if gl != gb and \
                    self._pressure.get(gl, 0.0) > self.cfg.revoke_threshold:
                self._release(l, tick, groups, action="revoke",
                              reason="lender_hot")
            elif (not groups[gb].queue
                  and groups[gb]._part_live_n(pb)
                  <= groups[gb].topology[pb]):
                # the burst passed: borrowed width sits unused, go home
                self._release(l, tick, groups, action="revoke",
                              reason="borrower_idle")

    def force_revoke(self, gid: int, reason: str = "reconfig",
                     tick: Optional[int] = None) -> None:
        """Return every lease touching ``gid`` — its composition is
        about to change, so the books it was written against vanish.
        ``tick`` is the caller's wall clock (a reconfigure happens
        between planner steps); without it the last step tick is used.
        """
        if self._groups is None:
            return
        now = self._now if tick is None else max(tick, self._now)
        for l in [l for l in self.active
                  if l.lender[0] == gid or l.borrower[0] == gid]:
            self._release(l, now, self._groups,
                          action="revoke", reason=reason)

    def _release(self, l: Lease, tick: int, groups: Sequence,
                 action: str, reason: str) -> None:
        groups[l.lender[0]].lease_back(l.lender[1], l.slots)
        groups[l.borrower[0]].lease_return(l.borrower[1], l.slots)
        self.active.remove(l)
        self.slot_ticks_lent += l.slots * max(tick - l.granted, 0)
        if action == "expire":
            self.expires += 1
        else:
            self.revokes += 1
        if self.obs.enabled:
            self.obs.emit("lease", gid=l.lender[0], part=l.lender[1],
                          tick=tick, action=action, lid=l.lid,
                          slots=l.slots, dst=l.borrower, reason=reason)

    # -- granting --------------------------------------------------------------

    def _grant(self, tick: int, groups: Sequence, res: Set[Addr]) -> None:
        budget = self.cfg.max_grants
        borrowers = sorted(
            (gi for gi, g in enumerate(groups) if g.queue),
            key=lambda gi: self._pressure.get(gi, 0.0), reverse=True)
        for gb in borrowers:
            if budget <= 0:
                break
            l = self._best_grant(tick, groups, gb, res)
            if l is None:
                continue
            groups[l.lender[0]].lease_out(l.lender[1], l.slots)
            groups[l.borrower[0]].lease_in(l.borrower[1], l.slots)
            groups[l.lender[0]].stats.leases_out += l.slots
            groups[l.borrower[0]].stats.leases_in += l.slots
            self.active.append(l)
            self.grants += 1
            budget -= 1
            if self.obs.enabled:
                self.obs.emit("lease", gid=l.lender[0], part=l.lender[1],
                              tick=tick, action="grant", lid=l.lid,
                              slots=l.slots, dst=l.borrower,
                              term=l.expires - l.granted,
                              gain=float(l.gain))

    def _best_grant(self, tick: int, groups: Sequence, gb: int,
                    res: Set[Addr]) -> Optional[Lease]:
        """Price every eligible lender part for borrower ``gb``."""
        g_b = groups[gb]
        topo_b = tuple(g_b.topology)
        # borrower part through the shared length-aware policy: the
        # burst is short work, so it lands on the widest part (the
        # lockstep drain), skipping reserved quarantine slices
        free_mask = [0 if (gb, i) in res else 1 for i in range(len(topo_b))]
        pb = fit_part(topo_b, is_long=False, free=free_mask)
        if pb is None:
            return None
        wait_b = self._pressure.get(gb, 0.0)
        term = min(self.cfg.max_term, max(1, int(math.ceil(wait_b))))
        need = len(g_b.queue)
        head_b = topo_b[pb] - self.borrowed_at((gb, pb))  # borrow headroom
        best: Optional[Lease] = None
        considered = False
        for gl, g_l in enumerate(groups):
            if not self._pair_ok(gl, gb):
                continue
            xfer = self._xfer_ticks(gl, gb)
            if math.isinf(xfer):
                continue               # dead link: unreachable neighbor
            wait_l = self._pressure.get(gl, 0.0)
            if gl != gb and wait_l > self.cfg.revoke_threshold:
                continue               # would be revoked next step anyway
            topo_l = tuple(g_l.topology)
            fused = float(sum(topo_l)) * max(term, 1)
            for pl, slots in enumerate(topo_l):
                if (gl, pl) == (gb, pb) or (gl, pl) in res:
                    continue
                lent = self.lent_at((gl, pl))
                idle = g_l.effective_slots(pl) - g_l._part_live_n(pl)
                n = min(
                    idle,
                    int(math.floor(self.cfg.max_frac * slots)) - lent,
                    # >= 1 resident slot: a fully-lent part could never
                    # drain its own admissions again
                    slots + self.borrowed_at((gl, pl)) - lent - 1,
                    head_b, need)
                if n <= 0:
                    continue
                considered = True
                live = g_l.part_live(pl)
                eta = max((r.remaining for r in live), default=0)
                saved = n * min(term, wait_b)
                # the stranded-slot loss model: the lender only misses
                # the slots once its part drains (at eta) AND its own
                # queue wants them (wait_l).  Intra-group leases lose
                # nothing — the backfill would pull from the very queue
                # the borrowed slots are draining.
                loss = 0.0 if gl == gb else \
                    n * max(0.0, min(float(term), wait_l) - eta)
                gain = (saved - loss - xfer) / fused
                if gain <= self.cfg.min_gain:
                    continue
                if best is None or gain > best.gain:
                    best = Lease(lid=self._next_lid, lender=(gl, pl),
                                 borrower=(gb, pb), slots=n, granted=tick,
                                 expires=tick + term, gain=gain)
        if considered and best is None:
            self.rejected_amortization += 1
        if best is not None:
            self._next_lid += 1
        return best

    # -- topology confinement + transfer pricing -------------------------------

    def _pair_ok(self, gl: int, gb: int) -> bool:
        if gl == gb:
            return True                # intra-group: always NoC-close
        if self.mesh is None:
            return True                # flat fleet: every pair is close
        return self.mesh.adjacent(gl, gb)

    def _xfer_ticks(self, gl: int, gb: int) -> float:
        """One-time tax on a cross-group grant: the borrower's admits
        land one NoC hop from their KV home, priced like a single-token
        steal.  Intra-group and flat-fleet grants are free."""
        if gl == gb or self.cost is None:
            return 0.0
        return float(self.cost.steal_ticks(1, gl, gb))
