"""Group- and chip-level reconfiguration controllers.

:class:`GroupController` is the single split/fuse state machine in the
codebase: it owns a topology (an integer composition of the group's
capacity), enforces the *per-part* dwell clocks that amortize
reconfiguration cost — a part that just reconfigured blocks its own next
move without freezing its siblings, the paper's independent
neighboring-SM moves — asks its
:class:`~repro.control.policies.ReconfigPolicy` for a proposal each
decision tick, and applies the
:class:`~repro.control.space.ConfigSpace` amortization check before any
transition.  Every consumer — the ``AmoebaController`` façade, the
serving ``ReconfigurableGroup``, the trainer's straggler monitor — drives
this one object.

:class:`FleetController` is the paper's chip-wide view: 24 SM pairs each
reconfigure independently, but the *mix* of fused and split pairs is a
chip property.  It watches the fleet's long-request fraction and nudges
individual group controllers (through the same dwell-checked transition
path) so the number of split groups — and, under sustained tail mass,
how deeply the divergent ones are split — tracks the load.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.control.features import FeatureVector, ReplayBuffer
from repro_torch.control.policies import Decision, ReconfigPolicy, ThresholdPolicy
from repro_torch.control.space import ConfigSpace, Topology, TopologyLike, n_parts
from repro_torch.obs.events import NULL_LOG, EventLog


@dataclass
class ControlState:
    """The one copy of a group's reconfiguration state."""
    topology: Topology = (1,)
    steps_in_state: int = 0
    step: int = 0
    # ticks since each part was last reconfigured — the per-part dwell
    # clocks (aligned with ``topology``)
    part_ages: List[int] = field(default_factory=lambda: [0])
    # (step, ways, divergence) per observe call — Fig 19's timeline
    history: List[Tuple[int, int, float]] = field(default_factory=list)
    # (step, from_topology, to_topology, gain, reason) per applied move
    transitions: List[Tuple[int, Topology, Topology, float, str]] = \
        field(default_factory=list)

    @property
    def ways(self) -> int:
        return len(self.topology)

    @property
    def split(self) -> bool:
        return len(self.topology) > 1


class GroupController:
    """Per-part dwell + policy + amortization check for one group."""

    def __init__(self, policy: Optional[ReconfigPolicy] = None,
                 space: Optional[ConfigSpace] = None,
                 dwell: int = 8,
                 replay: Optional[ReplayBuffer] = None,
                 label_margin: float = 0.02,
                 regroup_policy: str = "warp_regroup",
                 obs: Optional[EventLog] = None,
                 gid: int = -1):
        self.policy = policy or ThresholdPolicy()
        self.space = space or ConfigSpace(capacity=2, max_ways=2)
        self.dwell = dwell
        self.replay = replay
        self.label_margin = label_margin
        self.regroup_policy = regroup_policy
        self.obs = obs if obs is not None else NULL_LOG
        self.gid = gid
        self.state = ControlState(topology=(self.space.capacity,))
        self._hint: Optional[TopologyLike] = None

    # -- fleet-level override ------------------------------------------------

    def request_topology(self, t: TopologyLike) -> None:
        """Chip-level hint: move toward ``t`` when dwell next allows.

        ``t`` may be a part count (the fleet's usual nudge) or an exact
        composition (e.g. the ``(C-1, 1)`` quarantine reservation).  The
        hint flows through the same transition path as policy proposals
        (one move per decision tick, dwell-checked), so a fleet rebalance
        can never bypass the group's own pacing.  An exact-composition
        hint retires only when the group holds *exactly* that topology;
        a part-count hint retires on reaching the count.
        """
        self._hint = t if self.space.legal(t) else None

    def _hint_reached(self) -> bool:
        if self._hint is None:
            return False
        if isinstance(self._hint, int):
            return self.state.ways == self._hint
        return self.state.topology == self.space.as_topology(self._hint)

    def _hint_exact(self, target: Topology) -> bool:
        """Is ``target`` the exact composition a fleet hint asked for?"""
        return (self._hint is not None
                and not isinstance(self._hint, int)
                and target == self.space.as_topology(self._hint))

    # -- the decision tick ----------------------------------------------------

    def _log_label(self, fv: FeatureVector
                   ) -> Optional[Tuple[int, float, float]]:
        """Log one (features, realized-win) sample; returns the sample's
        (absolute replay index, realized gain, label) for the decision
        audit, or None when no label was logged."""
        if self.replay is None or fv.remaining is None \
                or fv.remaining.size < 2:
            return None
        # the lattice argmax scores up to ~hundred candidate partitions of
        # a <=capacity batch — microseconds against the jitted decode step
        # each tick pays for, and only paid when a replay buffer is wired
        _, gain = self.space.best_topology(fv.remaining, self.regroup_policy)
        label = 1.0 if gain > self.label_margin else 0.0
        idx = self.replay.add(fv.to_array(), label)
        return idx, float(gain), label

    def observe(self, fv: FeatureVector, max_ways_now: Optional[int] = None
                ) -> int:
        """Feed one decision tick's telemetry; returns the current ways.

        ``max_ways_now`` caps how far the group may split *right now*
        (e.g. a single-request batch cannot be partitioned) without
        touching the configured space.  The applied composition is read
        from ``state.topology``.
        """
        st = self.state
        st.step += 1
        st.steps_in_state += 1
        for i in range(len(st.part_ages)):
            st.part_ages[i] += 1
        label_info = self._log_label(fv)
        # no part has dwelt long enough for *any* move to touch it
        if max(st.part_ages) < self.dwell:
            st.history.append((st.step, st.ways, fv.divergence))
            return st.ways

        d = self._proposal(fv)
        target = self._resolve(d, fv, max_ways_now)
        cur = st.topology
        applied = False
        gain = d.gain
        if target is not None:
            gain = d.gain if d.topology == target else self._move_gain(
                fv, st.topology, target, d.gain)
            touched = self.space.touched_parts(st.topology, target)
            ok = self.space.transition_ok(st.topology, target, gain)
            if not ok and self._hint_exact(target):
                # a reservation's value (tenant isolation) lies outside
                # the slot-cost model, so an exact fleet hint skips the
                # min-gain floor — but must still be a legal single move
                # and (below) clear every touched part's dwell clock
                ok = target in self.space.neighbors(st.topology)
            if ok and all(st.part_ages[i] >= self.dwell for i in touched):
                st.transitions.append((st.step, st.topology, target, gain,
                                       d.reason))
                st.part_ages = self._rebuild_ages(st.topology, target,
                                                  st.part_ages)
                st.topology = target
                st.steps_in_state = 0
                applied = True
        if self.obs.enabled:
            payload = {"from": cur, "target": target, "applied": applied,
                       "proba": float(d.proba), "gain": float(gain),
                       "reason": d.reason, "features": fv.to_array(),
                       "step": st.step}
            if label_info is not None:
                payload["replay_idx"], payload["label_gain"], \
                    payload["label"] = label_info
            self.obs.emit("policy_decision", gid=self.gid, **payload)
        # a fleet hint survives rejected attempts (capped by a momentary
        # max_ways_now or an under-floor gain) and retires only once the
        # group actually reaches the requested topology
        if self._hint_reached():
            self._hint = None
        st.history.append((st.step, st.ways, fv.divergence))
        return st.ways

    def _move_gain(self, fv: FeatureVector, cur: Topology, new: Topology,
                   fallback: float) -> float:
        if fv.remaining is None:
            return fallback
        return self.space.move_gain(fv.remaining, cur, new,
                                    self.regroup_policy)

    def _rebuild_ages(self, cur: Topology, new: Topology,
                      ages: List[int]) -> List[int]:
        """Carry untouched parts' dwell clocks across a move."""
        touched = self.space.touched_parts(cur, new)
        p = touched[0]
        q = len(cur) - (touched[-1] + 1)
        fresh = [0] * (len(new) - p - q)
        return list(ages[:p]) + fresh + list(ages[len(cur) - q:])

    def _resolve(self, d: Decision, fv: FeatureVector,
                 max_ways_now: Optional[int]) -> Optional[Topology]:
        """Materialize a Decision into one legal topology move (or None)."""
        cur = self.state.topology
        t = d.topology
        if t is not None and (not self.space.legal(t) or t == cur):
            t = None
        if t is None:
            k = d.ways
            if k == len(cur):
                return None
            if k > len(cur):
                t = self.space.suggest_split(cur, fv.remaining,
                                             self.regroup_policy)
            else:
                t = self.space.suggest_fuse(cur, fv.remaining,
                                            self.regroup_policy)
        if t is None or t == cur:
            return None
        if max_ways_now is not None and len(t) > len(cur):
            limit = max(max_ways_now, len(cur))
            if len(t) > limit:
                t = self.space.suggest_split(
                    cur, fv.remaining, self.regroup_policy,
                    max_parts=limit) if len(cur) < limit else None
        return None if t == cur else t

    def _proposal(self, fv: FeatureVector) -> Decision:
        if self._hint is not None and not self._hint_reached():
            cur = self.state.topology
            if not isinstance(self._hint, int):
                want_t = self.space.as_topology(self._hint)
                if want_t in self.space.neighbors(cur):
                    gain = self._move_gain(fv, cur, want_t, fv.divergence)
                    return Decision(len(want_t), topology=want_t, gain=gain,
                                    reason="fleet rebalance")
                # not single-move reachable yet: fall through to the
                # part-count nudge and converge over later ticks
                if len(want_t) == len(cur):
                    # same part count but a different cut, and no single
                    # re-cut reaches it — let the policy act this tick
                    return self.policy.decide(fv, self.state.topology)
            want = n_parts(self._hint)
            if want > len(cur):
                t = self.space.suggest_split(cur, fv.remaining,
                                             self.regroup_policy)
            else:
                t = self.space.suggest_fuse(cur, fv.remaining,
                                            self.regroup_policy)
            if t is not None:
                gain = self._move_gain(fv, cur, t, fv.divergence)
                return Decision(len(t), topology=t, gain=gain,
                                reason="fleet rebalance")
        return self.policy.decide(fv, self.state.topology)

    def reset(self) -> None:
        self.state = ControlState(topology=(self.space.capacity,))
        self._hint = None


class FleetController:
    """Chip-wide heterogeneity management across N group controllers.

    The target number of split groups tracks the fraction of outstanding
    *long* work (live + queued requests past ``long_threshold`` tokens),
    re-evaluated every ``every`` wall ticks.  Groups are nudged — never
    forced — via :meth:`GroupController.request_topology`; the per-group
    dwell and amortization check still gate the actual move.  Because
    groups hold heterogeneous compositions, the rebalance also *deepens*
    the split mix: when every group the tail mass calls for is already
    split but the long fraction stays past ``deepen_threshold``, the
    most divergent split group is nudged one part further.
    """

    def __init__(self, long_threshold: int = 24, every: int = 16,
                 min_split: int = 0, max_split: Optional[int] = None,
                 deepen_threshold: float = 0.5,
                 planner=None, quarantine: Optional[int] = None,
                 mix: bool = True, leases=None):
        self.long_threshold = long_threshold
        self.every = max(every, 1)
        self.min_split = min_split
        self.max_split = max_split
        self.deepen_threshold = deepen_threshold
        # optional repro.fleet.migrate.MigrationPlanner: plans gathered
        # on the rebalance tick, executed by the engine between ticks
        self.planner = planner
        # optional repro.fleet.lease.LeasePlanner: slot leases granted /
        # revoked on the same gate, after steals claimed the free slots
        self.leases = leases
        # group index holding the reserved (C-1, 1) quarantine slice
        self.quarantine = quarantine
        # False = skip split-mix nudging (migration/quarantine only)
        self.mix = mix
        self.rebalances = 0
        self._plans: list = []

    # -- quarantine reservation ------------------------------------------------

    def reserved_parts(self, groups: Sequence) -> set:
        """Live ``(group, part)`` reservations — steal-ineligible."""
        out = set()
        q = self.quarantine
        if q is not None and 0 <= q < len(groups):
            topo = groups[q].controller.state.topology
            if len(topo) >= 2 and topo[-1] == 1:
                out.add((q, len(topo) - 1))
        return out

    def _maintain_quarantine(self, groups: Sequence) -> int:
        """Re-assert the exact-composition reservation when it drifted."""
        g = groups[self.quarantine]
        topo = g.controller.state.topology
        cap = g.controller.space.capacity
        want = (cap - 1, 1)
        if cap < 2 or (len(topo) >= 2 and topo[-1] == 1):
            return 0
        if not g.controller.space.legal(want):
            return 0
        g.controller.request_topology(want)
        return 1

    def take_plans(self) -> list:
        """Hand the engine this tick's migration plans (drains them)."""
        plans, self._plans = self._plans, []
        return plans

    def desired_split_groups(self, long_frac: float, n_groups: int) -> int:
        # round up: any long-tail mass deserves at least one split group
        want = int(math.ceil(long_frac * n_groups - 1e-9)) \
            if long_frac > 0 else 0
        hi = self.max_split if self.max_split is not None else n_groups
        return max(self.min_split, min(want, hi))

    @staticmethod
    def _divergence(g) -> float:
        rem = np.asarray([r.remaining for r in g.live_requests()],
                         np.float64)
        return 0.0 if rem.size == 0 or rem.max() <= 0 \
            else 1.0 - rem.mean() / rem.max()

    def rebalance(self, tick: int, groups: Sequence) -> int:
        """One chip-level control tick; returns hints issued this call.

        Re-asserts the quarantine reservation, nudges the split mix
        (unless ``mix`` is off), and — when a migration planner is
        wired — gathers this tick's steal/migration plans for the
        engine to pick up via :meth:`take_plans`.  ``groups`` are
        serving groups exposing ``controller`` (a
        :class:`GroupController`), ``live_requests()``, ``queue`` and
        ``load()`` — the :class:`repro.serve.engine.ReconfigurableGroup`
        surface.
        """
        if tick % self.every != 0:
            return 0
        issued = 0
        if self.quarantine is not None \
                and 0 <= self.quarantine < len(groups):
            issued += self._maintain_quarantine(groups)
        issued += self._rebalance_mix(groups) if self.mix else 0
        if self.planner is not None:
            self._plans = self.planner.plan(
                tick, groups, reserved=self.reserved_parts(groups))
        if self.leases is not None:
            self.leases.step(tick, groups,
                             reserved=self.reserved_parts(groups))
        self.rebalances += issued > 0
        return issued

    def _rebalance_mix(self, groups: Sequence) -> int:
        total, long_n = 0, 0
        for g in groups:
            for r in g.live_requests():
                total += 1
                long_n += r.remaining >= self.long_threshold
            for r in g.queue:
                total += 1
                long_n += r.max_new_tokens >= self.long_threshold
        if total == 0:
            return 0
        long_frac = long_n / total
        # the quarantine group's composition is reserved — mix nudges
        # must not fight the standing exact-composition hint
        pool = [g for i, g in enumerate(groups) if i != self.quarantine]
        if not pool:
            return 0
        want = self.desired_split_groups(long_frac, len(pool))
        split = [g for g in pool if g.controller.state.split]
        fused = [g for g in pool if not g.controller.state.split]
        issued = 0
        if len(split) < want:
            # split the most divergent fused groups first
            for g in sorted(fused, key=self._divergence,
                            reverse=True)[:want - len(split)]:
                g.controller.request_topology(2)
                issued += 1
        elif len(split) > want:
            # fuse the least-loaded split groups back
            for g in sorted(split, key=lambda g: g.load())[:len(split) - want]:
                g.controller.request_topology(1)
                issued += 1
        elif split and long_frac > self.deepen_threshold:
            # the split mix is right-sized but the tail mass persists:
            # push the most divergent split group one part deeper
            # (ladder spaces only admit power-of-two counts, so fall
            # back to the next rung when +1 is not legal)
            g = max(split, key=self._divergence)
            ways = g.controller.state.ways
            for deeper in (ways + 1, ways * 2):
                if g.controller.space.legal(deeper):
                    g.controller.request_topology(deeper)
                    issued += 1
                    break
        return issued
