"""Fleet scheduler: N reconfigurable groups behind a request router.

This is the serving translation of the paper's full chip: AMOEBA's 24 SM
pairs each fuse or split *independently*, so at any instant the chip is a
heterogeneous mix of big fused SMs and nimble split halves.  Here each
:class:`~repro_torch.serve.engine.ReconfigurableGroup` is one pair (own
controller, own admission queue, own topology) and the
:class:`FleetEngine` is the chip-level layer the single-pair
``ServeEngine`` could not express: a shared arrival stream, a routing
policy that decides *which* pair absorbs each request, and a wall clock
that ticks all pairs concurrently.

Two control-plane layers from ``repro_torch.control`` operate here:

* every group's :class:`~repro_torch.control.GroupController` runs the
  fleet-wide reconfiguration policy (``FleetConfig.amoeba.policy``:
  threshold / predictor / oracle / online) — one shared policy object, so
  an ``online`` fleet learns from every group's replay samples at once;
* an optional chip-level :class:`~repro_torch.control.FleetController`
  (``FleetConfig.rebalance_every > 0``) nudges the fused/split mix to
  track the fleet's long-request fraction — the paper's chip-wide
  heterogeneity as a managed quantity.

Routing policies (pluggable via ``FleetConfig.router`` or the
``ROUTERS`` registry):

* ``round_robin``   — arrival order striped across groups.
* ``least_loaded``  — minimize outstanding decode work (live remaining +
  queued budgets).
* ``length_aware``  — the heterogeneous-SM assignment: predicted-long
  requests go to already-split groups (whose slow halves quarantine
  tails), short requests prefer fused groups (which drain lockstep
  batches at full width); ties fall back to least-loaded, then
  least-recently-assigned.
* ``sticky``        — ``Request.shard`` pins the group (session/cache
  affinity); the imbalance regime ``repro_torch.fleet.migrate`` exists for.

Routers address ``(group, part)`` — the same scheme migration steals
use — so a length-aware admission can target the narrowest quarantine
slice directly; the part half is a soft affinity the group honors under
contention.  When ``FleetConfig.migrate.enabled``, the chip-level
``FleetController`` additionally gathers work-stealing and KV-costed
live-migration plans each rebalance tick and the engine executes them
between decode ticks (see :mod:`repro_torch.fleet.migrate`).

All pairs share one ``decode_step`` closure (same params, same model),
as the paper's SMs share one instruction front-end.

Counterpart of ``repro/fleet/scheduler.py``, with the same control flow;
only the decode it drives is the port's PyTorch model.
"""
from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import FleetConfig, ModelConfig
from repro_torch.control import ConfigSpace, FleetController, make_policy
from repro_torch.control.policies import ReconfigPolicy
from repro_torch.core.predictor import LogisticModel
from repro_torch.fleet.lease import LeasePlanner
from repro_torch.fleet.migrate import MigrationPlanner, fit_part
from repro_torch.fleet.telemetry import FleetTelemetry
from repro_torch.fleet.vec import VecGroup, VecState
from repro_torch.models import transformer as T
from repro_torch.obs.events import OBS_MODES, EventLog
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.engine import (IDLE, TICKED, ReconfigurableGroup,
                                      Request, make_decode_fn)


# -- routing policies ----------------------------------------------------------
# signature: (request, groups, state) -> (group index, part index | None);
# ``state`` is a dict the policy may use to persist across calls (the
# round-robin cursor, the least-recently-assigned tie-break clocks).  The
# part index is the same (group, part) addressing scheme migration steals
# use, so admissions and steals target parts uniformly; legacy routers
# returning a bare group index are still accepted by the engine.

def _mark_assigned(state: Dict, gi: int) -> None:
    """Stamp ``gi`` as most-recently-assigned for the LRU tie-break."""
    seq = state.get("assign_seq", 0) + 1
    state["assign_seq"] = seq
    state.setdefault("last_assigned", {})[gi] = seq


def _lru(state: Dict, gi: int) -> int:
    """Tie-break key: least-recently-assigned group wins.

    Breaking ties by group index biased steady-state load onto low-index
    groups (every tie went to group 0); the LRU clock rotates them.
    """
    return state.get("last_assigned", {}).get(gi, -1)


def route_round_robin(req: Request, groups: Sequence[ReconfigurableGroup],
                      state: Dict):
    i = (state.get("rr", -1) + 1) % len(groups)
    state["rr"] = i
    return i, None


def route_least_loaded(req: Request, groups: Sequence[ReconfigurableGroup],
                       state: Dict):
    gi = min(range(len(groups)),
             key=lambda i: (groups[i].load(), _lru(state, i), i))
    _mark_assigned(state, gi)
    return gi, None


def route_length_aware(req: Request, groups: Sequence[ReconfigurableGroup],
                       state: Dict):
    """Bin by predicted length onto the heterogeneous group mix.

    Predicted-long requests go to split groups, preferring the one whose
    smallest part — the tail-quarantine slice — is tightest (a long
    request in an s-slot part wastes s x length slot-steps, so the
    narrowest fitting part wins); short requests prefer fused groups and,
    among them, the widest lockstep slice.  Ties fall back to
    least-loaded, then least-recently-assigned.  Returns the chosen
    ``(group, part)`` — the part the fit logic picked, as a soft
    affinity the group honors under contention.
    """
    thresh = state.get("long_threshold", FleetConfig.long_threshold)
    is_long = req.max_new_tokens >= thresh
    pref = [i for i, g in enumerate(groups) if g.is_split == is_long]
    pool = pref if pref else range(len(groups))

    def part_fit(g) -> int:
        topo = getattr(g, "topology", None)
        if not topo:
            return 0
        return min(topo) if is_long and len(topo) > 1 else -max(topo)

    gi = min(pool, key=lambda i: (part_fit(groups[i]), groups[i].load(),
                                  _lru(state, i), i))
    _mark_assigned(state, gi)
    topo = getattr(groups[gi], "topology", None)
    if not topo or len(topo) < 2:
        return gi, None
    return gi, fit_part(topo, is_long)


def _spill(gi: int, groups: Sequence[ReconfigurableGroup],
           state: Dict) -> int:
    """Admission spill: reroute off ``gi`` when its pressure is hot.

    Closes the router/planner loop: the engine publishes its
    ``MigrationPlanner`` into the router state, and any pinned-group
    router consults the planner's pressure view (expected ticks-to-
    drain) before committing an admission.  When the pinned group's
    pressure exceeds ``MigrationConfig.spill_threshold`` the admission
    goes to the least-pressured group instead — so steals only handle
    the residual imbalance instead of re-homing requests the router
    could have placed right the first time.  Returns the (possibly
    unchanged) group index.

    Every outcome stamps the LRU clock: a pinned admission that *stays*
    is still an assignment, and skipping the stamp left the spill
    tie-break ranking cold groups by stale timestamps (two alternating
    hot shards would ping-pong onto the same cold group).
    """
    planner = state.get("planner")
    thresh = state.get("spill_threshold", 0.0)
    if planner is None or thresh <= 0:
        _mark_assigned(state, gi)
        return gi
    p = planner.pressure()
    if p.get(gi, 0.0) <= thresh:
        _mark_assigned(state, gi)
        return gi
    gj = min(range(len(groups)),
             key=lambda i: (p.get(i, 0.0), groups[i].load(),
                            _lru(state, i), i))
    if gj == gi or p.get(gj, 0.0) >= p.get(gi, 0.0):
        _mark_assigned(state, gi)
        return gi                  # nowhere strictly cooler to spill to
    state["spills"] = state.get("spills", 0) + 1
    obs = state.get("obs")
    if obs is not None and obs.enabled:
        # gid is the acting group (the spill source), like every other
        # event kind; the destination rides the payload
        obs.emit("spill", gid=gi, src=gi, dst=gj,
                 pressure=float(p.get(gi, 0.0)))
    _mark_assigned(state, gj)
    return gj


def route_sticky(req: Request, groups: Sequence[ReconfigurableGroup],
                 state: Dict):
    """Shard-affinity routing: ``Request.shard`` pins the group.

    The session/cache-affinity pattern that creates the imbalance the
    migration planner exists to fix — a hot shard's group overflows
    while its neighbors starve.  Unsharded requests fall back to
    least-loaded.  With ``MigrationConfig.spill_threshold`` set, a
    pinned admission spills off a hot group via :func:`_spill`.
    """
    if req.shard is not None:
        return _spill(req.shard % len(groups), groups, state), None
    return route_least_loaded(req, groups, state)


ROUTERS: Dict[str, Callable] = {
    "round_robin": route_round_robin,
    "least_loaded": route_least_loaded,
    "length_aware": route_length_aware,
    "sticky": route_sticky,
}


class FleetEngine:
    """N independently reconfigurable groups draining a shared arrival stream.

    ``submit`` accepts requests with ``arrival`` ticks (a trace from
    ``repro_torch.fleet.traffic``) or plain requests (arrive immediately).  The
    router assigns each request to a group's queue the tick it arrives —
    so ``length_aware`` sees the fleet's *current* split topology, which
    is the point of routing onto a heterogeneous chip.
    """

    def __init__(self, model_cfg: ModelConfig, params,
                 rt: T.Runtime = T.Runtime(),
                 fleet: FleetConfig = FleetConfig(),
                 decode_fn: Optional[Callable] = None,
                 model: Optional[LogisticModel] = None,
                 policy: Optional[ReconfigPolicy] = None):
        if fleet.num_groups < 1:
            raise ValueError("fleet needs at least one group")
        if fleet.router not in ROUTERS:
            raise ValueError(f"unknown router {fleet.router!r}; "
                             f"have {sorted(ROUTERS)}")
        if fleet.engine not in ("object", "vec"):
            raise ValueError(f"unknown engine {fleet.engine!r}; "
                             f"have ('object', 'vec')")
        if fleet.obs not in OBS_MODES:
            raise ValueError(f"unknown obs mode {fleet.obs!r}; "
                             f"have {OBS_MODES}")
        # structured event stream + per-tick metrics (repro_torch.obs); every
        # component below shares this one log so the trace is fleet-wide
        self.obs = EventLog(mode=fleet.obs)
        self._metrics = MetricsRegistry() if self.obs.full else None
        self.cfg = model_cfg
        self.params = params
        self.rt = rt
        self.fleet = fleet
        # one decode closure shared by every group; callers comparing
        # several fleets can pass one in to share it wider.  The vec
        # engine never decodes tokens, so it builds none (and tolerates
        # params=None).
        self._vec = VecState(fleet.num_groups, fleet.capacity) \
            if fleet.engine == "vec" else None
        self._decode = decode_fn if self._vec is not None \
            else (decode_fn or make_decode_fn(model_cfg, rt))
        # chip-wide control plane: one replay buffer and one policy object
        # shared by every group, so online learning pools all samples
        self.telemetry = FleetTelemetry(
            fleet.telemetry_window,
            replay_capacity=fleet.amoeba.replay_capacity)
        acfg = fleet.amoeba
        self.policy = policy
        if self.policy is None and fleet.mode == "dynamic":
            self.policy = make_policy(
                acfg.policy,
                space=ConfigSpace(capacity=fleet.capacity,
                                  max_ways=acfg.max_ways,
                                  min_gain=acfg.min_gain,
                                  hetero=acfg.hetero),
                split_threshold=acfg.split_threshold,
                fuse_threshold=acfg.fuse_threshold,
                regroup_policy=acfg.regroup_policy,
                model=model, model_path=acfg.predictor_path,
                replay=self.telemetry.replay, proba_band=acfg.proba_band,
                oracle_margin=acfg.oracle_margin,
                refit_every=acfg.refit_every)
        # only an online policy consumes the replay buffer; wiring it to
        # every group would pay the per-tick labeling cost for nothing
        grp_replay = getattr(self.policy, "replay", None)
        if self.policy is not None and hasattr(self.policy, "obs"):
            # refit/drift-reset events land in the same trace
            self.policy.obs = self.obs
        grp_kw = dict(rt=rt, amoeba=fleet.amoeba, capacity=fleet.capacity,
                      window=fleet.window, mode=fleet.mode,
                      policy=self.policy, replay=grp_replay,
                      obs=self.obs)
        if self._vec is not None:
            self.groups = [
                VecGroup(model_cfg, params, gid=i, vec_state=self._vec,
                         **grp_kw)
                for i in range(fleet.num_groups)]
        else:
            self.groups = [
                ReconfigurableGroup(model_cfg, params, gid=i,
                                    decode_fn=self._decode, **grp_kw)
                for i in range(fleet.num_groups)]
        self._router = ROUTERS[fleet.router]
        self._router_state: Dict = {"long_threshold": fleet.long_threshold,
                                    "obs": self.obs}
        if fleet.quarantine_group is not None and not (
                0 <= fleet.quarantine_group < fleet.num_groups):
            raise ValueError(
                f"quarantine_group {fleet.quarantine_group} out of range "
                f"for {fleet.num_groups} groups")
        if fleet.mode != "dynamic" and (fleet.migrate.enabled
                                        or fleet.lease.enabled
                                        or fleet.quarantine_group is not None):
            # the chip-level control loop only runs on dynamic fleets;
            # fail loudly rather than report all-zero steal counters
            raise ValueError(
                "migrate.enabled / lease.enabled / quarantine_group need "
                f"mode='dynamic' (got mode={fleet.mode!r})")
        self.planner = MigrationPlanner(
            fleet.migrate, model_cfg,
            long_threshold=fleet.long_threshold,
            window=fleet.window) if fleet.migrate.enabled else None
        if self.planner is not None:
            self.planner.obs = self.obs
            # close the router/planner loop: routers consult the
            # planner's pressure view for admission spill (see _spill)
            self._router_state["planner"] = self.planner
            self._router_state["spill_threshold"] = \
                fleet.migrate.spill_threshold
        self.leases = LeasePlanner(
            fleet.lease, long_threshold=fleet.long_threshold) \
            if fleet.lease.enabled else None
        if self.leases is not None:
            self.leases.obs = self.obs
            # the planner is every group's lease book: reconfiguration
            # force-revokes through it before a composition changes
            self.leases.bind(self.groups)
        # the chip-level controller runs whenever any chip-wide concern
        # exists: split-mix rebalancing, migration planning, slack
        # leasing, or a quarantine reservation to maintain
        need_controller = (fleet.rebalance_every > 0
                           or self.planner is not None
                           or self.leases is not None
                           or fleet.quarantine_group is not None)
        self.controller = FleetController(
            long_threshold=fleet.long_threshold,
            every=fleet.rebalance_every if fleet.rebalance_every > 0
            else max(fleet.migrate.every, 1),
            planner=self.planner,
            quarantine=fleet.quarantine_group,
            mix=fleet.rebalance_every > 0,
            leases=self.leases) if need_controller else None
        self.requests: List[Request] = []
        # min-heap of (arrival, seq, request): O(log n) per submit, and the
        # monotone seq keeps delivery FIFO-stable within an arrival tick
        self._pending: List[Tuple[int, int, Request]] = []
        self._seq = 0
        self._last_delivered: Tuple[int, int] = (-1, -1)
        self.wall = 0
        self._run_seconds = 0.0        # cumulative wall-clock inside run()

    # -- admission -------------------------------------------------------------

    def submit(self, requests: Sequence[Request]) -> None:
        """Queue requests for delivery at their ``arrival`` tick.

        Negative arrivals are normalized here, at the submission
        boundary, so delivery never mutates a caller's trace objects —
        a trace can be replayed across engines without aliasing
        surprises.
        """
        for r in requests:
            if r.arrival < 0:
                r.arrival = 0
            self.requests.append(r)
            self._seq += 1
            heapq.heappush(self._pending, (r.arrival, self._seq, r))

    def _deliver(self) -> None:
        while self._pending and self._pending[0][0] <= self.wall:
            arrival, seq, r = heapq.heappop(self._pending)
            # micro-invariant: within one arrival tick, delivery follows
            # submission order (a late submission whose arrival already
            # passed is delivered now and starts a fresh tick, so only
            # equal-arrival pops are comparable)
            if arrival == self._last_delivered[0]:
                assert seq > self._last_delivered[1], \
                    (arrival, seq, self._last_delivered)
            self._last_delivered = (arrival, seq)
            dest = self._router(r, self.groups, self._router_state)
            gi, pi = dest if isinstance(dest, tuple) else (dest, None)
            self.groups[gi].submit([r], now=self.wall, part=pi)

    def _next_event(self) -> Optional[int]:
        """Tick of the next externally scheduled event, or None.

        The idle fast-forward target: the base engine only has pending
        arrivals; subclasses with other deferred events (the cluster
        engine's in-flight cross-chip transfers) fold them in here so
        an idle fleet never terminates with work still in the air.
        """
        return self._pending[0][0] if self._pending else None

    # -- main loop ----------------------------------------------------------------

    def _step_groups(self, dynamic: bool) -> List[str]:
        """Advance every group one tick; vec mode batches the decode.

        In vec mode each group's ``step()`` only runs control flow
        (admission, controller, stall bookkeeping) and *marks* its
        decoding parts; the single ``decode_tick`` then applies every
        mark with one masked array pass.  Deferring is equivalent to the
        object engine's in-loop decodes because a decode only touches
        its own group's rows and nothing reads another group's
        post-decode state within the same tick.
        """
        statuses = [g.step(dynamic=dynamic, now=self.wall)
                    for g in self.groups]
        if self._vec is not None:
            self._vec.decode_tick(self.wall, self.groups)
        return statuses

    def run(self, dynamic: bool = True,
            max_ticks: int = 1_000_000) -> Dict:
        """Drive the fleet until the trace is fully drained (or max_ticks)."""
        t0 = time.perf_counter()
        while self.wall < max_ticks:
            if self.obs.enabled:
                # one clock for every emitter that has no tick in scope
                # (controller.observe, policy refits, live migrations)
                self.obs.set_tick(self.wall)
            self._deliver()
            if self.controller is not None and dynamic \
                    and self.fleet.mode == "dynamic":
                if self._vec is not None \
                        and self.wall % self.controller.every == 0:
                    # rebalance ticks read Request.generated lengths
                    # (KV-transfer pricing, long-fraction mix); make the
                    # lazily-materialized lists truthful first
                    self._vec.sync_generated()
                self.controller.rebalance(self.wall, self.groups)
                plans = self.controller.take_plans()
                if plans:
                    # execute between ticks: steals re-queue, live
                    # migrations splice KV rows before anyone decodes
                    self.planner.execute(plans, self.groups, now=self.wall)
            statuses = self._step_groups(dynamic)
            ticked = sum(s == TICKED for s in statuses)
            if all(s == IDLE for s in statuses):
                nxt_evt = self._next_event()
                if nxt_evt is None:
                    # terminal probe: the trace is drained, not an idle tick
                    break
                # fast-forward the idle gap to the next event, never
                # past the caller's tick bound
                nxt = min(max(self.wall + 1, nxt_evt), max_ticks)
                self.telemetry.on_tick(self.wall, self.groups, 0,
                                       all_idle=True)
                self.telemetry.on_idle_gap(nxt - self.wall - 1,
                                           len(self.groups))
                self.wall = nxt
                continue
            self.telemetry.on_tick(self.wall, self.groups, ticked)
            if self._metrics is not None:
                # vec: one fleet-wide sum instead of a slice per group
                live = int(self._vec.part_live_n.sum()) \
                    if self._vec is not None else None
                self._metrics.sample_fleet(self.wall, self.groups,
                                           planner=self.planner, live=live)
            self.wall += 1
        if self._vec is not None:
            self._vec.sync_generated()
        for g in self.groups:
            g.finalize()
        self.obs.meta.setdefault("obs_mode", self.obs.mode)
        self.obs.meta["wall_ticks"] = self.wall
        summary = self.telemetry.summary(self.groups, self.requests,
                                         policy=self.policy,
                                         fleet_controller=self.controller,
                                         router_state=self._router_state,
                                         obs=self.obs,
                                         metrics=self._metrics)
        # perf trajectory: every summary (and thus every BENCH entry)
        # carries measured wall seconds and simulated ticks per second;
        # cumulative across run() calls on the same engine
        self._run_seconds += time.perf_counter() - t0
        summary["wall_s"] = round(self._run_seconds, 4)
        summary["ticks_per_sec"] = round(
            summary["wall_ticks"] / max(self._run_seconds, 1e-9), 1)
        return summary

    # -- aggregates -------------------------------------------------------------

    @property
    def completed(self) -> int:
        return sum(g.stats.completed for g in self.groups)

    @property
    def useful_tokens(self) -> int:
        return sum(g.stats.useful_tokens for g in self.groups)

    @property
    def slot_steps(self) -> int:
        return sum(g.stats.slot_steps for g in self.groups)


# -- chip-configuration comparison ---------------------------------------------

# (label, group mode, router): the three chip configurations of Fig 12 —
# big-SMs-only, small-SMs-only, and AMOEBA free to pick per pair.
DEFAULT_MODES = (
    ("static_fused", "fused", "least_loaded"),
    ("static_split", "split", "least_loaded"),
    ("amoeba_dynamic", "dynamic", "length_aware"),
)


def replay_modes(model_cfg: ModelConfig, params, rt: T.Runtime,
                 trace_factory: Callable[[], Sequence[Request]], *,
                 groups: int, capacity: int,
                 amoeba=None, window: int = 256,
                 modes: Sequence = DEFAULT_MODES,
                 verbose: bool = True) -> Dict[str, Dict]:
    """Replay identical traces through several fleet configurations.

    ``trace_factory`` must return a *fresh* trace per call (replaying
    mutates the requests); same factory + same seed = byte-identical
    load for every mode.  One decode closure is shared across modes so
    differences are purely scheduling.  Used by both the fleet benchmark
    and the demo — raises if any mode fails to drain its trace.
    """
    from repro_torch.configs.base import AmoebaConfig
    amoeba = amoeba or AmoebaConfig()
    decode = make_decode_fn(model_cfg, rt)
    out: Dict[str, Dict] = {}
    for label, mode, router in modes:
        trace = trace_factory()
        eng = FleetEngine(model_cfg, params, rt=rt, decode_fn=decode,
                          fleet=FleetConfig(
                              num_groups=groups, capacity=capacity,
                              router=router, mode=mode, window=window,
                              amoeba=amoeba))
        eng.submit(trace)
        s = eng.run()
        if s["completed"] != len(trace):
            raise RuntimeError(f"{label}: completed {s['completed']} of "
                               f"{len(trace)} requests")
        out[label] = s
        if verbose:
            lat = s["latency"]
            print(f"{label:15s} ticks={s['wall_ticks']:4d} "
                  f"eff={s['efficiency']:.3f} "
                  f"p50={lat['p50']:5.1f} p95={lat['p95']:5.1f} "
                  f"p99={lat['p99']:5.1f} util={s['utilization']:.2f} "
                  f"churn/kt={s['churn_per_kilotick']:.0f} "
                  f"done={s['completed']}/{s['submitted']}")
    return out


def replay_policies(model_cfg: ModelConfig, params, rt: T.Runtime,
                    trace_factory: Callable[[], Sequence[Request]], *,
                    groups: int, capacity: int, amoeba=None,
                    window: int = 256,
                    policies: Sequence[str] = ("threshold", "predictor",
                                               "oracle", "online"),
                    model: Optional[LogisticModel] = None,
                    router: str = "length_aware",
                    verbose: bool = True) -> Dict[str, Dict]:
    """Replay identical traces under several reconfiguration policies.

    The policy-sweep companion of :func:`replay_modes`: every run is a
    fully dynamic fleet; only the decision stack differs.  ``predictor``
    needs a trained serve-level model (see
    ``repro_torch.control.offline.train_serve_predictor``); when ``model`` is
    None it is trained on the fly from the synthetic corpus.
    """
    from repro_torch.configs.base import AmoebaConfig
    amoeba = amoeba or AmoebaConfig()
    if model is None and "predictor" in policies:
        from repro_torch.control import train_serve_predictor
        model, _ = train_serve_predictor(capacity=capacity,
                                         max_ways=amoeba.max_ways,
                                         label_margin=amoeba.label_margin,
                                         regroup_policy=amoeba.regroup_policy,
                                         hetero=amoeba.hetero)
    decode = make_decode_fn(model_cfg, rt)
    out: Dict[str, Dict] = {}
    for name in policies:
        trace = trace_factory()
        eng = FleetEngine(
            model_cfg, params, rt=rt, decode_fn=decode, model=model,
            fleet=FleetConfig(num_groups=groups, capacity=capacity,
                              router=router, mode="dynamic", window=window,
                              amoeba=amoeba.replace(policy=name)))
        eng.submit(trace)
        s = eng.run()
        if s["completed"] != len(trace):
            raise RuntimeError(f"policy {name}: completed {s['completed']} "
                               f"of {len(trace)} requests")
        out[name] = s
        if verbose:
            lat = s["latency"]
            print(f"policy={name:10s} ticks={s['wall_ticks']:4d} "
                  f"eff={s['efficiency']:.3f} "
                  f"p50={lat['p50']:5.1f} p95={lat['p95']:5.1f} "
                  f"p99={lat['p99']:5.1f} "
                  f"churn/kt={s['churn_per_kilotick']:.0f}")
    return out
