"""Cross-group work stealing and KV-costed request migration.

AMOEBA's chip-level scheduler exists so reconfigurable cores never idle
while work queues elsewhere overflow; the fleet analogue is a group whose
drained split part can only backfill from its *own* queue while a
neighbor's queue — and p99 — blows up.  This module is the chip-level
work mover: each rebalance tick a :class:`MigrationPlanner` inspects
every group's queue depth, drain rate, and remaining-length mix, and
emits :class:`Migration` plans of two kinds:

* **queue steals** — a queued request moves from an overflowing group to
  a starving group's best-fitting part.  Nothing but the prompt travels,
  so a steal is free; the only constraints are the donor's backlog, the
  recipient's free slots, and reserved (quarantine) parts being
  steal-ineligible.

* **live migrations** — an in-flight request moves *with its decode
  state*.  The KV transfer is not free: :class:`KVTransferCost` prices
  the request's cache (bytes follow from its sequence length and the
  model config) over a configurable link bandwidth, and the resulting
  stall ticks are charged to the destination part, whose slots sit busy
  receiving state before decoding resumes.  A live move must clear the
  same normalized amortization bar the topology lattice applies to its
  moves: the predicted slot-step saving (donor part finishes earlier)
  minus the added cost (destination slots spent on stall + drain),
  normalized by the donor group's fused cost exactly like
  :meth:`repro_torch.control.ConfigSpace.move_gain`, must exceed
  ``MigrationConfig.min_gain``.  Zero link bandwidth therefore disables
  live migration outright (infinite stall never amortizes) while steals
  keep flowing — the Langhammer soft-GPGPU lesson that dynamic
  reallocation must be cost-aware to pay off.

The planner is pure decision logic over a small group *protocol* —
``queue``, ``topology``, ``part_live(i)``, ``stats``, ``can_insert``,
``extract_live``, ``insert_live``, ``submit(..., part=)`` — implemented
by :class:`repro_torch.serve.engine.ReconfigurableGroup` and by lightweight
fakes in the test suite.  Execution (the actual KV-slice surgery via
``repro_torch.serve.state_utils``) happens in :meth:`MigrationPlanner.execute`,
invoked by ``FleetEngine.run`` between ticks with the plans the
``FleetController`` gathered on its rebalance tick.

Counterpart of ``repro/fleet/migrate.py``.  The int8 wire constants come
from the port's own :mod:`repro_torch.kernels.quantize`, and the pricing
formula is the reference's unchanged (one fp32 scale per cached row of
``num_kv_heads * head_dim`` entries, where the int8 cache holds one per
position and kv head), so plans and stall charges are equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.configs.base import MigrationConfig, ModelConfig
from repro_torch.kernels.quantize import INT8_CODE_BYTES, INT8_SCALE_BYTES
from repro_torch.obs.events import NULL_LOG
from repro_torch.serve.engine import Request

# (group index, part index); part None = no part preference
Addr = Tuple[int, Optional[int]]


def charge_ticks(stall: float) -> int:
    """Integer stall charge for a fractional transfer time.

    The wall tick is the cost quantum, so a transfer that takes any
    fraction of a tick past a whole boundary occupies the destination
    for the *next* whole tick — ``int()`` truncation billed a 2.9-tick
    transfer as 2, systematically under-pricing live migrations and
    flipping amortization vetoes near the margin.  Sub-tick transfers
    stay free (the ``TieredTransferCost`` rule: a NoC hop hides behind
    the decode tick).  Infinite stalls must be vetoed before charging.
    """
    if math.isinf(stall):
        raise ValueError("infinite stall must be vetoed, not charged")
    if stall < 1.0:
        return 0
    return int(math.ceil(stall - 1e-9))


def fit_part(topology: Sequence[int], is_long: bool,
             free: Optional[Sequence[int]] = None) -> Optional[int]:
    """The length-aware part choice shared by admissions and steals.

    Predicted-long requests go to the narrowest eligible part (the
    tail-quarantine slice wastes the fewest slot-steps), short requests
    to the widest (the lockstep drain).  ``free`` restricts candidates
    to parts with free slots; without it every part is eligible (the
    router's soft-affinity case).
    """
    cands = [i for i in range(len(topology))
             if free is None or free[i] > 0]
    if not cands:
        return None
    if is_long:
        return min(cands, key=lambda i: (topology[i], i))
    return max(cands, key=lambda i: (topology[i], -i))


# -- the transfer-cost model ---------------------------------------------------

@dataclass(frozen=True)
class KVTransferCost:
    """Bytes-on-the-wire model for moving one request's decode state.

    ``bytes = f(seq_len, model_cfg)``: every attention layer contributes
    K and V rows (``2 * num_kv_heads * head_dim``) per cached position —
    capped by the KV window and any sliding-window attention — and every
    recurrent layer (SSM / RG-LRU) contributes its constant-size state.
    ``link_bandwidth`` (bytes per wall tick) converts bytes into the
    stall ticks charged to the destination part; a non-positive
    bandwidth prices every transfer at infinity, which makes every live
    migration fail its amortization check.

    ``quantized`` ships the cache in the int8 wire layout of
    ``repro_torch.kernels.quantize`` — one int8 code per entry plus one fp32
    scale per row — so transfer bytes drop ~4x against bf16 and live
    moves that a given bandwidth vetoed start amortizing.
    """
    # defaults mirror MigrationConfig — the planner always rebuilds this
    # from the config, so the config is the single source of truth
    link_bandwidth: float = MigrationConfig.link_bandwidth
    dtype_bytes: int = MigrationConfig.kv_dtype_bytes
    quantized: bool = MigrationConfig.quantized_kv

    def _cache_bytes(self, rows: int, row_width: int) -> int:
        """Bytes for ``rows`` cache-dtype rows of ``row_width`` entries."""
        if self.quantized:
            return rows * (row_width * INT8_CODE_BYTES + INT8_SCALE_BYTES)
        return rows * row_width * self.dtype_bytes

    def kv_bytes(self, seq_len: int, model_cfg: ModelConfig,
                 window: Optional[int] = None) -> int:
        cached = max(int(seq_len), 1)
        if window is not None:
            cached = min(cached, int(window))
        d = model_cfg.resolved_head_dim
        total = 0
        for kind in model_cfg.layer_kinds:
            if kind == "attn":
                span = cached if model_cfg.attn_window is None \
                    else min(cached, model_cfg.attn_window)
                # K and V: one cache-dtype row of num_kv_heads * d per
                # cached position each
                total += self._cache_bytes(2 * span,
                                           model_cfg.num_kv_heads * d)
            elif kind == "ssm":
                ssm = model_cfg.ssm
                if ssm is not None:
                    # SSMState: conv tail (d_conv-1, d_inner) in the
                    # cache dtype, scan state h in float32
                    di = ssm.expand * model_cfg.d_model
                    total += self._cache_bytes(ssm.d_conv - 1, di)
                    total += di * ssm.d_state * 4
            elif kind == "rglru":
                rg = model_cfg.rglru
                w = (rg.lru_width if rg and rg.lru_width
                     else model_cfg.d_model)
                conv = rg.conv_width if rg else 4
                # RGLRUState: conv tail (conv_width-1, W) in the cache
                # dtype, hidden h (W,) in float32
                total += self._cache_bytes(conv - 1, w)
                total += w * 4
        return total

    def stall_ticks(self, seq_len: int, model_cfg: ModelConfig,
                    window: Optional[int] = None,
                    src: Optional[int] = None,
                    dst: Optional[int] = None) -> float:
        """Wall ticks the destination part stalls for one transfer.

        ``src``/``dst`` (group indices) are accepted so distance-aware
        subclasses (the cluster layer's tiered cost) can price by
        the tier of the pair; the flat model ignores them.
        """
        if self.link_bandwidth <= 0:
            return math.inf
        return math.ceil(
            self.kv_bytes(seq_len, model_cfg, window) / self.link_bandwidth)


# -- plans ---------------------------------------------------------------------

STEAL = "steal"
LIVE = "live"


@dataclass
class Migration:
    """One planned move: a queued steal or a live KV-costed migration."""
    kind: str                      # STEAL | LIVE
    request: Request
    src: Addr
    dst: Addr
    stall: int = 0                 # destination stall ticks (LIVE only)
    gain: float = 0.0              # normalized amortization gain (LIVE only)

    def as_dict(self) -> Dict:
        return {"kind": self.kind, "rid": self.request.rid,
                "src": list(self.src), "dst": list(self.dst),
                "stall": self.stall, "gain": round(self.gain, 4)}


# -- the planner ---------------------------------------------------------------

@dataclass
class _GroupView:
    """One plan tick's snapshot of a group's pressure."""
    gi: int
    queue_len: int
    free: List[int]                # free decode slots per part
    drain_rate: float              # completions per tick since last plan
    topology: Tuple[int, ...]

    @property
    def total_free(self) -> int:
        return sum(self.free)


class MigrationPlanner:
    """Chip-level work-stealing and migration policy.

    ``plan`` ranks donors by expected time-to-drain (queue depth over
    recent drain rate — a deep queue on a fast group is less urgent than
    the same queue on a slow one) and matches their excess against
    starving groups' free slots, fitting each stolen request to the
    recipient part the length-aware router would pick (predicted-long
    requests to the narrowest free part, short to the widest).  Live
    migrations then move the worst tail request of a crowded part onto
    an idle part elsewhere when the amortization check clears.  Reserved
    parts (quarantine slices the :class:`repro_torch.control.FleetController`
    pinned via exact-composition hints) are never a steal or migration
    destination.
    """

    def __init__(self, cfg: MigrationConfig, model_cfg: ModelConfig,
                 long_threshold: int = 24, window: Optional[int] = None,
                 cost: Optional[KVTransferCost] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.long_threshold = long_threshold
        self.window = window
        self.cost = cost if cost is not None else KVTransferCost(
            link_bandwidth=cfg.link_bandwidth,
            dtype_bytes=cfg.kv_dtype_bytes,
            quantized=cfg.quantized_kv)
        # counters surfaced in FleetTelemetry.summary
        self.plan_ticks = 0
        self.planned = 0
        self.steals = 0
        self.live_migrations = 0
        self.rejected_amortization = 0
        self.stall_ticks_charged = 0
        self._drain: Dict[int, Tuple[int, int]] = {}   # gi -> (tick, done)
        # expected ticks-to-drain per group, refreshed each plan tick —
        # the pressure view routers consult for admission spill
        self._pressure: Dict[int, float] = {}
        # event stream (repro_torch.obs); the owning engine assigns its log
        # after construction so steal/migrate executions are traced
        self.obs = NULL_LOG

    # -- telemetry -------------------------------------------------------------

    def summary(self) -> Dict:
        return {
            "plan_ticks": self.plan_ticks,
            "planned": self.planned,
            "steals": self.steals,
            "live_migrations": self.live_migrations,
            "rejected_amortization": self.rejected_amortization,
            "stall_ticks_charged": self.stall_ticks_charged,
        }

    # -- the pressure view (router admission spill) ----------------------------

    def pressure(self) -> Dict[int, float]:
        """Expected ticks-to-drain per group, as of the last plan tick.

        The same donor-urgency signal :meth:`_plan_steals` ranks by
        (queue depth over recent drain rate), exported so routers can
        spill *admissions* off a hot group before its queue overflows —
        steals then only handle the residual.  Empty until the first
        plan tick.
        """
        return self._pressure

    # -- snapshots -------------------------------------------------------------

    def _drain_rate(self, tick: int, gi: int, completed: int) -> float:
        prev = self._drain.get(gi)
        self._drain[gi] = (tick, completed)
        if prev is None or tick <= prev[0]:
            return 0.0
        return (completed - prev[1]) / (tick - prev[0])

    def _view(self, tick: int, gi: int, g,
              reserved: Set[Addr]) -> _GroupView:
        topo = tuple(getattr(g, "topology", (1,)))
        # free slots are measured against the lease-adjusted width: a
        # lent slot is not available to steals, a borrowed one is
        eff = getattr(g, "effective_slots", None)
        free = []
        for i, slots in enumerate(topo):
            if (gi, i) in reserved:
                free.append(0)     # quarantine slice: steal-ineligible
            else:
                width = eff(i) if eff is not None else slots
                free.append(max(width - len(g.part_live(i)), 0))
        return _GroupView(gi=gi, queue_len=len(g.queue), free=free,
                          drain_rate=self._drain_rate(
                              tick, gi, g.stats.completed),
                          topology=topo)

    # -- part fitting ----------------------------------------------------------

    def _fit_part(self, view: _GroupView, req: Request) -> Optional[int]:
        return fit_part(view.topology,
                        req.max_new_tokens >= self.long_threshold,
                        free=view.free)

    # -- planning --------------------------------------------------------------

    def plan(self, tick: int, groups: Sequence,
             reserved: Optional[Iterable[Addr]] = None) -> List[Migration]:
        """One rebalance tick's worth of migration plans."""
        self.plan_ticks += 1
        res: Set[Addr] = set(reserved or ())
        views = [self._view(tick, gi, g, res)
                 for gi, g in enumerate(groups)]
        self._pressure = {v.gi: v.queue_len / max(v.drain_rate, 1e-3)
                          if v.queue_len else 0.0 for v in views}
        plans = self._plan_steals(views, groups)
        if self.cfg.live:
            plans += self._plan_live(views, groups, res)
        self.planned += len(plans)
        return plans

    def _recip_priority(self, v: _GroupView) -> Tuple:
        """Recipient ordering key (higher first): most free slots.

        Overridable — the cluster planner boosts gathered region groups
        so tail work lands on the slices reserved for it.
        """
        return (v.total_free,)

    def _plan_steals(self, views: List[_GroupView],
                     groups: Sequence) -> List[Migration]:
        thresh = self.cfg.steal_threshold
        # donors by urgency: expected ticks-to-drain of the backlog
        donors = sorted(
            (v for v in views if v.queue_len > thresh),
            key=lambda v: v.queue_len / max(v.drain_rate, 1e-3),
            reverse=True)
        # recipients starve: free slots, a queue short of filling them,
        # and — so no group is donor and recipient in one plan tick,
        # which would just swap requests in circles — no steal-worthy
        # backlog of their own
        recips = sorted(
            (v for v in views
             if v.total_free > 0 and v.queue_len < v.total_free
             and v.queue_len <= thresh),
            key=self._recip_priority, reverse=True)
        plans: List[Migration] = []
        budget = self.cfg.max_steals
        for donor in donors:
            if budget <= 0:
                break
            queue = list(groups[donor.gi].queue)
            # steal from the tail: the donor keeps FIFO order for the
            # requests it has already promised earliest service
            queue.reverse()
            for recip in recips:
                if recip.gi == donor.gi:
                    continue
                while (budget > 0 and queue
                       and donor.queue_len > thresh
                       and recip.total_free > 0):
                    # peek before popping: a victim this recipient can't
                    # place stays available for the other recipients
                    victim = queue[0]
                    part = self._fit_part(recip, victim)
                    if part is None:
                        break
                    queue.pop(0)
                    plans.append(Migration(STEAL, victim,
                                           src=(donor.gi, None),
                                           dst=(recip.gi, part)))
                    recip.free[part] -= 1
                    donor.queue_len -= 1
                    budget -= 1
        return plans

    def _plan_live(self, views: List[_GroupView], groups: Sequence,
                   reserved: Set[Addr]) -> List[Migration]:
        plans: List[Migration] = []
        budget = self.cfg.max_live
        for donor in views:
            if budget <= 0:
                break
            g = groups[donor.gi]
            for pi, slots in enumerate(donor.topology):
                if budget <= 0:
                    break
                live = g.part_live(pi)
                if len(live) < 2:
                    continue       # a lone request gains nothing by moving
                rem = sorted((r.remaining for r in live), reverse=True)
                victim = max(live, key=lambda r: r.remaining)
                m = self._best_live_move(donor, pi, slots, rem, victim,
                                         views, reserved)
                if m is not None:
                    plans.append(m)
                    # the chosen part is no longer idle for later plans
                    views[m.dst[0]].free[m.dst[1]] = 0
                    budget -= 1
        return plans

    def _best_live_move(self, donor: _GroupView, pi: int, slots: int,
                        rem: List[float], victim: Request,
                        views: List[_GroupView],
                        reserved: Set[Addr]) -> Optional[Migration]:
        """Pick the destination maximizing the amortized gain, or None.

        The gain is priced exactly like a lattice move
        (:meth:`repro_torch.control.ConfigSpace.move_gain`): predicted
        slot-step saving of the move, normalized by the donor group's
        fused drain cost, against the same ``min_gain`` floor.  Here the
        "move" spans two groups: the donor part sheds its longest tail
        (its cost drops from ``slots * max`` to ``slots * second_max``)
        while the destination part — idle by construction — spends
        ``dst_slots * (stall + remaining)`` slot-steps hosting it.
        """
        seq_len = len(victim.prompt) + len(victim.generated)
        saved = slots * (rem[0] - rem[1])
        fused = float(sum(donor.topology)) * max(rem[0], 1.0)
        best: Optional[Migration] = None
        considered = False
        for v in views:
            if v.gi == donor.gi:
                continue
            # the stall is per destination *group*: a tiered cost model
            # (the cluster layer) prices a same-chip hop differently from a
            # cross-chip or cross-node one; the flat model is constant
            stall = self._stall_ticks(seq_len, donor.gi, v.gi)
            for qi, dslots in enumerate(v.topology):
                if (v.gi, qi) in reserved or v.free[qi] < dslots:
                    continue       # only fully idle parts host a transfer
                considered = True
                if math.isinf(stall):
                    gain = -math.inf
                    charged = 0
                else:
                    # price the move at the stall actually charged (the
                    # whole-tick quantum), so the amortization check and
                    # the destination's bill agree
                    charged = charge_ticks(stall)
                    added = dslots * (charged + victim.remaining)
                    gain = (saved - added) / fused
                if gain <= self.cfg.min_gain:
                    continue
                if best is None or gain > best.gain:
                    best = Migration(LIVE, victim, src=(donor.gi, pi),
                                     dst=(v.gi, qi),
                                     stall=charged, gain=gain)
        if considered and best is None:
            # one vetoed *move* (not one per candidate destination)
            self.rejected_amortization += 1
        return best

    def _stall_ticks(self, seq_len: int, src_gi: int, dst_gi: int) -> float:
        """Transfer stall for moving ``seq_len`` of state src -> dst."""
        return self.cost.stall_ticks(seq_len, self.model_cfg, self.window,
                                     src=src_gi, dst=dst_gi)

    # -- execution -------------------------------------------------------------

    def execute(self, plans: Sequence[Migration], groups: Sequence,
                now: int = 0) -> int:
        """Apply plans against the live groups; returns moves executed.

        Every step re-validates against current state (the request must
        still be queued / live, the destination slot still free), so a
        stale plan is dropped rather than corrupting the books — no
        request is ever lost or duplicated.
        """
        done = 0
        for m in plans:
            if m.kind == STEAL:
                done += self._execute_steal(m, groups, now)
            else:
                done += self._execute_live(m, groups)
        return done

    def _execute_steal(self, m: Migration, groups: Sequence,
                       now: int) -> int:
        src, dst = groups[m.src[0]], groups[m.dst[0]]
        idx = next((i for i, q in enumerate(src.queue)
                    if q is m.request), None)
        if idx is None:
            return 0
        del src.queue[idx]
        dst.submit([m.request], now=now, part=m.dst[1])
        src.stats.steals_out += 1
        dst.stats.steals_in += 1
        self.steals += 1
        if self.obs.enabled:
            self.obs.emit("steal", gid=m.dst[0], part=m.dst[1], tick=now,
                          rid=m.request.rid, src=m.src, dst=m.dst,
                          gain=float(m.gain))
        return 1

    def _execute_live(self, m: Migration, groups: Sequence) -> int:
        src, dst = groups[m.src[0]], groups[m.dst[0]]
        if m.dst[1] is None or not dst.can_insert(m.dst[1]):
            return 0
        row = src.extract_live(m.request)
        if row is None:
            return 0
        state, last = row
        ok = dst.insert_live(m.request, state, last,
                             part=m.dst[1], stall=m.stall)
        assert ok, "insert_live failed after can_insert passed"
        self.live_migrations += 1
        self.stall_ticks_charged += m.stall
        if self.obs.enabled:
            self.obs.emit("migrate", gid=m.dst[0], part=m.dst[1],
                          rid=m.request.rid, src=m.src, dst=m.dst,
                          stall=int(m.stall), gain=float(m.gain))
        return 1
