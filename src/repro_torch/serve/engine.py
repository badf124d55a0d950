"""Serving engine with AMOEBA dynamic group splitting.

Counterpart of ``repro/serve/engine.py``, with the same control flow and
accounting; the decode state and token rows are torch tensors on the
params' device.  The fleet hooks (leases, live migration) are kept so a
later port of ``repro.fleet`` drives the same group.

The engine drives real ``prefill``/``decode_step`` calls.  A *group* is the
serving analogue of an SM: the fused group decodes its whole batch in
lockstep, so every tick costs ``capacity`` slot-steps and the batch runs
until its **longest** member finishes — the warp-waits-for-the-last-thread
pathology.  The control plane (``repro_torch.control``) watches the
remaining-length divergence and, when its policy fires, partitions the
group into independent parts that admit and drain on their own (the
paper's SM split; ``warp_regroup`` sorts by remaining work first,
``direct_split`` cuts in arrival order).  Parts re-fuse when the
divergence signal drops.

Topologies generalize the paper's binary pair to the full composition
lattice of :class:`repro_torch.control.ConfigSpace`: a capacity-8 group may
run fused ``(8,)``, as the equal pair ``(4, 4)``, or as a heterogeneous
cut like ``(5, 3)`` — each part owns its slot count, admits from the
queue on its own, and drains independently.  The fused/split lifecycle
decisions live in :class:`repro_torch.control.GroupController` — this module
only *executes* them (prefill waves, KV-state partitioning, decode
ticks).
:class:`ReconfigurableGroup` is the unit the fleet scheduler
(``repro.fleet``) replicates N times; :class:`ServeEngine` is the N=1
case and keeps the original public API.

Costs are counted in slot-steps (decode slots x ticks — the hardware-time
unit): a fused tick costs ``capacity``; k split parts tick concurrently
for the same total.  Useful work is generated tokens, so

    efficiency = useful tokens / slot-steps

is directly comparable across policies, and makespan (ticks) measures
latency.  Prefill is batched per distinct prompt length (no padding, no
cross-request contamination).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import AmoebaConfig, ModelConfig
from repro_torch.control import (ArrivalRateTracker, ConfigSpace,
                                 FeatureVector, GroupController, ReplayBuffer,
                                 Topology, balanced, make_policy)
from repro_torch.control.policies import ReconfigPolicy
from repro_torch.core.predictor import LogisticModel
from repro_torch.models import transformer as T
from repro_torch.obs.events import NULL_LOG, EventLog
from repro_torch.obs.spans import SPANS
from repro_torch.serve import state_utils as su
from repro_torch.serve.decode_graph import DecodeGraphs


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    # fleet metadata (defaults keep the original constructor signature)
    tenant: str = "default"
    arrival: int = 0                   # wall tick the request entered the system
    finish: Optional[int] = None       # wall tick the last token was generated
    # router shard for sticky (affinity) routing; None = unsharded
    shard: Optional[int] = None
    # soft preference for one part of the admitting group (set by
    # part-addressable routing and by migration steals); cleared on admit
    part_affinity: Optional[int] = None

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def done(self) -> bool:
        return self.remaining <= 0

    @property
    def latency(self) -> Optional[int]:
        return None if self.finish is None else self.finish - self.arrival + 1


@dataclass
class ServeStats:
    ticks: int = 0                 # wall-time units
    slot_steps: int = 0            # decode slots x ticks consumed
    useful_tokens: int = 0
    prefill_tokens: int = 0
    splits: int = 0
    fuses: int = 0
    resizes: int = 0               # same part count, re-cut slot budgets
    completed: int = 0
    # -- cross-group migration (repro.fleet.migrate) ------------------------
    stall_ticks: int = 0           # part-ticks spent receiving migrated KV
    steals_in: int = 0             # queued requests stolen into this group
    steals_out: int = 0            # queued requests stolen away
    migrations_in: int = 0         # live requests migrated into this group
    migrations_out: int = 0        # live requests migrated away
    # -- slack leases (repro.fleet.lease) -----------------------------------
    leases_out: int = 0            # leases granted as lender
    leases_in: int = 0             # leases received as borrower

    @property
    def efficiency(self) -> float:
        return self.useful_tokens / max(self.slot_steps, 1)


class _Group:
    """One decode group: live requests + their merged DecodeState."""

    def __init__(self, requests: List[Request], state: T.DecodeState,
                 last_tokens: torch.Tensor):
        self.requests = requests
        self.state = state
        self.last = last_tokens            # (B, 1) next input token per row

    @property
    def remaining(self) -> np.ndarray:
        return np.array([r.remaining for r in self.requests], np.float64)


def _group_done(g: Optional[_Group]) -> bool:
    return g is None or all(r.done for r in g.requests)


def make_decode_fn(model_cfg: ModelConfig, rt: T.Runtime) -> Callable:
    """One decode closure, ``(params, state, tokens) -> (logits, state)``,
    shared by every caller that ticks a group.  On a CUDA device each
    decode state's step is captured once as a CUDA graph and replayed
    (:class:`repro_torch.serve.decode_graph.DecodeGraphs`); on the CPU, or
    under a device mesh, it is ``decode_step`` run eagerly.  While a capture
    lasts, every ``torch.cuda.Event`` the process makes is an ``external``
    one, so that a caller's timers around a layer inside the step stay
    readable after replays."""
    return DecodeGraphs(model_cfg, rt)


def _recut_bytes(before: List, after: List) -> int:
    """Bytes of decode state a re-cut wrote: the merge's output (the live
    parts' states, where there were several) and the re-slice's (the new
    parts' states, where there are several).  The vec engine's parts hold
    no state and count 0."""
    after = [p for p in after if p is not None]
    return sum(su.nbytes([getattr(p, "state", None) for p in parts])
               for parts in (before, after) if len(parts) > 1)


# group step outcomes
TICKED = "ticked"        # one decode wall-tick of progress
RECONF = "reconfig"      # split or fuse happened; no decode this call
IDLE = "idle"            # no live work and nothing admissible from the queue


class ReconfigurableGroup:
    """One reconfigurable group: ``ways`` independent partitions of
    ``capacity // ways`` decode slots each.

    The serving analogue of one AMOEBA SM pair, generalized to the k-way
    topology ladder of :class:`repro_torch.control.ConfigSpace`.  It owns its
    admission queue, its :class:`repro_torch.control.GroupController` (policy +
    hysteresis + dwell + amortization check), its partitions, and its
    :class:`ServeStats`.  ``mode`` selects the configurations the group
    may take:

    * ``"dynamic"`` — fused by default; the control-plane policy walks
      the topology ladder on live telemetry (the paper's AMOEBA).
    * ``"fused"``   — never splits (static fused baseline).
    * ``"split"``   — permanently two halves (static split baseline; the
      paper's scale-out-only configuration).

    ``step`` advances the group by at most one wall tick; the caller (the
    N=1 :class:`ServeEngine` or the N-group ``repro.fleet.FleetEngine``)
    owns the wall clock and passes it in as ``now`` so request completion
    times are stamped consistently across groups.
    """

    def __init__(self, model_cfg: ModelConfig, params,
                 rt: T.Runtime = T.Runtime(),
                 amoeba: AmoebaConfig = AmoebaConfig(),
                 capacity: int = 8, window: int = 256,
                 mode: str = "dynamic", gid: int = 0,
                 decode_fn: Optional[Callable] = None,
                 policy: Optional[ReconfigPolicy] = None,
                 model: Optional[LogisticModel] = None,
                 replay: Optional[ReplayBuffer] = None,
                 obs: Optional[EventLog] = None):
        if mode not in ("dynamic", "fused", "split"):
            raise ValueError(f"unknown group mode {mode!r}")
        if mode == "split" and capacity < 2:
            raise ValueError("mode='split' needs capacity >= 2 "
                             "(each half needs at least one decode slot)")
        self.cfg = model_cfg
        self.params = params
        self.device = (params["embed"]["table"].device if params is not None
                       else None)        # the vec engine has no params
        self.rt = rt
        self.acfg = amoeba
        self.capacity = capacity
        self.window = window
        self.mode = mode
        self.gid = gid
        # structured event stream (repro_torch.obs); every emission site below
        # is shared control-plane code so the vec engine inherits it
        self.obs = obs if obs is not None else NULL_LOG
        self.queue: collections.deque[Request] = collections.deque()
        self.stats = ServeStats()
        self.space = ConfigSpace(
            capacity=capacity,
            max_ways=amoeba.max_ways if mode == "dynamic" else 2,
            min_gain=amoeba.min_gain,
            hetero=amoeba.hetero if mode == "dynamic" else False)
        if mode == "dynamic":
            self._policy = policy or make_policy(
                amoeba.policy, space=self.space,
                split_threshold=amoeba.split_threshold,
                fuse_threshold=amoeba.fuse_threshold,
                regroup_policy=amoeba.regroup_policy,
                model=model, model_path=amoeba.predictor_path,
                replay=replay, proba_band=amoeba.proba_band,
                oracle_margin=amoeba.oracle_margin,
                refit_every=amoeba.refit_every)
        else:
            # static modes never consult the controller — don't build a
            # policy (a predictor config would demand a model that a
            # static baseline run has no use for)
            self._policy = policy
        # label logging costs a full topology-ladder evaluation per tick,
        # so only wire a replay buffer when something consumes it: the
        # caller's explicit buffer, or the policy's own (OnlinePolicy)
        grp_replay = replay if replay is not None \
            else getattr(self._policy, "replay", None)
        self.controller = GroupController(
            self._policy, self.space, dwell=amoeba.min_phase_steps,
            replay=grp_replay, label_margin=amoeba.label_margin,
            regroup_policy=amoeba.regroup_policy,
            obs=self.obs, gid=gid)
        self._decode = decode_fn or make_decode_fn(model_cfg, rt)
        self._arrivals = ArrivalRateTracker()
        # the current topology: one entry per partition (None = drained)
        # and the matching per-part decode-slot budget — parts always
        # sum to capacity, so non-power-of-two capacities waste nothing
        if mode == "split":
            self._slots: List[int] = list(balanced(capacity, 2))
        else:
            self._slots = [capacity]
        self._parts: List[Optional[_Group]] = [None] * len(self._slots)
        # per-part stall ticks: a part receiving migrated KV holds its
        # slots busy (repro.fleet.migrate charges the transfer here)
        self._stall: List[int] = [0] * len(self._slots)
        # slack-lease books (repro.fleet.lease): slots this part lent
        # away / borrowed in.  The partition budget ``_slots`` never
        # changes under a lease — only the *effective* admission and
        # charge width does — so lent + resident always sum to the
        # budget.  ``_lease_book`` is the owning LeasePlanner (assigned
        # by the fleet engine); a reconfiguration force-revokes through
        # it before re-cutting, so no slots leak across the boundary.
        self._lent: List[int] = [0] * len(self._slots)
        self._borrowed: List[int] = [0] * len(self._slots)
        self._lease_book = None
        self._lease_touched = False
        self._now_tick = 0             # stamped each step; lease accrual

    # -- admission -------------------------------------------------------------

    def submit(self, requests: Sequence[Request], now: int = 0,
               part: Optional[int] = None) -> None:
        """Queue requests; ``part`` records a soft part preference."""
        for r in requests:
            if part is not None:
                r.part_affinity = part
            self.queue.append(r)
        self._arrivals.record(now, len(requests))

    def _admission_scan(self, n_slots: int,
                        part_idx: Optional[int] = None) -> List[Request]:
        """Pop up to ``n_slots`` admissible requests off the queue.

        Part affinity is a *soft* preference: requests affine to a
        different live part are passed over first, but an otherwise idle
        part takes them rather than stranding its slots (work
        conservation — affinity biases placement, never availability).
        The scan is bounded so a deep backlog of foreign-affine
        requests costs O(capacity) churn per part-tick, not O(queue).
        Shared by the model prefill path and the reference's vectorized engine, so
        both admit byte-identical waves.
        """
        wave: List[Request] = []
        deferred: List[Request] = []
        scan_budget = n_slots + 2 * self.capacity
        while self.queue and len(wave) < n_slots \
                and len(wave) + len(deferred) < scan_budget:
            r = self.queue.popleft()
            aff = r.part_affinity
            if aff is not None and (part_idx is None
                                    or aff >= len(self._slots)):
                aff = r.part_affinity = None   # stale affinity: topology moved
            if aff is not None and aff != part_idx:
                deferred.append(r)
                continue
            r.part_affinity = None
            wave.append(r)
        while deferred and len(wave) < n_slots:
            r = deferred.pop(0)
            r.part_affinity = None
            wave.append(r)
        for r in reversed(deferred):
            self.queue.appendleft(r)
        return wave

    def _prefill_wave(self, n_slots: int, now: int,
                      part_idx: Optional[int] = None) -> Optional[_Group]:
        """Admit up to n_slots queued requests: batch prefill per length."""
        wave = self._admission_scan(n_slots, part_idx)
        if not wave:
            return None
        by_len: Dict[int, List[Request]] = collections.defaultdict(list)
        for r in wave:
            by_len[len(r.prompt)].append(r)
        states, lasts, ordered = [], [], []
        for plen, reqs in sorted(by_len.items()):
            toks = torch.tensor([r.prompt for r in reqs], dtype=torch.long,
                                device=self.device)
            with SPANS.span("group.prefill", batch=len(reqs), seq=plen):
                logits, st = T.prefill(self.params, {"tokens": toks},
                                       self.cfg, self.rt, window=self.window)
            with SPANS.span("group.readback", gid=self.gid, part=part_idx):
                nxt = torch.argmax(logits, dim=-1)     # ties: first index
                for r, t in zip(reqs, nxt.tolist()):
                    r.generated.append(int(t))
                    if r.done:
                        r.finish = now
                self.stats.prefill_tokens += plen * len(reqs)
                self.stats.useful_tokens += len(reqs)
            states.append(st)
            lasts.append(nxt[:, None])
            ordered.extend(reqs)
        return _Group(ordered, su.concat(states), torch.cat(lasts, dim=0))

    # -- decode ----------------------------------------------------------------

    def _tick_group(self, g: _Group, slots: int, now: int,
                    part_idx: int = 0) -> None:
        """One decode step for every live request in the group."""
        live = [i for i, r in enumerate(g.requests) if not r.done]
        if not live:
            return
        with SPANS.span("group.decode", gid=self.gid, part=part_idx,
                        batch=len(g.requests)):
            logits, new_state = self._decode(self.params, g.state, g.last)
        with SPANS.span("group.readback", gid=self.gid, part=part_idx):
            nxt = torch.argmax(logits, dim=-1)         # ties: first index
            arr = nxt.tolist()
            for i, r in enumerate(g.requests):
                if not r.done:
                    r.generated.append(int(arr[i]))
                    self.stats.useful_tokens += 1
                    if r.done:
                        r.finish = now
        g.state = new_state
        g.last = nxt[:, None]
        self.stats.slot_steps += slots

    def _credit(self, r: Request) -> None:
        """Count a completion exactly once, even across resumed runs."""
        if not getattr(r, "_credited", False):
            r._credited = True
            self.stats.completed += 1

    def _retire(self, g: Optional[_Group]) -> None:
        for r in (g.requests if g else []):
            self._credit(r)

    def _part_done(self, g) -> bool:
        """Is this part drained (empty or all members done)?

        Overridable data-plane hook: the vectorized engine answers from
        its arrays instead of per-request ``generated`` lists.
        """
        return _group_done(g)

    # -- topology --------------------------------------------------------------

    def _reconfigure(self, target: Topology) -> None:
        """Merge all live partitions and re-partition onto ``target``.

        Executes the controller's decision: the KV states of the live
        parts are concatenated and re-sliced along the batch axis into
        parts sized to the target composition's slot budgets (a
        ``(5, 3)`` cut quarantines the long tail on 3 slots), so
        reconfiguration never changes any request's results — only which
        rows decode in lockstep and how many slots each cohort owns.
        """
        on = SPANS.on
        if on:
            before = [p for p in self._parts if p is not None]
            cut = {"from": list(self.topology),
                   "to": list(self.space.as_topology(target))}
        with SPANS.span("group.reconfigure", gid=self.gid) as sp:
            self._recut(target)
            if on:
                sp.set(bytes=_recut_bytes(before, self._parts), **cut)

    def _recut(self, target: Topology) -> None:
        """``_reconfigure``'s work: revoke leases, merge, re-slice."""
        # leases are defined against the *current* composition; a new cut
        # invalidates every book entry, so the planner force-revokes both
        # directions (ours and our counterparties') before parts move
        if self._lease_book is not None:
            self._lease_book.force_revoke(self.gid, reason="reconfig",
                                          tick=self._now_tick)
        self._lent = [0] * len(self._slots)
        self._borrowed = [0] * len(self._slots)
        target = self.space.as_topology(target)
        live = [p for p in self._parts if p is not None]
        merged = self._merge_parts(live)
        if len(target) > len(self._parts):
            self.stats.splits += 1
        elif len(target) < len(self._parts):
            self.stats.fuses += 1
        else:
            self.stats.resizes += 1
        # an in-flight KV transfer spans the re-laid-out state: every new
        # part waits out the worst remaining stall (conservative, and a
        # reconfiguration can never shed transfer cost)
        pending_stall = max(self._stall, default=0)
        if len(target) == 1:
            self._parts = [merged]
            self._slots = [self.capacity]
            self._stall = [pending_stall]
            self._lent, self._borrowed = [0], [0]
            return
        parts_idx = self.space.partition(
            list(range(len(merged.requests))), merged.remaining, target,
            self.acfg.regroup_policy)
        self._parts = [self._make_part(merged, ids) for ids in parts_idx]
        self._slots = list(target)
        self._stall = [pending_stall] * len(self._slots)
        self._lent = [0] * len(self._slots)
        self._borrowed = [0] * len(self._slots)

    def _merge_parts(self, live: List[_Group]) -> _Group:
        """Concatenate live parts (in part order) into one batch."""
        if len(live) == 1:
            return live[0]
        return _Group(
            sum((p.requests for p in live), []),
            su.concat([p.state for p in live]),
            torch.cat([p.last for p in live], dim=0))

    def _make_part(self, merged: _Group, ids: List[int]) -> Optional[_Group]:
        """Slice one re-partitioned part out of the merged batch."""
        if not ids:
            return None
        return _Group([merged.requests[i] for i in ids],
                      su.take(merged.state, ids),
                      su.rows(merged.last, ids))

    # -- introspection (used by the fleet router and telemetry) ----------------

    @property
    def ways(self) -> int:
        return len(self._parts)

    @property
    def topology(self) -> Topology:
        """The live composition: decode slots per part."""
        return tuple(self._slots)

    @property
    def is_split(self) -> bool:
        return len(self._parts) > 1

    def live_requests(self) -> List[Request]:
        out: List[Request] = []
        for g in self._parts:
            if g is not None:
                out.extend(r for r in g.requests if not r.done)
        return out

    def live_count(self) -> int:
        """In-flight request count — the metrics registry's live-load
        gauge.  Overridden O(capacity) by the vec engine; both answers
        are identical, so per-tick samples match across engines."""
        return len(self.live_requests())

    def part_live(self, i: int) -> List[Request]:
        """Live (not-done) requests currently decoding on part ``i``."""
        g = self._parts[i]
        if g is None:
            return []
        return [r for r in g.requests if not r.done]

    def load(self) -> float:
        """Outstanding decode work: live remaining + queued budgets."""
        return (sum(r.remaining for r in self.live_requests())
                + sum(r.max_new_tokens for r in self.queue))

    # -- slack leases (driven by repro.fleet.lease) ----------------------------

    def effective_slots(self, part: int) -> int:
        """Admission/charge width of ``part`` under the lease books."""
        return self._slots[part] - self._lent[part] + self._borrowed[part]

    def _part_live_n(self, part: int) -> int:
        """Live member count of ``part`` — overridable O(1) in the vec
        engine; both answers are identical, so charges stay bit-equal."""
        return len(self.part_live(part))

    def _slot_charge(self, part: int) -> int:
        """Slot-steps one tick of ``part`` costs.

        Normally the effective width.  After a lease releases while the
        borrowed cohort is still decoding, the part transiently holds
        more live rows than its effective width — those rows still
        occupy physical slots, so the charge follows the occupancy.
        Untouched groups keep the original constant-width charge.
        """
        if not self._lease_touched:
            return self._slots[part]   # books are all-zero: eff == slots
        return max(self.effective_slots(part), self._part_live_n(part))

    def lease_out(self, part: int, n: int) -> None:
        """Lender side of a grant: ``n`` slots leave the resident budget."""
        assert 0 < n and self._lent[part] + n < self._slots[part] \
            + self._borrowed[part], (self.gid, part, n, self._lent)
        self._lent[part] += n
        self._lease_touched = True

    def lease_back(self, part: int, n: int) -> None:
        """Lender side of a release: ``n`` slots return home."""
        assert 0 < n <= self._lent[part], (self.gid, part, n, self._lent)
        self._lent[part] -= n

    def lease_in(self, part: int, n: int) -> None:
        """Borrower side of a grant: ``n`` foreign slots widen the part."""
        assert n > 0, (self.gid, part, n)
        self._borrowed[part] += n
        self._lease_touched = True

    def lease_return(self, part: int, n: int) -> None:
        """Borrower side of a release."""
        assert 0 < n <= self._borrowed[part], \
            (self.gid, part, n, self._borrowed)
        self._borrowed[part] -= n

    # -- cross-group migration (driven by repro.fleet.migrate) -----------------

    def can_insert(self, part: int) -> bool:
        """True when part ``part`` has a free decode slot for a live row."""
        return (0 <= part < len(self._slots)
                and len(self.part_live(part)) < self.effective_slots(part))

    def extract_live(self, req: Request):
        """Remove one in-flight request and return its decode state.

        Returns ``(state_row, last_row)`` — the request's KV slice and
        next-token row, batch axis kept — or ``None`` when the request is
        not live here (already finished or never admitted).  The source
        part keeps its other members untouched; a part drained by the
        extraction frees its slots immediately.
        """
        for i, g in enumerate(self._parts):
            if g is None:
                continue
            for j, r in enumerate(g.requests):
                if r is req and not r.done:
                    rest = [k for k in range(len(g.requests)) if k != j]
                    state_row, rest_state = su.split(g.state, [j], rest)
                    last_row = g.last[j:j + 1]
                    if rest:
                        self._parts[i] = _Group(
                            [g.requests[k] for k in rest], rest_state,
                            su.rows(g.last, rest))
                    else:
                        self._parts[i] = None
                    self.stats.migrations_out += 1
                    return state_row, last_row
        return None

    def insert_live(self, req: Request, state, last, part: int,
                    stall: int = 0) -> bool:
        """Graft a migrated in-flight request onto part ``part``.

        The destination part's slots stall for ``stall`` ticks — the KV
        transfer cost — before decoding resumes.  Done-but-unretired
        rows are compacted out first so the part's decode batch never
        outgrows its slot budget.  Returns False (no state change) when
        the part has no free slot.
        """
        if not self.can_insert(part):
            return False
        req.part_affinity = None
        g = self._parts[part]
        if g is not None:
            live = [k for k, r in enumerate(g.requests) if not r.done]
            if len(live) < len(g.requests):
                for r in g.requests:
                    if r.done:
                        self._credit(r)
                g = _Group([g.requests[k] for k in live],
                           su.take(g.state, live),
                           su.rows(g.last, live)) \
                    if live else None
        if g is None:
            self._parts[part] = _Group([req], state, last)
        else:
            self._parts[part] = _Group(
                g.requests + [req], su.concat([g.state, state]),
                torch.cat([g.last, last], dim=0))
        self._stall[part] = max(self._stall[part], int(stall))
        self.stats.migrations_in += 1
        return True

    # -- one wall tick -----------------------------------------------------------

    def step(self, dynamic: bool = True, now: int = 0) -> str:
        """Advance the group: admit, maybe reconfigure, maybe decode.

        Returns ``TICKED`` after a decode step, ``RECONF`` after a
        topology change (reconfiguration consumes the call but no decode
        happens), ``IDLE`` when there is nothing to do.
        """
        if self.mode == "fused":
            dynamic = False
        self._now_tick = now
        # each partition admits new work independently the moment it
        # drains, up to its own slot budget; a stalled part's slots are
        # busy receiving migrated KV and admit nothing
        for i, p in enumerate(self._parts):
            if self._stall[i] > 0:
                continue
            if self._part_done(p):
                self._retire(p)
                with SPANS.span("group.admit", gid=self.gid, part=i) as sp:
                    wave = self._prefill_wave(self.effective_slots(i), now,
                                              part_idx=i)
                    if SPANS.on:
                        sp.set(n=0 if wave is None else len(wave.requests))
                self._parts[i] = wave
                if wave is not None and self.obs.enabled:
                    self.obs.emit("admission", gid=self.gid, part=i,
                                  tick=now, n=len(wave.requests),
                                  rids=[r.rid for r in wave.requests])
        live = [p for p in self._parts if p is not None]
        if not live:
            return IDLE
        if self.mode == "dynamic" and dynamic and self.acfg.enabled:
            with SPANS.span("group.control", gid=self.gid):
                rem = np.concatenate([p.remaining for p in live])
                fv = FeatureVector.from_group(rem, len(self.queue),
                                              self._arrivals.rate(now),
                                              self.capacity)
                # a group can only be partitioned as far as it has requests
                cap = min(self.space.max_ways, rem.size)
                self.controller.observe(fv, max_ways_now=cap)
            desired = self.controller.state.topology
            if desired != self.topology:
                prev = self.topology
                self._reconfigure(desired)
                if self.obs.enabled:
                    tr = self.controller.state.transitions
                    gain, reason = 0.0, ""
                    if tr and tuple(tr[-1][2]) == tuple(desired):
                        gain, reason = float(tr[-1][3]), tr[-1][4]
                    self.obs.emit("reconfig", gid=self.gid, tick=now,
                                  to=desired, gain=gain, reason=reason,
                                  **{"from": prev})
                return RECONF
        for i, p in enumerate(self._parts):
            if self._stall[i] > 0:
                # the transfer occupies the part's slots for this tick:
                # full slot-step cost, zero useful tokens.  A part left
                # empty by a mid-transfer reconfigure stays blocked but
                # charges nothing — it holds no work to stall
                self._stall[i] -= 1
                if p is not None:
                    self.stats.slot_steps += self._slot_charge(i)
                    self.stats.stall_ticks += 1
                    if self.obs.enabled:
                        self.obs.emit("stall", gid=self.gid, part=i,
                                      tick=now, remaining=self._stall[i])
                continue
            if p is not None:
                self._tick_group(p, self._slot_charge(i), now, part_idx=i)
        self.stats.ticks += 1
        return TICKED

    def finalize(self) -> None:
        """Drain accounting: credit completion for done-but-unretired work.

        Idempotent — groups persist on the engine, so a run may be
        resumed after a ``max_ticks`` cutoff and finalized again.
        """
        for g in self._parts:
            if g is None:
                continue
            for r in g.requests:
                if r.done:
                    self._credit(r)


class ServeEngine:
    """The N=1 fleet: one reconfigurable group behind the original API."""

    def __init__(self, model_cfg: ModelConfig, params,
                 rt: T.Runtime = T.Runtime(),
                 amoeba: AmoebaConfig = AmoebaConfig(),
                 capacity: int = 8, window: int = 256,
                 policy: Optional[ReconfigPolicy] = None,
                 model: Optional[LogisticModel] = None):
        self.group = ReconfigurableGroup(
            model_cfg, params, rt=rt, amoeba=amoeba,
            capacity=capacity, window=window, mode="dynamic",
            policy=policy, model=model)
        # aliases: the engine's queue/stats/controller ARE the group's
        self.queue = self.group.queue
        self.stats = self.group.stats
        self.controller = self.group.controller

    # the group owns all engine state; forward reads so there is one copy
    @property
    def cfg(self) -> ModelConfig:
        return self.group.cfg

    @property
    def params(self):
        return self.group.params

    @property
    def rt(self) -> T.Runtime:
        return self.group.rt

    @property
    def acfg(self) -> AmoebaConfig:
        return self.group.acfg

    @property
    def capacity(self) -> int:
        return self.group.capacity

    @property
    def window(self) -> int:
        return self.group.window

    # -- admission -------------------------------------------------------------

    def submit(self, requests: Sequence[Request]) -> None:
        self.group.submit(requests, now=self.stats.ticks)

    # -- main loop ----------------------------------------------------------------

    def run(self, dynamic: bool = True, max_ticks: int = 100_000) -> ServeStats:
        """Drain the queue.  ``dynamic=False`` = fused-only baseline."""
        while self.stats.ticks < max_ticks:
            if self.group.step(dynamic=dynamic, now=self.stats.ticks) == IDLE:
                break
        self.group.finalize()
        return self.stats
