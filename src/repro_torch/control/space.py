"""Configuration space: integer-composition topologies of one group.

The paper's pair has two hardware states (one wide SM or two narrow
halves).  A capacity-``C`` serving group generalizes this to the full
*composition lattice*: a topology is an integer composition of ``C`` —
``(8,)`` fully fused, ``(4, 4)`` the equal pair, ``(5, 3)`` a skewed cut
that quarantines a long tail on 3 slots while 5 slots drain the short
head, down to ``(1,) * C`` fully split.  This is the paper's "dynamic
creation of heterogeneous SMs through independent fusing or splitting"
(§5, Fig 12): parts move independently — one part may split into two
children, or two *neighboring* parts may fuse — and every move is
amortization-checked on its own predicted saving.

The legacy equal-ways ladder (``1x8 -> 2x4 -> 4x2``) falls out as the
special case ``topology == (C // k,) * k``: integer ``ways`` arguments
are accepted everywhere and coerced to the balanced composition, and the
2-way pair reduces bit-for-bit to :mod:`repro.core.regroup`'s
(fast, slow) semantics.  ``hetero=False`` pins the space to exactly that
ladder (the pre-composition behavior, kept for A/B benchmarking).

``min_gain`` is the amortization floor: a split transition is only legal
when its predicted relative slot-waste saving exceeds it (the serving
translation of ``fusion.amortized_switch_ok`` — a reconfiguration
consumes one wall tick of the group's decode budget, so a move that
saves less than ``min_gain`` of the fused cost never repays itself).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.regroup import POLICIES

# a topology: one slot count per independent part, summing to capacity
Topology = Tuple[int, ...]
TopologyLike = Union[int, Topology]

# compositions() refuses to materialize lattices beyond this; callers
# (best_topology) fall back to greedy neighbor search instead
MAX_ENUMERATION = 100_000


def n_parts(t: TopologyLike) -> int:
    """Part count of an int-or-tuple topology spec."""
    return t if isinstance(t, int) else len(t)


def balanced(capacity: int, ways: int) -> Topology:
    """The most even ``ways``-part composition of ``capacity``.

    Larger parts lead (the fast head keeps the wider slice so a drained
    part frees the most backfill slots).  ``balanced(8, 2) == (4, 4)``;
    ``balanced(6, 4) == (2, 2, 1, 1)`` — note the parts always sum to
    ``capacity``, unlike the old ``capacity // ways`` pricing that
    silently dropped the remainder slots.
    """
    ways = max(min(ways, capacity), 1)
    base, extra = divmod(capacity, ways)
    return tuple([base + 1] * extra + [base] * (ways - extra))


def topology_name(t: TopologyLike, capacity: Optional[int] = None) -> str:
    """Human name: ``2x4`` for equal parts, ``5+3`` for a skewed cut.

    The legacy ``topology_name(ways, capacity)`` call shape still works
    and now names the *balanced* composition — ``topology_name(4, 6)``
    is ``2+2+1+1``, not the lossy ``4x1`` that priced only 4 of 6 slots.
    """
    if isinstance(t, int):
        if capacity is None:
            raise ValueError("int topology needs a capacity")
        t = balanced(capacity, t)
    if len(set(t)) == 1:
        return f"{len(t)}x{t[0]}"
    return "+".join(str(p) for p in t)


def _count_compositions(capacity: int, max_parts: int) -> int:
    return sum(math.comb(capacity - 1, k - 1)
               for k in range(1, min(max_parts, capacity) + 1))


@functools.lru_cache(maxsize=128)
def _enumerate_compositions(capacity: int, max_parts: int
                            ) -> Tuple[Topology, ...]:
    """All compositions of ``capacity`` into at most ``max_parts`` parts,
    ordered by part count then lexicographically (fused first)."""
    out: List[Topology] = []

    def rec(rest: int, parts: List[int], budget: int) -> None:
        if rest == 0:
            out.append(tuple(parts))
            return
        if budget == 0:
            return
        for p in range(rest, 0, -1):
            parts.append(p)
            rec(rest - p, parts, budget - 1)
            parts.pop()

    rec(capacity, [], min(max_parts, capacity))
    out.sort(key=lambda t: (len(t), tuple(-p for p in t)))
    return tuple(out)


@functools.lru_cache(maxsize=65536)
def _partition_counts(B: int, topo: Topology) -> Tuple[int, ...]:
    """Requests-per-part for ``B`` requests on ``topo``.

    Pure function of the batch size and the topology — the slice sizes
    :meth:`ConfigSpace.partition` cuts its policy ordering into
    (largest-remainder quotas plus the overshoot / min-one repairs),
    factored out and cached so candidate scoring never recomputes them.
    Mirrors ``partition()`` exactly, including its degenerate path
    (one part or fewer than two requests: everything in part 0).
    """
    k = len(topo)
    if k <= 1 or B < 2:
        return (B,) + (0,) * max(k - 1, 0)
    C = sum(topo)
    quota = [B * s / C for s in topo]
    counts = [int(q) for q in quota]
    extras = B - sum(counts)
    by_frac = sorted(range(k), key=lambda i: (quota[i] - counts[i], i),
                     reverse=True)
    for i in by_frac[:extras]:
        counts[i] += 1
    if B <= C:                          # repair any budget overshoot
        for i in range(k):
            while counts[i] > topo[i]:
                j = min((m for m in range(k) if counts[m] < topo[m]),
                        key=lambda m: (abs(m - i), m))
                counts[j] += 1
                counts[i] -= 1
    if B >= k:
        # every part hosts at least one request: an empty part would
        # price its slots at zero and fake a gain by stranding them
        for i in range(k):
            while counts[i] == 0:
                j = max(range(k), key=lambda m: (counts[m], -m))
                counts[j] -= 1
                counts[i] += 1
    return tuple(counts)


@dataclass(frozen=True)
class ConfigSpace:
    """Legal topologies for one capacity-``C`` group and their transitions.

    ``hetero=True`` (the default) admits every integer composition up to
    ``max_ways`` parts with per-part moves; ``hetero=False`` restricts
    the space to the balanced power-of-two ladder with whole-group
    split/fuse moves — exactly the pre-composition behavior.
    """
    capacity: int
    max_ways: int = 2
    min_gain: float = 0.0
    hetero: bool = True

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if self.max_ways < 1:
            raise ValueError("max_ways must be >= 1")

    # -- topology coercion / enumeration --------------------------------------

    def as_topology(self, t: TopologyLike) -> Topology:
        """Coerce an integer ``ways`` to its balanced composition."""
        if isinstance(t, int):
            return balanced(self.capacity, t)
        return tuple(t)

    def topologies(self) -> Tuple[int, ...]:
        """Legacy view: power-of-two ways with at least one slot each."""
        out: List[int] = []
        w = 1
        while w <= self.max_ways and self.capacity // w >= 1:
            out.append(w)
            w *= 2
        return tuple(out)

    def compositions(self) -> Tuple[Topology, ...]:
        """Every legal topology, fused first.

        Exhaustive over the composition lattice when ``hetero``;
        the balanced ladder otherwise.  Raises for lattices past
        ``MAX_ENUMERATION`` — use :meth:`best_topology`, which falls
        back to greedy neighbor search, instead of materializing those.
        """
        if not self.hetero:
            return tuple(balanced(self.capacity, w)
                         for w in self.topologies())
        if _count_compositions(self.capacity, self.max_ways) \
                > MAX_ENUMERATION:
            raise ValueError(
                f"composition lattice of capacity={self.capacity} "
                f"max_ways={self.max_ways} is too large to enumerate; "
                f"use best_topology()'s neighbor search")
        return _enumerate_compositions(self.capacity, self.max_ways)

    def name(self, t: TopologyLike) -> str:
        return topology_name(t, self.capacity)

    def legal(self, t: TopologyLike) -> bool:
        if isinstance(t, int):
            if self.hetero:
                return 1 <= t <= min(self.max_ways, self.capacity)
            return t in self.topologies()
        if not t or len(t) > self.max_ways or any(p < 1 for p in t):
            return False
        if sum(t) != self.capacity:
            return False
        return self.hetero or (len(t) in self.topologies()
                               and t == balanced(self.capacity, len(t)))

    def clamp(self, ways: int) -> int:
        tops = self.topologies()
        return max(w for w in tops if w <= max(ways, 1))

    # -- moves -----------------------------------------------------------------

    def split_moves(self, t: TopologyLike) -> Tuple[Topology, ...]:
        """Topologies reachable by splitting: every single-part cut
        (part ``p`` -> children ``(a, p - a)``), plus the ladder move
        that halves every part at once (the legacy whole-group split)."""
        cur = self.as_topology(t)
        out: List[Topology] = []
        if self.hetero and len(cur) + 1 <= self.max_ways:
            for i, p in enumerate(cur):
                for a in range(p - 1, 0, -1):
                    out.append(cur[:i] + (a, p - a) + cur[i + 1:])
        # ladder: split every part >= 2 into near-halves simultaneously
        wide = sum(1 for p in cur if p >= 2)
        if wide and len(cur) + wide <= self.max_ways:
            lad: List[int] = []
            for p in cur:
                if p >= 2:
                    lad.extend(balanced(p, 2))
                else:
                    lad.append(p)
            out.append(tuple(lad))
        seen, uniq = set(), []
        for c in out:
            if c not in seen:
                seen.add(c)
                uniq.append(c)
        return tuple(uniq)

    def fuse_moves(self, t: TopologyLike) -> Tuple[Topology, ...]:
        """Topologies reachable by fusing: every neighboring-part merge
        (the paper fuses *neighboring* SMs only), plus the ladder move
        that merges every adjacent pair at once."""
        cur = self.as_topology(t)
        if len(cur) < 2:
            return ()
        out: List[Topology] = []
        if self.hetero:
            for i in range(len(cur) - 1):
                out.append(cur[:i] + (cur[i] + cur[i + 1],) + cur[i + 2:])
        lad = tuple(sum(cur[i:i + 2]) for i in range(0, len(cur), 2))
        out.append(lad)
        seen, uniq = set(), []
        for c in out:
            if c not in seen:
                seen.add(c)
                uniq.append(c)
        return tuple(uniq)

    def resize_moves(self, t: TopologyLike) -> Tuple[Topology, ...]:
        """Re-cut two neighboring parts without changing the part count.

        A resize is one fuse and one split of the same neighboring pair
        executed in a single reconfiguration — how a group already at
        its part budget adapts its cut as the live mix drifts (a
        ``(7, 1)`` quarantine widening to ``(5, 3)`` when more of the
        tail arrives).  Empty in ladder spaces: every unequal cut is
        off-ladder.
        """
        cur = self.as_topology(t)
        if not self.hetero or len(cur) < 2:
            return ()
        out: List[Topology] = []
        for i in range(len(cur) - 1):
            c = cur[i] + cur[i + 1]
            for a in range(c - 1, 0, -1):
                nt = cur[:i] + (a, c - a) + cur[i + 2:]
                if nt != cur and nt not in out:
                    out.append(nt)
        return tuple(out)

    def neighbors(self, t: TopologyLike) -> Tuple[Topology, ...]:
        """Single-move reachable topologies (splits, fuses, resizes)."""
        return self.split_moves(t) + self.fuse_moves(t) \
            + self.resize_moves(t)

    def touched_parts(self, cur: TopologyLike, new: TopologyLike
                      ) -> Tuple[int, ...]:
        """Indices of ``cur``'s parts a ``cur -> new`` move reconfigures.

        Untouched parts keep their dwell clocks; only the split/fused
        parts reset (per-part amortization, §5's independent moves).
        """
        c, n = self.as_topology(cur), self.as_topology(new)
        p = 0
        while p < min(len(c), len(n)) and c[p] == n[p]:
            p += 1
        q = 0
        while q < min(len(c), len(n)) - p and c[len(c) - 1 - q] == n[len(n) - 1 - q]:
            q += 1
        touched = tuple(range(p, len(c) - q))
        return touched if touched else tuple(range(len(c)))

    # -- cost model ----------------------------------------------------------

    def slot_cost(self, remaining: Sequence[float], t: TopologyLike,
                  policy: str = "warp_regroup") -> float:
        """Predicted slot-steps to drain ``remaining`` under topology ``t``.

        Each part runs its own slot count until its longest member
        finishes; fused ``(C,)`` cost is ``C x max(remaining)``.  Parts
        always price their full slot budget (the old equal-ways pricing
        charged ``C // ways`` per part, silently dropping the remainder
        slots of non-power-of-two capacities and inflating the gain).
        """
        r = np.asarray(remaining, np.float64)
        if r.size == 0 or r.max() <= 0:
            return 0.0
        topo = self.as_topology(t)
        parts = self.partition(list(range(r.size)), r, topo, policy)
        return float(sum(s * r[p].max()
                         for s, p in zip(topo, parts) if len(p)))

    def _policy_order(self, r: np.ndarray, policy: str) -> np.ndarray:
        """``r`` permuted into the policy's full (fast + slow) ordering.

        The key to fast candidate scoring: :meth:`partition`'s ordering
        is a pure function of ``remaining`` and the policy — it never
        depends on the candidate topology — so the sort happens *once*
        and every candidate is priced against the same ordered array.
        """
        fast, slow = POLICIES[policy](list(range(r.size)), r)
        return r[np.asarray(fast + slow, np.int64)]

    def _ordered_cost(self, r_ord: np.ndarray, t: TopologyLike) -> float:
        """:meth:`slot_cost` from a pre-ordered ``remaining`` array.

        Replaces the O(parts x capacity) per-candidate scan (re-sort,
        re-partition, fancy-index every part) with cached per-part
        counts (:func:`_partition_counts`) and one ``maximum.reduceat``
        over the contiguous chunks.  Bit-identical to ``slot_cost``:
        the chunks are the same members in the same order, ``max`` /
        ``reduceat`` pick an element (no arithmetic), and the ``sum``
        accumulates the same np.float64 terms in the same order.
        """
        if r_ord.size == 0 or r_ord.max() <= 0:
            return 0.0
        topo = self.as_topology(t)
        counts = _partition_counts(r_ord.size, topo)
        if 0 not in counts:                 # the common case: B >= parts
            starts, pos = [], 0
            for c in counts:
                starts.append(pos)
                pos += c
            maxes = np.maximum.reduceat(r_ord, starts)
            return float(sum(s * m for s, m in zip(topo, maxes)))
        chunks, pos = [], 0
        for s, c in zip(topo, counts):
            if c:
                chunks.append(s * r_ord[pos:pos + c].max())
            pos += c
        return float(sum(chunks))

    def gain(self, remaining: Sequence[float], t: TopologyLike,
             policy: str = "warp_regroup") -> float:
        """Relative slot-waste saving of ``t`` vs fully fused, in [0, 1).

        Topologies with more parts than live requests score zero: their
        inevitably empty parts would price their slots at nothing and
        report a phantom saving from stranding them.
        """
        r = np.asarray(remaining, np.float64)
        if r.size < 2 or r.max() <= 0 or n_parts(t) <= 1:
            return 0.0
        if len(self.as_topology(t)) > r.size:
            return 0.0
        fused = float(self.capacity * r.max())
        return (fused - self.slot_cost(r, t, policy)) / fused

    def move_gain(self, remaining: Sequence[float], cur: TopologyLike,
                  new: TopologyLike, policy: str = "warp_regroup") -> float:
        """Predicted saving of the single move ``cur -> new``, normalized
        by the fused cost so it shares the scale of :meth:`gain` (and of
        ``min_gain``) — the quantity each per-part move must amortize.

        A move into a topology with more parts than live requests never
        amortizes: its saving would come from empty parts pricing their
        slots at zero (the same stranding guard as :meth:`gain`).
        """
        r = np.asarray(remaining, np.float64)
        if r.size < 2 or r.max() <= 0:
            return 0.0
        if len(self.as_topology(new)) > r.size:
            return 0.0
        fused = float(self.capacity * r.max())
        return (self.slot_cost(r, cur, policy)
                - self.slot_cost(r, new, policy)) / fused

    def best_ways(self, remaining: Sequence[float],
                  policy: str = "warp_regroup") -> Tuple[int, float]:
        """(ways, gain) over the balanced ladder — the legacy oracle."""
        r = np.asarray(remaining, np.float64)
        best, best_gain = 1, 0.0
        for w in self.topologies():
            if w > r.size:                  # would strand empty parts
                continue
            g = self.gain(r, w, policy)
            if g > best_gain + 1e-12:
                best, best_gain = w, g
        return best, best_gain

    def best_topology(self, remaining: Sequence[float],
                      policy: str = "warp_regroup"
                      ) -> Tuple[Topology, float]:
        """(topology, gain) maximizing the predicted saving.

        Exhaustive over :meth:`compositions` when the lattice is small
        enough to enumerate; greedy best-neighbor ascent from fused
        otherwise (each step is a legal single move, so the returned
        topology is always reachable).  Ties prefer fewer parts.
        """
        fused = (self.capacity,)
        r = np.asarray(remaining, np.float64)
        if r.size < 2 or r.max() <= 0:
            return fused, 0.0
        if not self.hetero or _count_compositions(
                self.capacity, self.max_ways) <= MAX_ENUMERATION:
            best, best_gain = fused, 0.0
            for t in self.compositions():
                if len(t) > r.size:         # would strand empty parts
                    continue
                g = self.gain(r, t, policy)
                if g > best_gain + 1e-12:
                    best, best_gain = t, g
            return best, best_gain
        cur, cur_gain = fused, 0.0
        for _ in range(self.capacity):        # lattice depth bound
            step, step_gain = None, cur_gain
            for nb in self.neighbors(cur):
                g = self.gain(r, nb, policy)
                if g > step_gain + 1e-12:
                    step, step_gain = nb, g
            if step is None:
                break
            cur, cur_gain = step, step_gain
        return cur, cur_gain

    def suggest_split(self, cur: TopologyLike,
                      remaining: Optional[Sequence[float]] = None,
                      policy: str = "warp_regroup",
                      max_parts: Optional[int] = None
                      ) -> Optional[Topology]:
        """The best single split move from ``cur`` (skew-aware).

        With live ``remaining`` lengths the move minimizing predicted
        slot cost wins — on a skewed tail that is an unequal cut like
        ``(5, 3)``, not the balanced halving.  Without telemetry the
        ladder move (or the halving of the widest part) stands in.
        """
        cands = [t for t in self.split_moves(cur)
                 if max_parts is None or len(t) <= max_parts]
        if not cands:
            return None
        r = None if remaining is None \
            else np.asarray(remaining, np.float64)
        if r is None or r.size < 2 or r.max() <= 0:
            c = self.as_topology(cur)
            lad = [t for t in cands if len(t) > len(c) + 1]
            if lad:
                return lad[0]
            i = max(range(len(c)), key=lambda j: c[j])
            even = c[:i] + balanced(c[i], 2) + c[i + 1:]
            return even if even in cands else cands[0]
        cands = [t for t in cands if len(t) <= r.size] or None
        if cands is None:
            return None                     # every cut would strand a part
        r_ord = self._policy_order(r, policy)
        return min(cands, key=lambda t: (self._ordered_cost(r_ord, t),
                                         len(t), t))

    def suggest_improve(self, cur: TopologyLike,
                        remaining: Optional[Sequence[float]] = None,
                        policy: str = "warp_regroup",
                        max_parts: Optional[int] = None
                        ) -> Optional[Topology]:
        """The best cost-reducing split *or* resize move from ``cur``.

        From fused this is exactly :meth:`suggest_split`; from a split
        topology it also considers re-cutting neighboring parts, so a
        group whose quarantine slice went stale (new tail arrivals
        landed in the wide part) re-shapes instead of holding a wrong
        cut.  Returns None when no move strictly improves the predicted
        slot cost.
        """
        if remaining is None:
            return self.suggest_split(cur, None, policy, max_parts)
        r = np.asarray(remaining, np.float64)
        if r.size < 2 or r.max() <= 0:
            return self.suggest_split(cur, None, policy, max_parts)
        c = self.as_topology(cur)
        # candidates are capped at the live request count — a cut with
        # more parts than requests strands empty slots priced at zero
        # and its "gain" is phantom (see gain()/move_gain())
        cands = [t for t in self.split_moves(c) + self.resize_moves(c)
                 if (max_parts is None or len(t) <= max_parts)
                 and len(t) <= r.size]
        if not cands:
            return None
        r_ord = self._policy_order(r, policy)
        best = min(cands, key=lambda t: (self._ordered_cost(r_ord, t),
                                         len(t), t))
        if self._ordered_cost(r_ord, best) \
                < self._ordered_cost(r_ord, c) - 1e-12:
            return best
        return None

    def suggest_fuse(self, cur: TopologyLike,
                     remaining: Optional[Sequence[float]] = None,
                     policy: str = "warp_regroup") -> Optional[Topology]:
        """The least-costly single fuse move from ``cur``.

        Fusing usually *adds* predicted slot cost (it trades waste for
        the wide configuration's coalescing), so the argmin is the merge
        that gives up the least.  Without telemetry the ladder merge
        stands in.
        """
        c = self.as_topology(cur)
        cands = self.fuse_moves(c)
        if not cands:
            return None
        r = None if remaining is None \
            else np.asarray(remaining, np.float64)
        if r is None or r.size < 2 or r.max() <= 0:
            lad = tuple(sum(c[i:i + 2]) for i in range(0, len(c), 2))
            return lad if lad in cands else cands[0]
        r_ord = self._policy_order(r, policy)
        return min(cands, key=lambda t: (self._ordered_cost(r_ord, t),
                                         len(t), t))

    # -- transitions -----------------------------------------------------------

    def transition_ok(self, cur: TopologyLike, new: TopologyLike,
                      gain: float) -> bool:
        """Amortization-checked legality of a single ``cur -> new`` move.

        ``new`` must be one move away (a single part split, a single
        neighboring fuse or re-cut, or the whole-group ladder move).
        Splitting further or re-cutting must predict at least
        ``min_gain`` of saving; fusing back is always amortized — it
        frees no work but restores the wide configuration's coalescing,
        and the hysteresis band upstream already rate-limits it.
        """
        c, n = self.as_topology(cur), self.as_topology(new)
        if not (self.legal(c) and self.legal(n)) or n == c:
            return False
        if n in self.split_moves(c) or n in self.resize_moves(c):
            return gain > self.min_gain
        return n in self.fuse_moves(c)

    def partition(self, indices: Sequence[int], remaining: Sequence[float],
                  t: TopologyLike, policy: str = "warp_regroup"
                  ) -> List[List[int]]:
        """Assign ``indices`` to the parts of ``t``, sized to slot budgets.

        Requests are ordered by ``policy`` (``warp_regroup`` sorts by
        remaining work, ``direct_split`` keeps arrival order) and cut
        into contiguous chunks whose sizes follow each part's share of
        the slot budget (largest-remainder rounding, ties to the later
        part) — so part ``i`` never exceeds ``t[i]`` requests as long as
        the batch fits the group.  The equal pair ``(C/2, C/2)`` reduces
        bit-for-bit to the paper's (fast, slow) split from
        :mod:`repro.core.regroup`.
        """
        topo = self.as_topology(t)
        k = len(topo)
        idx = list(indices)
        if k <= 1 or len(idx) < 2:
            return [idx] + [[] for _ in range(max(k - 1, 0))]
        r = np.asarray(remaining, np.float64)
        fast, slow = POLICIES[policy](idx, r)
        order = fast + slow                 # full policy ordering
        out, pos = [], 0
        for c in _partition_counts(len(idx), topo):
            out.append(order[pos:pos + c])
            pos += c
        return out
