"""Struct-of-arrays fleet core: the vectorized tick engine.

``FleetEngine`` with ``FleetConfig.engine = "object"`` advances one wall
tick via nested Python loops over groups, parts, and requests, paying a
``decode_step`` call per part per tick.  That is the right
fidelity for token-level work but the wrong cost model for *scheduling*
studies: every quantity the benchmarks compare — completions, latency
percentiles, slot-steps, steal counters — depends only on request
*lengths* and the control plane's decisions, never on which token ids
the model sampled (each live request yields exactly one token per tick
until ``remaining`` hits zero).  This module exploits that: it keeps the
whole fleet's per-request state in flat numpy arrays and advances every
decode of a wall tick with one masked decrement + completion scatter,
with no model, no tensors, and no per-token Python.

The split of responsibilities:

* **data plane (vectorized here)** — per-request ``remaining`` /
  ``arrival`` / ``group`` / ``part`` / ``state`` / ``enqueue_tick``
  live in :class:`VecState`; the per-tick decode is a masked
  ``remaining[idx] -= 1`` over the fleet-wide live set, completions
  scatter finish ticks and per-group token counts (``np.bincount``
  segment sums), and ``load()`` becomes an O(1) read of incrementally
  maintained per-group totals.

* **control plane (delegated, bit-identical)** — :class:`VecGroup`
  subclasses :class:`~repro_torch.serve.engine.ReconfigurableGroup` and keeps
  its ``step()`` control flow, admission scan, controller/policy calls,
  and ``_reconfigure`` bookkeeping verbatim; only the data-plane hooks
  (``_prefill_wave``, ``_tick_group``, ``_merge_parts``,
  ``_make_part``, migration splices) are overridden to rewrite array
  indices instead of slicing KV tensors.  Routers, the
  ``FleetController``/``MigrationPlanner``/cluster stack, and telemetry
  therefore run the *same code* against the same views, which is what
  makes the object/vec equivalence suite assert bit-identical summary
  stats rather than merely similar ones.

The one lazily materialized quantity is ``Request.generated``: the
object engine appends one token per tick, the vec engine stores only
``remaining`` and synthesizes a placeholder list (zeros) whenever
shared consumers need ``len(generated)`` — on rebalance ticks (the
planner prices KV transfers by sequence length) and at completion.
Token *values* are the only thing the vec engine does not reproduce.

Counterpart of ``repro/fleet/vec.py``; its summaries and event streams
are bit-identical to the reference's.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.engine import ReconfigurableGroup, Request

# Request lifecycle codes (VecState.state)
PENDING = 0      # registered, not yet delivered to any group queue
QUEUED = 1       # sitting in a group's admission queue
LIVE = 2         # admitted: decoding (or stalled) on a part
DONE = 3         # finished; finish tick stamped


def _no_decode(*_a, **_k):  # pragma: no cover - guard, never called
    raise RuntimeError("vec engine has no model decode path")


class TrackedQueue(collections.deque):
    """A deque of Requests that tracks its summed ``max_new_tokens``.

    The migration planner mutates group queues directly (``del
    src.queue[idx]``), so an O(1) ``load()`` needs the queue itself to
    keep its budget total; every mutator the codebase uses is hooked.
    """

    def __init__(self, it=()):
        super().__init__()
        self.budget = 0
        self.extend(it)

    def append(self, r: Request) -> None:
        super().append(r)
        self.budget += r.max_new_tokens

    def appendleft(self, r: Request) -> None:
        super().appendleft(r)
        self.budget += r.max_new_tokens

    def popleft(self) -> Request:
        r = super().popleft()
        self.budget -= r.max_new_tokens
        return r

    def pop(self) -> Request:
        r = super().pop()
        self.budget -= r.max_new_tokens
        return r

    def extend(self, it) -> None:
        for r in it:
            self.append(r)

    def extendleft(self, it) -> None:
        for r in it:
            self.appendleft(r)

    def remove(self, r: Request) -> None:
        super().remove(r)
        self.budget -= r.max_new_tokens

    def insert(self, i: int, r: Request) -> None:
        super().insert(i, r)
        self.budget += r.max_new_tokens

    def __delitem__(self, i) -> None:
        r = self[i]
        super().__delitem__(i)
        self.budget -= r.max_new_tokens

    def clear(self) -> None:
        super().clear()
        self.budget = 0


class _VecPart:
    """One part's members: aligned Request objects and VecState rows.

    Order matters and is preserved exactly — ``warp_regroup``'s stable
    sort tie-breaks on member order, so any reordering here would
    diverge from the object engine's partitions.
    """

    __slots__ = ("requests", "idx", "vs", "pid")

    def __init__(self, requests: List[Request], idx: List[int],
                 vs: "VecState", pid: int = -1):
        self.requests = requests
        self.idx = idx
        self.vs = vs
        self.pid = pid                 # flat part id: gid * capacity + part

    @property
    def remaining(self) -> np.ndarray:
        return self.vs.remaining[
            np.asarray(self.idx, np.int64)].astype(np.float64)


class VecState:
    """The fleet's struct-of-arrays request store.

    One row per registered request; rows never move.  Per-part occupancy
    lives in flat ``(num_groups * capacity,)`` arrays indexed by
    ``gid * capacity + part`` so a topology change only rewrites the
    group's own slice.
    """

    def __init__(self, num_groups: int, capacity: int):
        self.G = num_groups
        self.C = capacity
        n = 1024
        self.remaining = np.zeros(n, np.int64)
        self.max_new = np.zeros(n, np.int64)
        self.arrival = np.zeros(n, np.int64)
        self.enqueue_tick = np.full(n, -1, np.int64)
        self.group_of = np.full(n, -1, np.int64)
        self.part_flat = np.full(n, -1, np.int64)
        self.state = np.full(n, PENDING, np.int8)
        self.n = 0
        self.reqs: List[Request] = []
        self._rows: Dict[int, int] = {}        # id(request) -> row
        # fleet-wide live set (rows with remaining > 0 on some part)
        self.live_idx = np.empty(0, np.int64)
        self._admitted: List[int] = []         # rows admitted this tick
        # per-part live-member counts and per-group live remaining totals
        self.part_live_n = np.zeros(num_groups * capacity, np.int64)
        self.live_load = np.zeros(num_groups, np.int64)
        # parts marked for decode this tick (cleared by decode_tick)
        self._marked = np.zeros(num_groups * capacity, bool)
        self._any_marked = False

    # -- registration ----------------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = len(self.remaining)
        if need <= cap:
            return
        new = max(cap * 2, need)
        for name in ("remaining", "max_new", "arrival", "enqueue_tick",
                     "group_of", "part_flat", "state"):
            old = getattr(self, name)
            arr = np.full(new, -1, old.dtype) if name in (
                "enqueue_tick", "group_of", "part_flat") \
                else np.zeros(new, old.dtype)
            if name == "state":
                arr[:] = PENDING
            arr[:cap] = old
            setattr(self, name, arr)

    def register(self, r: Request) -> int:
        """Row of ``r``, allocating one on first sight."""
        row = self._rows.get(id(r))
        if row is not None:
            return row
        row = self.n
        self._grow(row + 1)
        self.n += 1
        self.reqs.append(r)
        self._rows[id(r)] = row
        self.remaining[row] = r.remaining
        self.max_new[row] = r.max_new_tokens
        self.arrival[row] = r.arrival
        self.state[row] = PENDING
        return row

    def row(self, r: Request) -> Optional[int]:
        return self._rows.get(id(r))

    # -- the vectorized decode tick --------------------------------------------

    def mark_decode(self, pid: int) -> None:
        self._marked[pid] = True
        self._any_marked = True

    def decode_tick(self, now: int, groups: Sequence) -> None:
        """Apply every part's deferred decode for this wall tick.

        Equivalent to the object engine's per-part ``_tick_group`` calls:
        deferring them all behind the per-group ``step()`` control flow
        is safe because decode only touches the group's own rows and no
        same-tick consumer reads another group's post-decode state.
        """
        if self._admitted:
            self.live_idx = np.concatenate(
                [self.live_idx, np.asarray(self._admitted, np.int64)])
            self._admitted.clear()
        if not self._any_marked:
            return
        li = self.live_idx
        if li.size:
            mask = self._marked[self.part_flat[li]]
            dec = li[mask]
            if dec.size:
                self.remaining[dec] -= 1
                rem = self.remaining[dec]
                per_g = np.bincount(self.group_of[dec], minlength=self.G)
                self.live_load -= per_g
                for g in np.nonzero(per_g)[0]:
                    groups[g].stats.useful_tokens += int(per_g[g])
                fin = dec[rem == 0]
                for row in fin.tolist():
                    r = self.reqs[row]
                    r.generated = [0] * int(self.max_new[row])
                    r.finish = now
                    self.state[row] = DONE
                    self.part_live_n[self.part_flat[row]] -= 1
                self.live_idx = np.concatenate([li[~mask], dec[rem > 0]])
        self._marked[:] = False
        self._any_marked = False

    # -- lazy materialization ---------------------------------------------------

    def sync_generated(self) -> None:
        """Make ``len(r.generated)`` truthful for every live request.

        Called before control-plane consumers that price by sequence
        length (the migration planner) or read ``Request.remaining``
        directly (the fleet controller); queued requests have generated
        nothing and finished ones were materialized at completion.
        """
        for row in self.live_idx.tolist():
            r = self.reqs[row]
            tokens = int(self.max_new[row] - self.remaining[row])
            if len(r.generated) != tokens:
                r.generated = [0] * tokens

    # -- debug invariants -------------------------------------------------------

    def check(self, groups: Sequence) -> None:
        """Recompute every incremental total from scratch (tests only)."""
        for g in groups:
            assert g.queue.budget == sum(
                r.max_new_tokens for r in g.queue), g.gid
            live = 0
            for i, p in enumerate(g._parts):
                pid = g.gid * self.C + i
                n_live = 0 if p is None else int(
                    (self.remaining[np.asarray(p.idx, np.int64)] > 0).sum())
                assert self.part_live_n[pid] == n_live, (g.gid, i)
                if p is not None:
                    assert p.pid == pid, (g.gid, i, p.pid)
                    live += int(self.remaining[
                        np.asarray(p.idx, np.int64)].clip(min=0).sum())
            assert self.live_load[g.gid] == live, g.gid
            assert g.load() == live + g.queue.budget


class VecGroup(ReconfigurableGroup):
    """Array-backed group view: object control flow, vectorized data.

    Inherits ``step()``, the admission scan, submit/arrival tracking,
    controller wiring, and ``_reconfigure``'s partition bookkeeping from
    :class:`ReconfigurableGroup`; every hook that would touch model state
    instead rewrites rows in the shared :class:`VecState`.
    """

    def __init__(self, model_cfg, params=None, *, vec_state: VecState,
                 **kw):
        kw.setdefault("decode_fn", _no_decode)
        super().__init__(model_cfg, params, **kw)
        self.vs = vec_state
        self.queue: TrackedQueue = TrackedQueue()

    # -- admission -------------------------------------------------------------

    def submit(self, requests: Sequence[Request], now: int = 0,
               part: Optional[int] = None) -> None:
        vs = self.vs
        for r in requests:
            row = vs.register(r)
            vs.state[row] = QUEUED
            vs.enqueue_tick[row] = now
            vs.group_of[row] = self.gid
            vs.part_flat[row] = -1
        super().submit(requests, now=now, part=part)

    def _prefill_wave(self, n_slots: int, now: int,
                      part_idx: Optional[int] = None) -> Optional[_VecPart]:
        wave = self._admission_scan(n_slots, part_idx)
        if not wave:
            return None
        by_len: Dict[int, List[Request]] = collections.defaultdict(list)
        for r in wave:
            by_len[len(r.prompt)].append(r)
        vs = self.vs
        pid = self.gid * vs.C + (part_idx or 0)
        ordered: List[Request] = []
        rows: List[int] = []
        n_live = 0
        for plen, reqs in sorted(by_len.items()):
            self.stats.prefill_tokens += plen * len(reqs)
            self.stats.useful_tokens += len(reqs)   # the prefill token each
            for r in reqs:
                row = vs.row(r)
                ordered.append(r)
                rows.append(row)
                vs.group_of[row] = self.gid
                vs.part_flat[row] = pid
                vs.remaining[row] = r.max_new_tokens - 1
                if vs.remaining[row] <= 0:          # done at prefill
                    r.generated = [0] * r.max_new_tokens
                    r.finish = now
                    vs.state[row] = DONE
                else:
                    vs.state[row] = LIVE
                    vs._admitted.append(row)
                    vs.live_load[self.gid] += vs.remaining[row]
                    n_live += 1
        vs.part_live_n[pid] += n_live
        return _VecPart(ordered, rows, vs, pid=pid)

    # -- decode (deferred to VecState.decode_tick) -----------------------------

    def _tick_group(self, g: _VecPart, slots: int, now: int,
                    part_idx: int = 0) -> None:
        pid = self.gid * self.vs.C + part_idx
        if self.vs.part_live_n[pid] <= 0:
            return                      # all-done part: no decode, no charge
        self.vs.mark_decode(pid)
        self.stats.slot_steps += slots

    def _part_done(self, g: Optional[_VecPart]) -> bool:
        return g is None or self.vs.part_live_n[g.pid] == 0

    # -- topology --------------------------------------------------------------

    def _merge_parts(self, live: List[_VecPart]) -> _VecPart:
        if len(live) == 1:
            return live[0]
        reqs: List[Request] = []
        rows: List[int] = []
        for p in live:
            reqs += p.requests
            rows += p.idx
        return _VecPart(reqs, rows, self.vs)

    def _make_part(self, merged: _VecPart,
                   ids: List[int]) -> Optional[_VecPart]:
        if not ids:
            return None
        return _VecPart([merged.requests[i] for i in ids],
                        [merged.idx[i] for i in ids], self.vs)

    def _reconfigure(self, target) -> None:
        super()._reconfigure(target)
        self._refresh_parts()

    def _refresh_parts(self) -> None:
        """Re-stamp flat part ids and live counts after a re-partition."""
        vs = self.vs
        base = self.gid * vs.C
        vs.part_live_n[base:base + vs.C] = 0
        for i, p in enumerate(self._parts):
            if p is None:
                continue
            pid = base + i
            p.pid = pid
            rows = np.asarray(p.idx, np.int64)
            vs.part_flat[rows] = pid
            vs.part_live_n[pid] = int((vs.remaining[rows] > 0).sum())

    # -- introspection ---------------------------------------------------------

    def live_requests(self) -> List[Request]:
        rem = self.vs.remaining
        out: List[Request] = []
        for g in self._parts:
            if g is not None:
                out.extend(r for r, row in zip(g.requests, g.idx)
                           if rem[row] > 0)
        return out

    def part_live(self, i: int) -> List[Request]:
        g = self._parts[i]
        if g is None:
            return []
        rem = self.vs.remaining
        return [r for r, row in zip(g.requests, g.idx) if rem[row] > 0]

    def _part_live_n(self, i: int) -> int:
        # O(1) from the per-part live counter — identical to the object
        # engine's len(part_live(i)), so lease slot charges stay bit-equal
        return int(self.vs.part_live_n[self.gid * self.vs.C + i])

    def live_count(self) -> int:
        # O(capacity) from the per-part live counters — identical to the
        # object engine's len(live_requests()), so per-tick metric
        # samples (repro_torch.obs.metrics) match across engines
        base = self.gid * self.vs.C
        return int(self.vs.part_live_n[base:base + self.vs.C].sum())

    def load(self) -> int:
        return int(self.vs.live_load[self.gid]) + self.queue.budget

    # -- migration splices -----------------------------------------------------

    def extract_live(self, req: Request):
        vs = self.vs
        row = vs.row(req)
        if row is None:
            return None
        for i, g in enumerate(self._parts):
            if g is None:
                continue
            for j, r in enumerate(g.requests):
                if r is req and vs.remaining[row] > 0:
                    del g.requests[j]
                    del g.idx[j]
                    if not g.requests:
                        self._parts[i] = None
                    vs.part_live_n[self.gid * vs.C + i] -= 1
                    vs.live_load[self.gid] -= vs.remaining[row]
                    self.stats.migrations_out += 1
                    # opaque (state, last) handle — rows never move, so
                    # the row id is the whole decode state
                    return ("vecrow", row), ("vecrow", row)
        return None

    def insert_live(self, req: Request, state, last, part: int,
                    stall: int = 0) -> bool:
        if not self.can_insert(part):
            return False
        req.part_affinity = None
        vs = self.vs
        pid = self.gid * vs.C + part
        g = self._parts[part]
        if g is not None:
            # compact done-but-unretired members out (credit them), same
            # as the object engine's insert path
            keep_r, keep_i = [], []
            for r, row_ in zip(g.requests, g.idx):
                if vs.remaining[row_] > 0:
                    keep_r.append(r)
                    keep_i.append(row_)
                else:
                    self._credit(r)
            if keep_r:
                g.requests, g.idx = keep_r, keep_i
            else:
                g = None
                self._parts[part] = None
        row = vs.row(req)
        if g is None:
            self._parts[part] = _VecPart([req], [row], vs, pid=pid)
        else:
            g.requests.append(req)
            g.idx.append(row)
        vs.group_of[row] = self.gid
        vs.part_flat[row] = pid
        vs.state[row] = LIVE
        vs.part_live_n[pid] += 1
        vs.live_load[self.gid] += vs.remaining[row]
        self._stall[part] = max(self._stall[part], int(stall))
        self.stats.migrations_in += 1
        return True

    # -- drain -----------------------------------------------------------------

    def finalize(self) -> None:
        vs = self.vs
        for g in self._parts:
            if g is None:
                continue
            for r, row in zip(g.requests, g.idx):
                if vs.remaining[row] <= 0:
                    self._credit(r)
