"""Batch regrouping policies — the warp-regrouping analogue (paper §4.3).

A decode batch is the TPU's warp: every sequence in it pays one forward
step per token of the *longest* member, exactly the "entire warp waits for
the last thread" pathology.  When the spread of remaining lengths crosses
the controller's threshold, the batch splits across the two halves of a
fused group:

* ``direct_split``  — cut the batch in the middle (paper: cheap, but slow
  and fast sequences stay mixed in both halves).
* ``warp_regroup``  — sort by remaining length; the slow half gets the
  long tail, the fast half drains early and (backfill) picks up queued
  requests — the paper's "periodically move some fast warps".

The same machinery scores MoE expert imbalance for training-side divergence
(a capacity-overflowing expert stalls its whole group the way a divergent
warp stalls a wide pipe).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


def divergence_score(remaining: Sequence[float]) -> float:
    """Normalized length spread in [0, 1): 0 = lockstep batch.

    mean waste fraction = 1 - mean(remaining) / max(remaining): the fraction
    of decode slots that will run for already-finished sequences.
    """
    r = np.asarray(remaining, dtype=np.float64)
    if r.size == 0 or r.max() <= 0:
        return 0.0
    return float(1.0 - r.mean() / r.max())


def moe_divergence(expert_load: Sequence[float]) -> float:
    """Imbalance of expert load fractions in [0, 1): 0 = perfectly even."""
    p = np.asarray(expert_load, dtype=np.float64)
    if p.size == 0 or p.sum() <= 0:
        return 0.0
    p = p / p.sum()
    return float(1.0 - 1.0 / (p.size * (p ** 2).sum()))


def direct_split(indices: Sequence[int],
                 remaining: Sequence[float]) -> Tuple[List[int], List[int]]:
    """Cut the batch in the middle (arrival order) — paper's cheap policy."""
    idx = list(indices)
    mid = len(idx) // 2
    return idx[:mid], idx[mid:]


def warp_regroup(indices: Sequence[int],
                 remaining: Sequence[float]) -> Tuple[List[int], List[int]]:
    """Sort by remaining work: fast half (short) / slow half (long)."""
    order = np.argsort(np.asarray(remaining, dtype=np.float64), kind="stable")
    idx = [indices[i] for i in order]
    mid = len(idx) // 2
    return idx[:mid], idx[mid:]            # (fast, slow)


POLICIES = {"direct_split": direct_split, "warp_regroup": warp_regroup}


def regroup_gain(remaining: Sequence[float], policy: str) -> float:
    """Predicted slot-waste saving of splitting vs staying fused, in [0, 1).

    A batch of B sequences costs ``B x max(remaining)`` decode slot-steps
    (every slot runs until the longest member finishes — the warp-waits-
    for-the-last-thread pathology).  Splitting runs each half for its own
    maximum, so a drained fast half frees its slots for queued work
    (the paper's backfill of fast warps).  Gain = relative waste reduction;
    ``direct_split`` only wins if arrival order happens to correlate with
    length, which is exactly the paper's critique of it.
    """
    r = np.asarray(remaining, dtype=np.float64)
    if r.size < 2 or r.max() <= 0:
        return 0.0
    fused_cost = float(r.size * r.max())
    halves = POLICIES[policy](list(range(r.size)), r)
    split_cost = float(sum(len(h) * r[h].max() for h in halves if len(h)))
    return (fused_cost - split_cost) / fused_cost
