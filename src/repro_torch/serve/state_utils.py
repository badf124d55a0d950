"""Batch-dimension surgery on DecodeState trees.

Counterpart of ``repro/serve/state_utils.py``.  DecodeState has three
differently-shaped regions:
  * ``pos`` / ``rope_offset``: (B, ...)
  * ``reps``: leaves stacked (R, B, ...) — the per-layer states
  * ``rest``: leaves (B, ...)
so one function cannot slice the batch axis uniformly; these helpers apply
a function to the correct axis per region.  Every result is a copy, never
a view, so the parts of a re-cut group own their rows (decode writes the
KV cache in place).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from repro_torch import pytree
from repro_torch.models.transformer import DecodeState


def rows(x: torch.Tensor, idx: Sequence[int], axis: int = 0) -> torch.Tensor:
    """Copy of ``x`` restricted to batch rows ``idx`` along ``axis``."""
    return torch.index_select(
        x, axis, torch.as_tensor(list(idx), dtype=torch.long,
                                 device=x.device))


def _map_batch(state: DecodeState, f0: Callable, f1: Callable) -> DecodeState:
    """f0 applied to batch-leading leaves, f1 to layer-stacked (R, B, ...)"""
    return DecodeState(
        pos=f0(state.pos),
        rope_offset=f0(state.rope_offset),
        reps=pytree.map_(f1, state.reps),
        rest=pytree.map_(f0, state.rest),
    )


def take(state: DecodeState, idx: Sequence[int]) -> DecodeState:
    return _map_batch(state, lambda x: rows(x, idx, 0),
                      lambda x: rows(x, idx, 1))


def concat(states: List[DecodeState]) -> DecodeState:
    if len(states) == 1:
        return states[0]
    return DecodeState(
        pos=torch.cat([s.pos for s in states], dim=0),
        rope_offset=torch.cat([s.rope_offset for s in states], dim=0),
        reps=pytree.map_(lambda *xs: torch.cat(xs, dim=1),
                       *[s.reps for s in states]),
        rest=pytree.map_(lambda *xs: torch.cat(xs, dim=0),
                       *[s.rest for s in states]),
    )


def split(state: DecodeState, take_ids: Sequence[int],
          keep_ids: Sequence[int]):
    """Partition the batch axis into (taken, kept) states.

    The extraction primitive of live migration: the migrating rows
    travel as ``taken`` while ``kept`` stays on the source part.
    """
    return take(state, take_ids), take(state, keep_ids)


def nbytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (a decode state, or several)."""
    return sum(x.nbytes for x in pytree.leaves(tree)
               if isinstance(x, torch.Tensor))


def batch_size(state: DecodeState) -> int:
    return int(state.pos.shape[0])
