"""Decision audit: join predictions to realized outcomes.

Each ``policy_decision`` event carries what the controller saw (the
feature vector), what the predictor believed (``proba``: P(more-split
wins), ``gain``), what move it chose, and — when a
:class:`~repro_torch.control.ReplayBuffer` is wired — the realized label the
controller logged for that same tick (``label``: 1.0 when regrouping the
live batch would actually have beaten the margin) plus the absolute
replay index (``replay_idx``) of the stored sample.

That makes mispredictions queryable: a decision is *mispredicted* when
the predictor leaned one way (``proba`` vs 0.5) and the realized label
landed on the other.  ``confidence`` is how far the predictor leaned, so
``top_mispredictions`` surfaces the confidently-wrong decisions first —
the ones worth staring at when tuning ``refit_every`` or the drift
threshold.

Rows are built from event dicts (live :class:`~repro_torch.obs.events.Event`
objects or JSONL re-reads both work), so the audit runs offline from a
trace file alone.  When the live buffer is still around,
:func:`verify_replay` cross-checks each row's label against the stored
sample via the buffer's ``total_added`` high-water mark.

Counterpart of ``repro/obs/audit.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


def _as_dict(e: Any) -> Dict[str, Any]:
    return e if isinstance(e, dict) else e.as_dict()


def decision_rows(events: Sequence[Any]) -> List[Dict[str, Any]]:
    """Flatten ``policy_decision`` events into audit rows.

    Rows with a realized label gain ``mispredicted`` / ``confidence``
    columns; rows without (replay not wired, or too few live requests to
    label) keep them ``None`` so callers can filter.
    """
    rows: List[Dict[str, Any]] = []
    for raw in events:
        e = _as_dict(raw)
        if e["kind"] != "policy_decision":
            continue
        p = e["payload"]
        row: Dict[str, Any] = {
            "tick": e["tick"], "gid": e["gid"],
            "from": p.get("from"), "target": p.get("target"),
            "applied": p.get("applied"),
            "proba": p.get("proba"), "gain": p.get("gain"),
            "reason": p.get("reason"), "features": p.get("features"),
            "replay_idx": p.get("replay_idx"),
            "label": p.get("label"), "label_gain": p.get("label_gain"),
            "mispredicted": None, "confidence": None,
        }
        if row["label"] is not None and row["proba"] is not None:
            pred_split = row["proba"] > 0.5
            real_split = row["label"] > 0.5
            row["mispredicted"] = pred_split != real_split
            row["confidence"] = round(abs(row["proba"] - 0.5), 4)
        rows.append(row)
    return rows


def top_mispredictions(rows: Sequence[Dict[str, Any]],
                       k: int = 10) -> List[Dict[str, Any]]:
    """The K most confidently wrong decisions, worst first."""
    wrong = [r for r in rows if r["mispredicted"]]
    wrong.sort(key=lambda r: (-r["confidence"], r["tick"], r["gid"]))
    return wrong[:k]


def misprediction_rate(rows: Sequence[Dict[str, Any]]) -> Optional[float]:
    labeled = [r for r in rows if r["mispredicted"] is not None]
    if not labeled:
        return None
    return sum(1 for r in labeled if r["mispredicted"]) / len(labeled)


def verify_replay(rows: Sequence[Dict[str, Any]], replay) -> int:
    """Cross-check audit rows against the live ReplayBuffer.

    ``replay_idx`` is the absolute add index; samples evicted from the
    bounded buffer are skipped.  Returns the number of rows verified;
    raises if a retained sample's label disagrees with the event.
    """
    base = replay.total_added - len(replay)
    checked = 0
    for r in rows:
        idx = r.get("replay_idx")
        if idx is None:
            continue
        pos = idx - base
        if pos < 0 or pos >= len(replay):
            continue  # evicted
        stored = float(replay._y[pos])
        if stored != float(r["label"]):
            raise AssertionError(
                f"audit/replay mismatch at replay_idx={idx}: "
                f"event label {r['label']} vs stored {stored}")
        checked += 1
    return checked
