"""Trace exporters: JSONL and Chrome trace-event JSON (Perfetto).

JSONL is the archival format: one ``{"kind": "_meta", ...}`` header line
(run context: mesh layout, wall ticks, obs mode) followed by one event
object per line, normalized to JSON's fixed point by
:func:`~repro_torch.obs.events.jsonable` when viewed — so
``read_jsonl(write_jsonl(...))`` is exact.

The Chrome trace maps the fleet onto Perfetto's process/thread model:

* process = chip (when a mesh layout is in ``meta``), thread = group;
* each group's **topology** is a span (``ph: "X"``) named after the
  composition (``"5+3"``), rebuilt by walking its ``reconfig`` events;
* **reconfigs** are instants (``ph: "i"``) at the moment of the cut;
* **steals/migrates** are flow events (``ph: "s"`` at the source group,
  ``ph: "f"`` at the destination) so Perfetto draws the arrow;
* everything else (spill, admission, stall, region_grab,
  policy_decision, refit) renders as thread-scoped instants.

Ticks map to microseconds at 1 tick = 1 ms so short runs stay readable.

Counterpart of ``repro/obs/export.py``; its JSONL files are the
reference's byte for byte.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.events import Event

US_PER_TICK = 1000  # 1 wall tick renders as 1 ms in Perfetto


def _as_dict(e: Any) -> Dict[str, Any]:
    return e if isinstance(e, dict) else e.as_dict()


def write_jsonl(path: str, events: Sequence[Any],
                meta: Optional[Dict[str, Any]] = None) -> int:
    """Write a meta header plus one event per line; returns event count."""
    evs = [_as_dict(e) for e in events]
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "_meta", **(meta or {})},
                           sort_keys=True) + "\n")
        for e in evs:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return len(evs)


def read_jsonl(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Read a trace back; returns (meta, events)."""
    meta: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if obj.get("kind") == "_meta":
                meta = {k: v for k, v in obj.items() if k != "kind"}
            else:
                events.append(obj)
    return meta, events


def _topo_name(topo) -> str:
    if not topo:
        return "?"
    return "+".join(str(int(w)) for w in topo)


def chrome_trace(events: Sequence[Any],
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build a Chrome trace-event dict from an event stream."""
    meta = meta or {}
    evs = sorted((_as_dict(e) for e in events), key=lambda e: e["seq"])
    mesh = meta.get("mesh") or {}
    chip_of = {int(g): int(c)
               for g, c in (mesh.get("chip_of") or {}).items()}

    def pid(gid: int) -> int:
        return chip_of.get(gid, 0)

    out: List[Dict[str, Any]] = []
    gids = sorted({e["gid"] for e in evs if e["gid"] >= 0})
    pids = sorted(set(chip_of.values())) if chip_of else [0]
    for p in pids:
        name = f"chip {p}" if chip_of else "fleet"
        out.append({"ph": "M", "pid": p, "tid": 0,
                    "name": "process_name", "args": {"name": name}})
    for g in gids:
        out.append({"ph": "M", "pid": pid(g), "tid": g,
                    "name": "thread_name", "args": {"name": f"group {g}"}})

    end_tick = meta.get("wall_ticks")
    if end_tick is None:
        end_tick = (max((e["tick"] for e in evs), default=0)) + 1

    # -- topology spans + reconfig instants, per group -------------------------
    span_start: Dict[int, int] = {}
    span_topo: Dict[int, Any] = {}
    for e in evs:
        if e["kind"] != "reconfig":
            continue
        g, t = e["gid"], e["tick"]
        frm, to = e["payload"].get("from"), e["payload"].get("to")
        if g not in span_start:
            span_start[g], span_topo[g] = 0, frm
        out.append({"ph": "X", "pid": pid(g), "tid": g, "cat": "topology",
                    "name": _topo_name(span_topo[g]),
                    "ts": span_start[g] * US_PER_TICK,
                    "dur": max(t - span_start[g], 0) * US_PER_TICK})
        out.append({"ph": "i", "s": "t", "pid": pid(g), "tid": g,
                    "cat": "reconfig", "ts": t * US_PER_TICK,
                    "name": f"reconfig {_topo_name(frm)}->{_topo_name(to)}",
                    "args": e["payload"]})
        span_start[g], span_topo[g] = t, to
    for g, t0 in span_start.items():
        out.append({"ph": "X", "pid": pid(g), "tid": g, "cat": "topology",
                    "name": _topo_name(span_topo[g]),
                    "ts": t0 * US_PER_TICK,
                    "dur": max(end_tick - t0, 1) * US_PER_TICK})

    # -- flows (steal/migrate) + instants for the rest -------------------------
    for e in evs:
        kind, t = e["kind"], e["tick"]
        if kind == "reconfig":
            continue
        p = e["payload"]
        if kind in ("steal", "migrate"):
            src = p.get("src", e["gid"])
            dst = p.get("dst", e["gid"])
            sg = src[0] if isinstance(src, list) else src
            dg = dst[0] if isinstance(dst, list) else dst
            flow = {"cat": kind, "id": e["seq"],
                    "name": f"{kind} r{p.get('rid', '?')}"}
            out.append({"ph": "s", "pid": pid(sg), "tid": sg,
                        "ts": t * US_PER_TICK, **flow})
            out.append({"ph": "f", "bp": "e", "pid": pid(dg), "tid": dg,
                        "ts": t * US_PER_TICK + 1, **flow})
            out.append({"ph": "i", "s": "t", "pid": pid(dg), "tid": dg,
                        "cat": kind, "ts": t * US_PER_TICK + 1,
                        "name": flow["name"], "args": p})
        else:
            g = e["gid"] if e["gid"] >= 0 else gids[0] if gids else 0
            out.append({"ph": "i", "s": "t", "pid": pid(g), "tid": g,
                        "cat": kind, "ts": t * US_PER_TICK,
                        "name": kind, "args": p})

    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events: Sequence[Any],
                       meta: Optional[Dict[str, Any]] = None) -> int:
    trace = chrome_trace(events, meta)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
