"""Text renderers over a trace: timeline, attribution, mispredictions.

This is the library behind ``repro_torch.launch.trace_timeline``; it
works on live :class:`~repro_torch.obs.events.Event` objects or JSONL
re-reads alike.

The attribution table answers the acceptance question "which decision
preceded each topology change": for every ``reconfig`` event it finds
the latest prior ``policy_decision`` on the same group and prints the
decision's features, predicted win, and realized outcome next to the cut
it caused.

Counterpart of ``repro/obs/report.py``; every rendered text equals the
reference's on the same event stream.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.audit import (decision_rows, misprediction_rate,
                                   top_mispredictions)


def _as_dict(e: Any) -> Dict[str, Any]:
    return e if isinstance(e, dict) else e.as_dict()


def _topo(t) -> str:
    if not t:
        return "?"
    return "(" + ",".join(str(int(w)) for w in t) + ")"


def _fmt_payload(kind: str, p: Dict[str, Any]) -> str:
    if kind == "reconfig":
        return (f"{_topo(p.get('from'))} -> {_topo(p.get('to'))}"
                f" gain={p.get('gain', 0):+.3f} [{p.get('reason', '')}]")
    if kind in ("steal", "migrate"):
        return (f"r{p.get('rid')} {p.get('src')} -> {p.get('dst')}"
                + (f" stall={p['stall']}" if p.get("stall") else "")
                + (f" tier={p['tier']}" if p.get("tier") else ""))
    if kind == "spill":
        # gid (the timeline address column) is the acting source group;
        # the payload still carries both endpoints
        return f"g{p.get('src')} -> g{p.get('dst')}"
    if kind == "lease":
        dst = p.get("dst") or (None, None)
        s = (f"{p.get('action')} l{p.get('lid')} {p.get('slots')} slot(s)"
             f" -> g{dst[0]}/p{dst[1]}")
        if p.get("action") == "grant":
            s += f" term={p.get('term')} gain={p.get('gain', 0):+.3f}"
        elif p.get("reason"):
            s += f" [{p.get('reason')}]"
        return s
    if kind == "admission":
        return f"n={p.get('n')} rids={p.get('rids')}"
    if kind == "policy_decision":
        s = (f"{_topo(p.get('from'))} -> {_topo(p.get('target'))}"
             f" proba={p.get('proba', 0):.2f} [{p.get('reason', '')}]")
        if not p.get("applied"):
            s += " (held)"
        return s
    if kind == "refit":
        return " ".join(f"{k}={p[k]}" for k in sorted(p))
    if kind == "region_grab":
        return f"chip={p.get('chip')} {p.get('action')} groups={p.get('groups')}"
    if kind == "stall":
        return f"remaining={p.get('remaining')}"
    return str(p)


def render_timeline(events: Sequence[Any],
                    limit: Optional[int] = None) -> str:
    """One line per event: ``[tick] kind g<gid>/p<part> detail``."""
    evs = [_as_dict(e) for e in events]
    lines = []
    shown = evs if limit is None else evs[:limit]
    for e in shown:
        addr = f"g{e['gid']}" if e["gid"] >= 0 else "fleet"
        if e["part"] is not None:
            addr += f"/p{e['part']}"
        lines.append(f"[{e['tick']:>6}] {e['kind']:<15} {addr:<8} "
                     f"{_fmt_payload(e['kind'], e['payload'])}")
    if limit is not None and len(evs) > limit:
        lines.append(f"... {len(evs) - limit} more events")
    return "\n".join(lines)


def attribution_rows(events: Sequence[Any]) -> List[Dict[str, Any]]:
    """Join each reconfig to the latest prior decision on its group."""
    evs = sorted((_as_dict(e) for e in events), key=lambda e: e["seq"])
    last_decision: Dict[int, Dict[str, Any]] = {}
    rows: List[Dict[str, Any]] = []
    for e in evs:
        if e["kind"] == "policy_decision":
            last_decision[e["gid"]] = e
        elif e["kind"] == "reconfig":
            d = last_decision.get(e["gid"])
            dp = d["payload"] if d else {}
            rows.append({
                "tick": e["tick"], "gid": e["gid"],
                "from": e["payload"].get("from"),
                "to": e["payload"].get("to"),
                "gain": e["payload"].get("gain"),
                "reason": e["payload"].get("reason"),
                "decision_tick": d["tick"] if d else None,
                "features": dp.get("features"),
                "proba": dp.get("proba"),
                "label": dp.get("label"),
            })
    return rows


def render_attribution(events: Sequence[Any]) -> str:
    rows = attribution_rows(events)
    if not rows:
        return "(no reconfigs in trace)"
    lines = ["tick    gid  change              decision@  proba  label  "
             "reason                features"]
    for r in rows:
        feats = ("[" + ", ".join(f"{f:.2f}" for f in r["features"]) + "]"
                 if r["features"] else "-")
        proba = f"{r['proba']:.2f}" if r["proba"] is not None else "  - "
        label = f"{r['label']:.0f}" if r["label"] is not None else "-"
        lines.append(
            f"{r['tick']:<7} {r['gid']:<4} "
            f"{_topo(r['from'])+'->'+_topo(r['to']):<19} "
            f"{str(r['decision_tick']):<10} {proba:<6} {label:<6} "
            f"{(r['reason'] or '')[:20]:<21} {feats}")
    return "\n".join(lines)


def render_mispredictions(events: Sequence[Any], k: int = 10) -> str:
    rows = decision_rows(events)
    rate = misprediction_rate(rows)
    if rate is None:
        return ("(no labeled decisions in trace — run with an online "
                "policy so the replay buffer is wired)")
    worst = top_mispredictions(rows, k=k)
    lines = [f"labeled decisions: "
             f"{sum(1 for r in rows if r['mispredicted'] is not None)}  "
             f"misprediction rate: {rate:.3f}"]
    if not worst:
        lines.append("(no mispredictions)")
        return "\n".join(lines)
    lines.append("tick    gid  proba  label  conf   move               "
                 "features")
    for r in worst:
        feats = ("[" + ", ".join(f"{f:.2f}" for f in r["features"]) + "]"
                 if r["features"] else "-")
        lines.append(
            f"{r['tick']:<7} {r['gid']:<4} {r['proba']:.2f}   "
            f"{r['label']:.0f}      {r['confidence']:.2f}   "
            f"{_topo(r['from'])+'->'+_topo(r['target']):<19}{feats}")
    return "\n".join(lines)


def render_report(events: Sequence[Any], meta: Optional[Dict] = None,
                  timeline_limit: int = 40, top_k: int = 10) -> str:
    """The full text report the CLI prints."""
    sections = []
    if meta:
        sections.append("== meta ==\n" + "\n".join(
            f"{k}: {meta[k]}" for k in sorted(meta) if k != "mesh"))
    sections.append("== timeline ==\n"
                    + render_timeline(events, limit=timeline_limit))
    sections.append("== decisions preceding each topology change ==\n"
                    + render_attribution(events))
    sections.append(f"== top-{top_k} mispredictions ==\n"
                    + render_mispredictions(events, k=top_k))
    return "\n\n".join(sections)
