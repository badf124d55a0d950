"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each lives in a file of its own, so a later change adds a cell, a
configuration, a mix or a per-layer metric as new files plus new entries:

* ``port_bench/configs/<config>.json``: the model, as the port's
  ``ModelConfig`` fields (``model``) beside the published sizes it stands
  for (``published``), what was assumed and where it departs;
* ``port_bench/traffic/<traffic>.json``: the shape of the traffic
  (loop kind, length mixes), read by :mod:`.traffic`;
* ``port_bench/workloads/<cell>.json``: the deployment (groups, slots,
  window, router), the offered load (rate or clients) and the check's
  sample and limits;
* ``port_bench/metrics/<metric>.py`` (or ``<base>.py`` for
  ``<base>.<suffix>``): the reader of one per-layer metric.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATHPART = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"host_clock", "device_trace"}
# the longest a run may measure, and the check's whole allowance
MAX_RUN_SECONDS = 51
CHECK_SECONDS = 43200


@dataclass
class Cell:
    """One cell and everything it names, loaded from the repository."""
    name: str
    chips: int
    why: str
    config_name: str
    config: dict            # the configuration file
    traffic_name: str
    traffic: dict           # the traffic file
    spec: dict              # the cell file: deployment, load, check
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_root(root: Path) -> Path:
    return Path(root) / "port_bench"


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str,
              bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    pb = bench_root(root)
    return Cell(
        name=name, chips=int(entry["chips"]), why=entry["why"],
        config_name=conf["name"], config=load_json(root / conf["file"]),
        traffic_name=entry["traffic"],
        traffic=load_json(pb / "traffic" / f"{entry['traffic']}.json"),
        spec=load_json(pb / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _for_cell(m, name)],
        per_layer=[m for m in bench["per_layer"] if _for_cell(m, name)])


def reader_path(root: Path, metric: str) -> Path:
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``,
    else ``metrics/<base>.py`` for ``<base>.<suffix>``."""
    d = bench_root(root) / "metrics"
    own = d / f"{metric}.py"
    return own if own.exists() else d / f"{metric.split('.')[0]}.py"


def check_seconds(n_cells: int, run_seconds: int) -> float:
    """What a full check of ``n_cells`` cells takes at most: 2 + 14 runs a
    cell, each ``run_seconds`` + 60 s, 180 s a cell to compile, and 1200 s
    spare."""
    return ((2 + 14 * n_cells) * (run_seconds + 60) + 180 * n_cells
            + 1200)


def problems(bench: dict, root: Optional[Path] = None) -> List[str]:
    """Every way ``bench`` breaks the manifest's rules; empty if none.

    With ``root`` the files it names are looked for too.
    """
    out: List[str] = []
    if set(bench) != TOP_KEYS:
        out.append(f"top-level keys {sorted(bench)} are not {sorted(TOP_KEYS)}")
        return out
    cmd, paths = bench["command"], bench["paths"]
    if not (1 <= len(cmd) <= 32) or not all(
            isinstance(w, str) and 1 <= len(w) <= 200 and "\n" not in w
            and "\t" not in w for w in cmd):
        out.append("command: 1 to 32 words of 1 to 200 characters")
    if not (1 <= len(paths) <= 16) or not all(
            PATHPART.match(p) and not p.startswith("/") and ".." not in p
            for p in paths):
        out.append("paths: 1 to 16 relative paths")
    rs = bench["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= MAX_RUN_SECONDS):
        out.append(f"run_seconds {rs!r} not a whole number in 1..51")
    elif check_seconds(24, rs) > CHECK_SECONDS:
        out.append(f"run_seconds {rs}: 24 cells do not fit a check")

    def named(kind, items, keys, lo=1, hi=24):
        if not (lo <= len(items) <= hi):
            out.append(f"{kind}: {len(items)} entries, not {lo} to {hi}")
        seen = set()
        for it in items:
            extra = set(it) - set(keys)
            missing = set(keys) - set(it) - {"workloads"}
            if extra or missing:
                out.append(f"{kind} {it.get('name')}: keys {sorted(it)}")
            n = it.get("name", "")
            if not NAME.match(n):
                out.append(f"{kind}: bad name {n!r}")
            if n in seen:
                out.append(f"{kind}: {n!r} twice")
            seen.add(n)
        return seen

    def one_line(kind, s):
        if not (isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s
                and "\t" not in s):
            out.append(f"{kind}: {s!r} is not one line of 1 to 200")

    configs = named("configs", bench["configs"],
                    ["name", "source", "file", "reduced", "why"])
    for c in bench["configs"]:
        one_line(f"config {c['name']} source", c.get("source"))
        one_line(f"config {c['name']} why", c.get("why"))
        if not any(c.get("file", "").startswith(p.rstrip("/") + "/")
                   for p in paths):
            out.append(f"config {c['name']}: file outside paths")
        if len(c.get("reduced", [])) > 16 or not all(
                NAME.match(k) for k in c.get("reduced", [])):
            out.append(f"config {c['name']}: bad reduced")
        if root is not None and not (Path(root) / c["file"]).exists():
            out.append(f"config {c['name']}: no file {c['file']}")
    cells = named("workloads", bench["workloads"],
                  ["name", "config", "traffic", "chips", "why"])
    pairs = set()
    for w in bench["workloads"]:
        one_line(f"workload {w['name']} why", w.get("why"))
        if w.get("config") not in configs:
            out.append(f"workload {w['name']}: unknown config")
        if not NAME.match(str(w.get("traffic", ""))):
            out.append(f"workload {w['name']}: bad traffic name")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w['name']}: chips must be 1 or 4")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"workload {w['name']}: pair {pair} twice")
        pairs.add(pair)
        if root is not None:
            pb = bench_root(root)
            for f in (pb / "traffic" / f"{w['traffic']}.json",
                      pb / "workloads" / f"{w['name']}.json"):
                if not f.exists():
                    out.append(f"workload {w['name']}: no file {f}")
    four = sum(w.get("chips") == 4 for w in bench["workloads"])
    if four > max(1, len(bench["workloads"]) // 4):
        out.append(f"{four} cells ask for 4 chips")
    used = {w.get("config") for w in bench["workloads"]}
    for c in configs - used:
        out.append(f"config {c}: used by no cell")

    e2e = named("end_to_end", bench["end_to_end"],
                ["name", "unit", "better", "bound", "source", "workloads"],
                1, 16)
    per = named("per_layer", bench["per_layer"],
                ["name", "unit", "better", "source", "layer", "moves",
                 "workloads"], 1, 128)
    if e2e & per:
        out.append(f"metrics named twice: {sorted(e2e & per)}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m.get("unit", "")):
            out.append(f"metric {m['name']}: bad unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better must be lower or higher")
        if m.get("source") not in SOURCES:
            out.append(f"metric {m['name']}: bad source")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"metric {m['name']}: unknown workload {c}")
    for m in bench["end_to_end"]:
        if m.get("source") not in E2E_SOURCES:
            out.append(f"metric {m['name']}: end-to-end source must be "
                       f"host_clock or device_trace")
        b = m.get("bound")
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            out.append(f"metric {m['name']}: bound {b!r} not in 0.01..0.25")
    by_name = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        one_line(f"metric {m['name']} layer", m.get("layer"))
        mv = by_name.get(m.get("moves"))
        if mv is None:
            out.append(f"metric {m['name']}: moves {m.get('moves')!r} is "
                       f"no end-to-end metric")
            continue
        mine = m.get("workloads", sorted(cells))
        theirs = mv.get("workloads", sorted(cells))
        for c in mine:
            if c not in theirs:
                out.append(f"metric {m['name']}: cell {c} does not report "
                           f"{mv['name']}")
        if root is not None and not reader_path(root, m["name"]).exists():
            out.append(f"metric {m['name']}: no reader")
    for w in bench["workloads"]:
        n = w["name"]
        mine_e2e = [m["name"] for m in bench["end_to_end"]
                    if _for_cell(m, n)]
        if "setup_s" not in mine_e2e or len(mine_e2e) < 2:
            out.append(f"workload {n}: needs setup_s and one more "
                       f"end-to-end metric")
        if not any(_for_cell(m, n) for m in bench["per_layer"]):
            out.append(f"workload {n}: no per-layer metric")
    if len(json.dumps(bench, indent=1)) > 64 * 1024:
        out.append("BENCHMARK.json over 64 KiB")
    return out


def readers(root: Path, metrics: List[dict]) -> Dict[str, object]:
    """Each per-layer metric's reader module, loaded from its file."""
    import importlib.util
    out = {}
    for m in metrics:
        path = reader_path(root, m["name"])
        spec = importlib.util.spec_from_file_location(
            f"port_bench_metric_{path.stem.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = mod
    return out
