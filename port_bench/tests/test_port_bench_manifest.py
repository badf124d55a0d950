"""The manifest's rules, and that a cell is added with new files only."""
import copy
import hashlib
import json
import shutil

import pytest

from conftest import TINY
from port_bench.harness import manifest, serve


@pytest.fixture
def bench(root):
    return manifest.load_json(root / "BENCHMARK.json")


def test_benchmark_json_keeps_the_rules(bench, root):
    assert manifest.problems(bench, root) == []


def test_every_cell_loads_with_its_files(bench, root):
    for w in bench["workloads"]:
        cell = manifest.load_cell(root, w["name"])
        assert cell.chips == 1
        assert cell.config["name"] == w["config"]
        assert cell.traffic["loop"] in ("open", "closed")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer


@pytest.mark.parametrize("edit, words", [
    (lambda b: b["end_to_end"][0].update(unit="tokens per s"), "bad unit"),
    (lambda b: b["end_to_end"][0].update(unit="x" * 17), "bad unit"),
    (lambda b: b["per_layer"][0].update(name="a b"), "bad name"),
    (lambda b: b["per_layer"][0].update(name="a/b"), "bad name"),
    (lambda b: b["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda b: b["per_layer"][0].update(workloads=["fmamba7b-docs"]),
     "does not report"),
    (lambda b: b["workloads"][0].update(chips=2), "chips"),
    (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda b: b["end_to_end"][0].update(bound=0.005), "bound"),
    (lambda b: b["end_to_end"][0].update(source="program_span"),
     "end-to-end source"),
    (lambda b: b["per_layer"][0].update(why="extra"), "keys"),
    (lambda b: b.update(run_seconds=52), "run_seconds"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="x")),
     "twice"),
])
def test_problems_catch_each_break(bench, edit, words):
    b = copy.deepcopy(bench)
    edit(b)
    assert any(words in p for p in manifest.problems(b)), \
        manifest.problems(b)


def test_each_reader_declares_what_the_manifest_says(bench, root):
    mods = manifest.readers(root, bench["per_layer"])
    for m in bench["per_layer"]:
        mod = mods[m["name"]]
        assert mod.LAYER == m["layer"], m["name"]
        assert mod.UNIT == m["unit"], m["name"]
        moves = mod.MOVES
        if isinstance(moves, dict):
            moves = moves[m["name"].split(".", 1)[1]]
        assert moves == m["moves"], m["name"]
        assert callable(mod.read)


def test_a_full_check_fits_at_this_run_length(bench):
    assert manifest.check_seconds(24, bench["run_seconds"]) \
        <= manifest.CHECK_SECONDS
    assert manifest.check_seconds(24, manifest.MAX_RUN_SECONDS) \
        <= manifest.CHECK_SECONDS


def _digests(d):
    return {p.relative_to(d): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_config_mix_and_metric_are_added_as_new_files(bench, root,
                                                             tmp_path):
    """A throwaway configuration, mix, cell and per-layer metric: new files
    plus new manifest entries, and no file of port_bench edited."""
    shutil.copytree(root / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "port_bench")
    pb = tmp_path / "port_bench"
    cfg = json.loads((pb / "configs" / "deepseek-moe-16b.json").read_text())
    cfg["name"] = cfg["model"]["name"] = "throwaway-moe"
    (pb / "configs" / "throwaway-moe.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "openloop.json").write_text(json.dumps({
        "loop": "open", "prompt": [{"weight": 1.0, "lo": 64, "hi": 96}],
        "output": [{"weight": 1.0, "lo": 4, "hi": 8}]}))
    spec = json.loads((pb / "workloads" / "dsmoe16b-docs.json").read_text())
    spec["load"] = {"rate_per_s": 6.0}
    (pb / "workloads" / "throwaway-open.json").write_text(json.dumps(spec))
    (pb / "metrics" / "throwaway_count.py").write_text(
        'LAYER = "fleet and serving engine"\nUNIT = "1"\n'
        'MOVES = "output_tok_s"\n\n\ndef read(rec):\n'
        '    return float(len(rec.requests))\n')
    b = copy.deepcopy(bench)
    b["configs"].append({"name": "throwaway-moe", "source": "arXiv:0000.0",
                         "file": "port_bench/configs/throwaway-moe.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "throwaway-open",
                           "config": "throwaway-moe", "traffic": "openloop",
                           "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "output_tok_s":
            m["workloads"].append("throwaway-open")
    b["per_layer"].append({"name": "throwaway_count.chat", "unit": "1",
                           "better": "lower", "source": "program_counter",
                           "layer": "fleet and serving engine",
                           "moves": "output_tok_s",
                           "workloads": ["throwaway-open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    assert manifest.problems(b, tmp_path) == []
    cell = manifest.load_cell(tmp_path, "throwaway-open")
    assert cell.traffic["loop"] == "open"
    mods = manifest.readers(tmp_path, cell.per_layer)
    assert "throwaway_count.chat" in mods
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert len(after) == len(before) + 4
    # and it runs, open loop included (CPU, tiny width)
    cell.spec["engine"]["capacity"] = 4
    cell.spec["check"]["ref_tokens"] = 2000
    model = {**cfg["model"], **TINY["deepseek-moe-16b"]}
    res = serve.run_cell(tmp_path, cell, 2**31 + 77, 2.0, True,
                         device="cpu", model_override=model)
    assert res["correct"] and res["attempted"] > 0
    assert res["metrics"]["throwaway_count.chat"]["value"] > 0
