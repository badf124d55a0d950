"""The control: the reference computed with float8 inputs to every
projection must fail the check the program passes.

On the CPU at a tiny width in float32, where the program agrees with the
reference to rounding, the control's mean gap is above zero on every
seed, and a run with the control in the program's place is judged by the
control's reading.  On the card (marked ``cuda``) each cell's control run,
at the cell's own size and load on three seeds, comes out not correct
through the run's own comparison, while the program's reading on the
same sample lies below the limit.
"""
import json
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_cell
from port_bench.harness import manifest, serve

CELLS = ["fmamba7b-docs", "dsmoe16b-docs", "fmamba7b-rag"]


@pytest.mark.parametrize("name", CELLS)
def test_control_departs_where_the_program_does_not(name):
    for seed in (1, 2, 3):
        cell, model = tiny_cell(name)
        res = serve.run_cell(ROOT, cell, seed, 2.0, False, device="cpu",
                             model_override=model, fault="control")
        r = res["sample"]
        assert r["served_tokens"] > 100
        assert r["mean_gap"] == 0.0 and r["flips"] == 0
        assert r["control_mean_gap"] > 0.0 and r["control_flips"] > 0
        assert res["compared"]["mean_gap"]["value"] == r["control_mean_gap"]
        assert list(res)[-1] == "compared"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit_at_the_cells_size(cuda, name):
    limit = manifest.load_cell(ROOT, name).spec["check"]["limits"]
    out = subprocess.run(
        [sys.executable, "port_bench/control.py", "--workload", name,
         "--seconds", "20", "--seeds", "101", "102", "103"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()[:-1]]
    assert len(rows) == 3
    for r in rows:
        assert r["correct"] is False, r
        for k, lim in limit.items():
            assert r[k] <= lim < r[f"control_{k}"], (k, r)
