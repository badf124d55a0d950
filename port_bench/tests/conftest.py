"""Shared set-up of the benchmark's CPU tests.

Run them from the repository's root::

    python -m pytest -q port_bench/tests

Tests marked ``cuda`` need an NVIDIA card and skip without one.
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# each configuration's structure at a width the CPU runs in a second, in
# float32 so that the port and the reference agree to rounding
TINY = {
    "deepseek-moe-16b": dict(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        vocab_size=512, dtype="float32",
        moe={"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
             "num_shared": 1}),
    "falcon-mamba-7b": dict(
        num_layers=2, d_model=64, vocab_size=512, dtype="float32",
        ssm={"d_state": 8, "d_conv": 4, "expand": 2, "dt_rank": 4}),
}


@pytest.fixture
def root():
    return ROOT


def tiny_cell(name: str):
    """Cell ``name`` cut for the CPU: 4 slots a group, short prompts, a
    light load, a small check sample, and its model at ``TINY`` width."""
    from port_bench.harness import manifest
    cell = manifest.load_cell(ROOT, name)
    cell.spec = copy.deepcopy(cell.spec)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.spec["engine"]["capacity"] = 4
    cell.spec["check"]["ref_tokens"] = 3000
    load = cell.spec["load"]
    if "clients" in load:
        load["clients"] = 8
    else:
        load["rate_per_s"] = 4.0
    for c in cell.traffic["prompt"]:
        c["lo"] = c["hi"] = max(8, c["lo"] // 64)
    model = {**cell.config["model"], **TINY[cell.config_name]}
    return cell, model


@pytest.fixture
def cuda():
    """Skip without an NVIDIA card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
