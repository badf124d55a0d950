"""repro_torch's configs equal the reference's, and the port stands alone:
importing it pulls in neither JAX nor the reference package."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.configs as J  # noqa: E402
import repro.configs.base as JB  # noqa: E402
import repro_torch.configs as P  # noqa: E402
import repro_torch.configs.base as PB  # noqa: E402

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_registry_matches():
    assert P.ARCH_IDS == J.ARCH_IDS
    assert P.all_cells() == J.all_cells()


@pytest.mark.parametrize("arch", J.ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_model_config_matches_field_by_field(arch, reduced):
    want = J.get_config(arch, reduced=reduced)
    got = P.get_config(arch, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.layer_kinds == want.layer_kinds


@pytest.mark.parametrize("name", ["AmoebaConfig", "MigrationConfig",
                                  "LeaseConfig", "ClusterConfig",
                                  "FleetConfig", "TrainConfig"])
def test_runtime_config_defaults_match(name):
    assert dataclasses.asdict(getattr(PB, name)()) == \
        dataclasses.asdict(getattr(JB, name)())


def test_h100_is_the_data_sheet_part():
    assert PB.H100.name == "h100-sxm"
    assert (PB.H100.peak_flops, PB.H100.hbm_bandwidth, PB.H100.hbm_bytes) \
        == (989e12, 3.35e12, 80e9)
    assert dataclasses.asdict(PB.V5E) == dataclasses.asdict(JB.V5E)


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, pkgutil, importlib, repro_torch, repro_torch.fleet\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    src = str(PORT.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=src),
                         timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


def test_no_source_imports_jax_or_reference():
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    hits = [f"{p.relative_to(PORT)}: {m.group(0).strip()}"
            for p in PORT.rglob("*.py") for m in pat.finditer(p.read_text())]
    assert not hits, hits
