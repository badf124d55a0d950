"""Nothing the benchmark loads is ``jax`` or the JAX package ``repro``
(compared by whole top-level names: ``repro_torch`` begins with
``repro``), and the reference loads nothing of the port."""
import json
import shutil
import subprocess
import sys
import textwrap

from conftest import ROOT


def _python(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_a_whole_run_loads_no_jax_and_no_repro():
    out = _python("""
        import sys, json
        sys.path[:0] = ["src", "port_bench/tests", "."]
        from conftest import tiny_cell
        from port_bench.harness import serve
        sys.path.insert(0, "port_bench")
        import run
        cell, model = tiny_cell("fmamba7b-rag")
        serve.run_cell(".", cell, 9, 1.0, True, device="cpu",
                       model_override=model)
        print(json.dumps([run.forbidden_modules(),
                          "repro_torch" in sys.modules]))
    """)
    assert out.returncode == 0, out.stderr
    bad, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == [] and port


def test_the_reference_loads_nothing_of_the_port():
    out = _python("""
        import sys, json
        sys.path[:0] = ["src", "."]
        import port_bench.reference.model
        import port_bench.harness.check
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in
                                ("repro_torch", "repro", "jax"))))
    """)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names():
    out = _python("""
        import sys, types, json
        sys.path.insert(0, "port_bench")
        import run
        sys.modules["repro_torch_extra"] = types.ModuleType("x")
        sys.modules["jaxlib.xla"] = types.ModuleType("x")
        sys.modules["repro.models"] = types.ModuleType("x")
        print(json.dumps(run.forbidden_modules()))
    """)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        ["jaxlib.xla", "repro.models"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "dsmoe16b-docs",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "fmamba7b-docs",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
