"""The five launchers of ``repro_torch.launch`` that stand for the examples
``gpusim_paper``, ``quickstart``, ``control_plane``, ``hetero_topology``
and ``work_stealing``, against the examples themselves.

Each example runs in a child of its own (``python -c``, the JAX package on
the CPU, all six started together) at small settings, with the reference
functions whose results it prints wrapped so that the child also reports
them whole: every ``FleetEngine.run`` summary, every ``ServeEngine.run``'s
stats, ``train_sim_predictor``'s fit and ``KVTransferCost``'s prices.
Meanwhile each launcher's ``main`` runs here with ``--device cpu`` at the
same settings.  Compared:

* the gpusim tables (Fig 12 speedups and geomeans, quickstart's RAY run,
  the static chip-composition ranking), the ``(5, 3)`` lattice cut, the
  controller's walk, ``KVTransferCost``'s bytes and stall ticks: exactly,
  and each launcher's printed lines equal the example's;
* the predictor's fit: its decisions exactly, its accuracies within 1e-6
  (each package fits with its own gradient descent, as
  ``tests/test_torch_obs.py`` holds the ``online`` refit);
* the served runs: every fleet summary (completed, ticks, steals,
  migrations, latency percentiles, efficiency) and the serve engine's
  counters exactly.  No served counter depends on token values (no request
  stops early), so the two packages' different random weights do not move
  them; quickstart's training losses do depend on them and are not
  compared.

No launcher imports ``jax``.
"""
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
FIT_TOL = 1e-6
# each run by name: (example / launcher, arguments)
RUNS = {
    "gpusim_paper": ("gpusim_paper", []),
    "quickstart": ("quickstart", []),
    "control_plane": ("control_plane", ["--variants", "1", "--groups", "2",
                                        "--capacity", "2", "--horizon", "4"]),
    "hetero_lattice": ("hetero_topology", ["--skip-fleet"]),
    "hetero_fleet": ("hetero_topology", ["--groups", "2", "--capacity", "2",
                                         "--horizon", "4"]),
    "work_stealing": ("work_stealing", ["--groups", "2", "--capacity", "2",
                                        "--horizon", "4"]),
}
LAUNCHERS = sorted({name for name, _ in RUNS.values()})

# one example, its printed lines and the results of the reference calls
# it prints from
EXAMPLE_CHILD = r"""
import contextlib, dataclasses, io, json, runpy, sys
path, args = sys.argv[1], json.loads(sys.argv[2])
import repro.core.gpusim.corpus as corpus
from repro.fleet import FleetEngine, KVTransferCost
from repro.serve import ServeEngine
calls = {"fleet": [], "serve": [], "fit": [], "kv_bytes": [], "stall": []}


def wrap(owner, name, key, keep=lambda r: r):
    # only the example's own calls, not the engine's
    fn = getattr(owner, name)

    def run(*a, **kw):
        out = fn(*a, **kw)
        if sys._getframe(1).f_code.co_filename == path:
            calls[key].append(keep(out))
        return out
    setattr(owner, name, run)


wrap(FleetEngine, "run", "fleet")
wrap(ServeEngine, "run", "serve", dataclasses.asdict)
wrap(corpus, "train_sim_predictor", "fit", lambda r: r[1])
wrap(KVTransferCost, "kv_bytes", "kv_bytes")
wrap(KVTransferCost, "stall_ticks", "stall")
sys.argv = [path] + args
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    runpy.run_path(path, run_name="__main__")
print(json.dumps({"stdout": buf.getvalue(), **calls}, default=float))
"""

# the summary fields that are the run's own wall time
TIMING = ("wall_s", "ticks_per_sec")


def _lines(text):
    """Printed lines without the launcher's closing device line."""
    return [x for x in text.splitlines() if not x.startswith("device:")]


def _summary(s):
    return json.loads(json.dumps({k: v for k, v in s.items()
                                  if k not in TIMING}, default=float))


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*", line)]


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    children = {
        key: subprocess.Popen(
            [sys.executable, "-c", EXAMPLE_CHILD,
             os.path.join(ROOT, "examples", name + ".py"), json.dumps(args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for key, (name, args) in RUNS.items()}
    import contextlib
    import importlib
    import io
    got = {}
    try:
        for key, (name, args) in RUNS.items():
            mod = importlib.import_module(f"repro_torch.launch.{name}")
            buf = io.StringIO()
            argv = args if name == "gpusim_paper" else args + ["--device",
                                                               "cpu"]
            with contextlib.redirect_stdout(buf):
                out = mod.main(argv)
            got[key] = {"stdout": buf.getvalue(), "out": out}
        want = {}
        for key, p in children.items():
            log, err = p.communicate(timeout=600)
            assert p.returncode == 0, (key, err[-4000:])
            want[key] = json.loads(log.strip().splitlines()[-1])
    finally:
        for p in children.values():
            if p.poll() is None:
                p.kill()
    return got, want


def test_no_launcher_imports_jax():
    code = ("import sys\n"
            + "".join(f"import repro_torch.launch.{n}\n" for n in LAUNCHERS)
            + "assert 'jax' not in sys.modules and 'repro' not in "
              "sys.modules, sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('repro.'))\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=SRC))


@pytest.mark.parametrize("key", RUNS)
def test_printed_lines_match_the_example(runs, key):
    """Every line the example prints, the launcher prints the same, but
    quickstart's training line (its losses follow each package's random
    weights)."""
    got, want = runs
    mine, theirs = _lines(got[key]["stdout"]), _lines(want[key]["stdout"])
    assert len(mine) == len(theirs), (mine, theirs)
    for a, b in zip(mine, theirs):
        if a.startswith("[train]"):
            assert b.startswith("[train]")
            continue
        assert a == b


def test_gpusim_tables_equal(runs):
    got, want = runs
    out = got["gpusim_paper"]["out"]
    text = _lines(want["gpusim_paper"]["stdout"])
    names = list(out["speedup"]["warp_regroup"])
    assert len(names) == 12
    for name in names:
        (row,) = [x for x in text if x.split()[:1] == [name]]
        assert [round(out["speedup"][s][name], 3)
                for s in out["speedup"]] == _numbers(row[8:]), name
    for s, g in out["geomean"].items():
        assert f"geomean {s:14s} {g:.3f}" in text
    q = got["quickstart"]["out"]["gpusim"]
    assert _numbers(want["quickstart"]["stdout"].splitlines()[0])[:3] == [
        round(q["baseline_ipc"], 1), round(q["amoeba_ipc"], 1),
        round(q["amoeba_ipc"] / q["baseline_ipc"], 2)]


def test_lattice_cut_and_controller_walk(runs):
    """Capacity 8: the skew-aware partitioner's (5, 3) cut, and the
    controller's walk up the lattice under the oracle."""
    got, want = runs
    out = got["hetero_lattice"]["out"]
    assert out["lattice"]["best"] == (5, 3)
    text = want["hetero_lattice"]["stdout"]
    assert f"best topology   {'5+3':10s} gain={out['lattice']['gain']:.3f}" \
        in text
    walk = [x for x in text.splitlines() if x.strip().startswith("tick ")]
    assert len(walk) == len(out["walk"]) > 0
    for line, (step, frm, to, g, reason) in zip(walk, out["walk"]):
        assert line.strip() == (f"tick {step}: {frm} -> {to} "
                                f"(gain {g:.3f}; {reason})")


def test_kv_transfer_prices_equal(runs):
    got, want = runs
    out = got["work_stealing"]["out"]["cost"]
    w = want["work_stealing"]
    assert [out[s][0] for s in (16, 64, 256)] == w["kv_bytes"]
    assert [out[s][1] for s in (16, 64, 256)] + [out["zero_bandwidth"]] == \
        w["stall"]


def test_predictor_fit_and_decisions(runs):
    got, want = runs
    for key, info in (("control_plane", got["control_plane"]["out"]["gpusim"]),
                      ("quickstart", got["quickstart"]["out"]["predictor"])):
        fit = want[key]["fit"][0]
        assert abs(info["train_accuracy"] - fit["train_accuracy"]) <= FIT_TOL
        if key == "control_plane":
            assert info["n"] == fit["n"]
            assert abs(info["base_profile_accuracy"]
                       - fit["base_profile_accuracy"]) <= FIT_TOL
            lines = [x.split() for x in want[key]["stdout"].splitlines()
                     if "predictor says" in x]
            assert {x[0]: (x[3] == "fuse", x[5].rstrip(")") == "fuse")
                    for x in lines} == info["decisions"]
            assert info["agree"] == sum(a == b for a, b in
                                        info["decisions"].values())


@pytest.mark.parametrize("key", ["control_plane", "hetero_fleet",
                                 "work_stealing"])
def test_fleet_summaries_equal(runs, key):
    got, want = runs
    out = got[key]["out"]["fleet"]
    mine = [out] if "completed" in out else list(out.values())
    assert len(mine) == len(want[key]["fleet"]) > 0
    for a, b in zip(mine, want[key]["fleet"]):
        assert _summary(a) == _summary(b)
    if key == "work_stealing":
        assert mine[1]["migration"]["steals"] > 0


def test_quickstart_serve_counters_equal(runs):
    got, want = runs
    mine = got["quickstart"]["out"]["serve"]
    (theirs,) = want["quickstart"]["serve"]
    assert mine == theirs
    assert mine["completed"] == 12
