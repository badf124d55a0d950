"""The reader of the program's own spans, ``control_ms_per_tick``, on
made-up sub-windows and on a CPU profiler's trace of a small fleet run,
and no reading from a program without the spans."""
import pytest

from conftest import ROOT
from port_bench.harness import manifest, trace
from port_bench.harness.serve import Record

NAME = "control_ms_per_tick.chat"


def _reader(name):
    return manifest.readers(ROOT, [{"name": name}])[name]


def _rec(subwindows):
    c = manifest.load_cell(ROOT, "fmamba7b-rag")
    return Record(cell=c, model=c.config["model"], seconds=20.0,
                  open_t=100.0, close_t=120.0, requests=[], counters={},
                  subwindows=subwindows)


def _sub(spans, lo=0.0, hi=1000.0):
    return {"start_us": lo, "end_us": hi, "kernels": [], "spans": spans}


def test_the_manifest_lists_the_metric_with_its_reader():
    bench = manifest.load_json(ROOT / "BENCHMARK.json")
    assert manifest.problems(bench, ROOT) == []
    m = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert m["workloads"] == ["fmamba7b-rag"]
    assert m["source"] == "program_span" and m["unit"] == "ms"
    assert manifest.reader_path(ROOT, NAME).name == "control_ms_per_tick.py"


def test_control_ms_per_tick_is_control_spans_over_ticks():
    spans = [("bench.subwindow", 0.0, 1000.0), ("engine.run", 5.0, 395.0),
             ("engine.tick", 10.0, 200.0), ("group.control", 20.0, 50.0),
             ("group.control", 60.0, 70.0), ("engine.tick", 200.0, 390.0),
             ("engine.rebalance", 210.0, 230.0),
             ("group.control", 240.0, 300.0),
             # a tick cut by the sub-window's edge is not counted
             ("engine.tick", 990.0, 1010.0), ("group.control", 995.0, 1005.0)]
    got = _reader(NAME).read(_rec([_sub(spans)]))
    assert got == pytest.approx(1e-3 * (30 + 10 + 20 + 60) / 2)
    # two sub-windows pool their ticks
    got = _reader(NAME).read(
        _rec([_sub(spans), _sub([("engine.tick", 0.0, 100.0)])]))
    assert got == pytest.approx(1e-3 * 120 / 3)


@pytest.mark.parametrize("subs", [
    # the harness's own annotations alone, as a program without spans gives
    [_sub([("engine.run", 0.0, 100.0), ("group.step", 1.0, 99.0),
           ("model.decode_enqueue", 2.0, 50.0)])],
    [],                                        # no sub-window at all
], ids=["harness-annotations-only", "no-subwindow"])
def test_no_reading_without_the_programs_spans(subs):
    assert _reader(NAME).read(_rec(subs)) is None


def test_a_profilers_trace_of_the_fleet_carries_the_spans():
    """The program's spans reach ``trace.extract`` through a profiler
    alone (its span log off), so the reader reads a real trace."""
    import torch
    import repro_torch.configs as PCFG
    import repro_torch.configs.base as PB
    import repro_torch.fleet as PF
    from repro_torch.models import transformer as PT
    from repro_torch.obs import spans

    cfg = PCFG.get_config("qwen3-14b", reduced=True).replace(dtype="float32")
    params = PT.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    fc = PB.FleetConfig(
        num_groups=2, capacity=4, window=64, mode="dynamic",
        router="sticky", amoeba=PB.AmoebaConfig(
            split_threshold=0.3, fuse_threshold=0.05, min_phase_steps=2),
        migrate=PB.MigrationConfig(enabled=True, link_bandwidth=1e9))
    eng = PF.FleetEngine(cfg, params, rt=PT.Runtime(), fleet=fc)
    eng.submit(PF.imbalanced_trace(8, cfg.vocab_size, seed=38, shards=2,
                                   hot_rate=0.6, cold_rate=0.2))
    assert not spans.SPANS.on
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function(trace.SUBWINDOW):
        eng.run()
    prof.stop()
    sub = trace.extract(prof)
    names = {n for n, _, _ in sub["spans"]}
    assert {"engine.tick", "engine.rebalance", "group.control",
            "group.reconfigure", "group.decode", "group.admit"} <= names
    ctl = _reader(NAME).read(_rec([sub]))
    assert ctl is not None and ctl > 0
    # one a pass of the loop: every wall tick and the last pass, which
    # finds the trace drained
    ticks = sum(n == "engine.tick" for n, _, _ in sub["spans"])
    assert ticks == eng.wall + 1
