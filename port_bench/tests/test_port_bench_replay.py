"""The reader of ``decode_replay_share`` on made-up sub-windows: decode
calls that replayed, that captured, that ran eagerly, and a program
without graph spans, which gives no reading."""
import pytest

from conftest import ROOT
from port_bench.harness import manifest
from port_bench.harness.serve import Record

NAMES = ("decode_replay_share.chat", "decode_replay_share.docs")


def _read(subwindows, name=NAMES[0]):
    c = manifest.load_cell(ROOT, "fmamba7b-rag")
    rec = Record(cell=c, model=c.config["model"], seconds=20.0,
                 open_t=100.0, close_t=120.0, requests=[], counters={},
                 subwindows=subwindows)
    return manifest.readers(ROOT, [{"name": name}])[name].read(rec)


def _sub(spans, lo=0.0, hi=1000.0):
    return {"start_us": lo, "end_us": hi, "kernels": [], "spans": spans}


def _call(at, *inner):
    """One ``group.decode`` span at ``at`` holding the named spans."""
    return [("group.decode", at, at + 50.0),
            ("model.decode_enqueue", at + 1.0, at + 49.0)] + [
        (n, at + 2.0 + 10 * i, at + 10.0 + 10 * i)
        for i, n in enumerate(inner)]


def test_the_manifest_lists_both_metrics_with_their_reader():
    bench = manifest.load_json(ROOT / "BENCHMARK.json")
    assert manifest.problems(bench, ROOT) == []
    got = {m["name"]: m for m in bench["per_layer"]}
    assert got[NAMES[0]]["workloads"] == ["fmamba7b-rag"]
    assert got[NAMES[1]]["workloads"] == ["fmamba7b-docs", "dsmoe16b-docs"]
    for n in NAMES:
        assert got[n]["source"] == "program_span" and got[n]["unit"] == "%"
        assert manifest.reader_path(ROOT, n).name == "decode_replay_share.py"


@pytest.mark.parametrize("name", NAMES)
def test_share_of_calls_that_replayed_without_a_capture(name):
    spans = ([("bench.subwindow", 0.0, 1000.0)]
             + _call(10.0, "model.decode_capture", "model.decode_replay")
             + _call(100.0, "model.decode_replay")
             + _call(200.0, "model.decode_replay")
             + _call(300.0)                         # eager
             + _call(400.0, "model.decode_replay")
             # a call cut by the sub-window's edge is not counted
             + _call(980.0, "model.decode_replay"))
    assert _read([_sub(spans)], name) == pytest.approx(100.0 * 3 / 5)
    # two sub-windows pool their calls
    more = _sub(_call(10.0, "model.decode_replay"))
    assert _read([_sub(spans), more], name) == pytest.approx(100.0 * 4 / 6)


def test_only_captures_read_zero():
    spans = _call(10.0, "model.decode_capture", "model.decode_replay")
    assert _read([_sub(spans)]) == 0.0


@pytest.mark.parametrize("subs", [
    [_sub(_call(10.0) + _call(100.0))],     # decode calls, no graph spans
    [_sub([("engine.run", 0.0, 100.0)])],   # no decode call
    [],                                     # no sub-window
], ids=["eager-program", "no-decode", "no-subwindow"])
def test_no_reading_without_graph_spans(subs):
    assert _read(subs) is None
