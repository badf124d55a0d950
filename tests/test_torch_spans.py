"""The span log (``repro_torch.obs.spans``) on a reduced deepseek-moe-16b
fleet in float32, on a shard-skewed trace on which groups split, re-cut,
steal, lease and migrate.

Off, it records nothing, makes no span and enters no profiler
annotation.  On, the run is the same run (tokens, ``ServeStats``, summary
and event stream); each span sits inside the span it belongs to; there
is one ``group.decode`` span a decode call and one ``group.reconfigure``
span a re-cut, whose ``bytes`` are the decode state a re-cut writes.
With the log off, a running profiler still sees the spans as
annotations.
"""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.configs as PCFG  # noqa: E402
import repro_torch.configs.base as PB  # noqa: E402
import repro_torch.fleet as PF  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.serve import state_utils as su  # noqa: E402
from repro_torch.serve.engine import make_decode_fn  # noqa: E402

AMOEBA = dict(split_threshold=0.3, fuse_threshold=0.05, min_phase_steps=2)

# the span each span opens inside (None: at the top)
PARENTS = {
    "engine.tick": {None},
    "engine.rebalance": {"engine.tick"},
    "group.admit": {"engine.tick"},
    "group.prefill": {"group.admit"},
    "group.readback": {"group.admit", "engine.tick"},
    "group.control": {"engine.tick"},
    "group.reconfigure": {"engine.tick"},
    "group.decode": {"engine.tick"},
    "model.moe": {"group.prefill", "group.decode"},
}


@pytest.fixture(scope="module")
def model():
    cfg = PCFG.get_config("deepseek-moe-16b",
                          reduced=True).replace(dtype="float32")
    params = PT.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, params


@pytest.fixture(autouse=True)
def _log_off():
    spans.stop()
    spans.take()
    yield
    spans.stop()
    spans.take()


def _fleet(engine="object"):
    return PB.FleetConfig(
        num_groups=2, capacity=4, window=64, mode="dynamic",
        router="sticky", amoeba=PB.AmoebaConfig(**AMOEBA),
        migrate=PB.MigrationConfig(enabled=True, link_bandwidth=1e9),
        lease=PB.LeaseConfig(enabled=True), obs="full", engine=engine)


def _run(model, on, engine="object", max_ticks=1_000_000):
    """One run; with ``on`` the log records it.  Returns what the run
    gave, the log, and every decode call and re-cut seen from outside."""
    cfg, params = model
    trace = PF.imbalanced_trace(8, cfg.vocab_size, seed=38, shards=2,
                                hot_rate=0.6, cold_rate=0.2)
    seen = {"decodes": [], "recuts": []}
    decode = make_decode_fn(cfg, PT.Runtime())

    def decode_fn(p, s, t):
        seen["decodes"].append(int(t.shape[0]))
        return decode(p, s, t)

    eng = PF.FleetEngine(cfg, params if engine == "object" else None,
                         rt=PT.Runtime(), fleet=_fleet(engine),
                         decode_fn=decode_fn if engine == "object" else None)
    for g in eng.groups:
        _watch_recuts(g, seen["recuts"])
    eng.submit(trace)
    if on:
        spans.start()
    summary = eng.run(max_ticks=max_ticks)
    log = spans.take()
    spans.stop()
    summary.pop("wall_s")
    summary.pop("ticks_per_sec")
    return dict(
        summary=summary,
        tokens={r.rid: (tuple(r.generated), r.finish) for r in trace},
        stats=[dataclasses.asdict(g.stats) for g in eng.groups],
        events=[e.as_dict() for e in eng.obs.events()],
        log=log, seen=seen)


def _watch_recuts(g, out):
    """Re-cut each re-cut's live parts here too, as it happens (decode
    then writes the states in place), and keep the bytes that wrote."""
    recut = g._recut

    def watched(target):
        before = [(list(p.requests), getattr(p, "state", None))
                  for p in g._parts if p is not None]
        recut(target)
        after = [None if p is None else
                 (list(p.requests), getattr(p, "state", None))
                 for p in g._parts]
        out.append(_recut_bytes_by_hand(before, after))
    g._recut = watched


def _tensor_bytes(tree):
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tensor_bytes(x) for x in tree)
    return 0


def _recut_bytes_by_hand(before, after):
    """The bytes a re-cut writes, re-cut here with ``su.concat`` and
    ``su.take``: the merge where several parts were live, the slices
    where the new cut has several parts."""
    states = [st for _, st in before]
    if states[0] is None:
        return 0                      # the vec engine's parts hold none
    merged = su.concat(states)
    total = _tensor_bytes(merged) if len(before) > 1 else 0
    if len(after) > 1:
        order = [r for reqs, _ in before for r in reqs]
        for part in after:
            if part is None:
                continue
            ids = [next(i for i, q in enumerate(order) if q is r)
                   for r in part[0]]
            sliced = su.take(merged, ids)
            assert all(torch.equal(a, b) for a, b in
                       zip(_leaves(sliced), _leaves(part[1])))
            total += _tensor_bytes(sliced)
    return total


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return []


@pytest.fixture(scope="module")
def runs(model):
    return {"off": _run(model, False), "on": _run(model, True)}


def _names(log):
    return collections.Counter(s["name"] for s in log["spans"])


def test_off_records_nothing_makes_no_span_and_enters_no_annotation(
        model, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("entered while the log is off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(spans, "_Span", refuse)
    got = _run(model, False)
    assert not spans.SPANS.on
    assert got["log"] == {"spans": [], "dropped": 0}
    assert len(got["seen"]["decodes"]) > 0


@pytest.mark.parametrize("what", ["tokens", "stats", "summary", "events"])
def test_on_is_the_same_run(runs, what):
    assert runs["on"][what] == runs["off"][what]
    assert runs["on"][what]


def test_on_is_the_same_run_in_the_vec_engine(model):
    off, on = _run(model, False, "vec"), _run(model, True, "vec")
    for k in ("tokens", "stats", "summary", "events"):
        assert on[k] == off[k], k
    names = _names(on["log"])
    # the vec engine runs no model: control flow and re-cuts only
    assert names["engine.tick"] and names["group.reconfigure"]
    assert not names["group.decode"] and not names["model.moe"]
    assert all(s["attrs"]["bytes"] == 0 for s in on["log"]["spans"]
               if s["name"] == "group.reconfigure")


def test_each_span_sits_in_the_span_it_belongs_to(runs):
    log = runs["on"]["log"]
    by_id = {s["id"]: s for s in log["spans"]}
    assert set(_names(log)) == set(PARENTS)
    for s in log["spans"]:
        parent = by_id[s["parent"]] if s["parent"] is not None else None
        assert (parent and parent["name"]) in PARENTS[s["name"]], s
        if parent is not None:
            assert parent["start"] <= s["start"] <= s["end"] <= \
                parent["end"]
    ticks = [s["attrs"]["tick"] for s in log["spans"]
             if s["name"] == "engine.tick"]
    assert ticks == sorted(ticks) and len(set(ticks)) == len(ticks)
    assert log["dropped"] == 0


def test_one_decode_span_a_decode_call(runs):
    log, seen = runs["on"]["log"], runs["on"]["seen"]
    decodes = [s for s in log["spans"] if s["name"] == "group.decode"]
    assert [s["attrs"]["batch"] for s in decodes] == seen["decodes"]
    assert all({"gid", "part"} <= set(s["attrs"]) for s in decodes)


def test_one_reconfigure_span_a_recut_with_the_bytes_it_writes(runs):
    run = runs["on"]
    recuts = [s for s in run["log"]["spans"]
              if s["name"] == "group.reconfigure"]
    keys = ("splits", "fuses", "resizes")
    assert len(recuts) == sum(st[k] for st in run["stats"] for k in keys)
    assert len(recuts) == len(run["seen"]["recuts"]) >= 3
    # a fuse of one live part copies nothing
    assert [s["attrs"]["bytes"] for s in recuts] == run["seen"]["recuts"]
    assert sum(b > 0 for b in run["seen"]["recuts"]) >= 3
    for span in recuts:
        assert span["attrs"]["from"] != span["attrs"]["to"]
        assert sum(span["attrs"]["to"]) == 4


def test_the_log_is_bounded_and_counts_what_it_drops():
    log = spans.SpanLog(capacity=8)
    log.start(capacity=3)
    with log.span("engine.tick", tick=0):
        for i in range(4):
            with log.span("group.decode", part=i) as sp:
                sp.set(batch=i)
    got = log.take()
    assert got["dropped"] == 2
    assert [s["name"] for s in got["spans"]] == \
        ["engine.tick", "group.decode", "group.decode"]
    assert [s["attrs"] for s in got["spans"][1:]] == \
        [{"part": 2, "batch": 2}, {"part": 3, "batch": 3}]
    tick = got["spans"][0]["id"]
    assert all(s["parent"] == tick for s in got["spans"][1:])
    assert log.take() == {"spans": [], "dropped": 0}
    log.stop()
    assert log.span("engine.tick") is spans.NULL_SPAN
    with pytest.raises(ValueError):
        log.start(capacity=0)


def test_a_profiler_sees_the_spans_while_the_log_is_off(model):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        got = _run(model, False, max_ticks=12)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"engine.tick", "engine.rebalance", "group.admit",
            "group.prefill", "group.control", "group.decode",
            "group.readback"} <= names
    assert "model.moe" not in names          # per-layer: the log only
    assert got["log"] == {"spans": [], "dropped": 0}
