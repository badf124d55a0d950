"""repro_torch.obs against repro.obs: the audit, exporters and reports.

One event stream is recorded per package by the vec ``ClusterEngine``
(``obs="full"``, an ``online`` policy so decisions carry realized labels).
The two streams hold the same events in the same order with the same
decisions, labels and replay indices; only the online policy's fitted
``proba`` and a refit's ``train_accuracy`` may differ in the last float32
bits, because each package refits its logistic model with its own
gradient-descent code (``tests/test_torch_control.py`` holds the fitted
coefficients to 1e-3).  So:

* on either recorded stream, the port's decision audit, JSONL and
  Chrome-trace exporters and text reports give exactly what the
  reference's give: the same rows and rates, the same JSONL bytes, the
  same Chrome-trace JSON once parsed, the same text;
* across the two streams, everything the audit derives from decisions
  and labels is equal, and the misprediction rate and verified replay
  labels are exactly the reference's.

The unit cases of ``tests/test_obs.py`` for the ported modules run
through both packages too.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.cluster as JCL  # noqa: E402
import repro.configs as JCFG  # noqa: E402
import repro.configs.base as JB  # noqa: E402
import repro.control as JC  # noqa: E402
import repro.fleet as JF  # noqa: E402
import repro.obs as JO  # noqa: E402
import repro_torch.cluster as PCL  # noqa: E402
import repro_torch.configs as PCFG  # noqa: E402
import repro_torch.configs.base as PB  # noqa: E402
import repro_torch.control as PC  # noqa: E402
import repro_torch.fleet as PF  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
from repro_torch.launch import trace_timeline  # noqa: E402

AMOEBA = dict(split_threshold=0.3, fuse_threshold=0.05, min_phase_steps=2,
              policy="online")
# the fields an online refit computes in float32 in each package's own
# trainer; everything else in the streams is equal exactly
FITTED = ("proba", "train_accuracy")
FIT_TOL = 1e-6


def record(CL, CFG, B, F, horizon=40, seed=5):
    cfg = CFG.get_config("qwen3-14b", reduced=True)
    fleet = B.FleetConfig(
        num_groups=4, capacity=4, router="sticky", mode="dynamic",
        engine="vec", rebalance_every=4,
        migrate=B.MigrationConfig(enabled=True),
        amoeba=B.AmoebaConfig(**AMOEBA),
        cluster=B.ClusterConfig(groups_per_chip=2), obs="full")
    eng = CL.ClusterEngine(cfg, None, fleet=fleet)
    eng.submit(F.multichip_imbalanced_trace(horizon, cfg.vocab_size,
                                            seed=seed, chips=2,
                                            groups_per_chip=2))
    eng.run()
    return eng


def _unfitted(e):
    return dict(e, payload={k: v for k, v in e["payload"].items()
                            if k not in FITTED})


@pytest.fixture(scope="module")
def runs():
    """{"reference": engine, "port": engine}, the streams checked equal."""
    je = record(JCL, JCFG, JB, JF)
    pe = record(PCL, PCFG, PB, PF)
    jev = [e.as_dict() for e in je.obs.events()]
    pev = [e.as_dict() for e in pe.obs.events()]
    assert [_unfitted(e) for e in pev] == [_unfitted(e) for e in jev]
    for a, b in zip(pev, jev):
        for k in FITTED:
            if k in b["payload"] and b["payload"][k] is not None:
                assert abs(a["payload"][k] - b["payload"][k]) <= FIT_TOL
    assert pe.obs.meta == je.obs.meta
    return {"reference": je, "port": pe}


SRC = pytest.mark.parametrize("src", ["reference", "port"])


def events(eng):
    return eng.obs.events()


# -- the decision audit --------------------------------------------------------

@SRC
def test_decision_rows_identical(runs, src):
    evs = events(runs[src])
    got = PO.decision_rows(evs)
    assert got == JO.decision_rows(evs) and len(got) > 0
    # live events and their dicts (a JSONL re-read) give the same rows
    assert PO.decision_rows([e.as_dict() for e in evs]) == got
    assert any(r["mispredicted"] is not None for r in got)


@SRC
def test_misprediction_rate_and_top_k_identical(runs, src):
    rows = PO.decision_rows(events(runs[src]))
    rate = PO.misprediction_rate(rows)
    assert rate == JO.misprediction_rate(rows) and 0.0 < rate < 1.0
    for k in (1, 5, 50):
        assert PO.top_mispredictions(rows, k=k) == \
            JO.top_mispredictions(rows, k=k)


@SRC
def test_verify_replay_identical(runs, src):
    eng = runs[src]
    rows = PO.decision_rows(events(eng))
    got = PO.verify_replay(rows, eng.policy.replay)
    assert got == JO.verify_replay(rows, eng.policy.replay) > 0


def test_audit_across_packages(runs):
    """Each package's audit of its own run: the same decisions, labels,
    misprediction rate and verified replay labels."""
    je, pe = runs["reference"], runs["port"]
    jr, pr = JO.decision_rows(events(je)), PO.decision_rows(events(pe))
    cut = ("proba", "confidence")
    assert [{k: v for k, v in r.items() if k not in cut} for r in pr] == \
        [{k: v for k, v in r.items() if k not in cut} for r in jr]
    assert PO.misprediction_rate(pr) == JO.misprediction_rate(jr)
    assert PO.verify_replay(pr, pe.policy.replay) == \
        JO.verify_replay(jr, je.policy.replay) > 0
    assert [{k: v for k, v in r.items() if k != "proba"}
            for r in PO.attribution_rows(events(pe))] == \
        [{k: v for k, v in r.items() if k != "proba"}
         for r in JO.attribution_rows(events(je))]
    assert [r["tick"] for r in PO.top_mispredictions(pr, k=20)] == \
        [r["tick"] for r in JO.top_mispredictions(jr, k=20)]


def _decision(tick, gid, proba, label, applied=True, seq=1):
    return {"seq": seq, "tick": tick, "kind": "policy_decision", "gid": gid,
            "part": None,
            "payload": {"from": [4], "target": [2, 2], "applied": applied,
                        "proba": proba, "gain": 0.1, "reason": "r",
                        "features": [0.5, 0.5], "replay_idx": seq - 1,
                        "label": label, "label_gain": 0.0}}


def test_audit_unit_cases_identical():
    evs = [_decision(1, 0, proba=0.9, label=0.0, seq=1),
           _decision(2, 0, proba=0.6, label=1.0, seq=2),
           _decision(3, 1, proba=0.3, label=1.0, seq=3),
           {"seq": 4, "tick": 3, "kind": "steal", "gid": 1, "part": None,
            "payload": {}}]
    unlabeled = _decision(1, 0, proba=0.9, label=None)
    unlabeled["payload"].pop("label")
    unlabeled["payload"].pop("replay_idx")
    out = []
    for O in (JO, PO):
        rows = O.decision_rows(evs)
        urow = O.decision_rows([unlabeled])
        out.append((rows, O.misprediction_rate(rows),
                    O.top_mispredictions(rows, k=5), urow,
                    O.misprediction_rate(urow)))
    assert out[1] == out[0]
    rows, rate, worst, urow, urate = out[1]
    assert [r["mispredicted"] for r in rows] == [True, False, True]
    assert rate == pytest.approx(2 / 3)
    assert [r["tick"] for r in worst] == [1, 3]
    assert urow[0]["mispredicted"] is None and urate is None


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_verify_replay_checks_and_skips_evicted(pkg):
    C, O = (JC, JO) if pkg == "reference" else (PC, PO)
    replay = C.ReplayBuffer(maxlen=2)
    idxs = [replay.add(np.zeros(4), float(y)) for y in (1.0, 0.0, 1.0)]
    assert idxs == [0, 1, 2] and replay.total_added == 3
    rows = [{"replay_idx": i, "label": lab}
            for i, lab in zip(idxs, (1.0, 0.0, 1.0))]
    assert O.verify_replay(rows, replay) == 2      # idx 0 evicted
    rows[2]["label"] = 0.0
    with pytest.raises(AssertionError, match="audit/replay mismatch"):
        O.verify_replay(rows, replay)


# -- exporters -------------------------------------------------------------------

@SRC
def test_jsonl_identical_byte_for_byte_and_round_trips(runs, src, tmp_path):
    eng = runs[src]
    jp, pp = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    nj = JO.write_jsonl(str(jp), events(eng), meta=eng.obs.meta)
    n = PO.write_jsonl(str(pp), events(eng), meta=eng.obs.meta)
    assert n == nj == len(events(eng)) > 0
    assert pp.read_bytes() == jp.read_bytes()
    meta, evs = PO.read_jsonl(str(pp))
    assert (meta, evs) == JO.read_jsonl(str(jp))
    assert meta == eng.obs.meta and meta["mesh"]["num_groups"] == 4
    assert evs == [e.as_dict() for e in events(eng)]
    # the file is the fixed point of parse -> re-serialize
    rebuilt = [json.dumps({"kind": "_meta", **meta}, sort_keys=True)]
    rebuilt += [json.dumps(PO.jsonable(e), sort_keys=True) for e in evs]
    assert pp.read_text().splitlines() == rebuilt


@SRC
def test_chrome_trace_identical_and_one_process_per_chip(runs, src,
                                                         tmp_path):
    eng = runs[src]
    got = PO.chrome_trace(events(eng), meta=eng.obs.meta)
    assert got == JO.chrome_trace(events(eng), meta=eng.obs.meta)
    out, ref = tmp_path / "chrome.json", tmp_path / "ref.json"
    n = PO.write_chrome_trace(str(out), events(eng), eng.obs.meta)
    JO.write_chrome_trace(str(ref), events(eng), eng.obs.meta)
    parsed = json.loads(out.read_text())
    assert parsed == json.loads(ref.read_text())
    assert n == len(parsed["traceEvents"])
    evs = parsed["traceEvents"]
    procs = {e["args"]["name"] for e in evs if e.get("name") == "process_name"}
    assert procs == {"chip 0", "chip 1"}
    # topology spans tile [0, wall) per group; flows pair s with f
    for g in range(4):
        spans = sorted((e for e in evs if e["ph"] == "X" and e["tid"] == g),
                       key=lambda e: e["ts"])
        assert spans and spans[0]["ts"] == 0
        for a, b in zip(spans, spans[1:]):
            assert a["ts"] + a["dur"] == b["ts"]
    starts = {e["id"] for e in evs if e["ph"] == "s"}
    assert starts and starts == {e["id"] for e in evs if e["ph"] == "f"}


def test_chrome_trace_without_a_mesh_identical(runs):
    # the same stream with no mesh in meta renders as one process
    evs = events(runs["port"])
    got = PO.chrome_trace(evs)
    assert got == JO.chrome_trace(evs)
    procs = [e for e in got["traceEvents"] if e.get("name") == "process_name"]
    assert [p["args"]["name"] for p in procs] == ["fleet"]


# -- reports ---------------------------------------------------------------------

@SRC
def test_attribution_rows_identical(runs, src):
    evs = events(runs[src])
    got = PO.attribution_rows(evs)
    assert got == JO.attribution_rows(evs) and got
    for r in got:
        assert r["decision_tick"] is not None
        assert r["decision_tick"] <= r["tick"] and r["from"] != r["to"]


@SRC
@pytest.mark.parametrize("render", [
    ("render_timeline", dict(limit=None)),
    ("render_timeline", dict(limit=10)),
    ("render_attribution", {}),
    ("render_mispredictions", dict(k=3)),
    ("render_mispredictions", dict(k=10)),
    ("render_report", dict(timeline_limit=5)),
])
def test_rendered_text_identical(runs, src, render):
    eng = runs[src]
    name, kw = render
    if name == "render_report":
        kw = dict(kw, meta=eng.obs.meta)
    got = getattr(PO, name)(events(eng), **kw)
    assert got == getattr(JO, name)(events(eng), **kw) and got


def test_reports_of_an_empty_trace_identical():
    for name in ("render_attribution", "render_mispredictions",
                 "render_timeline"):
        assert getattr(PO, name)([]) == getattr(JO, name)([])
    assert PO.render_attribution([]) == "(no reconfigs in trace)"
    assert "no labeled decisions" in PO.render_mispredictions([])


def test_reports_render_every_event_kind_identically():
    """One synthetic event of every kind the timeline formats (the run
    may not emit them all), through both renderers."""
    payloads = {
        "reconfig": {"from": [4], "to": [2, 2], "gain": 0.125,
                     "reason": "split"},
        "steal": {"rid": 3, "src": [0, None], "dst": [2, 1], "stall": 2,
                  "tier": "link"},
        "migrate": {"rid": 4, "src": [0, 0], "dst": [1, 1], "stall": 0},
        "spill": {"src": 0, "dst": 1},
        "lease": {"action": "grant", "lid": 1, "slots": 2, "dst": [1, 0],
                  "term": 8, "gain": 0.5},
        "admission": {"n": 2, "rids": [5, 6]},
        "policy_decision": {"from": [4], "target": [2, 2], "proba": 0.75,
                            "reason": "r", "applied": False},
        "refit": {"n": 64, "loss": 0.5},
        "region_grab": {"chip": 1, "action": "gather", "groups": [2, 3]},
        "stall": {"remaining": 3},
    }
    evs = [{"seq": i + 1, "tick": i, "kind": k, "gid": i % 3 - 1,
            "part": None if i % 2 else 0, "payload": p}
           for i, (k, p) in enumerate(payloads.items())]
    evs.append({"seq": 99, "tick": 20, "kind": "lease", "gid": 1,
                "part": 0, "payload": {"action": "revoke", "lid": 1,
                                       "slots": 2, "dst": [1, 0],
                                       "reason": "expired"}})
    for name in ("render_timeline", "render_attribution"):
        assert getattr(PO, name)(evs) == getattr(JO, name)(evs)
    assert PO.chrome_trace(evs) == JO.chrome_trace(evs)
    assert PO.render_report(evs, meta={"wall_ticks": 21}) == \
        JO.render_report(evs, meta={"wall_ticks": 21})


def test_obs_exports_match_the_reference():
    assert sorted(PO.__all__) == sorted(JO.__all__)
    from repro.obs import export as JX
    from repro_torch.obs import export as PX
    assert PX.US_PER_TICK == JX.US_PER_TICK


# -- the launcher ----------------------------------------------------------------

def test_trace_timeline_launcher_writes_both_traces(tmp_path, capsys):
    trace_timeline.main(["--horizon", "20", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    jsonl = tmp_path / "trace_timeline.jsonl"
    chrome = tmp_path / "trace_timeline_chrome.json"
    meta, evs = PO.read_jsonl(str(jsonl))
    assert meta["mesh"]["num_groups"] == 4 and evs
    assert json.loads(chrome.read_text())["traceEvents"]
    assert "audit cross-check:" in out and "== timeline" in out
