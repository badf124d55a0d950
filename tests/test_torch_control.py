"""repro_torch's control plane against the reference's, on recorded inputs.

The control plane is numpy on both sides, so topologies, partitions,
move gains, controller transitions and the event log's JSONL lines must
be identical.  ``train_logistic`` is full-batch gradient descent in
float32 on both sides (XLA vs PyTorch, sums in another order), so its
coefficients are compared with a 1e-3 absolute tolerance.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.control as JC  # noqa: E402
import repro.core.predictor as JP  # noqa: E402
import repro.obs.events as JE  # noqa: E402
import repro_torch.control as PC  # noqa: E402
import repro_torch.core.predictor as PP  # noqa: E402
import repro_torch.obs.events as PE  # noqa: E402

SPACES = [(4, 2, True), (8, 2, False), (8, 4, True), (12, 3, True)]


def _remaining(rng, n):
    return rng.choice([0, 1, 3, 8, 20, 60], size=n).astype(np.float64)


@pytest.mark.parametrize("capacity,max_ways,hetero", SPACES)
def test_config_space_matches(capacity, max_ways, hetero):
    js = JC.ConfigSpace(capacity=capacity, max_ways=max_ways, hetero=hetero)
    ps = PC.ConfigSpace(capacity=capacity, max_ways=max_ways, hetero=hetero)
    assert ps.compositions() == js.compositions()
    assert ps.topologies() == js.topologies()
    rng = np.random.default_rng(capacity * 10 + max_ways)
    for topo in js.compositions():
        assert ps.neighbors(topo) == js.neighbors(topo)
        assert ps.name(topo) == js.name(topo)
        for _ in range(3):
            rem = _remaining(rng, capacity)
            for pol in ("direct_split", "warp_regroup"):
                idx = list(range(capacity))
                assert ps.partition(idx, rem, topo, pol) == \
                    js.partition(idx, rem, topo, pol)
                for nb in js.neighbors(topo):
                    assert ps.move_gain(rem, topo, nb, pol) == \
                        js.move_gain(rem, topo, nb, pol)
            assert ps.best_topology(rem) == js.best_topology(rem)


def _feature_stream(n=60, capacity=8, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rem = _remaining(rng, int(rng.integers(1, capacity + 1)))
        out.append((rem, int(rng.integers(0, 6)), float(rng.random())))
    return out


def _trained_models(seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((64, len(JC.SERVE_FEATURES)))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    jm, _ = JP.train_logistic(X, y, feature_names=JC.SERVE_FEATURES,
                              steps=200)
    pm = PP.LogisticModel(*(np.asarray(a, np.float32) for a in jm[:4]),
                          feature_names=tuple(jm.feature_names))
    return jm, pm


def _run_controller(mod, ev_mod, policy, model):
    space = mod.ConfigSpace(capacity=8, max_ways=4, hetero=True)
    log = ev_mod.EventLog(mode="full")
    pol = mod.make_policy(policy, space=space, split_threshold=0.3,
                          fuse_threshold=0.05, model=model)
    ctl = mod.GroupController(pol, space, dwell=2,
                              replay=mod.ReplayBuffer(), obs=log, gid=0)
    topos = []
    for t, (rem, qd, rate) in enumerate(_feature_stream()):
        log.set_tick(t)
        fv = mod.FeatureVector.from_group(rem, qd, rate, 8)
        ctl.observe(fv, max_ways_now=min(4, rem.size))
        topos.append(ctl.state.topology)
    lines = [json.dumps(e.as_dict(), sort_keys=True) for e in log.events()]
    return topos, ctl.state.transitions, lines, log.summary()


@pytest.mark.parametrize("policy", ["threshold", "oracle", "predictor"])
def test_group_controller_transitions_and_events_match(policy):
    jm, pm = _trained_models()
    want = _run_controller(JC, JE, policy, jm)
    got = _run_controller(PC, PE, policy, pm)
    assert got[0] == want[0]                      # topology after each tick
    assert [tuple(t[:3]) for t in got[1]] == [tuple(t[:3]) for t in want[1]]
    assert got[3] == want[3]                      # event counts by kind
    if policy != "predictor":
        # predictor payloads carry float32 probabilities computed by numpy
        # on one side and XLA on the other; their decisions match above
        assert got[2] == want[2]                  # JSONL lines, byte for byte
    assert len(want[2]) > 0


def test_event_log_jsonl_fixed_point_matches():
    payload = dict(to=(4, 4), gain=np.float64(0.25), rids=np.arange(3),
                   n=np.int64(2), nested={"a": (1, 2)})
    lines = []
    for mod in (JE, PE):
        log = mod.EventLog(mode="full")
        log.emit("reconfig", gid=1, part=0, tick=5, **payload)
        log.emit("admission", gid=1, part=1, **payload)
        lines.append([json.dumps(e.as_dict(), sort_keys=True)
                      for e in log.events()])
    assert lines[0] == lines[1]


@pytest.mark.parametrize("weighted", [False, True])
def test_train_logistic_coefficients_within_tolerance(weighted):
    rng = np.random.default_rng(11)
    X = rng.standard_normal((200, 5)) * np.array([1.0, 3.0, 0.5, 2.0, 1.0])
    y = (X @ np.array([1.0, -0.5, 2.0, 0.0, 0.3]) + 0.3
         * rng.standard_normal(200) > 0).astype(np.float64)
    sw = np.exp(-np.arange(200)[::-1] / 80.0) if weighted else None
    jm, jinfo = JP.train_logistic(X, y, steps=500, sample_weight=sw)
    pm, pinfo = PP.train_logistic(X, y, steps=500, sample_weight=sw)
    for a, b in zip(pm[:4], jm[:4]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)
    np.testing.assert_allclose(pinfo["loss_history"], jinfo["loss_history"],
                               atol=1e-3)
    assert pinfo["n"] == jinfo["n"]
    assert abs(pinfo["train_accuracy"] - jinfo["train_accuracy"]) < 1e-9
    np.testing.assert_array_equal(
        PP.predict_proba(pm, X) > 0.5,
        np.asarray(JP.predict_proba(jm, X)) > 0.5)


def test_predictor_model_round_trips_through_json(tmp_path):
    _, pm = _trained_models()
    path = str(tmp_path / "m.json")
    PP.save_model(pm, path)
    back = PP.load_model(path)
    for a, b in zip(back[:4], pm[:4]):
        np.testing.assert_array_equal(a, b)
    jback = JP.load_model(path)          # same file layout as the reference
    np.testing.assert_allclose(np.asarray(jback.w), pm.w)
