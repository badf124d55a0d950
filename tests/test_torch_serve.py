"""repro_torch's ServeEngine against the reference's, same weights, same trace.

Float32 on both sides (the reference's own bf16 greedy tokens move with
batch composition — ROADMAP queue 3), capacity 4, fused and dynamic,
under both regroup policies.  The engines must agree exactly: every
ServeStats field, every generated token, every completion tick.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import AmoebaConfig as JAmoeba  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import AmoebaConfig  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402


@pytest.fixture(scope="module")
def models():
    jc = jget_config("qwen3-14b", reduced=True).replace(dtype="float32")
    tc = get_config("qwen3-14b", reduced=True).replace(dtype="float32")
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _trace(vocab, n=10, seed=0):
    """(rid, prompt, max_new) triples: the draws of tests/test_serve_fleet.py."""
    rng = np.random.default_rng(seed)
    return [(i, list(map(int, rng.integers(0, vocab, int(rng.choice([8, 16]))))),
             int(rng.choice([2, 5, 20]))) for i in range(n)]


def _run(engine_cls, req_cls, amoeba_cls, cfg, params, policy, dynamic):
    eng = engine_cls(cfg, params, capacity=4, amoeba=amoeba_cls(
        regroup_policy=policy, split_threshold=0.3, fuse_threshold=0.05,
        min_phase_steps=2))
    reqs = [req_cls(i, p, m) for i, p, m in _trace(cfg.vocab_size)]
    eng.submit(reqs)
    st = eng.run(dynamic=dynamic)
    return (dataclasses.asdict(st),
            {r.rid: (tuple(r.generated), r.finish) for r in reqs},
            list(eng.controller.state.transitions))


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("policy", ["direct_split", "warp_regroup"])
def test_serve_engine_matches_reference(models, dynamic, policy):
    jc, jp, tc, tp = models
    want = _run(JServe, JRequest, JAmoeba, jc, jp, policy, dynamic)
    got = _run(ServeEngine, Request, AmoebaConfig, tc, tp, policy, dynamic)
    assert got[0] == want[0]             # ServeStats, field by field
    assert got[1] == want[1]             # tokens and finish ticks per request
    assert [t[:3] for t in got[2]] == [t[:3] for t in want[2]]
    st = got[0]
    assert st["completed"] == 10
    assert st["useful_tokens"] == sum(len(g) for g, _ in got[1].values())
    if not dynamic:
        assert st["splits"] == 0 and st["fuses"] == 0


def _run_fleet_hooks(group_cls, req_cls, cfg, params):
    """Two groups driven by hand through the fleet hooks: a live request
    migrates from a split group into a fused one (with a KV-transfer
    stall), then a slot is leased across them and released."""
    a = group_cls(cfg, params, capacity=4, mode="split", gid=0)
    b = group_cls(cfg, params, capacity=4, mode="fused", gid=1)
    reqs = [req_cls(i, p, m) for i, p, m in _trace(cfg.vocab_size, n=8,
                                                     seed=3)]
    a.submit(reqs[:6])
    b.submit(reqs[6:])
    moved, log = None, []
    for now in range(200):
        if now == 2:
            moved = a.part_live(0)[0]
            state, last = a.extract_live(moved)
            assert b.insert_live(moved, state, last, part=0, stall=2)
        if now == 4:
            a.lease_out(1, 1)
            b.lease_in(0, 1)
        if now == 9:
            a.lease_back(1, 1)
            b.lease_return(0, 1)
        outs = [g.step(dynamic=False, now=now) for g in (a, b)]
        log.append((now, tuple(outs),
                    [(g.effective_slots(i), g._slot_charge(i),
                      len(g.part_live(i))) for g in (a, b)
                     for i in range(g.ways)]))
        if outs == ["idle", "idle"]:
            break
    for g in (a, b):
        g.finalize()
    return ([dataclasses.asdict(g.stats) for g in (a, b)],
            {r.rid: (tuple(r.generated), r.finish) for r in reqs},
            moved.rid, log)


def test_migration_and_leases_match_reference(models):
    """extract_live / insert_live re-slice the KV state that decode writes
    in place; the lease books change admission and slot charges.  Both
    must leave every stat, token and per-tick book equal to the
    reference's."""
    from repro.serve.engine import ReconfigurableGroup as JGroup
    from repro_torch.serve.engine import ReconfigurableGroup
    jc, jp, tc, tp = models
    want = _run_fleet_hooks(JGroup, JRequest, jc, jp)
    got = _run_fleet_hooks(ReconfigurableGroup, Request, tc, tp)
    assert got == want
    stats_a, stats_b = got[0]
    assert stats_a["migrations_out"] == 1 and stats_b["migrations_in"] == 1
    assert stats_a["leases_out"] == stats_b["leases_in"] == 0  # planner's
    assert stats_b["stall_ticks"] == 2
    assert stats_a["completed"] + stats_b["completed"] == 8
