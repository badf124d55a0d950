"""repro_torch.cluster against repro.cluster: same mesh, prices, plans, runs.

The cluster layer is numpy and plain Python in both packages, so every
comparison is exact:

* the mesh (coordinates, hops, adjacency, tiers, ``layout()``) and the
  tiered prices on every tier, for full and reduced qwen3-14b, bf16 and
  int8, a zero-bandwidth tier pricing at infinity;
* the planner, region and controller cases of ``tests/test_cluster.py``,
  each run through both packages on the protocol fakes of
  ``fake_fleet.py``: the same plans, counters and hints, and the
  reference's own claims on the port's result;
* the vec ``ClusterEngine`` (``params=None``): bit-identical summaries
  and event streams on the variants of ``benchmarks/fleet_bench.py``'s
  cluster sweep, with leases, with a quarantine group, and on the
  configuration ``chip_smoke.py``'s cluster phase serves at full width;
* the object ``ClusterEngine`` on reduced qwen3-14b in float32 (tokens
  compared exactly; bf16 tokens drift with batch composition in the
  reference itself), kv_quant off and on: the only tests here that run a
  model in JAX.
"""
import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from hypothesis import given, settings, strategies as st  # noqa: E402

from fake_fleet import FakeGroup, all_requests  # noqa: E402
import repro.cluster as JCL  # noqa: E402
import repro.configs as JCFG  # noqa: E402
import repro.configs.base as JB  # noqa: E402
import repro.control as JC  # noqa: E402
import repro.fleet as JF  # noqa: E402
import repro.serve.engine as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.cluster as PCL  # noqa: E402
import repro_torch.configs as PCFG  # noqa: E402
import repro_torch.configs.base as PB  # noqa: E402
import repro_torch.control as PC  # noqa: E402
import repro_torch.fleet as PF  # noqa: E402
import repro_torch.serve.engine as PS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.fleet.migrate import LIVE  # noqa: E402
from repro_torch.launch import serve_cluster  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

J = types.SimpleNamespace(CL=JCL, CFG=JCFG, B=JB, C=JC, F=JF, S=JS, T=JT)
P = types.SimpleNamespace(CL=PCL, CFG=PCFG, B=PB, C=PC, F=PF, S=PS, T=PT)
AMOEBA = dict(split_threshold=0.3, fuse_threshold=0.05, min_phase_steps=2)
# no deadline: a busy test worker must not fail a property on the clock
PROPERTY = settings(deadline=None, derandomize=True, database=None,
                    max_examples=60)


def both(fn):
    """``fn`` through the reference and the port; asserts equal results
    and returns the port's."""
    want, got = fn(J), fn(P)
    assert got == want
    return got


def model_cfg(K, reduced=True):
    return K.CFG.get_config("qwen3-14b", reduced=reduced)


def req(K, rid, tokens, generated=0, plen=4):
    r = K.S.Request(rid, [1] * plen, tokens)
    r.generated = [0] * generated
    return r


def fake(K, gid, topology, queue=(), parts=None):
    g = FakeGroup(gid, topology, queue=queue, parts=parts)
    g.stats = K.S.ServeStats()
    return g


class RegionGroup(FakeGroup):
    """FakeGroup plus the GroupController surface regions drive."""

    def __init__(self, K, gid, topology, queue=(), parts=None, capacity=4,
                 max_ways=2):
        super().__init__(gid, topology, queue=queue, parts=parts)
        self.stats = K.S.ServeStats()
        self.controller = K.C.GroupController(
            K.C.ThresholdPolicy(0.95, 0.0),
            K.C.ConfigSpace(capacity, max_ways=max_ways), dwell=1)


def mesh4(K):
    return K.CL.ClusterMesh(num_groups=4, groups_per_chip=2)


def cplanner(K, ccfg=None, mesh=None, **kw):
    mesh = mesh or mesh4(K)
    kw.setdefault("enabled", True)
    ccfg = ccfg or K.B.ClusterConfig(groups_per_chip=mesh.groups_per_chip)
    cfg = K.B.MigrationConfig(**kw)
    cost = K.CL.TieredTransferCost.from_config(
        mesh, ccfg, dtype_bytes=cfg.kv_dtype_bytes,
        quantized=cfg.quantized_kv)
    return K.CL.ClusterPlanner(cfg, model_cfg(K), mesh=mesh, cost=cost,
                               ccfg=ccfg, long_threshold=24, window=256)


def plan_rows(plans):
    return [(m.kind, m.request.rid, tuple(m.src), tuple(m.dst), m.stall,
             m.gain) for m in plans]


def planner_state(p, groups):
    return dict(summary=p.summary(),
                in_flight=sorted(r.rid for r in p.in_flight_requests()),
                next_arrival=p.next_arrival(),
                stats=[dataclasses.asdict(g.stats) for g in groups],
                placed=sorted(r.rid for r in all_requests(groups)))


# -- mesh geometry -------------------------------------------------------------

MESHES = [(1, 1, None), (4, 2, None), (5, 4, None), (8, 4, 1), (8, 4, None),
          (9, 3, 2), (16, 4, 2), (12, 5, None)]


def mesh_view(K, n, gpc, cpn):
    m = K.CL.ClusterMesh(num_groups=n, groups_per_chip=gpc,
                         chips_per_node=cpn)
    pairs = [(a, b) for a in range(n) for b in range(n)]
    return dict(chips=m.num_chips, nodes=m.num_nodes,
                chip_of=[m.chip_of(g) for g in range(n)],
                node_of=[m.node_of(c) for c in range(m.num_chips)],
                chip_groups=[m.chip_groups(c) for c in range(m.num_chips)],
                coord=[m.coord(g) for g in range(n)],
                hops=[m.hops(a, b) for a, b in pairs],
                adjacent=[m.adjacent(a, b) for a, b in pairs],
                tier=[m.tier(a, b) for a, b in pairs],
                layout=m.layout(), describe=m.describe())


@pytest.mark.parametrize("n,gpc,cpn", MESHES)
def test_mesh_geometry_identical(n, gpc, cpn):
    v = both(lambda K: mesh_view(K, n, gpc, cpn))
    assert len(set(v["coord"])) == n
    assert PCL.TIERS == JCL.TIERS == ("noc", "link", "net")


@PROPERTY
@given(n=st.integers(1, 24), gpc=st.integers(1, 6),
       cpn=st.one_of(st.none(), st.integers(1, 3)))
def test_mesh_geometry_identical_property(n, gpc, cpn):
    v = both(lambda K: mesh_view(K, n, gpc, cpn))
    hops = np.array(v["hops"]).reshape(n, n)
    assert (hops == hops.T).all() and (np.diag(hops) == 0).all()


def test_mesh_validation_and_bounds():
    for K in (J, P):
        with pytest.raises(ValueError):
            K.CL.ClusterMesh(num_groups=0, groups_per_chip=2)
        with pytest.raises(ValueError):
            K.CL.ClusterMesh(num_groups=4, groups_per_chip=2,
                             chips_per_node=0)
        with pytest.raises(IndexError):
            K.CL.ClusterMesh(num_groups=8, groups_per_chip=4).coord(8)


# -- tiered transfer cost ------------------------------------------------------

TIER_CFGS = [
    dict(),                                             # ClusterConfig's
    dict(noc_bandwidth=1e9, noc_latency=0.0, link_bandwidth=100.0,
         link_latency=2.0, net_bandwidth=50.0, net_latency=4.0),
    dict(link_bandwidth=256.0, link_latency=12.0, net_bandwidth=64.0,
         net_latency=24.0),                             # fleet_bench's sweep
    dict(link_bandwidth=0.0, net_bandwidth=0.0),        # dead inter-chip
    dict(noc_bandwidth=0.0),                            # dead NoC
]


def prices(K, reduced, quantized, tiers):
    cfg = model_cfg(K, reduced)
    mesh = K.CL.ClusterMesh(num_groups=8, groups_per_chip=4,
                            chips_per_node=1)
    ccfg = K.B.ClusterConfig(groups_per_chip=4, chips_per_node=1, **tiers)
    c = K.CL.TieredTransferCost.from_config(mesh, ccfg, dtype_bytes=2,
                                            quantized=quantized)
    pairs = [(0, 0), (0, 1), (0, 3), (0, 4), (3, 4), (0, 7), (None, None),
             (0, None)]
    out = []
    for src, dst in pairs:
        for seq in (1, 17, 256, 2048):
            for window in (None, 256, 2304):
                out.append(c.stall_ticks(seq, cfg, window, src=src, dst=dst))
        for nbytes in (0, 16, 1000, 10**6, 10**9):
            out.append(c.transfer_ticks(nbytes, src, dst))
        for plen in (0, 4, 512):
            out.append(c.steal_ticks(plen, src, dst))
    return [str(x) for x in out]          # inf == inf, but keep repr exact


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("tiers", range(len(TIER_CFGS)))
def test_tiered_prices_identical(reduced, quantized, tiers):
    got = both(lambda K: prices(K, reduced, quantized, TIER_CFGS[tiers]))
    # a zero-bandwidth tier (the last two) prices at infinity
    assert ("inf" in got) == (tiers >= 3)


def test_tier_pricing_orders_by_distance_and_vetoes_dead_tiers():
    def run(K):
        m = K.CL.ClusterMesh(num_groups=8, groups_per_chip=4,
                             chips_per_node=1)
        c = K.CL.TieredTransferCost(mesh=m, noc_bandwidth=1e9,
                                    noc_latency=0.0, link_bandwidth=100.0,
                                    link_latency=2.0, net_bandwidth=50.0,
                                    net_latency=4.0)
        m4 = K.CL.ClusterMesh(num_groups=4, groups_per_chip=2)
        dead = K.CL.TieredTransferCost(mesh=m4, noc_bandwidth=4e9,
                                       link_bandwidth=0.0, net_bandwidth=0.0)
        flat = K.CL.TieredTransferCost(mesh=m4, link_bandwidth=100.0)
        dust = K.CL.TieredTransferCost(mesh=m4, link_bandwidth=2e8,
                                       link_latency=1.0)
        steal = K.CL.TieredTransferCost(mesh=m4, link_bandwidth=8.0,
                                        link_latency=0.0)
        return dict(
            noc=c.transfer_ticks(1000, 0, 1), net=c.transfer_ticks(1000, 0, 4),
            self_=c.transfer_ticks(1000, 3, 3),
            far=c.transfer_ticks(1000, 0, 7), near=c.transfer_ticks(1000, 3, 4),
            dead_link=dead.transfer_ticks(100, 0, 2),
            dead_noc=dead.transfer_ticks(100, 0, 1),
            dead_stall=dead.stall_ticks(16, model_cfg(K), src=0, dst=2),
            flat=flat.transfer_ticks(1000, None, None),
            dead_flat=dead.transfer_ticks(1000, None, None),
            dust=dust.transfer_ticks(16, 0, 2),
            steal_far=steal.steal_ticks(4, 0, 2),
            steal_near=steal.steal_ticks(4, 0, 1))
    v = both(run)
    assert v["noc"] == 0 and v["self_"] == 0.0
    assert v["net"] >= 4 + 1000 / 50.0 - 1 and v["far"] > v["near"]
    assert math.isinf(v["dead_link"]) and v["dead_noc"] == 0
    assert math.isinf(v["dead_stall"]) and math.isinf(v["dead_flat"])
    assert v["flat"] == 10 and v["dust"] == 2
    assert v["steal_far"] == 2 and v["steal_near"] == 0


# -- planner: chip-first stealing ----------------------------------------------

def test_steals_resolve_on_chip_first_then_amortized_residual_crosses():
    def run(K):
        groups = [fake(K, 0, (4,), queue=[req(K, i, 4) for i in range(6)]),
                  fake(K, 1, (4,)), fake(K, 2, (4,)), fake(K, 3, (4,))]
        p = cplanner(K, steal_threshold=1, max_steals=2)
        plans = p.plan(0, groups)
        rows = plan_rows(plans)
        done = p.execute(plans, groups, now=0)
        mid = planner_state(p, groups)
        t = p.next_arrival()
        early = p.deliver_in_flight(t - 1, groups)
        landed = p.deliver_in_flight(t, groups)
        return dict(rows=rows, done=done, mid=mid, t=t, early=early,
                    landed=landed, end=planner_state(p, groups))
    v = both(run)
    intra = [r for r in v["rows"] if r[3][0] == 1]
    cross = [r for r in v["rows"] if r[3][0] in (2, 3)]
    assert len(intra) == 2 and len(cross) == 2
    assert all(r[5] > 0 and r[4] > 0 for r in cross)
    s = v["mid"]["summary"]
    assert v["done"] == 4 and s["intra_chip_steals"] == 2
    assert s["cross_chip_steals"] == 2 and len(v["mid"]["in_flight"]) == 2
    assert s["tier_bytes"]["noc"] > 0 and s["tier_bytes"]["link"] > 0
    assert sorted(v["mid"]["placed"] + v["mid"]["in_flight"]) == list(range(6))
    assert v["t"] > 0 and v["early"] == 0 and v["landed"] == 2
    assert v["end"]["next_arrival"] is None
    assert v["end"]["placed"] == list(range(6))


def _steal_case(K, ccfg_kw, n_queue=6, mate=None, **kw):
    ccfg = K.B.ClusterConfig(groups_per_chip=2, **ccfg_kw)
    groups = [fake(K, 0, (4,), queue=[req(K, i, 4) for i in range(n_queue)]),
              mate(K) if mate else fake(K, 1, (4,)),
              fake(K, 2, (4,)), fake(K, 3, (4,))]
    p = cplanner(K, ccfg=ccfg, steal_threshold=1, max_steals=2, **kw)
    plans = p.plan(0, groups)
    rows = plan_rows(plans)
    done = p.execute(plans, groups, now=0)
    return dict(rows=rows, done=done, state=planner_state(p, groups),
                donor_queue=len(groups[0].queue))


def test_zero_interchip_bandwidth_vetoes_crossings_but_noc_flows():
    v = both(lambda K: _steal_case(K, dict(link_bandwidth=0.0,
                                           net_bandwidth=0.0)))
    s = v["state"]["summary"]
    assert v["rows"] and all(r[3][0] == 1 for r in v["rows"])
    assert s["vetoed_cross_chip"] > 0 and v["done"] == len(v["rows"])
    assert s["intra_chip_steals"] == 2 and s["cross_chip_steals"] == 0
    assert v["state"]["in_flight"] == []


def test_cross_steal_budget_caps_crossings():
    v = both(lambda K: _steal_case(K, dict(max_cross_steals=1), n_queue=8))
    assert sum(r[3][0] in (2, 3) for r in v["rows"]) == 1


def _busy_mate(K):
    return fake(K, 1, (1,), parts=[[req(K, 8, 9)]])


def test_distance_blind_planning_pays_tiered_prices_at_execution():
    v = both(lambda K: _steal_case(K, dict(distance_blind=True),
                                   mate=_busy_mate))
    s = v["state"]["summary"]
    assert v["rows"] and all(r[3][0] in (2, 3) for r in v["rows"])
    assert all(r[4] == 0 for r in v["rows"])          # planned flat
    assert s["cross_chip_steals"] == v["done"] == len(v["rows"])
    assert len(v["state"]["in_flight"]) == len(v["rows"])
    assert v["state"]["next_arrival"] > 0


def test_blind_plan_across_dead_link_is_dropped_not_teleported():
    v = both(lambda K: _steal_case(
        K, dict(distance_blind=True, link_bandwidth=0.0, net_bandwidth=0.0),
        mate=_busy_mate))
    assert v["rows"] and all(r[3][0] in (2, 3) for r in v["rows"])
    assert v["done"] == 0
    assert v["state"]["summary"]["dropped_unreachable"] == len(v["rows"])
    assert v["donor_queue"] == 6
    assert v["state"]["placed"] == [0, 1, 2, 3, 4, 5, 8]


def test_live_migration_prefers_the_noc_destination():
    def run(K):
        lives = [req(K, 0, 60, generated=1), req(K, 1, 3, generated=1),
                 req(K, 2, 3, generated=1), req(K, 3, 3, generated=1)]
        groups = [fake(K, 0, (4,), parts=[lives]), fake(K, 1, (2, 2)),
                  fake(K, 2, (1,), parts=[[req(K, 9, 5)]]),
                  fake(K, 3, (2, 2))]
        p = cplanner(K, live=True, min_gain=0.02)
        plans = [m for m in p.plan(0, groups) if m.kind == LIVE]
        rows = plan_rows(plans)
        return dict(rows=rows, done=p.execute(plans, groups, now=0),
                    state=planner_state(p, groups))
    v = both(run)
    assert len(v["rows"]) == 1
    assert v["rows"][0][3][0] == 1 and v["rows"][0][4] == 0
    s = v["state"]["summary"]
    assert v["done"] == 1 and s["intra_chip_live"] == 1
    assert s["cross_chip_live"] == 0


def test_region_groups_are_boosted_steal_recipients():
    def run(K):
        groups = [fake(K, 0, (4,), queue=[req(K, i, 40) for i in range(4)]),
                  fake(K, 1, (4,)), fake(K, 2, (2, 2))]
        p = cplanner(K, mesh=K.CL.ClusterMesh(num_groups=3,
                                              groups_per_chip=3),
                     ccfg=K.B.ClusterConfig(groups_per_chip=3),
                     steal_threshold=1, max_steals=2)
        base = plan_rows(p.plan(0, groups))
        p.set_regions([2])
        return dict(base=base, boosted=plan_rows(p.plan(1, groups)))
    v = both(run)
    assert v["base"] and all(r[3][0] == 1 for r in v["base"])
    assert v["boosted"] and all(r[3][0] == 2 for r in v["boosted"])


# -- region gather -------------------------------------------------------------

def region_fleet(K, long_tokens=60):
    return [RegionGroup(K, 0, (4,),
                        parts=[[req(K, 0, long_tokens, generated=1)]]),
            RegionGroup(K, 1, (4,),
                        parts=[[req(K, 1, long_tokens, generated=1)]]),
            RegionGroup(K, 2, (4,)), RegionGroup(K, 3, (4,))]


def hints(groups):
    return [g.controller._hint for g in groups]


def test_region_gathers_deepens_and_releases():
    def run(K):
        ccfg = K.B.ClusterConfig(groups_per_chip=2, region_dwell=4,
                                 region_long_frac=0.5,
                                 region_release_frac=0.2)
        rm = K.CL.RegionManager(mesh4(K), ccfg, long_threshold=24)
        groups = region_fleet(K)
        out = dict(deep=K.CL.RegionManager.deep_topology(
            groups[0].controller.space))
        out["open"] = rm.step(0, groups, {0: 0.9, 1: 0.0})
        out["after_open"] = (sorted(rm.region_groups()), hints(groups),
                             rm.summary())
        out["held"] = rm.step(2, groups, {0: 0.0})
        out["after_held"] = sorted(rm.region_groups())
        out["release"] = rm.step(6, groups, {0: 0.0})
        out["after_release"] = (sorted(rm.region_groups()), hints(groups),
                                rm.summary())
        return out
    v = both(run)
    assert v["deep"] == (2, 2) and v["open"] > 0
    groups_, h, summ = v["after_open"]
    assert groups_ == [0, 1] and h[:3] == [(2, 2), (2, 2), None]
    assert summ == {"gathered": 1, "released": 0, "active": [[0, 1]]}
    assert v["held"] >= 0 and v["after_held"] == [0, 1]
    groups_, h, summ = v["after_release"]
    assert groups_ == [] and summ["released"] == 1 and h[0] == (4,)


def test_region_reasserts_deep_hint_and_excludes_quarantine():
    def run(K):
        ccfg = K.B.ClusterConfig(groups_per_chip=2, region_dwell=4)
        rm = K.CL.RegionManager(mesh4(K), ccfg, long_threshold=24)
        groups = region_fleet(K)
        rm.step(0, groups, {0: 0.9})
        groups[0].controller._hint = None        # a later mix nudge
        again = rm.step(1, groups, {0: 0.9})
        q = K.CL.RegionManager(mesh4(K), K.B.ClusterConfig(
            groups_per_chip=2, region_max_groups=2), long_threshold=24)
        q.step(0, region_fleet(K), {0: 0.9}, quarantine=0)
        cold = K.CL.RegionManager(mesh4(K), K.B.ClusterConfig(
            groups_per_chip=2), long_threshold=24)
        idle = [RegionGroup(K, i, (4,)) for i in range(4)]
        return dict(again=again, hint=groups[0].controller._hint,
                    quarantined=sorted(q.region_groups()),
                    cold=cold.step(0, idle, {0: 0.9, 1: 0.9}),
                    cold_groups=sorted(cold.region_groups()))
    v = both(run)
    assert v["again"] > 0 and v["hint"] == (2, 2)
    assert v["quarantined"] == [1]
    assert v["cold"] == 0 and v["cold_groups"] == []


# -- cluster controller --------------------------------------------------------

def controller(K, num_groups=4, groups_per_chip=2, quarantine=None,
               rebalance_every=4, region_gather=False):
    mesh = K.CL.ClusterMesh(num_groups=num_groups,
                            groups_per_chip=groups_per_chip)
    ccfg = K.B.ClusterConfig(groups_per_chip=groups_per_chip,
                             region_gather=region_gather)
    fleet = K.B.FleetConfig(num_groups=num_groups, capacity=4,
                            mode="dynamic", rebalance_every=rebalance_every,
                            quarantine_group=quarantine,
                            migrate=K.B.MigrationConfig(enabled=True),
                            amoeba=K.B.AmoebaConfig(**AMOEBA))
    return K.CL.ClusterController(mesh, ccfg, fleet, model_cfg(K))


def test_controller_gates_on_cadence_and_tracks_chip_pressure():
    def run(K):
        cc = controller(K)
        idle = [RegionGroup(K, i, (4,)) for i in range(4)]
        cc.rebalance(1, idle)
        gated = (cc.planner.plan_ticks, dict(cc.chip_pressure))
        cc.rebalance(4, idle)
        ticked = (cc.planner.plan_ticks, sorted(cc.chip_pressure))
        hot = controller(K)
        groups = [RegionGroup(K, 0, (4,),
                              queue=[req(K, i, 40) for i in range(6)],
                              parts=[[req(K, 10, 60, generated=1)]]),
                  RegionGroup(K, 1, (4,),
                              parts=[[req(K, 11, 60, generated=1)]]),
                  RegionGroup(K, 2, (4,)), RegionGroup(K, 3, (4,))]
        issued = hot.rebalance(0, groups)
        return dict(gated=gated, ticked=ticked, issued=issued,
                    pressure={c: p.as_dict()
                              for c, p in hot.chip_pressure.items()},
                    plans=plan_rows(hot.take_plans()), hints=hints(groups))
    v = both(run)
    assert v["gated"] == (0, {}) and v["ticked"] == (1, [0, 1])
    p0, p1 = v["pressure"][0], v["pressure"][1]
    assert p0["queue_frac"] > p1["queue_frac"]
    assert p0["long_frac"] > p1["long_frac"] == 0.0


def test_controller_quarantine_maps_to_the_owning_chip():
    def run(K):
        cc = controller(K, quarantine=2)
        groups = [RegionGroup(K, i, (4,)) for i in range(4)]
        groups[2].controller.state.topology = (3, 1)
        return ([c.quarantine for c in cc.chip_controllers],
                cc.reserved_parts(groups))
    assert both(run) == ([None, 0], {(2, 1)})


def test_cluster_summary_identical():
    def run(K):
        cc = controller(K, region_gather=True)
        groups = [RegionGroup(K, i, (4,)) for i in range(4)]
        cc.rebalance(0, groups)
        return cc.cluster_summary(groups)
    s = both(run)
    assert s["chips"] == 2 and s["groups_per_chip"] == 2
    assert s["nodes"] == 1 and s["distance_blind"] is False
    assert set(s["tier_bytes"]) == {"noc", "link", "net"}
    assert "regions" in s and sorted(s["chip_pressure"]) == ["0", "1"]


def test_cluster_engine_requires_dynamic_migrating_fleet():
    for K in (J, P):
        with pytest.raises(ValueError, match="dynamic"):
            K.CL.ClusterEngine(model_cfg(K), None, fleet=K.B.FleetConfig(
                num_groups=4, capacity=4, mode="fused",
                amoeba=K.B.AmoebaConfig(**AMOEBA)))


# -- engine, vec: bit-identical summaries and event streams --------------------

# fleet_bench's cluster sweep: slow high-latency links under a near-free NoC
SWEEP = dict(noc_bandwidth=4e9, noc_latency=0.0, link_bandwidth=256.0,
             link_latency=12.0, net_bandwidth=64.0, net_latency=24.0,
             max_cross_steals=4)
VEC_CASES = {
    "hierarchical": dict(tiers=SWEEP),
    "flat_blind": dict(tiers=dict(SWEEP, distance_blind=True)),
    "zero_interchip": dict(tiers=dict(SWEEP, link_bandwidth=0.0,
                                      net_bandwidth=0.0)),
    "default_tiers": dict(tiers={}, live=False, window=64, horizon=30,
                          seed=11),
    "leases": dict(tiers={}, lease=True),
    "quarantine": dict(tiers={}, quarantine=2, router="length_aware"),
    # chip_smoke.py's cluster phase: full-width qwen3-14b, int8 KV pricing
    "chip_smoke": dict(tiers={}, lease=True, quantized=True, reduced=False,
                       capacity=8, horizon=24, seed=19),
}


def cluster_fleet(K, tiers, live=True, lease=False, quantized=False,
                  quarantine=None, router="sticky", capacity=4, window=256,
                  engine="vec", obs="full", policy="threshold", **_):
    return K.B.FleetConfig(
        num_groups=4, capacity=capacity, window=window, router=router,
        mode="dynamic", engine=engine, rebalance_every=4,
        quarantine_group=quarantine,
        migrate=K.B.MigrationConfig(enabled=True, live=live,
                                    quantized_kv=quantized),
        lease=K.B.LeaseConfig(enabled=lease),
        amoeba=K.B.AmoebaConfig(**AMOEBA, policy=policy),
        cluster=K.B.ClusterConfig(groups_per_chip=2, **tiers), obs=obs)


def scrub(summary):
    s = dict(summary)
    s.pop("wall_s")
    s.pop("ticks_per_sec")
    return s


def vec_run(K, case):
    kw = VEC_CASES[case]
    cfg = model_cfg(K, kw.get("reduced", True))
    eng = K.CL.ClusterEngine(cfg, None, fleet=cluster_fleet(K, **kw))
    eng.submit(K.F.multichip_imbalanced_trace(
        kw.get("horizon", 40), cfg.vocab_size, seed=kw.get("seed", 0),
        chips=2, groups_per_chip=2))
    s = eng.run()
    eng._vec.check(eng.groups)
    assert eng.planner.in_flight_requests() == []
    return eng, scrub(s)


@pytest.mark.parametrize("case", sorted(VEC_CASES))
def test_vec_cluster_engine_identical(case):
    je, want = vec_run(J, case)
    pe, got = vec_run(P, case)
    assert got == want
    ev_j = [e.as_dict() for e in je.obs.events()]
    ev_p = [e.as_dict() for e in pe.obs.events()]
    assert ev_p == ev_j and len(ev_j) > 0
    assert pe.obs.meta == je.obs.meta
    assert pe.obs.meta["mesh"] == pe.mesh.layout()
    assert got["completed"] == got["submitted"] > 0
    mig, cl = got["migration"], got["cluster"]
    assert mig["steals"] == mig["intra_chip_steals"] + mig["cross_chip_steals"]
    assert mig["intra_chip_steals"] > 0          # chip-first stealing runs
    if case == "zero_interchip":
        assert mig["cross_chip_steals"] == mig["cross_chip_live"] == 0
        assert cl["tier_bytes"]["link"] == 0
    else:
        assert mig["cross_chip_steals"] > 0
    if case == "chip_smoke":
        assert mig["intra_chip_live"] >= 1 and mig["cross_chip_live"] >= 1
        assert cl["regions"]["gathered"] >= 1 and got["lease"]["grants"] >= 1


def test_vec_cluster_off_and_observed_summaries_agree():
    """Turning observability on must not perturb the cluster run."""
    def run(K, obs):
        cfg = model_cfg(K)
        eng = K.CL.ClusterEngine(cfg, None, fleet=cluster_fleet(
            K, {}, obs=obs))
        eng.submit(K.F.multichip_imbalanced_trace(
            40, cfg.vocab_size, seed=5, chips=2, groups_per_chip=2))
        return scrub(eng.run())
    full = run(P, "full")
    full.pop("obs")
    assert run(P, "off") == full == run(J, "off")


# -- engine, object: reduced qwen3-14b in float32, same weights ----------------

@pytest.fixture(scope="module")
def models():
    jc = model_cfg(J).replace(dtype="float32")
    pc = model_cfg(P).replace(dtype="float32")
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, pc, pp


def object_trace(K, cfg):
    # a short chip-skewed trace on which the cluster steals on-chip and
    # across chips (in flight), live-migrates once, gathers a region and
    # grants leases (found with the vec engine, which plans the same)
    return K.F.multichip_imbalanced_trace(6, cfg.vocab_size, seed=13,
                                          chips=2, groups_per_chip=2)


def object_run(K, cfg, params, kv_quant):
    trace = object_trace(K, cfg)
    rt = K.T.Runtime(kv_quant=kv_quant) if K is P else \
        K.T.Runtime(production=False, remat=False, kv_quant=kv_quant)
    fc = cluster_fleet(K, {}, lease=True, quantized=kv_quant, window=64,
                       engine="object")
    eng = K.CL.ClusterEngine(cfg, params, rt=rt, fleet=fc)
    eng.submit(trace)
    s = scrub(eng.run())
    assert eng.planner.in_flight_requests() == []
    tokens = {r.rid: (tuple(r.generated), r.finish) for r in trace}
    groups = [dataclasses.asdict(g.stats) for g in eng.groups]
    events = [e.as_dict() for e in eng.obs.events()]
    return s, tokens, groups, events


@pytest.mark.parametrize("kv_quant", [False, True])
def test_object_cluster_engine_matches_reference(models, kv_quant):
    jc, jp, pc, pp = models
    want = object_run(J, jc, jp, kv_quant)
    got = object_run(P, pc, pp, kv_quant)
    assert got[0] == want[0]            # summary: cluster block included
    assert got[1] == want[1]            # tokens and finish tick per request
    assert got[2] == want[2]            # ServeStats of every group
    assert got[3] == want[3]            # the event stream
    s, tokens = got[0], got[1]
    trace = object_trace(P, pc)
    assert s["completed"] == s["submitted"] == len(tokens) == len(trace)
    assert all(len(tokens[r.rid][0]) == r.max_new_tokens for r in trace)
    mig = s["migration"]
    assert mig["intra_chip_steals"] >= 1 and mig["cross_chip_steals"] >= 1
    assert mig["live_migrations"] >= 1 and s["lease"]["grants"] >= 1
    assert s["cluster"]["regions"]["gathered"] >= 1
    # what chip_smoke.py relies on: the port's vec engine predicts the
    # object engine's run exactly, without a model
    vec = PCL.ClusterEngine(pc, None, fleet=cluster_fleet(
        P, {}, lease=True, quantized=kv_quant, window=64))
    vec.submit(object_trace(P, pc))
    assert scrub(vec.run()) == s
    assert [e.as_dict() for e in vec.obs.events()] == got[3]


# -- the launcher ----------------------------------------------------------------

def test_serve_cluster_launcher_runs_on_cpu(capsys):
    serve_cluster.main(["--device", "cpu", "--horizon", "6",
                        "--capacity", "4", "--kv-quant"])
    out = capsys.readouterr().out
    assert "chip 0 (node 0)" in out and "chip 1 (node 0)" in out
    assert "cross-chip stall = inf" in out
    assert "flat_blind" in out and "hierarchical" in out
    assert out.strip().endswith("device: cpu")


def test_serve_cluster_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cluster.main(["--horizon", "6"])
