"""repro_torch.fleet against repro.fleet: same traces, same plans, same runs.

The fleet's control plane is numpy and plain Python in both packages, so
the comparison is exact wherever no model runs:

* every trace generator returns identical requests (same numpy calls in
  the same order);
* ``KVTransferCost`` prices every config, full and reduced, bf16 and
  int8, to the same bytes and stall ticks;
* the vec engine (``params=None``) gives bit-identical summaries and
  event streams across the cases of ``tests/test_vec_equivalence.py``,
  ``obs/metrics`` snapshots included.

Where the model runs (the object engine, ``replay_modes``), both packages
decode reduced qwen3-14b in float32 with the same weights, and tokens,
summaries and counters must be identical (bf16 tokens drift with batch
composition in the reference itself, ROADMAP queue 3).  The serve-level
predictor is trained by two gradient-descent implementations, so its
coefficients agree within 1e-3 (as ``tests/test_torch_control.py``)
and its decisions on the corpus exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.configs as JCFG  # noqa: E402
import repro.configs.base as JB  # noqa: E402
import repro.control as JC  # noqa: E402
import repro.core.predictor as JP  # noqa: E402
import repro.fleet as JF  # noqa: E402
from repro.fleet import migrate as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.configs as PCFG  # noqa: E402
import repro_torch.configs.base as PB  # noqa: E402
import repro_torch.control as PC  # noqa: E402
import repro_torch.core.predictor as PP  # noqa: E402
import repro_torch.fleet as PF  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.fleet import migrate as PM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as PQ  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

AMOEBA = dict(split_threshold=0.3, fuse_threshold=0.05, min_phase_steps=2)


def _req_tuple(r):
    return (r.rid, tuple(r.prompt), r.max_new_tokens, r.tenant, r.arrival,
            r.shard)


def _profiles(mod):
    return [mod.TenantProfile("short", rate=1.2, length_dist="uniform",
                              mean_tokens=6, min_tokens=2, max_tokens=10,
                              prompt_lengths=(8,)),
            mod.TenantProfile("long", rate=0.4, length_dist="uniform",
                              mean_tokens=32, min_tokens=24, max_tokens=40,
                              prompt_lengths=(16,))]


# trace name -> a call of that generator, given either package's fleet
TRACES = {
    "make_trace": lambda F: F.make_trace(_profiles(F), 30, 512, seed=3),
    "make_trace_lognormal": lambda F: F.make_trace(
        [F.TenantProfile("t", rate=0.8, length_dist="lognormal",
                         burst_factor=3.0, burst_period=20, shard=1)],
        60, 512, seed=4),
    "poisson": lambda F: F.poisson_trace(0.7, 40, 512, seed=1),
    "bursty_longtail": lambda F: F.bursty_longtail_trace(120, 512, seed=2),
    "skewed_longtail": lambda F: F.skewed_longtail_trace(60, 512, seed=7),
    "imbalanced": lambda F: F.imbalanced_trace(40, 512, seed=5, shards=3),
    "transient_burst": lambda F: F.transient_burst_trace(
        48, 512, seed=5, shards=2, burst_len=16),
    "multichip_imbalanced": lambda F: F.multichip_imbalanced_trace(
        30, 512, seed=11, chips=2, groups_per_chip=2),
    "uniform": lambda F: F.uniform_trace(0.9, 30, 512, seed=6),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_functions_return_identical_requests(name):
    want = [_req_tuple(r) for r in TRACES[name](JF)]
    got = [_req_tuple(r) for r in TRACES[name](PF)]
    assert got == want and len(want) > 0


@pytest.mark.parametrize("arch", JCFG.ARCH_IDS)
def test_kv_transfer_cost_matches(arch):
    for reduced in (False, True):
        jc = JCFG.get_config(arch, reduced=reduced)
        pc = PCFG.get_config(arch, reduced=reduced)
        for quantized in (False, True):
            for bw in (0.0, 1e8, 4e9):
                jk = JM.KVTransferCost(link_bandwidth=bw, quantized=quantized)
                pk = PM.KVTransferCost(link_bandwidth=bw, quantized=quantized)
                for seq in (1, 17, 512, 4096):
                    for window in (None, 256, 2304):
                        assert pk.kv_bytes(seq, pc, window) == \
                            jk.kv_bytes(seq, jc, window)
                        assert pk.stall_ticks(seq, pc, window) == \
                            jk.stall_ticks(seq, jc, window)


def test_int8_wire_constants_match_the_reference():
    from repro.kernels import quantize as JQ
    assert (PQ.INT8_CODE_BYTES, PQ.INT8_SCALE_BYTES) == \
        (JQ.INT8_CODE_BYTES, JQ.INT8_SCALE_BYTES) == (1, 4)


# -- vec engine: bit-identical summaries and events ----------------------------

def _fleet_cases(B):
    am = B.AmoebaConfig(**AMOEBA)
    return {
        "static_fused": B.FleetConfig(num_groups=2, capacity=4, window=64,
                                      mode="fused", amoeba=am),
        "static_split_rr": B.FleetConfig(num_groups=2, capacity=4, window=64,
                                         mode="split", router="round_robin",
                                         amoeba=am),
        "dynamic_least_loaded": B.FleetConfig(num_groups=2, capacity=4,
                                              window=64, mode="dynamic",
                                              amoeba=am),
        "dynamic_length_aware_mix": B.FleetConfig(
            num_groups=3, capacity=4, window=64, mode="dynamic",
            router="length_aware", rebalance_every=8, amoeba=am),
        "dynamic_hetero": B.FleetConfig(
            num_groups=2, capacity=6, window=64, mode="dynamic",
            router="length_aware",
            amoeba=am.replace(hetero=True, max_ways=3)),
        "migration_sticky": B.FleetConfig(
            num_groups=2, capacity=4, window=64, mode="dynamic",
            router="sticky", migrate=B.MigrationConfig(enabled=True),
            amoeba=am),
        "quarantine": B.FleetConfig(
            num_groups=2, capacity=4, window=64, mode="dynamic",
            router="length_aware", quarantine_group=0, amoeba=am),
        "lease_sticky": B.FleetConfig(
            num_groups=2, capacity=4, window=64, mode="dynamic",
            router="sticky", migrate=B.MigrationConfig(enabled=True),
            lease=B.LeaseConfig(enabled=True), amoeba=am),
    }


def _case_trace(F, case, vocab, groups):
    if case == "migration_sticky":
        return F.imbalanced_trace(40, vocab, seed=5, shards=groups)
    if case == "lease_sticky":
        return F.transient_burst_trace(48, vocab, seed=5, shards=groups,
                                       burst_len=16)
    return F.make_trace(_profiles(F), horizon=30, vocab_size=vocab, seed=3)


def _scrub(summary):
    s = dict(summary)
    s.pop("wall_s")
    s.pop("ticks_per_sec")
    return s


def _vec_run(F, B, CFG, case, obs="off", max_ticks=1_000_000):
    cfg = CFG.get_config("qwen3-14b", reduced=True)
    fc = _fleet_cases(B)[case].replace(engine="vec", obs=obs)
    eng = F.FleetEngine(cfg, None, fleet=fc)
    eng.submit(_case_trace(F, case, cfg.vocab_size, fc.num_groups))
    s = eng.run(max_ticks=max_ticks)
    eng._vec.check(eng.groups)
    return eng, s


@pytest.mark.parametrize("case", sorted(_fleet_cases(JB)))
def test_vec_summary_identical(case):
    _, want = _vec_run(JF, JB, JCFG, case)
    _, got = _vec_run(PF, PB, PCFG, case)
    assert _scrub(got) == _scrub(want)
    assert got["completed"] == got["submitted"] > 0


def test_vec_summary_identical_under_tick_cutoff():
    _, want = _vec_run(JF, JB, JCFG, "dynamic_least_loaded", max_ticks=25)
    _, got = _vec_run(PF, PB, PCFG, "dynamic_least_loaded", max_ticks=25)
    assert _scrub(got) == _scrub(want)
    assert got["completed"] < got["submitted"]


@pytest.mark.parametrize("case", ["migration_sticky", "lease_sticky"])
def test_vec_event_streams_and_metrics_identical(case):
    """obs='full': the same events in the same order, and the same
    per-tick metrics snapshot (``obs/metrics``)."""
    je, want = _vec_run(JF, JB, JCFG, case, obs="full")
    pe, got = _vec_run(PF, PB, PCFG, case, obs="full")
    ev_j = [e.as_dict() for e in je.obs.events()]
    ev_p = [e.as_dict() for e in pe.obs.events()]
    assert ev_p == ev_j and len(ev_j) > 0
    assert got["obs"]["metrics"] == want["obs"]["metrics"]
    assert pe._metrics.snapshot() == je._metrics.snapshot()
    assert _scrub(got) == _scrub(want)


# -- object engine: reduced qwen3-14b in float32, same weights -----------------

@pytest.fixture(scope="module")
def models():
    jc = JCFG.get_config("qwen3-14b", reduced=True).replace(dtype="float32")
    pc = PCFG.get_config("qwen3-14b", reduced=True).replace(dtype="float32")
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, pc, pp


def _object_run(F, B, T, cfg, params, kv_quant):
    # a shard-skewed trace on which the planner steals, leases and makes
    # one live migration (found with the vec engine, which plans the same)
    trace = F.imbalanced_trace(8, cfg.vocab_size, seed=38, shards=2,
                               hot_rate=0.6, cold_rate=0.2)
    rt = T.Runtime(kv_quant=kv_quant) if T is PT else \
        T.Runtime(production=False, remat=False, kv_quant=kv_quant)
    fc = B.FleetConfig(
        num_groups=2, capacity=4, window=64, mode="dynamic",
        router="sticky", amoeba=B.AmoebaConfig(**AMOEBA),
        migrate=B.MigrationConfig(enabled=True, link_bandwidth=1e9,
                                  quantized_kv=kv_quant),
        lease=B.LeaseConfig(enabled=True))
    eng = F.FleetEngine(cfg, params, rt=rt, fleet=fc)
    eng.submit(trace)
    s = eng.run()
    tokens = {r.rid: (tuple(r.generated), r.finish) for r in trace}
    groups = [dataclasses.asdict(g.stats) for g in eng.groups]
    return _scrub(s), tokens, groups


@pytest.mark.parametrize("kv_quant", [False, True])
def test_object_engine_matches_reference(models, kv_quant):
    jc, jp, pc, pp = models
    want = _object_run(JF, JB, JT, jc, jp, kv_quant)
    got = _object_run(PF, PB, PT, pc, pp, kv_quant)
    assert got[0] == want[0]            # summary, counters included
    assert got[1] == want[1]            # tokens and finish tick per request
    assert got[2] == want[2]            # ServeStats of every group
    s = got[0]
    assert s["completed"] == s["submitted"] == len(got[1])
    assert s["migration"]["live_migrations"] >= 1
    assert s["migration"]["steals"] >= 1 and s["lease"]["grants"] >= 1


def test_replay_modes_matches_reference(models):
    jc, jp, pc, pp = models

    def run(F, B, T, cfg, params):
        rt = T.Runtime() if T is PT else T.Runtime(production=False,
                                                   remat=False)
        return F.replay_modes(
            cfg, params, rt,
            lambda: F.bursty_longtail_trace(10, cfg.vocab_size, seed=1,
                                            chat_rate=0.8),
            groups=2, capacity=4, amoeba=B.AmoebaConfig(**AMOEBA),
            window=64, verbose=False)

    want = run(JF, JB, JT, jc, jp)
    got = run(PF, PB, PT, pc, pp)
    assert list(got) == list(want) == [m[0] for m in PF.DEFAULT_MODES]
    for label in want:
        assert _scrub(got[label]) == _scrub(want[label]), label


# -- control/offline: the serve-level predictor ---------------------------------

def test_serve_corpus_identical_and_predictor_within_tolerance():
    kw = dict(n_samples=256, capacity=8, max_ways=2, seed=2)
    jX, jy = JC.build_serve_corpus(**kw)
    pX, py = PC.build_serve_corpus(**kw)
    np.testing.assert_array_equal(pX, jX)
    np.testing.assert_array_equal(py, jy)
    jm, _ = JC.train_serve_predictor(steps=300, **kw)
    pm, _ = PC.train_serve_predictor(steps=300, **kw)
    for a, b in zip(jm[:4], pm[:4]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-3)
    assert tuple(pm.feature_names) == tuple(jm.feature_names)
    jd = np.asarray(JP.predict_proba(jm, jX)) > 0.5
    pd = np.asarray(PP.predict_proba(pm, pX)) > 0.5
    np.testing.assert_array_equal(pd, jd)


# -- the int8 KV write path ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_kernel_path_equals_plain_on_cpu(dtype):
    """Under ``use_kernels`` the KV vectors go through the int8 stores of
    ``ops`` (on CPU tensors: their plain versions); codes and scales are
    the plain quantizer's at the KV floor exactly, and no launch is
    counted."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32) * 2
    x[0, 1, 2] = 0.0                    # an all-zero vector: the floor
    x[1, 3, 0] = 1e-10                  # amax between 1e-12 and 1e-8
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ops.reset_launches()
    # prefill: a ring as long as the prompt is the identity layout
    qk, _, sk, _ = ops.quantize_kv_prefill(xt, xt, W=7, floor=1e-8)
    qp, sp = PQ.quantize_int8_plain(xt, floor=1e-8)
    assert torch.equal(qk, qp) and torch.equal(sk, sp)
    # decode: position p of every batch row into slot p of a 7-slot ring
    kc, ks = torch.zeros_like(qp), torch.ones_like(sp)
    for p in range(7):
        ops.quantize_kv_store_(xt[:, p], xt[:, p], kc, kc.clone(), ks,
                               ks.clone(), torch.full((2,), p), W=7,
                               floor=1e-8)
    assert torch.equal(kc, qp) and torch.equal(ks, sp)
    assert ops.launches["quantize_int8"] == 0
    assert qk.shape == xt.shape and sk.shape == xt.shape[:-1] + (1,)
    assert float(sp[0, 1, 2, 0]) == np.float32(1e-8) / np.float32(127.0)
