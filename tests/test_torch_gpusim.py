"""The port's gpusim (``repro_torch.core.gpusim``) against the reference's.

Both simulators are numpy on the host and do the same operations in the
same order, so every ``SimResult`` field (the per-epoch pair-state trace
included), the profiling features, the workload variants, the chip-mix
ranking and the predictor corpus are equal exactly.  The one torch part is
the predictor fit of ``train_sim_predictor``: the port's float32 gradient
descent sums in another order than XLA's, so its coefficients are held to
``tests/test_torch_control.py``'s tolerance and its decisions exactly.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import paper_gpu as JG  # noqa: E402
from repro.core import gpusim as J  # noqa: E402
from repro.core import predictor as JP  # noqa: E402
from repro.core.gpusim import corpus as JC  # noqa: E402
from repro_torch.configs import paper_gpu as PG  # noqa: E402
from repro_torch.core import gpusim as Pt  # noqa: E402
from repro_torch.core import predictor as PP  # noqa: E402
from repro_torch.core.gpusim import corpus as PC  # noqa: E402

NAMES = tuple(J.WORKLOADS)
FIELDS = [f.name for f in dataclasses.fields(J.SimResult)]


@pytest.fixture(scope="module")
def ref_results():
    return {s: J.run_all(s) for s in J.SCHEMES}


@pytest.fixture(scope="module")
def port_results():
    return {s: Pt.run_all(s) for s in Pt.SCHEMES}


def _equal(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
        else:
            assert type(x) is type(y) and x == y, (what, f, x, y)


def test_schemes_and_workloads_are_the_reference_ones():
    assert Pt.SCHEMES == J.SCHEMES
    assert Pt.EXTENDED_SCHEMES == J.EXTENDED_SCHEMES
    assert Pt.FEATURE_NAMES == J.FEATURE_NAMES
    assert tuple(Pt.WORKLOADS) == NAMES
    for n in NAMES:
        assert dataclasses.asdict(Pt.WORKLOADS[n]) == \
            dataclasses.asdict(J.WORKLOADS[n])


def test_paper_gpu_config_equal_field_for_field():
    a, b = dataclasses.asdict(JG.PAPER_GPU), dataclasses.asdict(PG.PAPER_GPU)
    assert a == b
    assert [f.name for f in dataclasses.fields(PG.GPUConfig)] == \
        [f.name for f in dataclasses.fields(JG.GPUConfig)]


@pytest.mark.parametrize("scheme", J.SCHEMES)
def test_run_all_equal_exactly(scheme, ref_results, port_results):
    assert tuple(port_results[scheme]) == NAMES
    for n in NAMES:
        _equal(ref_results[scheme][n], port_results[scheme][n],
               f"{scheme}/{n}")


def test_port_meets_the_paper_headlines(port_results):
    """tests/test_gpusim.py's ranges, on the port's own results."""
    base = port_results["baseline"]
    wr = {n: port_results["warp_regroup"][n].ipc / base[n].ipc
          for n in NAMES}
    assert 3.8 <= wr["SM"] <= 4.8 and 1.8 <= wr["MUM"] <= 2.5
    assert 1.30 <= float(np.exp(np.mean(np.log(list(wr.values()))))) <= 1.60


@pytest.mark.parametrize("name", NAMES)
def test_profile_features_equal(name):
    a = J.profile_features(J.WORKLOADS[name])
    b = Pt.profile_features(Pt.WORKLOADS[name])
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
def test_workload_variants_equal(seed):
    for n in NAMES:
        a = J.workload_variants(J.WORKLOADS[n], 3, seed)
        b = Pt.workload_variants(Pt.WORKLOADS[n], 3, seed)
        assert [dataclasses.asdict(w) for w in a] == \
            [dataclasses.asdict(w) for w in b]


@pytest.mark.parametrize("name", ["SM", "RAY"])
def test_rank_chip_mixes_equal(name):
    a = J.rank_chip_mixes(J.WORKLOADS[name], epochs=16)
    b = Pt.rank_chip_mixes(Pt.WORKLOADS[name], epochs=16)
    assert a == b


def _decider(feats):
    """A fixed rule on the features (fuse when L1D misses dominate)."""
    return bool(feats[3] > 0.45)


@pytest.mark.parametrize("scheme", ["static_fuse", "warp_regroup"])
def test_run_benchmark_with_fuse_decider_equal(scheme):
    for n in ("SM", "RAY", "CP", "WP"):
        a = J.run_benchmark(J.WORKLOADS[n], scheme, fuse_decider=_decider,
                            epochs=32)
        b = Pt.run_benchmark(Pt.WORKLOADS[n], scheme, fuse_decider=_decider,
                             epochs=32)
        _equal(a, b, f"{scheme}/{n}")


def test_static_mix_equal():
    for n in ("SM", "LIB"):
        a = J.run_benchmark(J.WORKLOADS[n], "static_mix", epochs=16)
        b = Pt.run_benchmark(Pt.WORKLOADS[n], "static_mix", epochs=16)
        _equal(a, b, f"static_mix/{n}")


def test_build_corpus_exact():
    Xa, ya, na = JC.build_corpus(variants_per_workload=2, epochs=16)
    Xb, yb, nb = PC.build_corpus(variants_per_workload=2, epochs=16)
    np.testing.assert_array_equal(Xa, Xb)
    np.testing.assert_array_equal(ya, yb)
    assert na == nb and len(na) == 12 * 3


def test_train_sim_predictor_within_tolerance():
    """Coefficients within 1e-3, but for features that are constant over
    the corpus (``l1c_miss`` is 0.05 in every profile): there the float32
    mean differs from the value in its last bit by the sum's order, the
    clamped sigma (1e-6) scales that difference by 1e6, and the fitted
    weight is that rounding's echo in each package.  For those the test
    holds what the weight does: its share of every logit stays below 1e-3
    on both sides."""
    jm, jinfo = JC.train_sim_predictor(2, epochs=16)
    pm, pinfo = PC.train_sim_predictor(2, epochs=16)
    X, _, _ = PC.build_corpus(variants_per_workload=2, epochs=16)
    const = X.max(0) == X.min(0)
    assert list(np.flatnonzero(const)) == [5, 10]
    for a, b in zip(pm[1:4], jm[1:4]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)
    np.testing.assert_allclose(pm.w[~const], np.asarray(jm.w)[~const],
                               atol=1e-3)
    for m in (pm, jm):
        share = np.asarray(m.standardize(X)) * np.asarray(m.w)
        assert np.abs(share[:, const]).max() < 1e-3
    np.testing.assert_allclose(PP.predict_proba(pm, X),
                               np.asarray(JP.predict_proba(jm, X)), atol=1e-3)
    assert tuple(pm.feature_names) == tuple(jm.feature_names) \
        == Pt.FEATURE_NAMES
    assert pinfo["base_profile_accuracy"] == jinfo["base_profile_accuracy"]
    assert pinfo["n"] == jinfo["n"]
    for n in NAMES:
        f = Pt.profile_features(Pt.WORKLOADS[n])
        assert bool(PP.predict_fuse(pm, f)) == \
            bool(np.asarray(JP.predict_fuse(jm, f))), n
