"""repro_torch's AMOEBA core (controller, mesh plans, amortization,
roofline, HLO collective parsing) on the cases of tests/test_core.py,
each run on both packages: decisions, plans and numbers must be equal.
Where the defaults differ (the port's ``H100`` against the reference's
``V5E``), both sides are given the same ``HardwareConfig``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.configs.base import V5E as JV5E  # noqa: E402
from repro.configs.base import AmoebaConfig as JAmoeba  # noqa: E402
from repro.core import AmoebaController as JController  # noqa: E402
from repro.core import MeshPlan as JPlan  # noqa: E402
from repro.core import StepProfile as JProfile  # noqa: E402
from repro.core import collective_bytes as jcollective_bytes  # noqa: E402
from repro.core import plan_family as jplan_family  # noqa: E402
from repro.core import fusion as JF  # noqa: E402
from repro.core import regroup as JR  # noqa: E402
from repro_torch.configs.base import H100, V5E, AmoebaConfig  # noqa: E402
from repro_torch.core import (AmoebaController, MeshPlan,  # noqa: E402
                              StepProfile, collective_bytes, plan_family)
from repro_torch.core import fusion as F  # noqa: E402
from repro_torch.core import regroup as R  # noqa: E402
from repro_torch.core.metrics import _shape_bytes  # noqa: E402
from repro.core.metrics import _shape_bytes as j_shape_bytes  # noqa: E402


def test_plan_family_shapes():
    for base in ((16, 16, 1), (8, 4, 2), (3, 5, 1), (2, 1, 1)):
        fam = plan_family(MeshPlan("base", *base))
        jfam = jplan_family(JPlan("base", *base))
        assert sorted(fam) == sorted(jfam)
        for k in fam:
            assert (fam[k].shape, fam[k].axes, fam[k].num_devices) == \
                (jfam[k].shape, jfam[k].axes, jfam[k].num_devices)
    fam = plan_family(MeshPlan("base", data=16, model=16))
    assert fam["fused"].shape == (8, 32)
    assert fam["scale_out"].shape == (32, 8)
    assert all(p.num_devices == 256 for p in fam.values())
    with pytest.raises(RuntimeError, match="process group"):
        fam["base"].build()              # no process group joined here


@pytest.mark.parametrize("gain,nbytes,steps", [
    (1e-4, 1e9, 10), (1e-3, 1e9, 100), (1e-3, 5e10, 1e4), (0.0, 1.0, 1e9)])
def test_amortization_matches_reference(gain, nbytes, steps):
    for hw in (V5E, H100):
        jhw = JV5E.__class__(**vars(hw))
        assert F.amortized_switch_ok(gain, nbytes, steps, hw) == \
            JF.amortized_switch_ok(gain, nbytes, steps, jhw)
        assert F.reshard_cost_s(nbytes, hw) == JF.reshard_cost_s(nbytes, jhw)
    # 1 GB/chip resharded over v5e's 50 GB/s ICI = 0.04 s
    assert not F.amortized_switch_ok(1e-4, 1e9, 10, V5E)
    assert F.amortized_switch_ok(1e-3, 1e9, 100, V5E)
    assert F.reshard_cost_s(1e9) == 2e9 / H100.ici_bandwidth


HLO = """
  %a = bf16[1024,512] all-reduce(bf16[1024,512] %x)
  %b = f32[2048] all-gather(f32[512] %y), dimensions={0}
  %c = bf16[64,128] reduce-scatter(bf16[512,128] %z)
  %d = s32[10] add(s32[10] %p, s32[10] %q)
  %e = (f32[8,8], s8[16]) all-to-all(f32[8,8] %u, s8[16] %w)
  %f = u32[3,3] collective-permute(u32[3,3] %v)
"""


def test_collective_bytes_parser():
    got = collective_bytes(HLO)
    assert got == jcollective_bytes(HLO)
    assert got["all-reduce"] == 1024 * 512 * 2
    assert got["all-gather"] == 2048 * 4
    assert got["reduce-scatter"] == 64 * 128 * 2
    assert got["all-to-all"] == 8 * 8 * 4 + 16
    for text in ("bf16[2,3] f32[] pred[7] s64[1,1,1]", "nothing", HLO):
        assert _shape_bytes(text) == j_shape_bytes(text)


def _profiles(make, **kw):
    return [make("t", flops=197e12, hbm_bytes=819e9, coll_bytes=50e9,
                 chips=256, model_flops=197e12 * 256, **kw),
            make("u", flops=3e12, hbm_bytes=9e11, coll_bytes=1e9, chips=4,
                 model_flops=1e12, per_chip_batch=512, peak_memory=3e10,
                 divergence=0.4)]


def test_roofline_terms_and_features():
    for p, jp in zip(_profiles(StepProfile), _profiles(JProfile)):
        for hw in (V5E, H100):
            jhw = JV5E.__class__(**vars(hw))
            assert p.roofline(hw) == jp.roofline(jhw)
        assert np.array_equal(p.features(), jp.features())
    r = _profiles(StepProfile)[0].roofline(V5E)
    assert abs(r["compute_s"] - 1.0) < 1e-6
    assert abs(r["memory_s"] - 1.0) < 1e-6
    assert abs(r["collective_s"] - 1.0) < 1e-6
    assert r["roofline_frac"] == pytest.approx(1.0)
    assert _profiles(StepProfile)[0].roofline() == \
        _profiles(StepProfile)[0].roofline(H100)


def _choose(ctl, base, fused, **kw):
    return ctl.choose_plan({"base": base, "fused": fused}, **kw)


@pytest.mark.parametrize("hw", ["v5e", "h100"])
def test_controller_roofline_choice_and_veto(hw):
    h = V5E if hw == "v5e" else H100
    ctl = AmoebaController(AmoebaConfig(), hw=h)
    jctl = JController(JAmoeba(), hw=JV5E.__class__(**vars(h)))
    mk = [dict(flops=1e12, hbm_bytes=1e9, coll_bytes=5e9, chips=256),
          dict(flops=1e12, hbm_bytes=1e9, coll_bytes=2e9, chips=256)]
    for kw in (dict(param_bytes_per_chip=1e8, steps_remaining=1e6),
               dict(param_bytes_per_chip=1e12, steps_remaining=1)):
        d = _choose(ctl, *(StepProfile("s", **m) for m in mk), **kw)
        jd = _choose(jctl, *(JProfile("s", **m) for m in mk), **kw)
        assert (d.plan, d.proba, d.reason, d.profiles) == \
            (jd.plan, jd.proba, jd.reason, jd.profiles)
    assert [d.plan for d in ctl.decisions] == ["fused", "base"]
    assert "amortize" in ctl.decisions[1].reason
    # one profile: the heuristic fallback
    for m in mk:
        one = ctl.choose_plan({"base": StepProfile("s", **m)})
        jone = jctl.choose_plan({"base": JProfile("s", **m)})
        assert (one.plan, one.proba, one.reason) == \
            (jone.plan, jone.proba, jone.reason)
    off = AmoebaController(AmoebaConfig(enabled=False))
    assert off.choose_plan({}).reason == "amoeba off"


def test_controller_split_fuse_hysteresis():
    kw = dict(min_phase_steps=2, split_threshold=0.3, fuse_threshold=0.1)
    ctl, jctl = AmoebaController(AmoebaConfig(**kw)), JController(
        JAmoeba(**kw))
    lens = np.array([100.0, 5.0, 90.0, 3.0])
    calm = np.array([5.0, 5.0, 5.0, 5.0])
    states = []
    for x in [lens] * 4 + [calm] * 4:
        s = ctl.observe(R.divergence_score(x), x)
        assert s == jctl.observe(JR.divergence_score(x), x)
        states.append(s)
        if len(states) == 4:
            assert s is True
            assert ctl.layout([0, 1, 2, 3], x) == jctl.layout([0, 1, 2, 3],
                                                              x)
            fast, slow = ctl.layout([0, 1, 2, 3], x)
            assert set(fast) == {1, 3} and set(slow) == {0, 2}
    assert states[-1] is False
    assert vars(ctl.split_state) == vars(jctl.split_state)


def test_moe_divergence_bounds():
    for load in ([0.25] * 4, [0.97, 0.01, 0.01, 0.01], [0.5, 0.5, 0, 0]):
        assert R.moe_divergence(load) == JR.moe_divergence(load)
    assert R.moe_divergence([0.25] * 4) == pytest.approx(0.0)
    assert 0.7 < R.moe_divergence([0.97, 0.01, 0.01, 0.01]) < 1.0
