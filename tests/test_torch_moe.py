"""repro_torch's MoE models (deepseek-moe-16b, arctic-480b) against the JAX
reference, same weights.

Reduced configs on the CPU; the reference's parameter tree goes through
``bridge.params_from_numpy`` (its float32 router among the other leaves),
and every input comes from a seeded numpy generator.  Tolerances:

* the router (``_route``): top-k ids exactly equal; weights, ``aux_loss``
  and ``load`` within 1e-6 (float32 softmax over 8 experts; XLA and
  PyTorch sum in other orders).
* ``moe_dense``: 1e-4 of the output's largest magnitude (float32; the
  expert matmuls and the top-k combine sum in other orders).
* float32 logits: 1e-4 absolute, and greedy tokens identical.
* bfloat16 logits: 5e-2 absolute, as tests/test_torch_models.py.
* ``ServeEngine``: every ServeStats field, token and finish tick equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import AmoebaConfig as JAmoeba  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import AmoebaConfig  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCHS = ["deepseek-moe-16b", "arctic-480b"]
B, S, STEPS = 2, 16, 4


def _cfgs(arch, dtype="float32"):
    return (jget_config(arch, reduced=True).replace(dtype=dtype),
            get_config(arch, reduced=True).replace(dtype=dtype))


def _to_torch(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu")


def _moe_params(jc, seed=0):
    jp, _ = JM.init_moe(jax.random.PRNGKey(seed), jc)
    return jp, _to_torch(jp)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, seed):
    jc, tc = _cfgs(arch)
    jp, tp = _moe_params(jc, seed)
    x = _x((37, jc.d_model), seed)
    want = JM._route(jp, jnp.asarray(x), jc)
    got = M._route(tp, torch.from_numpy(x), tc)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    assert got[1].dtype == got[2].dtype == got[3].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_reference(arch):
    """Shared experts (deepseek) or the dense residual branch (arctic)
    included; ``moe_forward`` is ``moe_dense`` without a mesh."""
    jc, tc = _cfgs(arch)
    jp, tp = _moe_params(jc)
    x = _x((B, S, jc.d_model), 3)
    y, aux = JM.moe_dense(jp, jnp.asarray(x), jc)
    for fn in (M.moe_dense, M.moe_forward):
        got, gaux = fn(tp, torch.from_numpy(x), tc)
        want = np.asarray(y)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=0)
        for g, w in zip(gaux, aux):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)


def test_expert_ffn_broadcasts_without_repeating():
    """x broadcast over the expert axis gives the reference's repeated x."""
    jc, tc = _cfgs("deepseek-moe-16b")
    jp, tp = _moe_params(jc)
    x = _x((11, jc.d_model), 4)
    want = JM._expert_ffn(jp["experts"], jnp.asarray(x)[None].repeat(
        jc.moe.num_experts, 0), jc)
    got = M._expert_ffn(tp["experts"], torch.from_numpy(x)[None], tc)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4 * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_prefill_and_greedy_decode_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tp = _to_torch(jp)
    jrt = JT.Runtime(production=False, remat=False, q_block=32, kv_block=32)
    trt = T.Runtime(q_block=32, kv_block=32)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (B, S))
    jb, tb = {"tokens": jnp.asarray(toks, jnp.int32)}, {
        "tokens": torch.as_tensor(toks)}

    want, jaux = JT.logits_fn(jp, jb, jc, jrt)
    got, taux = T.logits_fn(tp, tb, tc, trt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    for g, w in zip(taux, jaux):       # summed over the 3 MoE blocks
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    assert float(taux.load.sum()) == pytest.approx(tc.num_layers)

    horizon = S + STEPS
    jl, jst = JT.prefill(jp, jb, jc, jrt, window=horizon)
    tl, tst = T.prefill(tp, tb, tc, trt, window=horizon)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    jdec = jax.jit(lambda p, s, t: JT.decode_step(p, s, t, jc, jrt))
    for step in range(STEPS):
        jt = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, dim=-1)[:, None]
        assert np.array_equal(np.asarray(jt), tt.numpy()), step
        jl, jst = jdec(jp, jst, jt)
        tl, tst = T.decode_step(tp, tst, tt, tc, trt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"decode step {step}")
    assert np.array_equal(np.asarray(jnp.argmax(jl, -1)),
                          torch.argmax(tl, -1).numpy())


def test_bf16_logits_within_tolerance():
    jc, tc = _cfgs("deepseek-moe-16b", dtype="bfloat16")
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tp = _to_torch(jp)
    assert tp["reps"][0]["ffn"]["router"].dtype == torch.float32
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (B, S))
    want, _ = JT.logits_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
                           JT.Runtime(production=False, remat=False))
    got, _ = T.logits_fn(tp, {"tokens": torch.as_tensor(toks)}, tc)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2,
                               rtol=0)


def _serve(engine_cls, req_cls, amoeba_cls, cfg, params, n=6):
    """tests/test_torch_serve.py's trace and engine settings, dynamic
    warp_regroup, so splits and fuses re-cut the MoE model's KV caches."""
    eng = engine_cls(cfg, params, capacity=4, amoeba=amoeba_cls(
        regroup_policy="warp_regroup", split_threshold=0.3,
        fuse_threshold=0.05, min_phase_steps=2))
    rng = np.random.default_rng(0)
    reqs = [req_cls(i, list(map(int, rng.integers(
        0, cfg.vocab_size, int(rng.choice([8, 16]))))),
        int(rng.choice([2, 5, 20]))) for i in range(n)]
    eng.submit(reqs)
    st = eng.run(dynamic=True)
    return (dataclasses.asdict(st),
            {r.rid: (tuple(r.generated), r.finish) for r in reqs},
            [t[:3] for t in eng.controller.state.transitions])


def test_serve_engine_matches_reference():
    jc, tc = _cfgs("deepseek-moe-16b")
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tp = _to_torch(jp)
    want = _serve(JServe, JRequest, JAmoeba, jc, jp)
    got = _serve(ServeEngine, Request, AmoebaConfig, tc, tp)
    assert got == want
    assert got[0]["completed"] == 6
    assert got[0]["splits"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_cpu(arch, capsys):
    serve_launcher.main(["--device", "cpu", "--arch", arch, "--requests",
                         "4", "--capacity", "4"])
    out = capsys.readouterr().out
    assert '"completed": 4' in out and '"device": "cpu"' in out
