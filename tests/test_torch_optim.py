"""repro_torch's optimizer and gradient compression against the JAX
reference, on the CPU.

Inputs come from a seeded numpy generator; bf16 leaves are the same f32
draws rounded to nearest even on both sides.  Tolerances:

* AdamW in float32 storage: rtol 1e-6, atol 1e-7 (the same fp32
  operations; XLA and PyTorch may evaluate ``b ** t`` an ulp apart);
  bfloat16 storage: the stored values within one bf16 ulp (rtol 2^-7),
  since an fp32 ulp before the final rounding can move it.
* ``cosine_schedule``: rtol 1e-6; ``global_norm``: rtol 1e-6 (sums in
  another order).
* ``compress_leaf`` / ``decompress_leaf``: exact (codes, scales and the
  dequantized leaf): the same IEEE operations, run op by op on both sides.
* ``adamw_update`` refuses a non-contiguous parameter or moment.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.optim import adamw as JA  # noqa: E402
from repro.parallel import compression as JC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.parallel import compression as C  # noqa: E402

# a flat leaf, a small stack (< 8 layers: one update), a stacked leaf the
# reference updates layer by layer (lax.map), a 1-D scale
SHAPES = {"w": (6, 5), "few": (3, 4, 5), "stack": (12, 6, 4), "s": (7,)}


def _tree(seed, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return {k: (scale * rng.standard_normal(s)).astype(np.float32).astype(
        np_dt) for k, s in SHAPES.items()}


def _np(t):
    return t.float().numpy()


def _close(got, want, dtype):
    rtol, atol = (2.0 ** -7, 0.0) if dtype == "bfloat16" else (1e-6, 1e-7)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [False, True])
def test_adamw_update_matches_reference(dtype, clip):
    """Three steps on flat and stacked leaves; the moments and step too.
    ``clip`` passes a ``grad_scale`` below 1, as the trainer's clip does."""
    p = _tree(0, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = bridge.params_from_numpy(p, device="cpu")
    jst, tst = JA.adamw_init(jp), A.adamw_init(tp)
    for step in range(3):
        g = _tree(10 + step, dtype, scale=3.0)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = bridge.params_from_numpy(g, device="cpu")
        lr = JA.cosine_schedule(jst.step, base_lr=1e-2, warmup=1, total=5)
        tlr = A.cosine_schedule(tst.step, base_lr=1e-2, warmup=1, total=5)
        np.testing.assert_allclose(float(tlr), float(lr), rtol=1e-6)
        scale = 1.0
        tscale = 1.0
        if clip:
            norm = JA.global_norm(jg)
            scale = jnp.minimum(1.0, 1.0 / jnp.maximum(norm, 1e-9))
            tscale = torch.tensor(float(scale))
        jp, jst = JA.adamw_update(jp, jg, jst, lr=lr, grad_scale=scale)
        tp, tst = A.adamw_update(tp, tg, tst, lr=tlr, grad_scale=tscale)
        assert int(tst.step) == int(jst.step) == step + 1
        assert tst.step.dtype == torch.int32
        for k in SHAPES:
            assert tp[k].dtype == tst.m[k].dtype == getattr(torch, dtype)
            _close(tp[k], jp[k], dtype)
            _close(tst.m[k], jst.m[k], dtype)
            _close(tst.v[k], jst.v[k], dtype)


def test_adamw_state_dtype_and_blocks(monkeypatch):
    """fp32 moments for bf16 parameters (``state_dtype``), and an update
    cut into flat blocks equals the update in one piece bit for bit."""
    p = _tree(1, "bfloat16")
    g = _tree(2, "bfloat16")
    outs = []
    for block in (A.BLOCK, 7):
        monkeypatch.setattr(A, "BLOCK", block)
        tp = bridge.params_from_numpy(p, device="cpu")
        st = A.adamw_init(tp, "float32")
        assert all(m.dtype == torch.float32 for m in st.m.values())
        tp, st = A.adamw_update(tp, bridge.params_from_numpy(g, device="cpu"),
                                st, lr=torch.tensor(1e-2))
        outs.append((tp, st))
    for k in SHAPES:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
        assert torch.equal(outs[0][1].m[k], outs[1][1].m[k])
        assert torch.equal(outs[0][1].v[k], outs[1][1].v[k])


@pytest.mark.parametrize("step", [0, 1, 3, 10, 99, 100, 150])
def test_cosine_schedule_matches_reference(step):
    kw = dict(base_lr=3e-4, warmup=10, total=100)
    want = JA.cosine_schedule(jnp.asarray(step, jnp.int32), **kw)
    got = A.cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference(dtype):
    g = _tree(3, dtype, scale=10.0)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = bridge.params_from_numpy(g, device="cpu")
    np.testing.assert_allclose(float(A.global_norm(tg)),
                               float(JA.global_norm(jg)), rtol=1e-6)
    jc, jn = JA.global_norm_clip(jg, 1.0)
    tc, tn = A.global_norm_clip(tg, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        _close(tc[k], jc[k], dtype)


@pytest.mark.parametrize("n", [1, 7, 1000, 1024, 5000])
def test_compress_leaf_exact_against_reference(n):
    """Codes, scales and the dequantized leaf equal the reference's; a
    padded tail row and an all-zero leaf take the floor."""
    rng = np.random.default_rng(n)
    for x in (rng.standard_normal(n).astype(np.float32) * 3.0,
              np.zeros(n, np.float32)):
        shape = (n,) if n < 1000 else (n // 8, 8) if n % 8 == 0 else (n,)
        x = x.reshape(shape)
        jq, js, jshape = JC.compress_leaf(jnp.asarray(x))
        tq, ts, tshape = C.compress_leaf(torch.from_numpy(x))
        assert tshape == tuple(jshape)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(ts.numpy(), np.asarray(js))
        want = JC.decompress_leaf(jq, js, jshape)
        got = C.decompress_leaf(tq, ts, tshape)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_round_trip_is_the_reference_error_feedback():
    """``round_trip_`` in place equals the reference trainer's
    ``gf = g + r; g' = deq(compress(gf)); r' = gf - deq`` exactly, for a
    bf16 gradient and an fp32 residual."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((3, 700)).astype(np.float32).astype(
        ml_dtypes.bfloat16)
    r = (1e-3 * rng.standard_normal((3, 700))).astype(np.float32)
    gf = jnp.asarray(g).astype(jnp.float32) + jnp.asarray(r)
    q, s, shp = JC.compress_leaf(gf)
    deq = JC.decompress_leaf(q, s, shp)
    tg = bridge.params_from_numpy({"g": g}, device="cpu")["g"]
    tr = torch.from_numpy(r.copy())
    C.round_trip_(tg, tr)
    assert np.array_equal(tg.view(torch.int16).numpy(),
                          np.asarray(deq.astype(jnp.bfloat16)).view(np.int16))
    assert np.array_equal(tr.numpy(), np.asarray(gf - deq))
    res = C.init_residuals({"a": tg, "b": (tr,)})
    assert res["a"].dtype == torch.float32 and not res["b"][0].any()


@pytest.mark.parametrize("which", ["params", "m"])
def test_adamw_update_refuses_a_non_contiguous_leaf(which):
    """Updates go through flat views; a non-contiguous leaf's would land
    in a copy and be lost, so the update raises before touching anything."""
    p = {"w": torch.zeros(6, 4)}
    g = {"w": torch.ones(6, 4)}
    st = A.adamw_init(p)
    if which == "params":
        p = {"w": torch.zeros(4, 6).t()}
    else:
        st = st._replace(m={"w": torch.zeros(4, 6).t()})
    before = p["w"].clone()
    with pytest.raises(ValueError, match="non-contiguous"):
        A.adamw_update(p, g, st, lr=1e-3)
    assert torch.equal(p["w"], before)


def test_round_trip_over_row_aligned_blocks_equals_the_whole_leaf():
    """The sharded trainer runs the whole leaf's round trip over blocks of
    whole 1,024-value rows: the same rows, so the same bits."""
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.standard_normal(9000).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(9000).astype(np.float32)) / 50
    g1, r1, g2, r2 = g.clone(), r.clone(), g.clone(), r.clone()
    C.round_trip_(g1, r1)
    for lo in range(0, 9000, 2048):
        C.round_trip_(g2[lo:lo + 2048], r2[lo:lo + 2048])
    assert torch.equal(g1, g2) and torch.equal(r1, r2)
