"""repro_torch's recurrent families (falcon-mamba-7b's Mamba-1 SSM and
recurrentgemma-9b's RG-LRU hybrid) against the JAX reference, same weights.

Reduced configs on the CPU; the reference's parameter tree goes through
``bridge.params_from_numpy``, and every input comes from a seeded numpy
generator.  With ``use_kernels`` the reference runs its Pallas kernels in
interpret mode and the port the kernels' plain versions (the tensors lie
on the CPU).  Tolerances:

* float32, module outputs and logits: 1e-4 absolute.  Same math, but the
  port's Hillis–Steele chunk scan and XLA's associative scan combine in
  other orders, and matmuls sum in other orders (≈1e-6 relative per op).
* greedy tokens in float32: identical.
* bfloat16 logits: 3e-2 of the largest logit magnitude.  Both sides
  round to bf16 after every matmul, but not always at the same points.
  falcon-mamba's tied unembedding gives logits up to ~120, where one bf16
  ulp is 0.5, so the bound scales with the logits (a CPU probe measured
  0.4 % for falcon-mamba and 1.5 % for recurrentgemma's 9 layers).
* teacher-forced decode against the full forward: 1e-3, as
  tests/test_models.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import scan_utils as JSU  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rglru as R  # noqa: E402
from repro_torch.models import scan_utils as SU  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.serve import state_utils as su  # noqa: E402

B, SEQ, STEPS = 2, 16, 20

# (arch, num_layers or None for the reduced default).  recurrentgemma's
# reduced config has 9 = 3 x 3 layers and no remainder; 5 layers is one
# repetition plus two ``rest`` layers.
MODELS = {
    "falcon-mamba-7b": ("falcon-mamba-7b", None),
    "recurrentgemma-9b": ("recurrentgemma-9b", None),
    "recurrentgemma-9b-L5": ("recurrentgemma-9b", 5),
}
# the other families, whose parameter trees the init-tree test also holds
# to the reference's (their numerics: tests/test_torch_{moe,multimodal}.py)
TREE_MODELS = {**MODELS, **{a: (a, None) for a in (
    "deepseek-moe-16b", "arctic-480b", "qwen2-vl-7b", "whisper-base")}}


def _cfgs(name, dtype="float32"):
    arch, layers = TREE_MODELS[name]
    jc = jget_config(arch, reduced=True).replace(dtype=dtype)
    tc = get_config(arch, reduced=True).replace(dtype=dtype)
    if layers is not None:
        jc, tc = jc.replace(num_layers=layers), tc.replace(num_layers=layers)
    return jc, tc


def _to_torch(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu")


def _params(jc):
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    return jp, _to_torch(jp)


def _runtimes(use_kernels=False):
    jrt = JT.Runtime(production=False, remat=False, use_kernels=use_kernels,
                     q_block=32, kv_block=32)
    trt = T.Runtime(use_kernels=use_kernels, q_block=32, kv_block=32)
    return jrt, trt


def _tokens(vocab, seed=1, shape=(B, SEQ)):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# scan_utils
# ---------------------------------------------------------------------------

def _scan_inputs(shape, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.4, 0.999, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("S_,chunk", [(64, 16), (100, 32), (7, 256)])
def test_linear_scan_matches_reference(S_, chunk):
    """S not a multiple of the chunk pads with a=1, b=0; h0 is folded in."""
    a, b = _scan_inputs((2, S_, 12))
    h0 = np.random.default_rng(5).standard_normal((2, 12)).astype(np.float32)
    jh, jl = JSU.linear_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                             chunk=chunk)
    th, tl = SU.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(h0), chunk=chunk)
    assert th.shape == (2, S_, 12) and tl.shape == (2, 12)
    _close(th, jh, 1e-5)
    _close(tl, jl, 1e-5)


@pytest.mark.parametrize("S_,chunk", [(64, 64), (77, 16)])
def test_linear_scan_contract_matches_reference(S_, chunk):
    a, b = _scan_inputs((2, S_, 10, 4))
    b = b * 0.1
    rng = np.random.default_rng(6)
    c = rng.standard_normal((2, S_, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 10, 4)).astype(np.float32)
    jy, jh = JSU.linear_scan_contract(*(jnp.asarray(x) for x in (a, b, c, h0)),
                                      chunk=chunk)
    ty, th = SU.linear_scan_contract(*(torch.from_numpy(x)
                                       for x in (a, b, c, h0)), chunk=chunk)
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("S_", [1, 2, 3, 9])
def test_conv_helpers_match_reference(S_):
    """causal_conv1d, its decode step, and conv_tail (front-padded when
    S < K-1 = 3)."""
    rng = np.random.default_rng(S_)
    x = rng.standard_normal((2, S_, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    _close(SU.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w)),
           JSU.causal_conv1d(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    tail = SU.conv_tail(torch.from_numpy(x), 4)
    assert tail.shape == (2, 3, 6)
    _close(tail, JSU.conv_tail(jnp.asarray(x), 4), 0)
    out, new = SU.causal_conv1d_step(torch.from_numpy(x[:, -1]),
                                     torch.from_numpy(st), torch.from_numpy(w))
    jout, jnew = JSU.causal_conv1d_step(jnp.asarray(x[:, -1]),
                                        jnp.asarray(st), jnp.asarray(w))
    _close(out, jout, 1e-5)
    _close(new, jnew, 0)
    h = rng.standard_normal((2, 6)).astype(np.float32)
    _close(SU.linear_scan_step(torch.from_numpy(w[0]), torch.from_numpy(w[1]),
                               torch.from_numpy(h)),
           JSU.linear_scan_step(jnp.asarray(w[0]), jnp.asarray(w[1]),
                                jnp.asarray(h)), 1e-6)


# ---------------------------------------------------------------------------
# Blocks: ssm / rglru forward and step
# ---------------------------------------------------------------------------

BLOCKS = {"ssm": ("falcon-mamba-7b", JS.init_ssm, JS.ssm_forward, JS.ssm_step,
                  S.ssm_forward, S.ssm_step),
          "rglru": ("recurrentgemma-9b", JR.init_rglru, JR.rglru_forward,
                    JR.rglru_step, R.rglru_forward, R.rglru_step)}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_forward_and_step_match_reference(kind, use_kernel):
    arch, jinit, jfwd, jstep, tfwd, tstep = BLOCKS[kind]
    jc = jget_config(arch, reduced=True).replace(dtype="float32")
    tc = get_config(arch, reduced=True).replace(dtype="float32")
    jp, _ = jinit(jax.random.PRNGKey(3), jc)
    tp = _to_torch(jp)
    x = np.random.default_rng(7).standard_normal(
        (B, 11, jc.d_model)).astype(np.float32)
    jout, jst = jfwd(jp, jnp.asarray(x), jc, use_kernel=use_kernel,
                     return_state=True)
    tout, tst = tfwd(tp, torch.from_numpy(x), tc, use_kernel=use_kernel,
                     return_state=True)
    _close(tout, jout)
    assert type(tst).__name__ == type(jst).__name__
    for t, j in zip(tst, jst):
        _close(t, j)
    xn = np.random.default_rng(8).standard_normal(
        (B, 1, jc.d_model)).astype(np.float32)
    jout, jst = jstep(jp, jst, jnp.asarray(xn), jc)
    tout, tst = tstep(tp, tst, torch.from_numpy(xn), tc)
    _close(tout, jout)
    for t, j in zip(tst, jst):
        _close(t, j)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_prefill_and_greedy_decode_match_reference(name, use_kernels):
    jc, tc = _cfgs(name)
    jp, tp = _params(jc)
    jrt, trt = _runtimes(use_kernels)
    toks = _tokens(jc.vocab_size)
    want, _ = JT.logits_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           jc, jrt)
    got, _ = T.logits_fn(tp, {"tokens": torch.as_tensor(toks)}, tc, trt)
    _close(got, want)

    horizon = SEQ + STEPS
    jl, jst = JT.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
                         jrt, window=horizon)
    tl, tst = T.prefill(tp, {"tokens": torch.as_tensor(toks)}, tc, trt,
                        window=horizon)
    _close(tl, jl)
    jdec = jax.jit(lambda p, s, t: JT.decode_step(p, s, t, jc, jrt))
    jt = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl, dim=-1)[:, None]
    for step in range(STEPS):
        assert np.array_equal(np.asarray(jt), tt.numpy()), step
        jl, jst = jdec(jp, jst, jt)
        tl, tst = T.decode_step(tp, tst, tt, tc, trt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"decode step {step}")
        jt = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, dim=-1)[:, None]
    assert np.array_equal(np.asarray(jt), tt.numpy())
    for t, j in zip(jax.tree.leaves(tst, is_leaf=torch.is_tensor),
                    jax.tree.leaves(jst)):
        assert tuple(t.shape) == j.shape
        _close(t, j)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_logits_within_tolerance(name):
    jc, tc = _cfgs(name, dtype="bfloat16")
    jp, tp = _params(jc)
    jrt, trt = _runtimes()
    toks = _tokens(jc.vocab_size)
    want, _ = JT.logits_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           jc, jrt)
    got, _ = T.logits_fn(tp, {"tokens": torch.as_tensor(toks)}, tc, trt)
    want = np.asarray(want, np.float32)
    _close(got.float(), want, 3e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decode_matches_full_forward(name):
    """Teacher-forced decode off the prefill state == full-sequence logits
    (tests/test_models.py's check, on the port alone)."""
    _, tc = _cfgs(name)
    tp = T.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    rt = T.Runtime()
    toks = torch.as_tensor(_tokens(tc.vocab_size, seed=2, shape=(B, 32)))
    full, _ = T.logits_fn(tp, {"tokens": toks}, tc, rt)
    p0 = 29
    lg, st = T.prefill(tp, {"tokens": toks[:, :p0]}, tc, rt, window=32)
    errs = [float((lg - full[:, p0 - 1]).abs().max())]
    for t in range(p0, 32):
        lg, st = T.decode_step(tp, st, toks[:, t:t + 1], tc, rt)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 1e-3, errs


@pytest.mark.parametrize("name", sorted(TREE_MODELS))
def test_init_model_tree_matches_reference(name):
    """Same paths, shapes and dtypes as the reference's tree (fp32 where
    it keeps fp32: A_log, D, ba, lam, the MoE router), count_params equal
    to the reference's and to param_count, and the same decode-state
    shapes (whisper's cross caches included)."""
    jc, tc = _cfgs(name, dtype="bfloat16")
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tp = T.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    assert [x.shape for _, x in jflat] == [tuple(x.shape) for _, x in tflat]
    assert [str(x.dtype) for _, x in jflat] == [
        str(x.dtype).replace("torch.", "") for _, x in tflat]
    assert T.count_params(tp) == tc.param_count() == JT.count_params(jp)
    enc = 7 if tc.encoder_layers else 0
    st = T.init_decode_state(tc, 3, 40, enc_len=enc, device="cpu")
    jst = JT.init_decode_state(jc, 3, 40, enc_len=enc)
    assert [tuple(t.shape) for t in jax.tree.leaves(
        st, is_leaf=torch.is_tensor)] == [x.shape for x in jax.tree.leaves(jst)]


def test_bridge_keeps_fp32_leaves_among_bf16():
    jc, _ = _cfgs("recurrentgemma-9b-L5", dtype="bfloat16")
    jp, tp = _params(jc)
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree.leaves(tp, is_leaf=torch.is_tensor)):
        key = path[-1].key
        assert str(t.dtype) == ("torch.float32" if key in ("ba", "lam")
                                else "torch.bfloat16"), path
        assert np.array_equal(t.float().numpy(), np.asarray(j, np.float32))


# ---------------------------------------------------------------------------
# Tree helpers on NamedTuple states
# ---------------------------------------------------------------------------

def _states():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    return [S.SSMState(conv=r(4, 3, 6), h=r(4, 6, 2)),
            R.RGLRUState(conv=r(4, 3, 5), h=r(4, 5)),
            KVCache(k=r(4, 7, 1, 2), v=r(4, 7, 1, 2))]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_index_and_stack_treat_namedtuple_states_field_by_field(which):
    layers_ = [_states()[which] for _ in range(3)]
    for i, st in enumerate(layers_):
        for t in st:
            if t is not None:
                t.add_(i)
    stacked = T._stack([{"self": s} for s in layers_])
    assert type(stacked["self"]) is type(layers_[0])
    for r in range(3):
        got = T._index(stacked, r)["self"]
        assert type(got) is type(layers_[0])
        for g_, w in zip(got, layers_[r]):
            assert (g_ is None) == (w is None)
            if w is not None:
                assert torch.equal(g_, w)


def test_state_utils_round_trip_recurrent_rows():
    _, tc = _cfgs("recurrentgemma-9b-L5")
    st = T.init_decode_state(tc, 4, 12, device="cpu")
    g = torch.Generator().manual_seed(1)
    for t in jax.tree.leaves(st, is_leaf=torch.is_tensor):
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    taken, kept = su.split(st, [2, 0], [1, 3])
    assert type(taken.reps[0]["self"]) is R.RGLRUState
    assert type(taken.rest[1]["self"]) is R.RGLRUState
    assert type(taken.reps[2]["self"]) is KVCache
    assert su.batch_size(taken) == 2
    back = su.take(su.concat([taken, kept]), [1, 2, 0, 3])
    for a, b in zip(jax.tree.leaves(back, is_leaf=torch.is_tensor),
                    jax.tree.leaves(st, is_leaf=torch.is_tensor)):
        assert torch.equal(a, b)
    assert torch.equal(taken.reps[0]["self"].h[:, 0], st.reps[0]["self"].h[:, 2])
    assert torch.equal(taken.rest[0]["self"].h[1], st.rest[0]["self"].h[0])
    _, fc = _cfgs("falcon-mamba-7b")
    st = T.init_decode_state(fc, 3, 8, device="cpu")
    got = su.concat(list(su.split(st, [1], [0, 2])))
    assert type(got.reps[0]["self"]) is S.SSMState
    assert tuple(got.reps[0]["self"].h.shape) == (3, 3, 256, 8)
