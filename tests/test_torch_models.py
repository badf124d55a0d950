"""repro_torch's dense transformer against the JAX reference, same weights.

The reference's parameter tree goes through ``bridge.params_from_numpy``,
so both packages compute with bit-identical weights on the CPU.  Token
inputs come from a seeded numpy generator.  Tolerances:

* float32 logits: 1e-4 absolute.  Same math, but XLA and PyTorch sum
  matmuls and softmaxes in different orders (≈1e-6 relative per op over
  3 layers).
* greedy tokens in float32: identical (argmax ties resolve to the first
  index on both sides).
* bfloat16 logits: 5e-2 absolute.  Both sides round to bf16 after every
  matmul, but not always at the same points (≈4e-3 relative per
  rounding, compounded over 3 layers).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

B, S, STEPS = 2, 16, 20

CASES = {
    "plain": {},
    "kernels": {"use_kernels": True},
    "kv_quant": {"kv_quant": True},
    "window8": {"window": 8},
}


def _cfgs(dtype="float32", window=None):
    jc = jget_config("qwen3-14b", reduced=True).replace(dtype=dtype)
    tc = get_config("qwen3-14b", reduced=True).replace(dtype=dtype)
    if window is not None:
        jc, tc = jc.replace(attn_window=window), tc.replace(attn_window=window)
    return jc, tc


def _params(jc):
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _runtimes(use_kernels=False, kv_quant=False):
    # reference kernels run in Pallas interpret mode on the CPU, with the
    # same small blocks as tests/test_models.py
    jrt = JT.Runtime(production=False, remat=False, use_kernels=use_kernels,
                     kv_quant=kv_quant, q_block=32, kv_block=32)
    trt = T.Runtime(use_kernels=use_kernels, kv_quant=kv_quant, q_block=32,
                    kv_block=32)
    return jrt, trt


def _tokens(vocab, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_logits_fn_matches_reference():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    jrt, trt = _runtimes()
    toks = _tokens(jc.vocab_size)
    want, _ = JT.logits_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           jc, jrt)
    got = T.logits_fn(tp, {"tokens": torch.as_tensor(toks)}, tc, trt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_greedy_decode_match_reference(case):
    opts = CASES[case]
    jc, tc = _cfgs(window=opts.get("window"))
    jp, tp = _params(jc)
    jrt, trt = _runtimes(opts.get("use_kernels", False),
                         opts.get("kv_quant", False))
    toks = _tokens(jc.vocab_size)
    horizon = S + STEPS
    jl, jst = JT.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
                         jrt, window=horizon)
    tl, tst = T.prefill(tp, {"tokens": torch.as_tensor(toks)}, tc, trt,
                        window=horizon)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)

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


def test_bf16_logits_within_tolerance():
    jc, tc = _cfgs(dtype="bfloat16")
    jp, tp = _params(jc)
    jrt, trt = _runtimes()
    toks = _tokens(jc.vocab_size)
    want, _ = JT.logits_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           jc, jrt)
    got = T.logits_fn(tp, {"tokens": torch.as_tensor(toks)}, tc, trt)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2,
                               rtol=0)


def test_init_model_shapes_match_reference_tree():
    """init_model builds the reference's tree: same keys, shapes, dtypes."""
    jc, tc = _cfgs(dtype="bfloat16")
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tp = T.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.empty(t.shape), tp,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    assert [x.shape for _, x in jflat] == [x.shape for _, x in tflat]
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert T.count_params(tp) == tc.param_count()


def test_unsupported_families_raise():
    for arch in ("deepseek-moe-16b", "falcon-mamba-7b", "recurrentgemma-9b",
                 "whisper-base", "qwen2-vl-7b"):
        cfg = get_config(arch, reduced=True)
        with pytest.raises(NotImplementedError, match="queue 1, item 7"):
            T.init_model(cfg, torch.Generator(), device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen3-14b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_model(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_decode_state(cfg, 1, 8)


@pytest.mark.parametrize("activation", ["swiglu", "relu2", "gelu"])
def test_layer_helpers_match_reference(activation):
    """The layers this slice carries beyond the qwen3 path, in float32."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    h = rng.standard_normal((2, 6, 32)).astype(np.float32)
    mp = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
          [("wi_gate", (32, 48)), ("wi_up", (32, 48)), ("wo", (48, 32))]}
    np.testing.assert_allclose(
        L.mlp({k: torch.from_numpy(v) for k, v in mp.items()},
              torch.from_numpy(h), activation).numpy(),
        np.asarray(JL.mlp({k: jnp.asarray(v) for k, v in mp.items()},
                          jnp.asarray(h), activation)), atol=1e-5)
    pos = np.stack([np.arange(6), np.arange(6) // 2, np.arange(6) % 2])
    pos = np.broadcast_to(pos[None], (2, 3, 6)).copy()
    np.testing.assert_allclose(
        L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                      (4, 2, 2)).numpy(),
        np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                                  (4, 2, 2))), atol=1e-5)
    np.testing.assert_allclose(L.sinusoidal_positions(7, 16).numpy(),
                               np.asarray(JL.sinusoidal_positions(7, 16)),
                               atol=1e-5)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    toks = rng.integers(0, 11, (2, 6))
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = L.next_token_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                                None if m is None else torch.from_numpy(m))
        want = JL.next_token_loss(jnp.asarray(logits), jnp.asarray(toks),
                                  None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), atol=1e-5)
