"""repro_torch's multimodal families against the JAX reference, same
weights: qwen2-vl-7b's M-RoPE with its vision stub, and whisper-base's
encoder-decoder (bidirectional encoder, cross-attention, sinusoidal
positions).

Reduced float32 configs on the CPU; the reference's parameter tree goes
through ``bridge.params_from_numpy``, and tokens, vision patch embeddings
and audio frame embeddings (24 frames, as tests/test_models.py) come from
a seeded numpy generator.  Tolerances:

* M-RoPE positions and the prefill's ``rope_offset``: exactly equal.
* encoder output, logits, caches: 1e-4 absolute (same math; XLA and
  PyTorch sum matmuls and softmaxes in other orders).
* greedy tokens: identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

B, S, STEPS, FRAMES = 2, 32, 4, 24


def _setup(arch):
    jc = jget_config(arch, reduced=True).replace(dtype="float32")
    tc = get_config(arch, reduced=True).replace(dtype="float32")
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _runtimes(use_kernels=False):
    # the reference's kernels run in Pallas interpret mode on the CPU; the
    # port's wrappers take their plain versions for CPU tensors
    jrt = JT.Runtime(production=False, remat=False, use_kernels=use_kernels,
                     q_block=16, kv_block=16)
    trt = T.Runtime(use_kernels=use_kernels, q_block=16, kv_block=16)
    return jrt, trt


def _batches(cfg, extra=None, seed=1):
    """The same batch for both packages: tokens, plus the ``extra`` stub
    input (``vision_embeds`` or ``audio_embeds``) of that many rows."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    jb, tb = ({"tokens": jnp.asarray(toks, jnp.int32)},
              {"tokens": torch.as_tensor(toks)})
    if extra is not None:
        key, n = extra
        e = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        jb[key], tb[key] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]


def _assert_trees_close(got, want, atol=1e-4):
    g, w = _leaves(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=0, err_msg=str(path))


def _greedy_decode(jc, tc, jp, tp, jl, tl, jst, tst, jrt, trt):
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
    assert np.array_equal(tst.pos.numpy(), np.asarray(jst.pos))


# -- qwen2-vl: M-RoPE and the vision stub ---------------------------------------

@pytest.mark.parametrize("b,s,v", [(2, 32, 16), (1, 20, 0), (3, 40, 10),
                                   (2, 9, 9), (1, 1, 0), (2, 1100, 1024)])
def test_mrope_positions_match_reference(b, s, v):
    want = np.asarray(JT._mrope_positions(b, s, v))
    got = T._mrope_positions(b, s, v)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("vision", [True, False])
def test_qwen2vl_logits_prefill_and_decode_match_reference(vision):
    """Logits with and without the vision prefix, the prefill's
    ``rope_offset`` exactly, then greedy decode steps, whose M-RoPE
    positions run from ``pos + rope_offset``."""
    jc, tc, jp, tp = _setup("qwen2-vl-7b")
    jrt, trt = _runtimes()
    extra = ("vision_embeds", tc.max_vision_tokens) if vision else None
    jb, tb = _batches(tc, extra)
    want, _ = JT.logits_fn(jp, jb, jc, jrt)
    got, _ = T.logits_fn(tp, tb, tc, trt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    window = S + STEPS
    jl, jst = JT.prefill(jp, jb, jc, jrt, window=window)
    tl, tst = T.prefill(tp, tb, tc, trt, window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert np.array_equal(tst.rope_offset.numpy(), np.asarray(jst.rope_offset))
    assert int(tst.rope_offset[0]) == (4 - 16 if vision else 0)
    _greedy_decode(jc, tc, jp, tp, jl, tl, jst, tst, jrt, trt)


# -- whisper: encoder, cross-attention, sinusoidal positions --------------------

def test_whisper_encode_matches_reference():
    jc, tc, jp, tp = _setup("whisper-base")
    e = np.random.default_rng(2).standard_normal(
        (B, FRAMES, tc.d_model)).astype(np.float32)
    want = JT.encode(jp, jnp.asarray(e), jc,
                     JT.Runtime(production=False, remat=False))
    for use_kernels in (False, True):
        got = T.encode(tp, torch.from_numpy(e), tc,
                       T.Runtime(use_kernels=use_kernels))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_whisper_logits_prefill_and_decode_match_reference(use_kernels):
    """Logits, the prefill's decode state (self and ``"cross"`` caches of
    every decoder block), then greedy decode steps with the new token's
    sinusoidal position and cross-attention over all 24 frames."""
    jc, tc, jp, tp = _setup("whisper-base")
    jrt, trt = _runtimes(use_kernels)
    jb, tb = _batches(tc, ("audio_embeds", FRAMES))
    want, _ = JT.logits_fn(jp, jb, jc, jrt)
    got, _ = T.logits_fn(tp, tb, tc, trt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    window = S + STEPS
    jl, jst = JT.prefill(jp, jb, jc, jrt, window=window)
    tl, tst = T.prefill(tp, tb, tc, trt, window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    _assert_trees_close(tst.reps, jst.reps)
    cross = tst.reps[0]["cross"]
    assert tuple(cross.k.shape) == (tc.num_layers, B, FRAMES,
                                    tc.num_kv_heads, tc.resolved_head_dim)
    _greedy_decode(jc, tc, jp, tp, jl, tl, jst, tst, jrt, trt)


# -- the serving launcher --------------------------------------------------------

def test_serve_launcher_runs_qwen2vl_on_cpu(capsys):
    serve_launcher.main(["--device", "cpu", "--arch", "qwen2-vl-7b",
                         "--requests", "4", "--capacity", "4"])
    out = capsys.readouterr().out
    assert '"completed": 4' in out and '"device": "cpu"' in out


def test_serve_launcher_refuses_whisper_with_a_reason(capsys):
    with pytest.raises(SystemExit) as exc:
        serve_launcher.main(["--device", "cpu", "--arch", "whisper-base"])
    assert exc.value.code == 2
    assert "audio_embeds" in capsys.readouterr().err
