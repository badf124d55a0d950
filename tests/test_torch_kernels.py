"""repro_torch's kernels: plain versions vs the JAX reference on the CPU,
and the CUDA kernels vs those plain versions on a GPU.

The sweep is the one of tests/test_kernels.py (shapes, dtypes, masks).
Inputs come from a seeded numpy generator; bf16 inputs are the same f32
draws rounded to nearest even on both sides, so both see identical bits.
Tolerances are those of tests/test_kernels.py: 2e-5 in float32 (sums in
another order), 2e-2 in bfloat16 (one bf16 rounding of the output is
2^-8 relative).

The CUDA tests import no JAX, so the GPU machine runs this file alone:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402

FLASH_SHAPES = [
    (1, 64, 64, 4, 4, 32),      # MHA square
    (2, 96, 96, 8, 2, 64),      # GQA, non-block-multiple seq
    (1, 33, 128, 4, 1, 64),     # MQA, cross shapes
    (2, 200, 200, 8, 4, 128),   # 128-lane head dim
]
MASKS = [(True, None), (False, None), (True, 48)]
FLASH_CASES = [(*shape, dt, c, w) for shape in FLASH_SHAPES
               for dt in ("float32", "bfloat16") for c, w in MASKS
               if not (shape[1] != shape[2] and c)]   # causal cross-shape
# (8, 5120): the block norms' width, which takes the kernel's 256-thread
# block reduction; the narrower rows take its one-warp-per-row branch
NORM_CASES = [(T, D, dt) for T, D in [(16, 128), (37, 256), (100, 64),
                                      (8, 5120)]
              for dt in ("float32", "bfloat16")]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _np(t):
    return t.float().cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _flash_inputs(B, S, Skv, H, KV, hd):
    return _draw(0, (B, S, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))


@pytest.mark.parametrize("B,S,Skv,H,KV,hd,dtype,causal,window", FLASH_CASES)
def test_flash_plain_matches_reference(B, S, Skv, H, KV, hd, dtype, causal,
                                       window):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops as jops, ref as jref
    q, k, v = _flash_inputs(B, S, Skv, H, KV, hd)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    got = _np(ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                  causal=causal, window=window))
    pallas = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                             window=window, bq=64, bk=64),
                        np.float32)
    oracle = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal,
                                             window=window), np.float32)
    tol = _tol(dtype)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)


@pytest.mark.parametrize("T,D,dtype", NORM_CASES)
def test_rmsnorm_plain_matches_reference(T, D, dtype):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops as jops, ref as jref
    x, sc = _draw(3, (T, D), (D,))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    got = _np(ops.rmsnorm(_t(x, dtype), torch.from_numpy(sc)))
    pallas = np.asarray(jops.rmsnorm(jx, jnp.asarray(sc), bt=16), np.float32)
    oracle = np.asarray(jref.rmsnorm(jx, jnp.asarray(sc)), np.float32)
    tol = _tol(dtype)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launches()
    q, k, v = (_t(a, "float32") for a in _flash_inputs(1, 8, 8, 2, 1, 32))
    ops.flash_attention(q, k, v)
    ops.rmsnorm(q, torch.ones(32))
    assert ops.launches == {"flash_attention": 0, "rmsnorm": 0}


def test_cuda_launchers_raise_on_cpu_tensors():
    """A launcher never falls back to the plain version: it raises."""
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention_hm_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        RN.rmsnorm_cuda(torch.zeros(4, 8), torch.ones(8))


def test_build_names_each_library_by_its_source():
    from repro_torch.kernels import _build
    assert _build.sources() == ["flash_attention", "rmsnorm"]
    paths = [_build.lib_path(n) for n in _build.sources()]
    assert len(set(paths)) == 2 and all(p.parent == _build.BUILD
                                        for p in paths)
    assert paths == [_build.lib_path(n) for n in _build.sources()]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Skv,H,KV,hd,dtype,causal,window", FLASH_CASES)
def test_flash_cuda_matches_plain(cuda, B, S, Skv, H, KV, hd, dtype, causal,
                                  window):
    q, k, v = (_t(a, dtype, cuda) for a in _flash_inputs(B, S, Skv, H, KV, hd))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 1
    want = FA.flash_attention_hm_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window).transpose(1, 2)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,dtype", NORM_CASES)
def test_rmsnorm_cuda_matches_plain(cuda, T, D, dtype):
    x, sc = _draw(3, (T, D), (D,))
    xt, st = _t(x, dtype, cuda), _t(sc, "float32", cuda)
    ops.reset_launches()
    got = ops.rmsnorm(xt, st)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm"] == 1
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), _np(RN.rmsnorm_plain(xt, st)),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)          # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_hm_cuda(q, q[:, :1], q[:, :1])
    x = torch.zeros(4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        RN.rmsnorm_cuda(x, torch.ones(8, device=cuda))
