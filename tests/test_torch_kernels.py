"""repro_torch's kernels: plain versions vs the JAX reference on the CPU,
and the CUDA kernels vs those plain versions on a GPU.

The sweep is the one of tests/test_kernels.py (shapes, dtypes, masks).
Inputs come from a seeded numpy generator; bf16 inputs are the same f32
draws rounded to nearest even on both sides, so both see identical bits.
Tolerances are those of tests/test_kernels.py: 2e-5 in float32 (sums in
another order), 2e-2 in bfloat16 (one bf16 rounding of the output is
2^-8 relative); the scans 1e-5 (RG-LRU) and 1e-4 (selective scan, whose
contraction over N sums in another order) relative and absolute.  The
int8 quantizer: at most 1 code and scales within rtol 1e-6 against the
reference, with the reconstruction bound of tests/test_kernels.py; the
CUDA kernel does the plain version's IEEE operations, so on the card its
codes and scales must be equal exactly.

The CUDA tests import no JAX, so the GPU machine runs this file alone:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import linear_scan as LS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as QZ  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402

FLASH_SHAPES = [
    (1, 64, 64, 4, 4, 32),      # MHA square
    (2, 96, 96, 8, 2, 64),      # GQA, non-block-multiple seq
    (1, 33, 128, 4, 1, 64),     # MQA, cross shapes
    (2, 200, 200, 8, 4, 128),   # 128-lane head dim
    (1, 80, 80, 4, 1, 256),     # recurrentgemma's MQA head dim
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


# (B, S, W, bs, bw) and (B, S, D, N, bs, bd): the sweeps of
# tests/test_kernels.py, with the Pallas blocks they run the reference at
RGLRU_CASES = [(1, 64, 64, 32, 32), (2, 100, 96, 32, 64), (1, 257, 33, 64, 16)]
SSM_CASES = [(1, 64, 64, 8, 32, 32), (2, 77, 96, 16, 32, 64),
             (1, 130, 48, 4, 64, 48)]


# (T, D, dtype, floor): tests/test_kernels.py's sweep, at the TPU kernel's
# floor and at the KV cache's
QUANT_CASES = [(T, D, dt, fl) for T, D in [(8, 64), (33, 257), (128, 1024)]
               for dt in ("float32", "bfloat16") for fl in (1e-12, 1e-8)]


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


def _rglru_inputs(B, S, W):
    rng = np.random.default_rng(1)
    return (rng.uniform(0.4, 0.999, (B, S, W)).astype(np.float32),
            rng.standard_normal((B, S, W)).astype(np.float32))


def _ssm_inputs(B, S, D, N):
    rng = np.random.default_rng(2)
    return (rng.uniform(0.4, 0.999, (B, S, D, N)).astype(np.float32),
            (rng.standard_normal((B, S, D, N)) * 0.1).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


@pytest.mark.parametrize("B,S,W,bs,bw", RGLRU_CASES)
def test_rglru_scan_plain_matches_reference(B, S, W, bs, bw):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops as jops, ref as jref
    a, b = _rglru_inputs(B, S, W)
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for want in (jops.rglru_scan(ja, jb, bs=bs, bw=bw),
                 jref.rglru_scan(ja, jb)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("B,S,D,N,bs,bd", SSM_CASES)
def test_ssm_scan_plain_matches_reference(B, S, D, N, bs, bd):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops as jops, ref as jref
    a, b, c = _ssm_inputs(B, S, D, N)
    y, h = ops.ssm_scan(*(torch.from_numpy(x) for x in (a, b, c)))
    ja, jb, jc = (jnp.asarray(x) for x in (a, b, c))
    for wy, wh in (jops.ssm_scan(ja, jb, jc, bs=bs, bd=bd),
                   jref.ssm_scan(ja, jb, jc)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=1e-4,
                                   rtol=1e-4)


def _quant_input(T, D):
    """normal * 3 (tests/test_kernels.py), with a zero row and a row whose
    amax lies between the two floors, so that each floor shows."""
    x = np.random.default_rng(4).standard_normal((T, D)).astype(np.float32)
    x *= 3.0
    x[1] = 0.0
    x[2] *= np.float32(1e-9) / np.abs(x[2]).max()      # amax 1e-9
    return x


@pytest.mark.parametrize("T,D,dtype,floor", QUANT_CASES)
def test_quantize_int8_plain_matches_reference(T, D, dtype, floor):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops as jops, ref as jref
    from repro.models import attention as jattn
    x = _quant_input(T, D)
    xt = _t(x, dtype)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    q, s = QZ.quantize_int8_plain(xt, floor)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (T, D) and s.shape == (T, 1)
    if floor == 1e-12:      # the TPU kernel's floor: its oracle and kernel
        wants = [jref.quantize_int8(jx), jops.quantize_int8(jx, bt=16)]
    else:                   # the KV cache's floor: the reference's inline one
        wants = [jattn._quantize_kv(jx)]
    for wq, ws in wants:
        diff = np.abs(q.numpy().astype(np.int32)
                      - np.asarray(wq).astype(np.int32))
        assert diff.max() <= 1
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)
    xf = xt.float().numpy()
    # reconstruction error bounded by half a quantization step per row
    err = np.abs(QZ.dequantize_int8(q, s).numpy() - xf).max(axis=1)
    bound = np.maximum(np.abs(xf).max(axis=1), np.float32(floor)) / 127.0
    assert np.all(err <= bound * 1.01)
    assert not q[1].any()
    assert float(s[1, 0]) == np.float32(floor) / np.float32(127.0)
    tiny = np.float32(np.abs(xf[2]).max())               # ~1e-9
    assert 1e-12 < tiny < 1e-8
    assert float(s[2, 0]) == max(tiny, np.float32(floor)) / np.float32(127.0)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launches()
    q, k, v = (_t(a, "float32") for a in _flash_inputs(1, 8, 8, 2, 1, 32))
    ops.flash_attention(q, k, v)
    ops.rmsnorm(q, torch.ones(32))
    ops.rglru_scan(*(torch.from_numpy(x) for x in _rglru_inputs(1, 4, 8)))
    ops.ssm_scan(*(torch.from_numpy(x) for x in _ssm_inputs(1, 4, 8, 4)))
    q, s = ops.quantize_int8(q.reshape(-1, 32), floor=1e-8)
    assert q.dtype == torch.int8 and s.shape == (16, 1)
    assert ops.launches == {"flash_attention": 0, "rmsnorm": 0,
                            "ssm_scan": 0, "rglru_scan": 0,
                            "quantize_int8": 0}


def test_cuda_launchers_raise_on_cpu_tensors():
    """A launcher never falls back to the plain version: it raises."""
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention_hm_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        RN.rmsnorm_cuda(torch.zeros(4, 8), torch.ones(8))
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        LS.rglru_scan_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        LS.ssm_scan_cuda(x[..., None], x[..., None], x[:, :, :1])
    with pytest.raises(ValueError, match="CUDA device"):
        QZ.quantize_int8_cuda(torch.zeros(4, 8))


def test_build_names_each_library_by_its_source():
    from repro_torch.kernels import _build
    assert _build.sources() == ["flash_attention", "linear_scan", "quantize",
                                "rmsnorm"]
    paths = [_build.lib_path(n) for n in _build.sources()]
    assert len(set(paths)) == 4 and all(p.parent == _build.BUILD
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
@pytest.mark.parametrize("B,S,W,bs,bw", RGLRU_CASES + [(2, 333, 4100, 0, 0)])
def test_rglru_scan_cuda_matches_plain(cuda, B, S, W, bs, bw):
    a, b = (torch.from_numpy(x).to(cuda) for x in _rglru_inputs(B, S, W))
    ops.reset_launches()
    got = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan"] == 1
    np.testing.assert_allclose(_np(got), _np(LS.rglru_scan_plain(a, b)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,N,bs,bd",
                         SSM_CASES + [(2, 333, 4100, 16, 0, 0),
                                      (1, 77, 96, 8, 0, 0),
                                      (1, 9, 5, 32, 0, 0)])
def test_ssm_scan_cuda_matches_plain(cuda, B, S, D, N, bs, bd):
    a, b, c = (torch.from_numpy(x).to(cuda) for x in _ssm_inputs(B, S, D, N))
    ops.reset_launches()
    y, h = ops.ssm_scan(a, b, c)
    torch.cuda.synchronize()
    assert ops.launches["ssm_scan"] == 1
    wy, wh = LS.ssm_scan_plain(a, b, c)
    np.testing.assert_allclose(_np(y), _np(wy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(h), _np(wh), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,dtype,floor",
                         QUANT_CASES + [(73728, 128, "bfloat16", 1e-8),
                                        (64, 128, "bfloat16", 1e-8),
                                        (5, 300, "float32", 1e-12),
                                        (3, 1, "bfloat16", 1e-8)])
def test_quantize_int8_cuda_matches_plain_exactly(cuda, T, D, dtype, floor):
    xt = _t(_quant_input(T, D), dtype, cuda)
    ops.reset_launches()
    q, s = ops.quantize_int8(xt, floor)
    torch.cuda.synchronize()
    assert ops.launches["quantize_int8"] == 1
    wq, ws = QZ.quantize_int8_plain(xt, floor)
    assert torch.equal(q, wq) and torch.equal(s, ws)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)          # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_hm_cuda(q, q[:, :1], q[:, :1])
    x = torch.zeros(4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        RN.rmsnorm_cuda(x, torch.ones(8, device=cuda))
    a = torch.ones(1, 4, 6, 3, device=cuda)            # d_state 3
    with pytest.raises(ValueError, match="d_state"):
        LS.ssm_scan_cuda(a, a, a[..., 0, :].contiguous())
    with pytest.raises(ValueError, match="float32"):
        LS.rglru_scan_cuda(a[..., 0].double(), a[..., 0].double())
    with pytest.raises(ValueError, match="contiguous"):
        LS.rglru_scan_cuda(a[..., 0].transpose(1, 2), a[..., 0].transpose(1, 2))
    with pytest.raises(ValueError, match="float32/bfloat16"):
        QZ.quantize_int8_cuda(x)
    with pytest.raises(ValueError, match="contiguous"):
        QZ.quantize_int8_cuda(torch.zeros(8, 4, device=cuda).t())
    with pytest.raises(ValueError, match=r"\(T, D\)"):
        QZ.quantize_int8_cuda(torch.zeros(2, 4, 8, device=cuda))
