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

The fused selective scan (``ops.selective_scan``) takes dt, x, A, B, C:
its plain version is held to the reference block's discretization
followed by the Pallas kernel and ``ref.ssm_scan``.  The RG-LRU kernel's
chunked carry reassociates the recurrence, so a torch emulation of it is
held to ``ref.rglru_scan`` at 1e-5 here, and the kernel to its plain
version on the card.

The CUDA tests import no JAX, so the GPU machine runs this file alone:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

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
# (8, 5120) and (8, 4096): the block norms' widths, which take the
# kernel's 128-thread vector rows in bf16 (its scalar branch in fp32); the
# narrower rows share a warp; D 100 and 257 take the scalar branch (not a
# multiple of the 16-byte vector)
NORM_CASES = [(T, D, dt) for T, D in [(16, 128), (37, 256), (100, 64),
                                      (8, 5120), (8, 4096), (5, 100),
                                      (3, 257)]
              for dt in ("float32", "bfloat16")]
# the CUDA test: NORM_CASES and the kernel's edges (the path's widths and
# the scalar branch at 1, 8 and 4096 rows), each with an fp32 and a bf16
# scale
NORM_SWEEP = list(dict.fromkeys(
    (T, D, dt, sdt) for T, D, dt in NORM_CASES + [
        (T, D, dt) for D in (128, 256, 4096, 5120, 100, 257)
        for T in (1, 8, 4096) for dt in ("float32", "bfloat16")]
    for sdt in ("float32", "bfloat16")))

# the bf16 tensor-core kernel's edges, beyond FLASH_CASES: Sq and Skv not
# multiples of the 128-row q tile or the kv tile (128 keys; 64 at hd 128,
# 32 at hd 256),
# windows that end inside a tile, GQA groups G = H / KV of 1, 5 and 16,
# every head dim, B > 1
FLASH_EDGES = [
    (1, 333, 333, 40, 8, 128, "bfloat16", True, None),     # qwen3's G = 5
    (2, 333, 333, 10, 2, 128, "bfloat16", True, 77),
    (2, 33, 128, 16, 1, 128, "bfloat16", False, None),     # G = 16
    (1, 33, 128, 2, 2, 32, "bfloat16", False, None),       # G = 1
    (2, 200, 200, 4, 4, 32, "bfloat16", True, 50),
    (1, 300, 300, 8, 8, 64, "bfloat16", True, None),
    (2, 129, 129, 6, 3, 64, "bfloat16", True, 100),
    (1, 333, 333, 16, 1, 256, "bfloat16", True, 100),      # recurrentgemma
    (2, 33, 128, 16, 1, 256, "bfloat16", False, None),
    (1, 1000, 1000, 16, 1, 256, "bfloat16", True, 300),
    (2, 520, 520, 40, 8, 128, "bfloat16", False, None),
    # tensor-parallel prefill: each rank's heads of qwen3-14b on 2 model
    # ranks (20 / 4), and of reduced qwen3-14b on 4 (one q head reading
    # one of the replicated KV heads it keeps: 1 / 1)
    (2, 512, 512, 20, 4, 128, "bfloat16", True, None),
    (2, 24, 24, 1, 1, 32, "bfloat16", True, None),
]


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


def _flash_tiled_bf16(q, k, v, causal, window):
    """What the bf16 CUDA kernel computes, tile by tile, in torch on the
    CPU: 128-row q tiles split into two 64-row halves, kv tiles of 128 keys
    (64 at hd 128, 32 at hd 256) over the tiles the masks leave, scores in fp32 from the
    bf16 inputs with the scale applied after Q·Kᵀ, an online softmax in
    exp2 with the -1e30 sentinel, and P rounded to bf16 before P·V.

    q: (B, S, H, hd); k, v: (B, Skv, KV, hd), bf16 -> (B, S, H, hd) bf16.
    """
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    bk = {256: 32, 128: 64}.get(hd, 128)
    neg = -1e30
    c = math.log2(math.e) / math.sqrt(hd)
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    out = torch.zeros(B, H, S, hd)
    for q_lo in range(0, S, 128):
        k_end = min(Skv, q_lo + 128) if causal else Skv
        k_start = max(0, q_lo - window + 1) if window else 0
        for qa in range(q_lo, min(q_lo + 128, S), 64):
            rows = torch.arange(qa, min(qa + 64, S))
            qt = qh[:, :, rows]                        # (B, H, r, hd)
            m = torch.full((B, H, len(rows), 1), neg)
            l = torch.zeros(B, H, len(rows), 1)
            acc = torch.zeros(B, H, len(rows), hd)
            for t in range(k_start // bk, -(-k_end // bk)):
                k_lo = t * bk
                if causal and k_lo > qa + 63:
                    continue
                if window and k_lo + bk - 1 <= qa - window:
                    continue
                keys = torch.arange(k_lo, min(k_lo + bk, Skv))
                kt = kh[:, :, keys].repeat_interleave(H // KV, dim=1)
                vt = vh[:, :, keys].repeat_interleave(H // KV, dim=1)
                s = (qt @ kt.transpose(-1, -2)) * c
                ok = torch.ones(len(rows), len(keys), dtype=torch.bool)
                if causal:
                    ok &= keys[None, :] <= rows[:, None]
                if window:
                    ok &= keys[None, :] > rows[:, None] - window
                s = torch.where(ok, s, torch.full_like(s, neg))
                m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp2(m - m_cur)
                p = torch.exp2(s - m_cur)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.bfloat16().float() @ vt
                m = m_cur
            out[:, :, rows] = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).transpose(1, 2)


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


@pytest.mark.parametrize(
    "B,S,Skv,H,KV,hd,dtype,causal,window",
    [c for c in FLASH_CASES if c[6] == "bfloat16"] + FLASH_EDGES)
def test_flash_bf16_tiling_fits_the_reference(B, S, Skv, H, KV, hd, dtype,
                                              causal, window):
    """The bf16 kernel's tiling and rounding (P in bf16 before P·V) stays
    within the bf16 tolerance of the reference, before any card runs it."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ref as jref
    q, k, v = _flash_inputs(B, S, Skv, H, KV, hd)
    got = _np(_flash_tiled_bf16(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                causal, window))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    oracle = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal,
                                             window=window), np.float32)
    tol = _tol(dtype)
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


def _selective_inputs(B, S, D, N):
    """dt in softplus's range, x, B, C normal, A = -exp(A_log) around the
    model's -(1..N)."""
    rng = np.random.default_rng(5)
    A = -np.exp(np.log(np.arange(1, N + 1, dtype=np.float32))
                + 0.1 * rng.standard_normal((D, N))).astype(np.float32)
    return (rng.uniform(1e-3, 0.2, (B, S, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32), A,
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,D,N,bs,bd", SSM_CASES)
def test_selective_scan_plain_matches_reference(B, S, D, N, bs, bd, dtype):
    """The fused scan's plain version against the reference block's own
    discretization (src/repro/models/ssm.py) followed by the Pallas kernel
    (interpret mode) and ref.ssm_scan."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops as jops, ref as jref
    dt, x, A, Bm, Cm = _selective_inputs(B, S, D, N)
    y, h = ops.selective_scan(_t(dt, dtype), _t(x, dtype), torch.from_numpy(A),
                              _t(Bm, dtype), _t(Cm, dtype))
    assert y.dtype == h.dtype == torch.float32
    jdt, jx, jB, jC = (jnp.asarray(v, getattr(jnp, dtype))
                       for v in (dt, x, Bm, Cm))
    dtf = jdt.astype(jnp.float32)
    ja = jnp.exp(dtf[..., None] * jnp.asarray(A))
    jb = (dtf * jx.astype(jnp.float32))[..., None] * \
        jB.astype(jnp.float32)[:, :, None, :]
    jc = jC.astype(jnp.float32)
    for wy, wh in (jops.ssm_scan(ja, jb, jc, bs=bs, bd=bd),
                   jref.ssm_scan(ja, jb, jc)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=1e-4,
                                   rtol=1e-4)


def _rglru_chunked(a, b, L):
    """What the RG-LRU kernel computes, chunk by chunk, in torch: each chunk
    of L steps folds its aggregate (P = prod a, H = the scan from 0), its
    carry is the fold P_j * carry + H_j over the chunks before it (the value
    the look-back gives, whichever predecessor it stops at), and h is the
    chunk rescanned in sequence order from that carry."""
    h = torch.empty_like(a)
    carry = torch.zeros_like(a[:, 0])
    for c0 in range(0, a.shape[1], L):
        ac, bc = a[:, c0:c0 + L], b[:, c0:c0 + L]
        P, H = torch.ones_like(carry), torch.zeros_like(carry)
        for u in range(ac.shape[1]):
            H = ac[:, u] * H + bc[:, u]
            P = P * ac[:, u]
        hh = carry
        for u in range(ac.shape[1]):
            hh = ac[:, u] * hh + bc[:, u]
            h[:, c0 + u] = hh
        carry = P * carry + H
    return h


@pytest.mark.parametrize("chunk", [1, 7, 64, None])
@pytest.mark.parametrize("B,S,W,bs,bw", RGLRU_CASES)
def test_rglru_chunked_carry_fits_the_reference(B, S, W, bs, bw, chunk):
    """The kernel's chunk-and-carry composition (64-step chunks; also 1, 7
    and the whole sequence) stays within the scan's 1e-5 of the reference."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ref as jref
    a, b = _rglru_inputs(B, S, W)
    got = _rglru_chunked(torch.from_numpy(a), torch.from_numpy(b),
                         chunk or S).numpy()
    want = np.asarray(jref.rglru_scan(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


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
    ops.selective_scan(*(torch.from_numpy(x)
                         for x in _selective_inputs(1, 4, 8, 8)))
    q, s = ops.quantize_int8(q.reshape(-1, 32), floor=1e-8)
    assert q.dtype == torch.int8 and s.shape == (16, 1)
    kv = torch.zeros(1, 8, 2, 32)
    caches = ops.quantize_kv_prefill(kv, kv, W=8)
    assert caches[0].shape == (1, 8, 2, 32) and caches[2].shape == (1, 8, 2, 1)
    ops.quantize_kv_store_(kv[:, 0], kv[:, 0], *caches, torch.tensor([9]),
                           W=8)
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
        LS.selective_scan_cuda(x, x, torch.zeros(8, 8), x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        QZ.quantize_int8_cuda(torch.zeros(4, 8))


def test_build_names_each_library_by_its_source():
    from repro_torch.kernels import _build
    assert _build.sources() == ["flash_attention", "linear_scan", "quantize",
                                "rmsnorm", "selective_scan"]
    paths = [_build.lib_path(n) for n in _build.sources()]
    assert len(set(paths)) == 5 and all(p.parent == _build.BUILD
                                        for p in paths)
    assert paths == [_build.lib_path(n) for n in _build.sources()]


def test_build_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """An edited header renames every library whose source includes it,
    directly or through another header, and no other."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = _build.sources()
    before = {n: _build.lib_path(n) for n in names}
    users = {n for n in names if b'#include "hopper.cuh"'
             in (csrc / f"{n}.cu").read_bytes()}
    assert users == {"flash_attention", "selective_scan"}
    hdr = csrc / "hopper.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"// edited\n")
    edited = {n: _build.lib_path(n) for n in names}
    assert {n for n in names if edited[n] != before[n]} == users
    # a header that hopper.cuh includes counts too
    (csrc / "inner.cuh").write_text("#pragma once\n")
    hdr.write_bytes(hdr.read_bytes() + b'#include "inner.cuh"\n')
    nested = {n: _build.lib_path(n) for n in names}
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert {n for n in names if _build.lib_path(n) != nested[n]} == users


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Skv,H,KV,hd,dtype,causal,window",
                         FLASH_CASES + FLASH_EDGES)
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


# a tensor-parallel rank's chunk of heads whose KV heads it reads in
# unequal groups: qwen2-vl-7b's 28 heads and 4 KV heads on 8 model ranks,
# rank 1's heads 4-7 reading KV heads 0, 0, 0, 1 (B, S, first head, heads,
# KV heads, hd, group)
GROUPED = (2, 256, 4, 4, 2, 128, 7)


def _grouped_inputs(dtype, device="cpu"):
    B, S, first, H, KV, hd, group = GROUPED
    q, k, v = (_t(a, dtype, device) for a in _flash_inputs(B, S, S, H, KV,
                                                           hd))
    # the q heads' KV heads, expanded for the reference alone
    reads = [(first + i) // group - first // group for i in range(H)]
    return q, k, v, k[:, :, reads], v[:, :, reads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_grouped_runs_match_expanded_heads(dtype):
    """``attention.grouped_attention`` over heads that read KV heads in
    unequal groups, on the CPU (the flash wrapper's plain version and the
    chunked path): the same values as every q head against its own KV head,
    K / V never expanded."""
    from repro_torch.models import attention as A
    q, k, v, ke, ve = _grouped_inputs(dtype)
    first, group = GROUPED[2], GROUPED[6]
    want = ops.flash_attention(q, ke, ve, causal=True)
    for attend in (ops.flash_attention, A.chunked_attention):
        got = A.grouped_attention(attend, q, k, v, first, group, causal=True,
                                  window=None)
        tol = _tol(dtype)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cuda_grouped_runs_match_plain(cuda, dtype):
    """The kernel on a rank's chunk of heads that read KV heads in unequal
    groups: one launch per run of heads that read one KV head (two here),
    against the plain version on the expanded heads."""
    from repro_torch.models import attention as A
    q, k, v, ke, ve = _grouped_inputs(dtype, cuda)
    ops.reset_launches()
    got = A.grouped_attention(ops.flash_attention, q, k, v, GROUPED[2],
                              GROUPED[6], causal=True, window=None)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 2
    want = FA.flash_attention_hm_plain(
        q.transpose(1, 2), ke.transpose(1, 2), ve.transpose(1, 2),
        causal=True, window=None).transpose(1, 2)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,dtype,sdtype", NORM_SWEEP)
def test_rmsnorm_cuda_matches_plain(cuda, T, D, dtype, sdtype):
    x, sc = _draw(3, (T, D), (D,))
    xt, st = _t(x, dtype, cuda), _t(sc, sdtype, cuda)
    ops.reset_launches()
    got = ops.rmsnorm(xt, st)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm"] == 1
    tol = _tol(dtype) if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(RN.rmsnorm_plain(xt, st)),
                               atol=tol, rtol=tol)


# the kernel's chunks are 64 steps of 128 columns: S on either side of one
# and two chunk boundaries, W off the column tile, and recurrentgemma's B2
# S3072 prefill
RGLRU_EDGES = [(1, S, W, 0, 0) for S in (1, 63, 64, 65, 127, 128, 129)
               for W in (128, 130)] + [(3, 200, 4100, 0, 0),
                                       (2, 3072, 4096, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,bs,bw",
                         RGLRU_CASES + [(2, 333, 4100, 0, 0)] + RGLRU_EDGES)
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


# the fused kernel's edges: both dtypes, N 8 and 16, D off its d-tile (32
# d's at N 16, 64 at N 8) and S off its 64-step tile, B > 1
SELECTIVE_SWEEP = [(B, S, D, N, dt) for B, S, D, N in [
    (1, 64, 64, 8), (2, 77, 96, 16), (1, 1, 32, 16), (1, 63, 40, 16),
    (2, 65, 200, 8), (1, 129, 4104, 16), (2, 333, 4100, 16),
    (1, 77, 96, 8), (3, 200, 512, 16)] for dt in ("float32", "bfloat16")
    if (D * (2 if dt == "bfloat16" else 4)) % 16 == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,N,dtype", SELECTIVE_SWEEP)
def test_selective_scan_cuda_matches_plain(cuda, B, S, D, N, dtype):
    dt, x, A, Bm, Cm = _selective_inputs(B, S, D, N)
    args = [_t(v, dtype, cuda) for v in (dt, x)] + [
        torch.from_numpy(A).to(cuda)] + [_t(v, dtype, cuda) for v in (Bm, Cm)]
    ops.reset_launches()
    y, h = ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert ops.launches["ssm_scan"] == 1
    wy, wh = LS.selective_scan_plain(*args)
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
    flat = torch.zeros(2 * 8 * 64 + 8, device=cuda, dtype=torch.bfloat16)
    q = flat[1:1 + 2 * 8 * 64].view(1, 2, 8, 64)       # 2 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention_hm_cuda(q, q, q)
    x = torch.zeros(4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        RN.rmsnorm_cuda(x, torch.ones(8, device=cuda))
    a = torch.ones(1, 4, 6, 3, device=cuda)            # d_state 3
    with pytest.raises(ValueError, match="d_state"):
        LS.ssm_scan_cuda(a, a, a[..., 0, :].contiguous())
    with pytest.raises(ValueError, match="float32"):
        LS.rglru_scan_cuda(a[..., 0].double(), a[..., 0].double())
    dt = torch.ones(1, 4, 16, device=cuda)
    bc = torch.ones(1, 4, 8, device=cuda)
    A = -torch.ones(16, 8, device=cuda)
    with pytest.raises(ValueError, match="d_state"):          # N 4
        LS.selective_scan_cuda(dt, dt, A[:, :4].contiguous(), bc[..., :4]
                               .contiguous(), bc[..., :4].contiguous())
    with pytest.raises(ValueError, match="dtype"):            # float16
        LS.selective_scan_cuda(dt.half(), dt.half(), A, bc.half(), bc.half())
    with pytest.raises(ValueError, match="dtype"):            # mixed
        LS.selective_scan_cuda(dt.bfloat16(), dt, A, bc, bc)
    with pytest.raises(ValueError, match="16 bytes"):         # D 12 in bf16
        LS.selective_scan_cuda(dt[..., :12].bfloat16(), dt[..., :12]
                               .bfloat16(), A[:12].contiguous(),
                               bc.bfloat16(), bc.bfloat16())
    with pytest.raises(ValueError, match="float32"):          # A in bf16
        LS.selective_scan_cuda(dt, dt, A.bfloat16(), bc, bc)
    with pytest.raises(ValueError, match="contiguous"):
        LS.rglru_scan_cuda(a[..., 0].transpose(1, 2), a[..., 0].transpose(1, 2))
    with pytest.raises(ValueError, match="float32/bfloat16"):
        QZ.quantize_int8_cuda(x)
    with pytest.raises(ValueError, match="contiguous"):
        QZ.quantize_int8_cuda(torch.zeros(8, 4, device=cuda).t())
    with pytest.raises(ValueError, match=r"\(T, D\)"):
        QZ.quantize_int8_cuda(torch.zeros(2, 4, 8, device=cuda))


# gradient compression's leaves (rows of 1,024 fp32 values, one row of the
# leaf's size below that): short leaves, an exact multiple of 1,024, a
# zero-padded tail, a tail row whose real values are all zero (amax 0:
# the floor sets its scale), a bf16 leaf, and qwen3-14b's 151,936 x 5,120
# embedding (759,680 rows)
COMPRESS_LEAVES = [((1,), "float32", False), ((7,), "float32", False),
                   ((128,), "float32", False), ((1000,), "float32", False),
                   ((1023,), "float32", False), ((8, 128), "float32", False),
                   ((5000,), "float32", False), ((3, 1025), "float32", True),
                   ((4, 2048), "bfloat16", False),
                   ((151936, 5120), "float32", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,zero_tail", COMPRESS_LEAVES)
def test_compress_leaf_cuda_matches_plain_exactly(cuda, monkeypatch, shape,
                                                  dtype, zero_tail):
    from repro_torch.parallel import compression as C
    g = torch.Generator(device=cuda).manual_seed(0)
    x = 3.0 * torch.randn(shape, device=cuda, generator=g)
    if zero_tail:
        x.view(-1)[-(x.numel() % 1024):] = 0.0
    x = x.to(getattr(torch, dtype))
    ops.reset_launches()
    q, s, shp = C.compress_leaf(x)
    torch.cuda.synchronize()
    assert ops.launches["quantize_int8"] == 1 and shp == tuple(shape)
    row = min(x.numel(), 1024)
    assert q.shape == (-(-x.numel() // row), row)
    monkeypatch.setattr(C, "_quant",
                        lambda r: QZ.quantize_int8_plain(r, C.FLOOR))
    wq, ws, _ = C.compress_leaf(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    if zero_tail:
        assert float(s[-1]) == np.float32(1e-12) / np.float32(127.0)
        assert not q[-1].any()


@pytest.mark.cuda
def test_kernel_wrappers_refuse_autograd(cuda):
    """The kernels have no backward: a launch on a tensor autograd records
    raises; under no_grad it runs."""
    x = torch.randn(4, 128, device=cuda, requires_grad=True)
    scale = torch.ones(128, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.rmsnorm(x, scale)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.quantize_int8(x)
    q = torch.randn(1, 64, 4, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q, q, q)
    with torch.no_grad():
        ops.rmsnorm(x, scale)
        ops.quantize_int8(x)
