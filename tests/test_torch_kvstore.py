"""The int8 KV-cache stores (``kernels.ops.quantize_kv_store_`` and
``quantize_kv_prefill``) against the JAX reference, and the CUDA kernel
against their plain versions.

On the CPU the plain stores are held to the reference's own cache
updates, bit for bit: ``_decode_core``'s quantize and ``_write_slot_update``
over several steps past a ring wrap (also with a slot window
``offset``/``s_loc`` that leaves rows out of range), and
``prefill_cache(quant=True)``'s slice, roll, zero pad and quantize.  The
reference runs op by op (not under ``jit``, where XLA multiplies by the
reciprocal of 127 instead of dividing), on the K/V values it projected
itself.  Inputs come from a seeded numpy generator; bf16 inputs are the
same f32 draws rounded to nearest even on both sides.

On the card (``cuda`` marker, skipped without one) each of the kernel's
three entries must equal its plain version exactly: codes, scales, and
every slot a decode step does not write (sentinels).  The GPU machine runs
these alone: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kvstore.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as QZ  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402

FLOOR = 1e-8          # the int8 KV cache's, the reference _quantize_kv's


def _t(x, dtype, device="cpu"):
    return torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype)).to(device)


def _sentinel_caches(rng, B, s_loc, KV, hd, device="cpu"):
    """int8 caches and f32 scales filled with values no store writes
    (scales 5-6, far above any |x|/127 drawn here)."""
    k, v = (torch.as_tensor(rng.integers(-127, 128, (B, s_loc, KV, hd)),
                            dtype=torch.int8, device=device) for _ in "kv")
    ks, vs = (torch.as_tensor(5 + rng.random((B, s_loc, KV, 1)),
                              dtype=torch.float32, device=device)
              for _ in "kv")
    return [k, v, ks, vs]


def _draw(rng, shape):
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0           # a zero vector: the floor
    return x


# ---------------------------------------------------------------------------
# CPU: the plain stores against the reference
# ---------------------------------------------------------------------------

# (W, offset, s_loc): the whole ring; a window of it that leaves rows out
# of range (the sequence-sharded decode's form); a ring that wraps often
RING_CASES = [(8, 0, 8), (8, 3, 4), (5, 0, 5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,offset,s_loc", RING_CASES)
def test_decode_store_plain_matches_reference_decode_core(dtype, W, offset,
                                                          s_loc):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models import attention as JA
    rng = np.random.default_rng(11)
    B, KV, hd, steps = 3, 2, 16, 12
    caches = _sentinel_caches(rng, B, s_loc, KV, hd)
    jcache = JA.KVCache(*(jnp.asarray(c.numpy()) for c in caches))
    pos = np.array([0, 3, 6], dtype=np.int64)       # wraps W within 12 steps
    skipped = 0                                     # rows out of range
    for _ in range(steps):
        slot = pos % W - offset
        skipped += int(((slot < 0) | (slot >= s_loc)).sum())
        nk, nv = _draw(rng, (B, KV, hd)), _draw(rng, (B, KV, hd))
        jdt = getattr(jnp, dtype)
        q = jnp.zeros((B, 1, KV, hd), jdt)
        _, jcache = JA._decode_core(
            q, jcache, jnp.asarray(nk, jdt)[:, None],
            jnp.asarray(nv, jdt)[:, None], jnp.asarray(pos), W=W,
            offset=offset, s_loc=s_loc, update=True)
        QZ.quantize_kv_store_plain_(_t(nk, dtype), _t(nv, dtype), *caches,
                                    torch.from_numpy(pos), W, offset, FLOOR)
        for got, want in zip(caches, jcache):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        pos += 1
    assert (skipped > 0) == (s_loc < W)


@pytest.fixture(scope="module")
def jattn():
    """A reduced qwen3 attention layer of the reference, fp32 and bf16."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget_config
    from repro.models import attention as JA
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = jget_config("qwen3-14b", reduced=True).replace(dtype=dtype)
        out[dtype] = (cfg, JA.init_attention(jax.random.PRNGKey(3), cfg)[0])
    return out


# S < W (zero-padded tail slots), S == W, S > W with (S - W) mod W != 0
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (13, 5)])
def test_prefill_store_plain_matches_reference_prefill_cache(jattn, dtype,
                                                             S, W):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models import attention as JA
    cfg, params = jattn[dtype]
    B = 2
    x = jnp.asarray(np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32), getattr(jnp, dtype))
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    want = JA.prefill_cache(params, x, positions, cfg, window_override=W,
                            quant=True)
    _, k, v = JA._project_qkv(params, x, cfg, positions)
    k, v = (torch.from_numpy(np.array(t.astype(jnp.float32))).to(
        getattr(torch, dtype)) for t in (k, v))
    got = QZ.quantize_kv_prefill_plain(k, v, W, FLOOR)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if S < W:        # the zero pad's scale, not init_cache's 1.0
        assert (got[2][:, S:] == np.float32(FLOOR) / np.float32(127)).all()
        assert not got[0][:, S:].any()


@pytest.mark.parametrize("S,W", [(S, W) for W in (1, 3, 4, 7)
                                 for S in (1, W - 1, W, W + 1, 2 * W + 3)
                                 if S > 0])
def test_kernel_slot_formula_matches_ring_layout(S, W):
    """The prefill kernel's own map from slot j to position p
    (``csrc/quantize.cu::locate``: p = S - W + ((j - (S - W)) mod W) when
    S >= W, else j, or a zero row past S) gives ``ring_layout``'s slots."""
    x = torch.arange(1, S + 1, dtype=torch.float32).reshape(1, S, 1, 1)
    want = QZ.ring_layout(x, W).reshape(W).tolist()
    got = []
    for j in range(W):
        if S >= W:
            p = S - W + (j - (S - W)) % W
        else:
            p = j if j < S else -1
        got.append(float(p + 1) if p >= 0 else 0.0)
    assert got == want


def _layer(dtype="float32"):
    """A reduced qwen3 attention layer of the port without qk-norm, so that
    ``use_kernels`` changes nothing upstream of the cache stores."""
    cfg = get_config("qwen3-14b", reduced=True).replace(dtype=dtype,
                                                         qk_norm=False)
    g = torch.Generator().manual_seed(0)
    return cfg, PA.init_attention(cfg, "cpu", g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_path_on_cpu_equals_plain_path_and_counts_no_launch(dtype):
    """``use_kernels=True`` on CPU tensors takes the plain stores: the
    prefill ring and 10 decode writes (past the wrap) equal the
    ``use_kernels=False`` path's exactly, and no launch is counted."""
    cfg, params = _layer(dtype)
    rng = np.random.default_rng(2)
    B, S, W = 2, 5, 7
    x = _t(rng.standard_normal((B, S, cfg.d_model)), dtype)
    positions = torch.arange(S).expand(B, S)
    ops.reset_launches()
    caches = [PA.prefill_cache(params, x, positions, cfg, window_override=W,
                               quant=True, use_kernels=k) for k in (True,
                                                                    False)]
    for a, b in zip(*caches):
        assert torch.equal(a, b)
    pos = torch.tensor([S, S - 2])
    for _ in range(10):
        xn = _t(rng.standard_normal((B, 1, cfg.d_model)), dtype)
        outs = []
        for i, k in enumerate((True, False)):
            out, caches[i] = PA.decode_attention(params, caches[i], xn, pos,
                                                 cfg, use_kernels=k)
            outs.append(out)
        assert torch.equal(outs[0], outs[1])
        for a, b in zip(*caches):
            assert torch.equal(a, b)
        pos = pos + 1
    assert ops.launches["quantize_int8"] == 0


def test_store_launchers_raise_on_what_the_kernel_does_not_take():
    """Checked before any launch, so on the CPU too: a non-contiguous
    cache raises (a copy would drop the in-place write), as do wrong
    dtypes and shapes; well-formed CPU tensors raise for want of a card."""
    rng = np.random.default_rng(0)
    B, W, KV, hd = 2, 6, 2, 16
    nk = _t(_draw(rng, (B, KV, hd)), "float32")
    caches = _sentinel_caches(rng, B, W, KV, hd)
    pos = torch.tensor([3, 9])
    store = QZ.quantize_kv_store_cuda_
    with pytest.raises(ValueError, match="CUDA device"):
        store(nk, nk, *caches, pos, W)
    strided = torch.zeros(B, KV, W, hd, dtype=torch.int8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous caches"):
        store(nk, nk, strided, *caches[1:], pos, W)
    with pytest.raises(ValueError, match="contiguous caches"):
        store(nk, nk, *caches[:3], caches[3].transpose(0, 1)
              .contiguous().transpose(0, 1), pos, W)
    with pytest.raises(ValueError, match="int8"):
        store(nk, nk, caches[0].float(), *caches[1:], pos, W)
    with pytest.raises(ValueError, match="int64"):
        store(nk, nk, *caches, pos.int(), W)
    with pytest.raises(ValueError, match="one dtype"):
        store(nk, nk.bfloat16(), *caches, pos, W)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        store(nk.half(), nk.half(), *caches, pos, W)
    with pytest.raises(ValueError, match="contiguous inputs"):
        wide = torch.zeros(B, KV, 2 * hd)[..., ::2]
        store(wide, wide, *caches, pos, W)
    kv = _t(_draw(rng, (B, 5, KV, hd)), "bfloat16")
    with pytest.raises(ValueError, match="CUDA device"):
        QZ.quantize_kv_prefill_cuda(kv, kv, W)
    with pytest.raises(ValueError, match="4-d"):
        QZ.quantize_kv_prefill_cuda(kv[0], kv[0], W)


def _launch(entry, x, floor):
    """One call of a launcher on rows ``x`` (B, KV, hd): the rows entry on
    them flattened, the decode store into a fresh ring slot 0, the prefill
    store as a one-position prompt.  Returns what it wrote."""
    B, KV, hd = x.shape
    if entry == "rows":
        return QZ.quantize_int8_cuda(x.reshape(-1, hd), floor)
    if entry == "prefill":
        return QZ.quantize_kv_prefill_cuda(x[:, None], x[:, None], 1, floor)
    caches = [torch.zeros(B, 1, KV, hd, dtype=torch.int8, device=x.device)
              for _ in "kv"]
    caches += [torch.ones(B, 1, KV, 1, device=x.device) for _ in "kv"]
    QZ.quantize_kv_store_cuda_(x, x, *caches,
                               torch.zeros(B, dtype=torch.int64,
                                           device=x.device), 1, 0, floor)
    return caches


@pytest.mark.parametrize("entry", ["rows", "decode", "prefill"])
@pytest.mark.parametrize("floor", [0.0, 1e-40, 1e-37])
def test_launchers_raise_on_a_floor_that_allows_a_subnormal_scale(entry,
                                                                   floor):
    """Below ``FLOOR_MIN`` a scale can be subnormal, where the kernel's
    clip-free conversion would wrap: each launcher refuses, before it looks
    at the device."""
    x = torch.zeros(2, 1, 8)
    with pytest.raises(ValueError, match="subnormal"):
        _launch(entry, x, floor)


# ---------------------------------------------------------------------------
# CUDA: the kernel's entries against their plain versions, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), int((g != w).sum())


# D: one value, a ragged row, rows of 8 and of 16-byte loads a lane, a
# row too long for registers; each aligned and one element off 16 bytes
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 7, 64, 128, 256, 1000, 4096])
@pytest.mark.parametrize("misaligned", [False, True])
def test_quantize_int8_cuda_rows_match_plain(cuda, dtype, D, misaligned):
    rng = np.random.default_rng(D)
    T = 37
    x = _draw(rng, (T, D))
    x[2] *= 1e-9 / np.abs(x[2]).max()          # amax between the floors
    flat = np.zeros(T * D + 1, np.float32)
    flat[int(misaligned):][:T * D] = x.reshape(-1)
    xt = _t(flat, dtype, cuda)[int(misaligned):][:T * D].view(T, D)
    assert (xt.data_ptr() % 16 != 0) == misaligned
    ops.reset_launches()
    got = ops.quantize_int8(xt, 1e-12)
    torch.cuda.synchronize()
    assert ops.launches["quantize_int8"] == 1
    _equal(got, QZ.quantize_int8_plain(xt, 1e-12))


# (B, KV, hd): qwen3's B8 KV8 hd128, recurrentgemma's MQA hd 256, hd 64,
# a ragged hd that takes the scalar path
STORE_SHAPES = [(8, 8, 128), (1, 1, 256), (3, 8, 64), (5, 1, 128),
                (2, 2, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,hd", STORE_SHAPES)
@pytest.mark.parametrize("W,offset,s_loc", [(23, 0, 23), (23, 5, 9)])
def test_decode_store_cuda_matches_plain(cuda, dtype, B, KV, hd, W, offset,
                                         s_loc):
    """Caches are views of a stacked (R, B, s_loc, KV, hd) tensor with a
    storage offset, as ``decode_step`` hands them over; slots the step does
    not write keep their sentinels."""
    rng = np.random.default_rng(B * hd + s_loc)
    stacked = [torch.stack([c, c]) for c in
               _sentinel_caches(rng, B, s_loc, KV, hd, cuda)]
    got = [c[1] for c in stacked]
    want = [c.clone() for c in got]
    other = [c[0].clone() for c in stacked]
    for step in range(4):
        pos = torch.as_tensor(rng.integers(0, 3 * W, B), device=cuda)
        nk, nv = (_t(_draw(rng, (B, 1, KV, hd)), dtype, cuda)[:, 0]
                  for _ in "kv")
        ops.reset_launches()
        ops.quantize_kv_store_(nk, nv, *got, pos, W, offset, FLOOR)
        torch.cuda.synchronize()
        assert ops.launches["quantize_int8"] == 1
        QZ.quantize_kv_store_plain_(nk, nv, *want, pos, W, offset, FLOOR)
        _equal(got, want)
    for c, o in zip(stacked, other):           # the other layer untouched
        assert torch.equal(c[0], o)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,hd", STORE_SHAPES)
@pytest.mark.parametrize("S,W", [(9, 23), (23, 23), (50, 23)])
def test_prefill_store_cuda_matches_plain(cuda, dtype, B, KV, hd, S, W):
    rng = np.random.default_rng(S * hd + B)
    k, v = (_t(_draw(rng, (B, S, KV, hd)), dtype, cuda) for _ in "kv")
    ops.reset_launches()
    got = ops.quantize_kv_prefill(k, v, W, FLOOR)
    torch.cuda.synchronize()
    assert ops.launches["quantize_int8"] == 1
    _equal(got, QZ.quantize_kv_prefill_plain(k, v, W, FLOOR))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["rows", "decode", "prefill"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_least_floor_with_subnormal_rows_matches_plain(cuda, entry, dtype):
    """At ``FLOOR_MIN`` the scale of a row of subnormals is 2^-126, the
    least normal float: the codes and scales equal the plain version's,
    and floor 0 is refused on the card too."""
    rng = np.random.default_rng(7)
    x = _draw(rng, (4, 2, 128))
    x[0] *= 1e-39 / np.abs(x[0]).max()          # subnormal rows
    x[1, 0] *= 2e-36 / np.abs(x[1, 0]).max()    # amax just past the floor
    xt = _t(x, dtype, cuda)
    with pytest.raises(ValueError, match="subnormal"):
        _launch(entry, xt, 0.0)
    got = _launch(entry, xt, QZ.FLOOR_MIN)
    torch.cuda.synchronize()
    if entry == "rows":
        want = QZ.quantize_int8_plain(xt.reshape(-1, 128), QZ.FLOOR_MIN)
    else:
        q, sc = QZ.quantize_int8_plain(xt[:, None], QZ.FLOOR_MIN)
        want = [q, q, sc, sc]
    _equal(got, want)
    assert float(want[-1].min()) == 2.0 ** -126


@pytest.mark.cuda
def test_store_launchers_raise_on_noncontiguous_cuda_caches(cuda):
    rng = np.random.default_rng(1)
    B, W, KV, hd = 2, 6, 2, 128
    nk = _t(_draw(rng, (B, KV, hd)), "bfloat16", cuda)
    caches = _sentinel_caches(rng, B, W, KV, hd, cuda)
    pos = torch.tensor([3, 9], device=cuda)
    strided = torch.zeros(B, KV, W, hd, dtype=torch.int8,
                          device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous caches"):
        ops.quantize_kv_store_(nk, nk, strided, *caches[1:], pos, W)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.quantize_kv_store_(nk, nk, caches[0].cpu(), *caches[1:], pos, W)
