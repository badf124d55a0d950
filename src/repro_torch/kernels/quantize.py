"""Row-wise symmetric int8 quantization and the int8 KV-cache stores: the
CUDA kernel's launchers and their plain versions.

Replaces ``repro/kernels/quantize.py::quantize_int8_pallas``.  The kernel
(``csrc/quantize.cu``) is bound by bytes on the H100: lane groups read
rows with 16-byte loads, several rows in flight a thread, and write each
row's codes and scale once.  It has three entries:

* ``quantize_int8_cuda`` — the TPU kernel's interface, (T, D) rows;
* ``quantize_kv_store_cuda_`` — one decode step's K and V vectors
  quantized and written in place into their ring slot of the int8 caches,
  in one launch (the slot is computed on the device from ``pos``);
* ``quantize_kv_prefill_cuda`` — prefill's K and V quantized straight into
  fresh ring caches (the reference's slice, roll and zero pad included).

Each has a plain version in torch ops (``quantize_int8_plain`` is the
reference ``repro/kernels/ref.py::quantize_int8``; the stores are the
slot arithmetic, ``quantize_int8_plain`` and ``write_slot_``, or slice,
roll, pad and quantize).  The kernel does the same IEEE operations, so the
two agree bit for bit, and the tests and ``chip_smoke.py`` hold it to that.

``floor`` is the least scale numerator: 1e-12 is the TPU kernel's, and
the int8 KV cache passes 1e-8, the reference ``_quantize_kv``'s.  The
launchers refuse a floor below ``FLOOR_MIN`` (127 times the least normal
float32): the kernel leaves out the plain version's clip, which is exact
only while every scale is a normal float.

The launchers never copy a cache: ``decode_step`` relies on the store
writing the cache it was given, so a non-contiguous cache raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# wire layout of the int8 path: one int8 code per entry plus one float32
# scale per row (the (T, 1) scale the kernel writes).  The KV-migration
# cost model (repro_torch.fleet.migrate.KVTransferCost) prices quantized
# transfers from these.
INT8_CODE_BYTES = 1
INT8_SCALE_BYTES = 4

_DTYPES = (torch.float32, torch.bfloat16)

# the least floor the kernel takes: scale = max(amax, floor) / 127 is then
# at least 2^-126, a normal float32 (see ``code`` in csrc/quantize.cu)
FLOOR_MIN = 127 * 2.0 ** -126


def quantize_int8_plain(x: torch.Tensor, floor: float = 1e-12
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (q int8 (..., D), scale f32 (..., 1)).

    ``torch.round`` rounds half to even, as ``jnp.round`` does.  The
    divisor 127 is a tensor on ``x``'s device: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, which is an ulp off the
    IEEE quotient for about 4 % of inputs; the kernel and the reference's
    ``ref.quantize_int8`` divide.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=floor) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def write_slot_(buf, new_val, bidx, clamped, in_range) -> None:
    """In place: buf[b, clamped[b]] = new_val[b] where in_range[b]."""
    cur = buf[bidx, clamped]
    keep = in_range.reshape((-1,) + (1,) * (cur.dim() - 1))
    buf[bidx, clamped] = torch.where(keep, new_val.to(buf.dtype), cur)


def ring_layout(x: torch.Tensor, W: int) -> torch.Tensor:
    """(B, S, ...) prefill values -> (B, W, ...) ring, slot = p mod W.

    S > W keeps the last W positions, rolled so that position S - W lands
    on slot (S - W) mod W; S < W pads the tail slots with zeros (invalid
    until the position wraps), as the reference's ``prefill_cache``.
    """
    S = x.shape[1]
    if S > W:
        return torch.roll(x[:, -W:], (S - W) % W, dims=1)
    if S < W:
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, W - S))
    return x


def quantize_kv_store_plain_(new_k, new_v, k, v, k_scale, v_scale, pos,
                             W: int, offset: int = 0,
                             floor: float = 1e-8) -> None:
    """In place: each batch row's new K/V vector, quantized, into ring
    slot ``(pos[b] mod W) - offset`` of the caches where that slot lies in
    ``[0, s_loc)``; other rows are left as they are.

    new_k, new_v: (B, KV, hd); k, v: (B, s_loc, KV, hd) int8; k_scale,
    v_scale: (B, s_loc, KV, 1) f32; pos: (B,) int.
    """
    s_loc = k.shape[1]
    slot = torch.remainder(pos, W) - offset
    in_range = (slot >= 0) & (slot < s_loc)
    clamped = torch.clamp(slot, 0, s_loc - 1)
    bidx = torch.arange(pos.shape[0], device=pos.device)
    for new, codes, scales in ((new_k, k, k_scale), (new_v, v, v_scale)):
        q, s = quantize_int8_plain(new, floor)
        write_slot_(codes, q, bidx, clamped, in_range)
        write_slot_(scales, s, bidx, clamped, in_range)


def quantize_kv_prefill_plain(k: torch.Tensor, v: torch.Tensor, W: int,
                              floor: float = 1e-8):
    """k, v: (B, S, KV, hd) -> (k int8, v int8 (B, W, KV, hd), k_scale,
    v_scale f32 (B, W, KV, 1)): the ring layout, then quantized."""
    (kq, ks), (vq, vs) = (quantize_int8_plain(ring_layout(x, W), floor)
                          for x in (k, v))
    return kq, vq, ks, vs


def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize")
    if lib.quantize_int8_fwd.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        sigs = {"quantize_int8_fwd": [p, p, p, ll, i, f, i, i, i, p],
                "quantize_kv_store_fwd": [p] * 7 + [i, i, i, ll, ll, i, f,
                                                    i, i, i, p],
                "quantize_kv_prefill_fwd": [p] * 6 + [i] * 5 + [f, i, i, i,
                                                                p]}
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def _aligned(D: int, esz: int, *tensors: torch.Tensor) -> int:
    """1 when every row of these tensors starts on 16 bytes and a row of
    values is a whole number of 16-byte loads: the kernel's vector path."""
    return int((D * esz) % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_values(name: str, dims: int, *xs: torch.Tensor) -> None:
    """The rows to quantize: ``dims``-d, float32/bfloat16, one dtype and
    shape, contiguous, a nonzero row width."""
    x = xs[0]
    if any(t.dim() != dims or t.shape != x.shape for t in xs) \
            or x.shape[-1] == 0:
        raise ValueError(f"{name}: inputs {[tuple(t.shape) for t in xs]} "
                         f"must be {dims}-d, of one shape, with D > 0")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in xs):
        raise ValueError(f"{name} takes float32/bfloat16 inputs of one "
                         f"dtype, got {[t.dtype for t in xs]}")
    if not all(t.is_contiguous() for t in xs):
        raise ValueError(f"{name} needs contiguous inputs")


def _check_caches(name: str, shape, k, v, k_scale, v_scale) -> None:
    """int8 caches of ``shape`` and f32 scales of ``shape[:-1] + (1,)``,
    contiguous: the kernel writes them where they are, never a copy."""
    want = [(k, torch.int8, shape), (v, torch.int8, shape),
            (k_scale, torch.float32, shape[:-1] + (1,)),
            (v_scale, torch.float32, shape[:-1] + (1,))]
    for t, dtype, shp in want:
        if t.dtype != dtype or tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name}: cache {tuple(t.shape)} {t.dtype} must "
                             f"be {tuple(shp)} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous caches: a copy would "
                             f"drop the in-place write")


def _check_floor(name: str, floor: float) -> None:
    if not floor >= FLOOR_MIN:
        raise ValueError(f"{name}: floor {floor!r} is below {FLOOR_MIN!r}, "
                         f"where a scale can be subnormal")


def _check_device(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{name} needs every tensor on one CUDA device")


def quantize_int8_cuda(x: torch.Tensor, floor: float = 1e-12
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on (T, D) rows; raises on what it cannot take."""
    _check_floor("quantize_int8_cuda", floor)
    _check_device("quantize_int8_cuda", x)
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"quantize_int8_cuda: x {tuple(x.shape)} must be "
                         f"(T, D) with D > 0")
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_int8_cuda takes float32/bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8_cuda needs a contiguous x")
    T, D = x.shape
    q = torch.empty((T, D), dtype=torch.int8, device=x.device)
    scale = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    if T == 0:
        return q, scale
    err = _lib().quantize_int8_fwd(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), T, D, float(floor),
        int(x.dtype == torch.bfloat16), _aligned(D, x.element_size(), x),
        x.get_device(), _stream(x))
    _build.check(err, "quantize_int8_fwd")
    return q, scale


def quantize_kv_store_cuda_(new_k, new_v, k, v, k_scale, v_scale, pos,
                            W: int, offset: int = 0,
                            floor: float = 1e-8) -> None:
    """One launch: ``quantize_kv_store_plain_`` on the card, K and V
    together; raises on what the kernel cannot take."""
    name = "quantize_kv_store_cuda_"
    _check_floor(name, floor)
    _check_values(name, 3, new_k, new_v)
    B, KV, D = new_k.shape
    _check_caches(name, (B, k.shape[1], KV, D), k, v, k_scale, v_scale)
    if pos.shape != (B,) or pos.dtype != torch.int64 \
            or not pos.is_contiguous():
        raise ValueError(f"{name}: pos {tuple(pos.shape)} {pos.dtype} must "
                         f"be contiguous ({B},) int64")
    if W <= 0 or k.shape[1] == 0:
        raise ValueError(f"{name}: W {W} and the cache's slots "
                         f"{k.shape[1]} must be positive")
    _check_device(name, new_k, new_v, k, v, k_scale, v_scale, pos)
    if B * KV == 0:
        return
    err = _lib().quantize_kv_store_fwd(
        new_k.data_ptr(), new_v.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr(), B, KV, D,
        int(W), int(offset), k.shape[1], float(floor),
        int(new_k.dtype == torch.bfloat16),
        _aligned(D, new_k.element_size(), new_k, new_v, k, v),
        new_k.get_device(), _stream(new_k))
    _build.check(err, "quantize_kv_store_fwd")


def quantize_kv_prefill_cuda(k: torch.Tensor, v: torch.Tensor, W: int,
                             floor: float = 1e-8):
    """One launch: ``quantize_kv_prefill_plain`` on the card, into ring
    caches allocated here and written whole by the kernel."""
    name = "quantize_kv_prefill_cuda"
    _check_floor(name, floor)
    _check_values(name, 4, k, v)
    _check_device(name, k, v)
    B, S, KV, D = k.shape
    if W <= 0 or S == 0:
        raise ValueError(f"{name}: W {W} and S {S} must be positive")
    kq = torch.empty((B, W, KV, D), dtype=torch.int8, device=k.device)
    vq = torch.empty_like(kq)
    ks = torch.empty((B, W, KV, 1), dtype=torch.float32, device=k.device)
    vs = torch.empty_like(ks)
    if B * KV == 0:
        return kq, vq, ks, vs
    err = _lib().quantize_kv_prefill_fwd(
        k.data_ptr(), v.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), B, S, KV, D, int(W), float(floor),
        int(k.dtype == torch.bfloat16), _aligned(D, k.element_size(), k, v),
        k.get_device(), _stream(k))
    _build.check(err, "quantize_kv_prefill_fwd")
    return kq, vq, ks, vs
