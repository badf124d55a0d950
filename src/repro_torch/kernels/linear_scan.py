"""Linear-recurrence scans: the CUDA kernels' launchers and plain versions.

Replaces ``repro/kernels/linear_scan.py``: ``rglru_scan_pallas`` (the
RG-LRU gate scan) and ``ssm_scan_pallas`` (the Mamba-1 selective scan
fused with the C-contraction).

- ``rglru_scan_cuda`` (``csrc/linear_scan.cu``): chunks of the sequence
  in parallel, joined by a decoupled look-back over the chunks' carries.
- ``ssm_scan_cuda`` (``csrc/linear_scan.cu``): the TPU kernel's own
  interface, on materialised ``a, b (B, S, D, N)``.
- ``selective_scan_cuda`` (``csrc/selective_scan.cu``): what the
  falcon-mamba path runs.  It takes ``dt, x, A, B, C`` and builds ``a`` and
  ``b`` in registers, so no ``(B, S, D, N)`` tensor exists.

``rglru_scan_plain`` and ``ssm_scan_plain`` are the step-by-step
recurrences of ``repro/kernels/ref.py`` in the model layout, and
``selective_scan_plain`` is the model's discretization followed by
``ssm_scan_plain``; the tests and ``chip_smoke.py`` hold the kernels
against them.  Unlike the reference wrapper, the selective scans take the
model layout ``(B, S, D, N)`` directly: no transposed copy is made.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

SSM_STATES = (1, 2, 4, 8, 16, 32)   # N: the lanes that share one d
SELECTIVE_STATES = (8, 16)          # N the fused kernel is compiled for


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h (B, S, W); h_t = a_t h_{t-1} + b_t, h_{-1} = 0."""
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def ssm_scan_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, D, N); c: (B, S, N) -> (y (B, S, D), h_last (B, D, N))."""
    h = torch.zeros_like(a[:, 0])
    y = a.new_empty(a.shape[:3])
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        y[:, t] = torch.einsum("bdn,bn->bd", h, c[:, t])
    return y, h


def selective_scan_plain(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The falcon-mamba block's discretization, then ``ssm_scan_plain``.

    dt, x: (B, S, D); A: (D, N) fp32; Bm, Cm: (B, S, N) ->
    (y (B, S, D), h_last (B, D, N)), both fp32.  ``a = exp(dt A)`` and
    ``b = (dt x) B`` are built whole, in fp32; exp in place.
    """
    dtf = dt.float()
    a = (dtf[..., None] * A).exp_()
    bx = (dtf * x.float())[..., None] * Bm.float()[:, :, None, :]
    return ssm_scan_plain(a, bx, Cm.float())


def _lib() -> ctypes.CDLL:
    lib = _build.load("linear_scan")
    if lib.rglru_scan_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_fwd.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.rglru_scan_fwd.restype = ctypes.c_int
        lib.ssm_scan_fwd.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.ssm_scan_fwd.restype = ctypes.c_int
    return lib


def _selective_lib() -> ctypes.CDLL:
    lib = _build.load("selective_scan")
    if lib.selective_scan_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.selective_scan_fwd.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.selective_scan_fwd.restype = ctypes.c_int
    return lib


def _check(name: str, *ts: torch.Tensor, dtypes=(torch.float32,)) -> None:
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{name} needs its inputs on one CUDA device")
    if not (ts[0].dtype in dtypes and all(t.dtype == ts[0].dtype for t in ts)):
        raise ValueError(f"{name} takes one dtype of {dtypes}, got "
                         f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous inputs")
    if ts[0].shape[0] > 65535:
        raise ValueError(f"{name}: batch {ts[0].shape[0]} exceeds the grid")


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the RG-LRU scan kernel; raises on what it does not take."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan_cuda: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must both be (B, S, W)")
    _check("rglru_scan_cuda", a, b)
    B, S, W = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = _lib()
    chunks = -(-S // lib.rglru_scan_chunk())
    col_tiles = -(-W // lib.rglru_scan_cols())
    # per chunk and column: its aggregate (P, H) and its inclusive carry;
    # the ticket and one flag a chunk start at zero
    ws = a.new_empty(3 * B * chunks * W)
    flags = torch.zeros(1 + B * chunks * col_tiles, dtype=torch.int32,
                        device=a.device)
    err = lib.rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), ws.data_ptr(),
        flags.data_ptr(), B, S, W, a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "rglru_scan_fwd")
    return h


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the selective-scan kernel on the model layout."""
    if a.dim() != 4 or b.shape != a.shape or c.shape != (
            a.shape[0], a.shape[1], a.shape[3]):
        raise ValueError(f"ssm_scan_cuda: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} must be (B, S, D, N) and c "
                         f"{tuple(c.shape)} (B, S, N)")
    _check("ssm_scan_cuda", a, b, c)
    B, S, D, N = a.shape
    if N not in SSM_STATES:
        raise ValueError(f"ssm_scan_cuda: d_state {N} not in {SSM_STATES}")
    y = a.new_empty((B, S, D))
    h_last = a.new_zeros((B, D, N))
    if y.numel() == 0:
        return y, h_last
    err = _lib().ssm_scan_fwd(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), B, S, D, N, a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "ssm_scan_fwd")
    return y, h_last


def selective_scan_cuda(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused selective-scan kernel; raises on what it does not
    take.  dt, x: (B, S, D), both bf16 or both fp32; Bm, Cm: (B, S, N) in
    their type or fp32; A: (D, N) fp32 -> (y (B, S, D), h_last (B, D, N))
    fp32.  Bm and Cm, which may be strided, go to the kernel as contiguous
    fp32 copies ((B, S, N): small), as the plain version reads them, so no
    lane converts them per step."""
    if dt.dim() != 3 or x.shape != dt.shape or A.dim() != 2 \
            or A.shape[0] != dt.shape[2] or Bm.shape != Cm.shape \
            or Bm.shape != (*dt.shape[:2], A.shape[1]):
        raise ValueError(
            f"selective_scan_cuda: dt {tuple(dt.shape)} and x "
            f"{tuple(x.shape)} must be (B, S, D), A {tuple(A.shape)} (D, N), "
            f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} (B, S, N)")
    _check("selective_scan_cuda", dt, x,
           dtypes=(torch.bfloat16, torch.float32))
    if any(t.dtype not in (dt.dtype, torch.float32) for t in (Bm, Cm)):
        raise ValueError(f"selective_scan_cuda: Bm, Cm dtype {Bm.dtype}, "
                         f"{Cm.dtype} is neither dt's {dt.dtype} nor float32")
    Bm, Cm = Bm.float().contiguous(), Cm.float().contiguous()
    _check("selective_scan_cuda", Bm, Cm, A)
    if A.device != dt.device:
        raise ValueError("selective_scan_cuda needs its inputs on one CUDA "
                         "device")
    B, S, D = dt.shape
    N = A.shape[1]
    if N not in SELECTIVE_STATES:
        raise ValueError(f"selective_scan_cuda: d_state {N} not in "
                         f"{SELECTIVE_STATES}")
    es = dt.element_size()
    # TMA reads whole 16-byte units: aligned bases and row strides
    if (D * es) % 16 or any(t.data_ptr() % 16 for t in (dt, x, Bm, Cm, A)):
        raise ValueError(f"selective_scan_cuda: d_inner {D} x {es} bytes and "
                         f"every base address must be multiples of 16 bytes")
    y = dt.new_empty((B, S, D), dtype=torch.float32)
    h_last = dt.new_empty((B, D, N), dtype=torch.float32)
    if y.numel() == 0:
        return y, h_last.zero_()
    err = _selective_lib().selective_scan_fwd(
        dt.data_ptr(), x.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, D, N,
        int(dt.dtype == torch.bfloat16), dt.device.index,
        torch.cuda.current_stream(dt.device).cuda_stream)
    _build.check(err, "selective_scan_fwd")
    return y, h_last
