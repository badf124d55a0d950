"""Linear-recurrence scans: the CUDA kernels' launchers and plain versions.

Replaces ``repro/kernels/linear_scan.py``: ``rglru_scan_pallas`` (the
RG-LRU gate scan) and ``ssm_scan_pallas`` (the Mamba-1 selective scan
fused with the C-contraction).  Both kernels live in
``csrc/linear_scan.cu`` and keep the running state in a register while a
thread walks its column in sequence order (see the note there).

``rglru_scan_plain`` and ``ssm_scan_plain`` are the step-by-step
recurrences of ``repro/kernels/ref.py`` in the model layout; the tests and
``chip_smoke.py`` hold the kernels against them.  Unlike the reference
wrapper, the selective scan takes the model layout ``(B, S, D, N)``
directly: no transposed copy of ``a`` or ``b`` is made.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

SSM_STATES = (1, 2, 4, 8, 16, 32)   # N: the lanes that share one d


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("linear_scan")
    if lib.rglru_scan_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_fwd.argtypes = [p, p, p, i, i, i, i, p]
        lib.rglru_scan_fwd.restype = ctypes.c_int
        lib.ssm_scan_fwd.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.ssm_scan_fwd.restype = ctypes.c_int
    return lib


def _check(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{name} needs its inputs on one CUDA device")
    if not all(t.dtype == torch.float32 for t in ts):
        raise ValueError(f"{name} takes float32 only, got "
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
    err = _lib().rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W, a.device.index,
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
