"""RMSNorm over rows: the CUDA kernel's launcher and its plain version.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas``.  The kernel
(``csrc/rmsnorm.cu``) is bound by bytes on the H100: it reads each row once
and writes it once.  ``rmsnorm_plain`` computes the same function in torch
ops (the reference ``repro/kernels/ref.py::rmsnorm``); the tests and
``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,) -> x.dtype, fp32 statistics over D."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel on (T, D) rows; raises on what it cannot take."""
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError("rmsnorm_cuda needs x and scale on one CUDA device")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_cuda: x {tuple(x.shape)} must be (T, D) "
                         f"and scale {tuple(scale.shape)} must be (D,)")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm_cuda takes float32/bfloat16, got "
                         f"{x.dtype} and {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous inputs")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _lib().rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], float(eps), int(x.dtype == torch.bfloat16),
        int(scale.dtype == torch.bfloat16), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm_fwd")
    return out
