"""Row-wise symmetric int8 quantization: the CUDA kernel's launcher and its
plain version.

Replaces ``repro/kernels/quantize.py::quantize_int8_pallas``.  The kernel
(``csrc/quantize.cu``) is bound by bytes on the H100: one warp reads a row
once and writes its codes and scale once.  ``quantize_int8_plain``
computes the same function in torch ops (the reference
``repro/kernels/ref.py::quantize_int8``); the kernel does the same IEEE
operations, so the two agree bit for bit, and the tests and
``chip_smoke.py`` hold it to that.

``floor`` is the least scale numerator: 1e-12 is the TPU kernel's, and
the int8 KV cache passes 1e-8, the reference ``_quantize_kv``'s.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

# wire layout of the int8 path: one int8 code per entry plus one float32
# scale per row (the (T, 1) scale the kernel writes).  The KV-migration
# cost model (repro_torch.fleet.migrate.KVTransferCost) prices quantized
# transfers from these.
INT8_CODE_BYTES = 1
INT8_SCALE_BYTES = 4

_DTYPES = (torch.float32, torch.bfloat16)


def quantize_int8_plain(x: torch.Tensor, floor: float = 1e-12
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (q int8 (T, D), scale f32 (T, 1)).

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize")
    fn = lib.quantize_int8_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def quantize_int8_cuda(x: torch.Tensor, floor: float = 1e-12
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on (T, D) rows; raises on what it cannot take."""
    if not x.is_cuda:
        raise ValueError("quantize_int8_cuda needs x on a CUDA device")
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
        int(x.dtype == torch.bfloat16), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "quantize_int8_fwd")
    return q, scale
