"""Head-major flash attention: the CUDA kernel's launcher and its plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_hm``.  The
kernel (``csrc/flash_attention.cu``) runs one thread block per (b, h,
64-row q tile) and loops over 64-key tiles with an fp32 online softmax,
skipping tiles the causal/window mask removes.  ``flash_attention_hm_plain``
is the full-materialization version of ``repro/kernels/ref.py``
(``flash_attention``) in the head-major layout; the tests and
``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_hm_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd) -> (B, H, Sq, hd), fp32 math."""
    B, H, S, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, S, hd) / math.sqrt(hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_hm_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True,
                            window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel; raises on shapes or types it does not take."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_hm_cuda needs q, k, v on one "
                         "CUDA device")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B,H,Sq,hd) and k, v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} (B,KV,Skv,hd)")
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_hm_cuda needs contiguous q, k, v")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    if q.numel() == 0 or Skv == 0:
        return out.zero_()
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KV, Sq, Skv, hd, int(causal), -1 if window is None else window,
        int(q.dtype == torch.bfloat16), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    return out
