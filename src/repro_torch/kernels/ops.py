"""Public kernel entry points in the model's layout, with launch counters.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper takes the model's
layout, reshapes to the kernel's, and launches the hand-written CUDA
kernel for a CUDA tensor (or raises); for a CPU tensor it runs the
kernel's plain version instead, which is how the CPU tests reach it.

``launches`` counts kernel launches only (a plain int per kernel, bumped
next to the launch), so a run can show that its main path went through
the kernels; ``reset_launches`` zeroes it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import linear_scan as _ls
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import rmsnorm as _rn

launches: Dict[str, int] = {"flash_attention": 0, "rmsnorm": 0,
                            "ssm_scan": 0, "rglru_scan": 0,
                            "quantize_int8": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Skv, KV, hd) -> (B, S, H, hd)."""
    qhm = q.transpose(1, 2).contiguous()
    khm = k.transpose(1, 2).contiguous()
    vhm = v.transpose(1, 2).contiguous()
    if q.is_cuda:
        out = _fa.flash_attention_hm_cuda(qhm, khm, vhm, causal=causal,
                                          window=window)
        launches["flash_attention"] += 1
    else:
        out = _fa.flash_attention_hm_plain(qhm, khm, vhm, causal=causal,
                                           window=window)
    return out.transpose(1, 2)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,)."""
    shape = x.shape
    rows = x.reshape(-1, shape[-1])
    if x.is_cuda:
        out = _rn.rmsnorm_cuda(rows.contiguous(), scale.contiguous(), eps)
        launches["rmsnorm"] += 1
    else:
        out = _rn.rmsnorm_plain(rows, scale, eps)
    return out.reshape(shape)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) fp32 -> h (B, S, W) fp32."""
    if a.is_cuda:
        out = _ls.rglru_scan_cuda(a.contiguous(), b.contiguous())
        launches["rglru_scan"] += 1
        return out
    return _ls.rglru_scan_plain(a, b)


def ssm_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model-layout selective scan.

    a, b: (B, S, D, N); c: (B, S, N) -> (y (B, S, D), h_last (B, D, N)).
    The kernel reads this layout as it is (the reference transposes to
    ``(B, S, N, D)`` for the TPU's lane axis).
    """
    if a.is_cuda:
        out = _ls.ssm_scan_cuda(a.contiguous(), b.contiguous(),
                                c.contiguous())
        launches["ssm_scan"] += 1
        return out
    return _ls.ssm_scan_plain(a, b, c)


def quantize_int8(x: torch.Tensor, floor: float = 1e-12
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (q int8 (T, D), scale f32 (T, 1))."""
    if x.is_cuda:
        out = _qz.quantize_int8_cuda(x.contiguous(), floor)
        launches["quantize_int8"] += 1
        return out
    return _qz.quantize_int8_plain(x, floor)


dequantize_int8 = _qz.dequantize_int8
