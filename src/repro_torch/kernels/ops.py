"""Public kernel entry points in the model's layout, with launch counters.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper takes the model's
layout, reshapes to the kernel's, and launches the hand-written CUDA
kernel for a CUDA tensor (or raises); for a CPU tensor it runs the
kernel's plain version instead, which is how the CPU tests reach it.

``launches`` counts kernel launches only (a plain int per kernel, bumped
next to the launch), so a run can show that its main path went through
the kernels; ``reset_launches`` zeroes it.

The kernels have no backward.  A CUDA launch on a tensor that autograd
records raises instead of handing back a result whose gradient would be
lost; the plain versions on the CPU are torch ops and differentiate.
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


def _forward_only(name: str, *ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only and autograd records "
            f"its inputs; run it under torch.no_grad(), or train with "
            f"Runtime(use_kernels=False) as the reference does")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Skv, KV, hd) -> (B, S, H, hd)."""
    qhm = q.transpose(1, 2).contiguous()
    khm = k.transpose(1, 2).contiguous()
    vhm = v.transpose(1, 2).contiguous()
    if q.is_cuda:
        _forward_only("flash_attention", q, k, v)
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
        _forward_only("rmsnorm", x, scale)
        out = _rn.rmsnorm_cuda(rows.contiguous(), scale.contiguous(), eps)
        launches["rmsnorm"] += 1
    else:
        out = _rn.rmsnorm_plain(rows, scale, eps)
    return out.reshape(shape)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) fp32 -> h (B, S, W) fp32."""
    if a.is_cuda:
        _forward_only("rglru_scan", a, b)
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
        _forward_only("ssm_scan", a, b, c)
        out = _ls.ssm_scan_cuda(a.contiguous(), b.contiguous(),
                                c.contiguous())
        launches["ssm_scan"] += 1
        return out
    return _ls.ssm_scan_plain(a, b, c)


def selective_scan(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan with its discretization fused in.

    dt, x: (B, S, D); A: (D, N) fp32; Bm, Cm: (B, S, N) ->
    (y (B, S, D), h_last (B, D, N)) fp32; ``a = exp(dt A)`` and
    ``b = (dt x) B`` never reach memory.  The path's counterpart of
    ``ssm_scan_pallas``, so its launches count as ``"ssm_scan"``.
    ``Bm`` and ``Cm`` may be strided slices of the x-projection: the
    launcher copies them, (B, S, N), into contiguous fp32.
    """
    if dt.is_cuda:
        _forward_only("selective_scan", dt, x, A, Bm, Cm)
        out = _ls.selective_scan_cuda(dt.contiguous(), x.contiguous(),
                                      A.contiguous(), Bm, Cm)
        launches["ssm_scan"] += 1
        return out
    return _ls.selective_scan_plain(dt, x, A, Bm, Cm)


def quantize_int8(x: torch.Tensor, floor: float = 1e-12
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (q int8 (T, D), scale f32 (T, 1))."""
    if x.is_cuda:
        _forward_only("quantize_int8", x)
        out = _qz.quantize_int8_cuda(x.contiguous(), floor)
        launches["quantize_int8"] += 1
        return out
    return _qz.quantize_int8_plain(x, floor)


def quantize_kv_store_(new_k: torch.Tensor, new_v: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       pos: torch.Tensor, W: int, offset: int = 0,
                       floor: float = 1e-8) -> None:
    """One decode step's int8 KV write, in place.

    new_k, new_v: (B, KV, hd); k, v: (B, s_loc, KV, hd) int8; k_scale,
    v_scale: (B, s_loc, KV, 1) f32; pos: (B,) int64.  Each batch row's
    vectors are quantized into ring slot ``(pos[b] mod W) - offset`` where
    it lies in ``[0, s_loc)``.  On the card K and V go in one launch of
    the quantize kernel (counted as ``"quantize_int8"``); the caches are
    written where they are (a non-contiguous one raises).
    """
    if new_k.is_cuda:
        _forward_only("quantize_kv_store_", new_k, new_v)
        _qz.quantize_kv_store_cuda_(new_k.contiguous(), new_v.contiguous(),
                                    k, v, k_scale, v_scale, pos.contiguous(),
                                    W, offset, floor)
        launches["quantize_int8"] += 1
        return
    _qz.quantize_kv_store_plain_(new_k, new_v, k, v, k_scale, v_scale, pos,
                                 W, offset, floor)


def quantize_kv_prefill(k: torch.Tensor, v: torch.Tensor, W: int,
                        floor: float = 1e-8):
    """Prefill's int8 KV caches: k, v (B, S, KV, hd) -> (k int8, v int8
    (B, W, KV, hd), k_scale, v_scale f32 (B, W, KV, 1)) in the ring
    layout (slot = p mod W); one launch on the card."""
    if k.is_cuda:
        _forward_only("quantize_kv_prefill", k, v)
        out = _qz.quantize_kv_prefill_cuda(k.contiguous(), v.contiguous(), W,
                                           floor)
        launches["quantize_int8"] += 1
        return out
    return _qz.quantize_kv_prefill_plain(k, v, W, floor)


dequantize_int8 = _qz.dequantize_int8
