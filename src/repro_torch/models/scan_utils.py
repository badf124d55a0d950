"""Linear-recurrence scan shared by the SSM and RG-LRU blocks.

Counterpart of ``repro/models/scan_utils.py``: ``h_t = a_t * h_{t-1} +
b_t`` evaluated chunk by chunk.  A Python loop carries the state across
fixed-size chunks (peak memory O(chunk)); inside a chunk a log-depth
Hillis–Steele pass plays the part of the reference's
``lax.associative_scan``.  As there, the carry is folded into the chunk's
first element and the sequence is padded with the identity ``a=1, b=0``.
This is the plain path; ``kernels.ops`` carries the CUDA scans.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _scan_chunk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of (a, b) pairs along axis 1; returns the b half.

    Step ``off`` combines element t with t - off:
    ``(a1, b1) . (a2, b2) = (a2 a1, a2 b1 + b2)``.
    """
    n = a.shape[1]
    off = 1
    while off < n:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        a = torch.cat([a[:, :off], a_cur * a_prev], dim=1)
        off *= 2
    return b


def _pad_chunks(x: torch.Tensor, n: int, c: int, value: float) -> torch.Tensor:
    pad = n * c - x.shape[1]
    if not pad:
        return x
    fill = x.new_full((x.shape[0], pad) + x.shape[2:], value)
    return torch.cat([x, fill], dim=1)


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate h_t = a_t h_{t-1} + b_t along axis 1.

    a, b: (B, S, ...); h0: (B, ...).  Returns (h_all (B,S,...), h_last).
    """
    S = a.shape[1]
    c = min(chunk, S)
    n = -(-S // c)
    a = _pad_chunks(a, n, c, 1.0)        # identity: state left untouched
    b = _pad_chunks(b, n, c, 0.0)
    h, outs = h0, []
    for i in range(n):
        ac, bc = a[:, i * c:(i + 1) * c], b[:, i * c:(i + 1) * c]
        bc = torch.cat([bc[:, :1] + ac[:, :1] * h[:, None], bc[:, 1:]], 1)
        hs = _scan_chunk(ac, bc)
        h = hs[:, -1]
        outs.append(hs)
    return torch.cat(outs, dim=1)[:, :S], h


def linear_scan_contract(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         h0: torch.Tensor, chunk: int = 64
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + state contraction for the selective SSM.

    h_t = a_t * h_{t-1} + b_t  with  a, b: (B, S, D, N);  then
    y_t = sum_n h_t[.., n] * c_t[.., n]  with  c: (B, S, N).

    Returns (y (B, S, D), h_last (B, D, N)); the (B, S, D, N) state history
    exists one chunk at a time.
    """
    S = a.shape[1]
    ck = min(chunk, S)
    n = -(-S // ck)
    a = _pad_chunks(a, n, ck, 1.0)
    b = _pad_chunks(b, n, ck, 0.0)
    c = _pad_chunks(c, n, ck, 0.0)
    h, ys = h0, []
    for i in range(n):
        sl = slice(i * ck, (i + 1) * ck)
        ac, bc = a[:, sl], b[:, sl]
        bc = torch.cat([bc[:, :1] + ac[:, :1] * h[:, None], bc[:, 1:]], 1)
        hs = _scan_chunk(ac, bc)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, c[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1)[:, :S], h


def linear_scan_step(a: torch.Tensor, b: torch.Tensor,
                     h: torch.Tensor) -> torch.Tensor:
    """Single decode step of the same recurrence."""
    return a * h + b


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq.  x: (B,S,C); w: (K,C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S] * w[i]
    return out


def causal_conv1d_step(x_new: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-step conv.  x_new: (B,C); conv_state: (B,K-1,C); w: (K,C)."""
    window = torch.cat([conv_state, x_new[:, None]], dim=1)   # (B,K,C)
    out = torch.einsum("bkc,kc->bc", window, w)
    return out, window[:, 1:]


def conv_tail(x: torch.Tensor, kernel_width: int) -> torch.Tensor:
    """Last K-1 steps of the conv input (front-padded when S < K-1).

    x: (B, S, C) -> (B, K-1, C): the decode-time conv state after a prefill.
    A copy, not a view: the state must not keep the whole prefill input
    alive.
    """
    K1 = kernel_width - 1
    S = x.shape[1]
    if S >= K1:
        return x[:, S - K1:].clone()
    return F.pad(x, (0, 0, K1 - S, 0))
