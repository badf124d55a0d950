"""Gradient compression: the int8 wire format of the data-parallel
all-reduce, with error feedback.

Counterpart of ``repro/parallel/compression.py``.  A gradient leaf is
flattened into rows of 1,024 fp32 values (one row of the leaf's size when
it is smaller), zero-padded, and each row quantized symmetrically to int8
with an fp32 scale: ``scale = max(amax, 1e-12) / 127``, ``q =
clip(round(x / scale), +-127)``.  That is ``quantize_int8_pallas``'s body,
so ``_quant`` is ``kernels.ops.quantize_int8``: the hand-written CUDA
kernel on the card (one launch a leaf), its plain version on the CPU.
Error feedback carries each step's quantization residual into the next.

``compressed_psum_mean``, the collective itself, needs a process group and
waits for the sharded path (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import pytree
from repro_torch.kernels import ops

ROW = 1024          # fp32 values a row
FLOOR = 1e-12       # least scale numerator


def _quant(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return ops.quantize_int8(x2d, floor=FLOOR)


def compress_leaf(g: torch.Tensor):
    """-> (q int8 (R, C), scale f32 (R, 1), orig_shape)."""
    flat = g.float().reshape(-1)
    c = min(flat.numel(), ROW)
    r = -(-flat.numel() // c)
    pad = r * c - flat.numel()
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = _quant(flat.reshape(r, c))
    return q, s, tuple(g.shape)


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


@torch.no_grad()
def round_trip_(g: torch.Tensor, residual: torch.Tensor) -> None:
    """In place, one leaf: the gradient ``g`` becomes what the int8 wire
    format carries of ``g + residual``, and ``residual`` what it failed to
    carry.  The reference trainer's ``gf = g + r; g = deq(compress(gf));
    r = gf - g`` with the same IEEE operations, holding ``gf`` in the
    residual's own buffer."""
    residual.add_(g)
    q, s, shape = compress_leaf(residual)
    deq = decompress_leaf(q, s, shape)
    g.copy_(deq)
    residual.sub_(deq)


def init_residuals(params):
    return pytree.map_(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
