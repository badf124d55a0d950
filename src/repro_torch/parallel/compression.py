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

Under a mesh, ``round_trip_sharded_`` runs the same round trip on a
``DTensor`` leaf: the rows are the whole (global) leaf's, as in the
reference, but each rank gathers only the dimensions that cut its rows,
so its block is whole rows of the global flattened leaf (the kernel runs on
it as on a whole leaf) and keeps its own shard of the result.

``compressed_psum_mean`` is the collective itself, over one axis of the
current mesh.  Its codes use a scale shared by the axis (phase 1, an
all-reduce MAX of the per-row scales, which are the quantize kernel's own
scales), and the kernel takes no scale, so it runs in torch ops, as the
reference's does in jnp.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import pytree
from repro_torch.kernels import ops
from repro_torch.parallel import collectives, shardctx

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


def _row_aligned(shape, placements, mesh, keep_dim: int) -> bool:
    """Whether this rank's block, gathered over every sharded dimension
    but ``keep_dim``, is whole rows of the global flattened leaf: each
    index of the dimensions before ``keep_dim`` gives one contiguous range
    of it, which must start on a row and hold whole rows (the leaf's last
    range may end in its padded row)."""
    from torch.distributed.tensor import Shard
    n = math.prod(shape)
    c = min(n, ROW)
    tail = math.prod(shape[keep_dim + 1:])
    full_k = shape[keep_dim]
    n_k, off_k = full_k, 0
    for a, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard) and p.dim == keep_dim:
            n_k //= shardctx.axis_size(a, mesh)
            off_k += shardctx.axis_index(a, mesh) * n_k
    lead = math.prod(shape[:keep_dim])
    ends = off_k + n_k == full_k and lead == 1
    return ((off_k * tail) % c == 0 and ((n_k * tail) % c == 0 or ends)
            and (lead == 1 or (full_k * tail) % c == 0))


@torch.no_grad()
def round_trip_sharded_(g, residual) -> None:
    """``round_trip_`` for a ``DTensor`` gradient and residual laid out
    alike, on the rows of the whole leaf; each rank's shards are updated in
    place.  The rank's ``g + residual`` is gathered over every sharded
    dimension but the first (all of them when that block would cut a row),
    the round trip runs on that block in ``BLOCK``-value pieces of whole
    rows, and each rank keeps its shard."""
    from torch.distributed.tensor import Shard
    from repro_torch.optim.adamw import BLOCK
    mesh, pl = g.device_mesh, tuple(g.placements)
    gl, rl = shardctx.local(g), shardctx.local(residual)
    rl.add_(gl)                                 # the rank's g + residual
    dims = sorted({p.dim for p in pl if isinstance(p, Shard)})
    keep = dims[0] if dims and _row_aligned(tuple(g.shape), pl, mesh,
                                            dims[0]) else None
    cut = [(a, p.dim) for a, p in zip(mesh.mesh_dim_names, pl)
           if isinstance(p, Shard) and p.dim != keep]
    block = rl
    for a, d in reversed(cut):                  # innermost axis first
        block = collectives._gather_along(block, d, a, mesh)
    block = block.contiguous()
    deq = torch.zeros_like(block)
    fb, fd = block.view(-1), deq.view(-1)
    for lo in range(0, fb.numel(), BLOCK):      # deq, and block - deq
        round_trip_(fd[lo:lo + BLOCK], fb[lo:lo + BLOCK])
    for a, d in cut:                            # outermost axis first
        n, i = shardctx.axis_size(a, mesh), shardctx.axis_index(a, mesh)
        block, deq = block.chunk(n, d)[i], deq.chunk(n, d)[i]
    gl.copy_(deq)
    rl.copy_(block)


def _rows(flat: torch.Tensor) -> torch.Tensor:
    c = min(flat.numel(), ROW)
    r = -(-flat.numel() // c)
    if r * c != flat.numel():
        flat = F.pad(flat, (0, r * c - flat.numel()))
    return flat.reshape(r, c)


@torch.no_grad()
def compressed_psum_mean(grads, axis_name: str, residuals=None):
    """Mean-all-reduce a gradient tree over ``axis_name`` of the current
    mesh with an int8 payload and error feedback.

    Each rank passes its own gradients (and residuals); returns (mean
    gradients, new residuals), the mean equal on every rank of the axis.
    """
    n = shardctx.axis_size(axis_name)

    def one(g, res):
        gf = g.float()
        if res is not None:
            gf = gf + res
        shape = tuple(gf.shape)
        rows = _rows(gf.reshape(-1))
        # phase 1: agree on per-row scales (tiny collective), so every
        # rank's int8 payload shares the same quantization grid and the
        # int32 sum dequantizes exactly
        amax = rows.abs().amax(dim=-1, keepdim=True)
        s_shared = collectives.pmax(
            torch.clamp(amax, min=FLOOR) / 127.0, axis_name)
        q = torch.clamp(torch.round(rows / s_shared), -127, 127).to(
            torch.int8)
        # phase 2: the payload, int8 codes summed in int32
        acc = collectives.all_reduce_(q.to(torch.int32), axes=axis_name)
        mean = decompress_leaf(acc, s_shared, shape) / n
        # error feedback: what this rank's wire format failed to carry
        sent = decompress_leaf(q, s_shared, shape)
        return mean.to(g.dtype), gf - sent

    flat_g = pytree.leaves(grads)
    flat_r = (pytree.leaves(residuals) if residuals is not None
              else [None] * len(flat_g))
    outs = [one(g, r) for g, r in zip(flat_g, flat_r)]
    return (pytree.unflatten(grads, iter([o[0] for o in outs])),
            pytree.unflatten(grads, iter([o[1] for o in outs])))


def init_residuals(params):
    return pytree.map_(
        lambda p: shardctx.zeros_like_layout(p, dtype=torch.float32), params)
