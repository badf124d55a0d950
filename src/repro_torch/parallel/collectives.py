"""The collectives of the sharded paths, over named mesh axes.

The reference's three: ``psum`` (all-reduce SUM), ``pmax`` (all-reduce MAX)
and the tiled ``all_gather``, each over one axis (or several, one after the
other) of the current ``DeviceMesh``.  ``psum`` and ``all_gather`` are
differentiable with their transposes, as ``shard_map`` differentiates them:
the backward of an all-reduce SUM is an all-reduce SUM, the backward of an
all-gather a reduce-scatter, written as all-reduce + slice.  Only
all-reduce and the list all-gather are used.

On a gloo group a CUDA tensor is staged through ordinary host memory here
(:func:`_staged`).  Gloo has CUDA forms of both, but they copy through
pinned buffers from the CUDA caching host allocator, which keeps every
buffer for reuse: four ranks sharing one card (the only multi-rank layout
one card allows, NCCL refusing two ranks on one device) then hold tens of
GiB of pinned host memory after a training step.  An NCCL group never
takes this branch.

A training step that takes its loss as ``loss / world_size`` on every rank
then gets each parameter's exact gradient, whatever share of the work each
rank did twice: ranks that hold the same value (a replicated activation, a
copy of a weight) each pass their part of the gradient, and the transposes
add them up.

Gradients are reduced in their own dtype (bf16 for a bf16 model, as
XLA's reduce-scatter of the reference's sharded step does), and over the
whole world in one all-reduce when the axes cover a mesh that spans it.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.parallel import shardctx

Axes = Union[str, Sequence[str], None]


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _group(axis: str, mesh=None):
    mesh = mesh if mesh is not None else shardctx.current_mesh()
    return mesh.get_group(axis)


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group crosses it through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce_in(t: torch.Tensor, op, group) -> None:
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, axes: Axes = None,
                mesh=None) -> torch.Tensor:
    """In place over ``axes`` (SUM and MAX compose axis by axis; axes that
    cover a mesh spanning the world take one all-reduce over it)."""
    axes = _axes(axes)
    mesh = mesh if mesh is not None else shardctx.current_mesh()
    if (axes and set(axes) == set(mesh.mesh_dim_names)
            and mesh.size() == dist.get_world_size()):
        _all_reduce_in(t, op, dist.group.WORLD)
        return t
    for a in axes:
        _all_reduce_in(t, op, _group(a, mesh))
    return t


def _reduce_grad(g: torch.Tensor, axes, mesh) -> torch.Tensor:
    if not axes:
        return g
    return all_reduce_(g.clone(), dist.ReduceOp.SUM, axes, mesh)


def _gather_along(t: torch.Tensor, dim: int, axis: str, mesh) -> torch.Tensor:
    g = _group(axis, mesh)
    n = dist.get_world_size(g)
    src = t.cpu() if _staged(t, g) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src.contiguous(), group=g)
    return torch.cat(parts, dim=dim).to(t.device)


def _own(t: torch.Tensor, dim: int, axis: str, mesh) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim``, as a copy (a view would
    keep the whole gathered gradient alive)."""
    n = shardctx.axis_size(axis, mesh)
    return t.chunk(n, dim=dim)[shardctx.axis_index(axis, mesh)].clone(
        memory_format=torch.contiguous_format)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_reduce_(x.clone(), dist.ReduceOp.SUM, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_grad(g.contiguous(), ctx.axes, ctx.mesh), None, None


def psum(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """All-reduce SUM over ``axes`` of the current mesh (identity for no
    axes)."""
    axes = _axes(axes)
    if not axes:
        return x
    return _PSum.apply(x, axes, shardctx.current_mesh())


def pmean(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    axes = _axes(axes)
    if not axes:
        return x
    n = 1
    for a in axes:
        n *= shardctx.axis_size(a)
    return psum(x, axes) / n


def pmax(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """All-reduce MAX, outside autograd (the decode's softmax shift, whose
    value cancels out of the result)."""
    return all_reduce_(x.detach().clone(), dist.ReduceOp.MAX, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        return _gather_along(x, dim, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        g = _reduce_grad(g.contiguous(), (ctx.axis,), ctx.mesh)
        return _own(g, ctx.dim, ctx.axis, ctx.mesh), None, None, None


def all_gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """Tiled all-gather of ``x`` along ``dim`` over ``axis``."""
    return _AllGather.apply(x, dim, axis, shardctx.current_mesh())


class _GatherDTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, placements, keep):
        from torch.distributed.tensor import Shard
        names = list(mesh.mesh_dim_names)
        ctx.mesh, ctx.keep = mesh, keep
        ctx.cut = [(a, p.dim) for a, p in zip(names, placements)
                   if isinstance(p, Shard) and a not in keep]
        if not ctx.cut:
            return x.view_as(x)
        out = x
        for a, d in reversed(ctx.cut):       # innermost axis first
            out = _gather_along(out, d, a, mesh)
        return out

    @staticmethod
    def backward(ctx, g):
        names = [a for a in ctx.mesh.mesh_dim_names if a not in ctx.keep]
        g = _reduce_grad(g.contiguous(), names, ctx.mesh)
        for a, d in ctx.cut:                 # outermost axis first
            g = _own(g, d, a, ctx.mesh)
        return g, None, None, None


def gather_dtensor(t, keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """See :func:`shardctx.gather`."""
    return _GatherDTensor.apply(t.to_local(), t.device_mesh,
                                tuple(t.placements), tuple(keep))
