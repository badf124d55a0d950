"""AdamW, with its state laid out as the parameters are (ZeRO).

Counterpart of ``repro/optim/adamw.py``.  The math is the reference's, in
fp32, with results cast back to each leaf's storage dtype; moments are kept
in the parameter's dtype unless ``state_dtype`` says otherwise.  Updates
happen in place under ``torch.no_grad()``: the torch counterpart of the
reference's buffer donation.  Stacked layer leaves (``ndim >= 3`` and at
least 8 layers) are updated one layer at a time, as the reference's
``lax.map`` does, and any piece larger than ``BLOCK`` elements in flat
blocks: the math is elementwise, so the result is the same bit for bit
while the fp32 temporaries stay small (qwen3-14b's 151,936 x 5,120
embedding would need 3.1 GB for each).  Updates go through flat views,
so every parameter and moment must be contiguous: ``adamw_update`` raises
on one that is not, whose update would land in a copy.

The moments mirror the parameter PartitionSpecs (``adamw_pspecs``), so
under a mesh each rank updates its own shards: the update is elementwise,
so the rank's shards of the parameters, gradients and moments (the local
tensors of ``DTensor``s with the same layout) update as the whole would.
Only the global norm crosses ranks: :func:`global_norm` counts each element
of a ``DTensor`` once, whatever copies of it the ranks hold.
"""
from __future__ import annotations

import math
from typing import Any, Iterator, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.parallel import collectives, shardctx
from repro_torch.parallel.shardctx import P

# the most elements one fp32 temporary of the update holds (256 MB)
BLOCK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32
    m: Any                     # tree like params
    v: Any


def adamw_init(params, state_dtype: Optional[str] = None) -> AdamWState:
    dt = getattr(torch, state_dtype) if state_dtype else None

    def zero(p):
        return shardctx.zeros_like_layout(p, dtype=dt or (
            p.dtype if p.is_floating_point() else torch.float32))

    dev = pytree.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=pytree.map_(zero, params),
                      v=pytree.map_(zero, params))


def adamw_pspecs(param_pspecs) -> AdamWState:
    """State PartitionSpecs mirroring the parameter specs."""
    return AdamWState(step=P(), m=param_pspecs, v=param_pspecs)


def cosine_schedule(step: torch.Tensor, *, base_lr: float, warmup: int,
                    total: int, min_frac: float = 0.1) -> torch.Tensor:
    s = step.float()
    warm = s / s.new_tensor(max(warmup, 1))
    prog = torch.clamp((s - warmup) / s.new_tensor(max(total - warmup, 1)),
                       0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)


def _stacked(t: torch.Tensor) -> bool:
    return t.dim() >= 3 and t.shape[0] >= 8


def _pieces(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Flat blocks of at most ``BLOCK`` elements covering ``t`` (its layers
    one at a time when stacked): views of a contiguous ``t``, so updates
    through them land in ``t`` (a gradient's layout may differ: it is
    only read)."""
    for part in (torch.unbind(t) if _stacked(t) else (t,)):
        flat = part.reshape(-1)
        for lo in range(0, flat.numel(), BLOCK):
            yield flat[lo:lo + BLOCK]


@torch.no_grad()
def global_norm(grads) -> torch.Tensor:
    """Global L2 norm in fp32, without an fp32 copy of any large leaf.

    ``DTensor`` leaves sum their local shards, each divided by the number
    of ranks holding a copy, and the total is all-reduced over the mesh.
    """
    sq, mesh = [], None
    for g in pytree.leaves(grads):
        if shardctx.is_dtensor(g):
            mesh = g.device_mesh
        n = shardctx.replication(g)
        s = torch.stack([torch.sum(torch.square(piece.float()))
                         for piece in _pieces(shardctx.local(g))]).sum()
        sq.append(s / n if n > 1 else s)
    total = torch.stack(sq).sum()
    if mesh is not None:
        collectives.all_reduce_(total, axes=mesh.mesh_dim_names, mesh=mesh)
    return torch.sqrt(total)


@torch.no_grad()
def global_norm_clip(grads, max_norm: float):
    """Returns (clipped grads, pre-clip global norm).

    Prefer passing ``grad_scale`` to :func:`adamw_update`: it folds the
    clip into the update.
    """
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return pytree.map_(lambda g: (g.float() * scale).to(g.dtype),
                       grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_scale=1.0) -> Tuple[Any, AdamWState]:
    """One AdamW step, in place on ``params`` and the moments; returns
    (params, the new state).  ``grad_scale`` applies gradient clipping
    inside the update.  Every parameter and moment must be contiguous."""
    for name, tree in (("parameter", params), ("m", state.m),
                       ("v", state.v)):
        for x in pytree.leaves(tree):
            if not x.is_contiguous():
                raise ValueError(
                    f"adamw_update: a non-contiguous {name} of shape "
                    f"{tuple(x.shape)}; its update would land in a copy")
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        gf = g.float() * grad_scale
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * torch.square(gf)
        mhat = mf / c1
        vhat = vf / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)

    trees: List[List[torch.Tensor]] = [pytree.leaves(x) for x in
                                       (params, grads, state.m, state.v)]
    for p, g, m, v in zip(*trees):
        for pieces in zip(*(_pieces(x) for x in (p, g, m, v))):
            upd(*pieces)
    return params, AdamWState(step=step, m=state.m, v=state.v)
