"""Resolve abstract PartitionSpecs against a concrete mesh.

Counterpart of ``repro/parallel/resolve.py``, the same logic in pure
Python.  Model code writes specs with the placeholder axis ``"batch"`` and
logical axes ``"data"`` / ``"model"`` / ``"pod"``.  The launcher resolves
them:

* ``"batch"`` expands to the mesh's batch axes (``("pod", "data")`` on the
  multi-pod mesh) — or to no sharding when the actual batch dimension is
  not divisible by them (long-context decode with global_batch=1).
* axes missing from the mesh are dropped (a 1D mesh still runs TP specs).

A mesh is a ``DeviceMesh`` or an :class:`AbstractMesh` (axis names and
sizes, no devices: the production meshes' 256 and 512 ranks resolve in one
process).  :func:`to_placements` turns a resolved spec into the ``DTensor``
placements, one per mesh dimension.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch import pytree
from repro_torch.parallel.shardctx import P, PartitionSpec, mesh_axes


class AbstractMesh:
    """Axis names and sizes of a mesh, without devices or a process group."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError((shape, axis_names))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def batch_axes(mesh):
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _axes_size(mesh, axes) -> int:
    sizes = mesh_axes(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


def resolve_spec(spec: PartitionSpec, mesh,
                 batch_size: Optional[int] = None) -> PartitionSpec:
    names = mesh_axes(mesh)
    out = []
    for entry in spec:
        if entry == "batch":
            ax = batch_axes(mesh)
            if not ax:
                out.append(None)
            elif batch_size is not None and batch_size % _axes_size(mesh, ax):
                out.append(None)          # unshardable batch: replicate
            else:
                out.append(ax if len(ax) > 1 else ax[0])
        elif entry is None:
            out.append(None)
        else:
            entries = entry if isinstance(entry, tuple) else (entry,)
            kept = tuple(a for a in entries if a in names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def resolve_spec_for(shape, spec: PartitionSpec, mesh,
                     batch_size: Optional[int] = None) -> PartitionSpec:
    """Shape-aware resolution: drop mesh axes on non-divisible dims.

    (whisper's 51865 vocab does not divide by 16 — that dim replicates.)
    """
    base = resolve_spec(spec, mesh, batch_size)
    out = []
    for d, entry in enumerate(base):
        if entry is None or d >= len(shape):
            out.append(entry if d < len(shape) else None)
            continue
        if shape[d] % _axes_size(mesh, entry) != 0:
            out.append(None)
        else:
            out.append(entry)
    return P(*out)


@dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh (the counterpart of JAX's; a leaf of a
    tree, not a node).  ``to_placements`` gives its ``DTensor`` form."""
    mesh: object
    spec: PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_specs(fn, pspecs):
    """``fn`` over the specs of a tree (a None node stays None)."""
    if pspecs is None:
        return None
    if _is_spec(pspecs):
        return fn(pspecs)
    return pytree.map_(fn, pspecs)


def resolve_tree(pspecs, mesh, batch_size: Optional[int] = None):
    """Tree of PartitionSpec -> tree of NamedSharding."""
    return _map_specs(
        lambda s: NamedSharding(mesh, resolve_spec(s, mesh, batch_size)),
        pspecs)


def resolve_tree_for(shapes, pspecs, mesh, batch_size: Optional[int] = None):
    """Shape-aware variant: ``shapes`` is a matching tree of tensors (a
    ``meta`` tensor will do); any sharded-but-indivisible dim falls back to
    replication."""
    return pytree.map_(
        lambda s, p: NamedSharding(mesh, resolve_spec_for(
            tuple(getattr(s, "shape", ())), p, mesh, batch_size)),
        shapes, pspecs)


def spec_tree(pspecs, mesh, batch_size: Optional[int] = None):
    """Tree of PartitionSpec -> resolved tree of PartitionSpec."""
    return _map_specs(lambda s: resolve_spec(s, mesh, batch_size), pspecs)


def to_placements(spec: PartitionSpec, mesh) -> list:
    """A resolved spec as ``DTensor`` placements: for each mesh dimension,
    ``Shard(d)`` if tensor dimension ``d`` is split over it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                if a in where:
                    raise ValueError(f"axis {a!r} used twice in {spec}")
                where[a] = d
    return [Shard(where[a]) if a in where else Replicate()
            for a in mesh_axes(mesh)]
