"""Mesh context plumbing, and the DTensor helpers of the sharded paths.

Counterpart of ``repro/parallel/shardctx.py``.  Model code never imports a
concrete mesh; it calls :func:`hint` / :func:`current_mesh`.  Launchers and
tests install the active mesh with :func:`use_mesh`.  Without a mesh every
hint is a no-op and every helper below returns its input, so the same model
code runs on one device.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimensions
are named from ``pod``, ``data`` and ``model``.  A layout is written as a
:class:`PartitionSpec` (``P``): one entry per tensor dimension, a mesh axis
name, a tuple of names, or None (replicated), with ``"batch"`` standing for
the mesh's batch axes (``repro_torch.parallel.resolve`` resolves it).

The port computes eagerly on each rank, so a tensor in model code is the
rank's own value: the rows of the batch this rank holds (the batch axes'
share), replicated over ``model`` unless a path says otherwise.  ``hint``
therefore marks a layout and moves nothing.  Parameters and optimizer state
live at rest as ``DTensor``s laid out by their resolved specs
(:func:`layout`); a layer reads its weights through :func:`gather`, an
all-gather whose backward all-reduces the gradient over the axes the rank's
copy stands for and keeps its own shard (the reduce-scatter, written as
all-reduce + slice).  The tensor-parallel serving path reads a weight its
spec splits over 'model' through :func:`model_shard` instead: only this
rank's 'model' shard, found by :func:`model_dim`.  Cache and stacked-layer
helpers (:func:`select`,
:func:`stack`, :func:`local`) move between a ``DTensor`` and its local
tensor without a collective.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Sequence, Tuple

import torch

_state = threading.local()


class PartitionSpec:
    """A tensor's layout over mesh axes, one entry per dimension.

    The port's counterpart of ``jax.sharding.PartitionSpec``: entries are
    axis names, tuples of axis names, or None.  It is not a tuple, so a tree
    walk (``repro_torch.pytree``) takes it as a leaf.
    """
    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(tuple(e) if isinstance(e, list) else e
                              for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}" if len(self) != 1 \
            else f"P({self._entries[0]!r})"


P = PartitionSpec


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``resolve.AbstractMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def batch_axes() -> Tuple[str, ...]:
    """Mesh axes that carry the batch/data-parallel dimension."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def model_axes() -> Tuple[str, ...]:
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in mesh_axes(mesh) if a == "model")


def axis_size(axis: str, mesh=None) -> int:
    mesh = mesh if mesh is not None else current_mesh()
    return mesh_axes(mesh).get(axis, 1) if mesh is not None else 1


def axis_index(axis: str, mesh=None) -> int:
    """This rank's coordinate on ``axis`` (0 off the mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis not in mesh_axes(mesh):
        return 0
    return mesh.get_local_rank(axis)


def _resolved(spec) -> list:
    ax = batch_axes()
    return [(ax if ax else None) if s == "batch" else s for s in spec]


def hint(x, *spec):
    """Mark ``x``'s layout; a no-op, as the reference's is without a mesh.

    Under a mesh the spec must name only the mesh's axes.  The rank's
    tensor already is its share in the layouts the model code computes in
    (see the module docstring), so nothing moves.
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    names = mesh_axes(mesh)
    for s in _resolved(spec):
        for a in (s if isinstance(s, tuple) else (s,)):
            if a is not None and a not in names:
                raise ValueError(f"hint: axis {a!r} not in mesh {names}")
    return x


def named_sharding(*spec):
    """The resolved sharding of ``spec`` on the current mesh, or None."""
    mesh = current_mesh()
    if mesh is None:
        return None
    from repro_torch.parallel import resolve
    return resolve.NamedSharding(mesh, P(*_resolved(spec)))


# ---------------------------------------------------------------------------
# DTensor helpers
# ---------------------------------------------------------------------------

def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """A ``DTensor``'s local tensor (differentiable); anything else as is."""
    return t.to_local() if is_dtensor(t) else t


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _wrap(loc: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(loc, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _shift(placements, by: int):
    from torch.distributed.tensor import Shard
    out = []
    for p in placements:
        if isinstance(p, Shard):
            if p.dim + by < 0:
                raise ValueError("select: the leading dimension is sharded")
            p = Shard(p.dim + by)
        out.append(p)
    return out


def unbind(t) -> List:
    """The layers of a stacked leaf (leading dimension unsharded): one
    ``torch.unbind`` of the local tensor, each layer a ``DTensor`` again."""
    if not is_dtensor(t):
        return list(torch.unbind(t))
    pl = _shift(t.placements, -1)
    return [_wrap(x, t.device_mesh, pl, t.shape[1:])
            for x in torch.unbind(t.to_local())]


def select(t, r: int):
    """Layer ``r`` of a stacked leaf, a view (no copy, no collective)."""
    if not is_dtensor(t):
        return t[r]
    return _wrap(t.to_local()[r], t.device_mesh, _shift(t.placements, -1),
                 t.shape[1:])


def stack(ts: Sequence):
    """Stack identical leaves on a new leading (unsharded) axis."""
    if not is_dtensor(ts[0]):
        return torch.stack(list(ts))
    t0 = ts[0]
    return _wrap(torch.stack([x.to_local() for x in ts]), t0.device_mesh,
                 _shift(t0.placements, 1), (len(ts),) + tuple(t0.shape))


def _axis_dims(mesh) -> List[str]:
    return list(mesh.mesh_dim_names)


def shard_of(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A copy of this rank's block of ``full`` under ``placements`` (one
    per mesh dimension).  Dimensions sharded over several mesh axes are
    split by the outer axis first, as ``DTensor`` lays them out."""
    from torch.distributed.tensor import Shard
    out = full
    for name, p in zip(_axis_dims(mesh), placements):
        if isinstance(p, Shard):
            n = mesh_axes(mesh)[name]
            out = out.chunk(n, dim=p.dim)[mesh.get_local_rank(name)]
    return out.clone(memory_format=torch.contiguous_format)


def layout(full: torch.Tensor, mesh, spec, batch_size=None,
           device=None) -> torch.Tensor:
    """A ``DTensor`` of ``full`` (the same value on every rank) laid out by
    ``spec`` (shape-aware: a dimension its axes do not divide replicates),
    its shard moved to ``device`` when given.  0-dim leaves (step counters)
    stay plain tensors, replicated."""
    from repro_torch.parallel import resolve
    if full.dim() == 0:
        return full if device is None else full.to(device)
    pl = resolve.to_placements(resolve.resolve_spec_for(
        tuple(full.shape), spec, mesh, batch_size), mesh)
    loc = shard_of(full, mesh, pl)
    return _wrap(loc if device is None else loc.to(device), mesh, pl,
                 full.shape)


def layout_tree(tree, pspecs, mesh, batch_size=None, device=None):
    """:func:`layout` over a tree, each leaf by the spec at its path."""
    from repro_torch import pytree
    specs = pytree.flatten_with_paths(pspecs)
    flat = pytree.flatten_with_paths(tree)
    return pytree.unflatten(tree, iter(
        layout(v, mesh, specs[k], batch_size, device)
        for k, v in flat.items()))


def like(t, loc: torch.Tensor):
    """``loc`` as the local tensor of a ``DTensor`` laid out as ``t`` (a
    plain ``t``: ``loc`` itself)."""
    if not is_dtensor(t):
        return loc
    return _wrap(loc, t.device_mesh, list(t.placements), t.shape)


def batch_shard(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """This rank's rows of a batch tensor: the reference's
    ``resolve_spec(P("batch"), mesh, B)``.  A batch the batch axes do not
    divide is replicated (every rank keeps all of it)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return t
    sizes = mesh_axes(mesh)
    idx, n = 0, 1
    for a in sizes:
        if a in ("pod", "data"):
            idx = idx * sizes[a] + mesh.get_local_rank(a)
            n *= sizes[a]
    if n == 1 or t.shape[0] % n:
        return t
    return t.chunk(n, dim=0)[idx]


def zeros_like_layout(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """Zeros with ``t``'s layout (no full-size allocation)."""
    if not is_dtensor(t):
        return torch.zeros_like(t, dtype=dtype)
    return _wrap(torch.zeros_like(t.to_local(), dtype=dtype), t.device_mesh,
                 list(t.placements), t.shape)


def replication(t) -> int:
    """How many ranks hold each element of ``t`` (1 for a plain tensor)."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(t):
        return 1
    n = 1
    for name, p in zip(_axis_dims(t.device_mesh), t.placements):
        if isinstance(p, Replicate):
            n *= mesh_axes(t.device_mesh)[name]
    return n


def gather(t, keep: Sequence[str] = ()):
    """The value a layer computes with: ``t`` all-gathered over every mesh
    axis it is sharded on except ``keep``.

    Differentiable: the backward all-reduces the gradient over every mesh
    axis not in ``keep`` (the gathered axes and those ``t`` is replicated
    on, whose ranks each hold a copy the forward used) and slices this
    rank's shard back out: the reduce-scatter of the reference's FSDP
    gather, as all-reduce + slice.  A plain tensor comes back as it is.
    """
    if not is_dtensor(t):
        return t
    from repro_torch.parallel import collectives
    return collectives.gather_dtensor(t, tuple(keep))


def model_chunk(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` over 'model' (a view)."""
    n = axis_size("model")
    if t.shape[dim] % n:
        raise ValueError(f"model_chunk: {t.shape[dim]} does not divide over "
                         f"{n} model ranks")
    return t.chunk(n, dim=dim)[axis_index("model")]


def model_dim(t, spec):
    """The dimension of ``t`` that its spec, resolved shape-aware on the
    current mesh (``resolve.resolve_spec_for``), splits over 'model'; None
    when the resolved spec leaves 'model' out (the leaf is replicated over
    it, as the reference replicates it)."""
    from repro_torch.parallel import resolve
    rs = resolve.resolve_spec_for(tuple(t.shape), spec, current_mesh())
    for d, entry in enumerate(rs):
        if entry == "model":
            return d
        if isinstance(entry, tuple) and "model" in entry:
            raise ValueError(f"model_dim: {spec} splits one dimension over "
                             f"'model' and other axes")
    return None


def model_shard(t, dim: int):
    """A weight as a tensor-parallel layer computes with it: this rank's
    'model' shard along ``dim``, whole over every other axis.  A ``DTensor``
    laid out by the same spec is gathered over the other axes only
    (``gather(keep=("model",))``, the form ``moe_sharded`` uses); a plain
    (replicated) tensor gives its chunk.  A ``DTensor`` laid out otherwise
    raises."""
    if not is_dtensor(t):
        return model_chunk(t, dim)
    from torch.distributed.tensor import Shard
    at = _axis_dims(t.device_mesh).index("model")
    if t.placements[at] != Shard(dim):
        raise ValueError(f"model_shard: a leaf laid out as {t.placements} "
                         f"is not split over 'model' on dimension {dim}")
    return gather(t, keep=("model",))


def full(t) -> torch.Tensor:
    """The whole value of ``t`` on every rank, outside autograd: a new
    tensor for a ``DTensor`` (a plain tensor comes back as it is)."""
    if not is_dtensor(t):
        return t
    with torch.no_grad():
        out = gather(t.detach())
        if out.data_ptr() == t.to_local().data_ptr():
            out = out.clone()               # replicated: nothing gathered
        return out


def model_sharded(loc: torch.Tensor, dim: int) -> torch.Tensor:
    """``loc``, this rank's chunk along ``dim`` over 'model', as a
    ``DTensor`` over the current mesh's model axis: its global shape is
    ``loc``'s with ``dim`` ``n_model`` times as long (the other dimensions,
    the rank's batch rows among them, as ``loc`` has them)."""
    from torch.distributed.tensor import Shard
    dim %= loc.dim()
    shape = list(loc.shape)
    shape[dim] *= axis_size("model")
    return _wrap(loc, current_mesh()["model"], [Shard(dim)], shape)
