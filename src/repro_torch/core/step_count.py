"""Counting one eager step: the port's counterpart of
``repro/core/metrics.py::profile_from_compiled``.

The reference reads a compiled XLA program: ``hlo_analysis.analyze`` walks
its HLO and ``memory_analysis`` sizes its buffers.  Torch runs eagerly and
compiles nothing, so :class:`StepCounter` is a ``TorchDispatchMode`` that
watches one step run, op by op, and tallies what ``analyze`` tallies, in
the same units:

* ``flops`` — only the matmul-class aten ops (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, the convolutions and the fused attention ops), by
  ``torch.utils.flop_counter``'s formulas (2 x |result| x contraction),
  as the reference counts only ``dot`` and ``convolution``.  No
  elementwise work is counted.
* ``hbm_bytes`` — the reference's estimator: the step's arguments are read
  once, and every op result is written once and read about once (2 x its
  bytes).  Under eager execution each aten op is a top-level op.  A view
  (an alias the op does not write) allocates nothing and is not counted.
* ``coll_bytes`` / ``coll_breakdown`` — the result-shape payload of every
  collective, keyed by the reference's HLO names
  (``hlo_analysis.COLLECTIVE_OPS``), from the c10d ops that
  ``parallel/collectives.py`` issues and their functional forms.  A
  collective's result also counts 2x in ``hbm_bytes``, as in the HLO.
* ``peak_bytes`` — the most bytes live at once during the step: the
  arguments' storages, plus every storage an op allocates, until it is
  freed.  It stands in for ``memory_analysis()``'s temp + argument +
  output sizes.

The counts depend on shapes and on the ops the step runs, never on
values, so a step on the ``meta`` device counts what the same step counts
on real tensors (``launch/dryrun.py`` relies on it), and a
``fake`` process group's collectives count what a real group's do.  A
tensor subclass (``DTensor``) is sized by its local tensor.

On ``meta`` tensors many of torch's shape functions are Python, and a
chunked-attention prefill dispatches millions of ops.  Every op still runs
through the counter, but an op that allocates a new result from plain
``meta`` inputs whose layouts it has already seen gets a fresh
``empty_strided`` result of the layout it gave the first time, instead of
running the shape function again (:meth:`StepCounter._run`): the
results' shapes, strides and dtypes are those of the inputs' layouts and
the op's other arguments alone.
:func:`profile_from_step` wraps it all into a
:class:`~repro_torch.core.metrics.StepProfile`; its ``raw`` holds what has
no XLA meaning here: the counts by aten op and the largest collectives.
"""
from __future__ import annotations

import collections
import time
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.hlo_analysis import COLLECTIVE_OPS
from repro_torch.core.metrics import StepProfile

_c10d = torch.ops.c10d
_fn = torch.ops._c10d_functional

# in-place c10d ops: the payload is their first argument (the results)
_C10D_KIND = {
    _c10d.allreduce_: "all-reduce",
    _c10d.allreduce_coalesced_: "all-reduce",
    _c10d.allgather_: "all-gather",
    _c10d._allgather_base_: "all-gather",
    _c10d.reduce_scatter_: "reduce-scatter",
    _c10d._reduce_scatter_base_: "reduce-scatter",
    _c10d.alltoall_: "all-to-all",
    _c10d.alltoall_base_: "all-to-all",
}
# functional forms: the payload is what they return
_FUNCTIONAL_KIND = {
    _fn.all_reduce: "all-reduce",
    _fn.all_reduce_coalesced: "all-reduce",
    _fn.all_gather_into_tensor: "all-gather",
    _fn.all_gather_into_tensor_coalesced: "all-gather",
    _fn.reduce_scatter_tensor: "reduce-scatter",
    _fn.all_to_all_single: "all-to-all",
}
assert set(_C10D_KIND.values()) | set(_FUNCTIONAL_KIND.values()) \
    <= set(COLLECTIVE_OPS)


def _local(t: torch.Tensor) -> torch.Tensor:
    """The tensor that holds the bytes (a ``DTensor``'s local shard)."""
    inner = getattr(t, "_local_tensor", None)
    return inner if isinstance(inner, torch.Tensor) else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _shape_text(t: torch.Tensor) -> str:
    t = _local(t)
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


class _NotMemoable(Exception):
    pass


_CONSTANTS = (int, float, bool, str, type(None), torch.dtype, torch.device,
              torch.layout, torch.memory_format)


def _layout_key(x):
    """A hashable key of an argument tree's layouts: plain ``meta`` tensors
    by dtype, shape and strides, constants by type and value."""
    if type(x) is torch.Tensor:
        if not x.is_meta:
            raise _NotMemoable
        return (x.dtype, tuple(x.shape), x.stride())
    if isinstance(x, (tuple, list)):
        return (type(x),) + tuple(_layout_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _layout_key(v)) for k, v in x.items())
    if isinstance(x, _CONSTANTS):
        return (type(x), x)
    raise _NotMemoable


class _Op:
    """What the counter needs of one aten overload, looked up once."""
    __slots__ = ("name", "flops", "c10d", "functional", "writes", "mutable",
                 "memoable")

    def __init__(self, func):
        packet = func._overloadpacket
        sch = func._schema
        self.name = str(packet)
        self.flops = flop_registry.get(packet)
        self.c10d = _C10D_KIND.get(packet)
        self.functional = _FUNCTIONAL_KIND.get(packet)
        self.mutable = sch.is_mutable
        # per return: a new or written result (a view is an alias the op
        # does not write)
        self.writes = [r.alias_info is None or r.alias_info.is_write
                       for r in sch.returns]
        self.memoable = (not self.mutable and bool(sch.returns) and all(
            str(r.type) == "Tensor" and r.alias_info is None
            for r in sch.returns))


# a constant lifted from a Python scalar: an alias, and on the meta device
# torch builds such constants without it
_UNCOUNTED = ("aten.lift_fresh",)


class StepCounter(TorchDispatchMode):
    """Tallies FLOPs, device-memory bytes, collective bytes and the live
    peak of everything run inside it; ``args`` are the step's inputs (read
    once, live from the start)."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_breakdown = {op: 0.0 for op in COLLECTIVE_OPS}
        self.ops: Dict[str, int] = collections.Counter()
        self.flops_by_op: Dict[str, float] = collections.Counter()
        self._colls: Dict[tuple, list] = {}
        self._live = 0
        self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()
        self._info: Dict[Any, _Op] = {}
        self._memo: Dict[tuple, tuple] = {}
        self.arg_bytes = 0
        for t in _tensors(args):
            if self._track(t):
                self.arg_bytes += _nbytes(t)
        self.hbm_bytes += self.arg_bytes

    # -- live bytes ---------------------------------------------------------

    def _freed(self, n: int) -> None:
        self._live -= n

    def _track(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage live from now until it is freed; False if
        it already is."""
        st = _local(t).untyped_storage()
        if st in self._seen:
            return False
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._freed, n)
        self._live += n
        if self._live > self.peak_bytes:
            self.peak_bytes = self._live
        return True

    # -- meta results by layout ----------------------------------------------

    def _run(self, op: _Op, func, args, kwargs):
        """``func``'s result; on plain ``meta`` inputs of layouts it has
        seen, a fresh result of the layouts it gave then.  Views, ops that
        write their inputs, results other than new tensors and inputs other
        than plain ``meta`` tensors and constants always run."""
        key = None
        if op.memoable:
            try:
                key = (func, _layout_key(args), _layout_key(kwargs))
            except _NotMemoable:
                pass
            else:
                layouts = self._memo.get(key, ())
                if layouts is None:
                    key = None
                elif layouts:
                    outs = tuple(torch.empty_strided(
                        shape, stride, dtype=dtype, device="meta")
                        for shape, stride, dtype in layouts)
                    return outs[0] if len(outs) == 1 else outs
        out = func(*args, **kwargs)
        if key is not None:
            results = out if isinstance(out, tuple) else (out,)
            inputs = {id(t.untyped_storage())
                      for t in _tensors((args, kwargs))}
            if all(type(t) is torch.Tensor and t.is_meta
                   and id(t.untyped_storage()) not in inputs
                   for t in results):
                self._memo[key] = tuple((t.shape, t.stride(), t.dtype)
                                        for t in results)
            else:
                # an undeclared alias (``_unsafe_view``): runs every time
                self._memo[key] = None
        return out

    # -- the dispatch hook ---------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = self._info.get(func)
        if op is None:
            op = self._info[func] = _Op(func)
        out = self._run(op, func, args, kwargs)
        if op.name in _UNCOUNTED:
            return out
        self.ops[op.name] += 1
        if op.flops is not None:
            f = float(op.flops(*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[op.name] += f
        if op.c10d is not None:
            self._collective(op.c10d, _tensors(args[0]))
            return out
        if op.functional is not None:
            self._collective(op.functional, _tensors(out))
        results = out if isinstance(out, (tuple, list)) else (out,)
        for w, r in zip(op.writes, results):
            if not w:
                continue
            for t in _tensors(r):
                if self._track(t) or op.mutable:
                    self.hbm_bytes += 2.0 * _nbytes(t)
        return out

    def _collective(self, kind: str, results) -> None:
        b = float(sum(_nbytes(t) for t in results))
        self.coll_bytes += b
        self.coll_breakdown[kind] += b
        self.hbm_bytes += 2.0 * b
        key = (kind, ", ".join(_shape_text(t) for t in results)[:48])
        rec = self._colls.setdefault(key, [0.0, 0])
        rec[0] += b
        rec[1] += 1

    # -- the profile ---------------------------------------------------------

    def top_collectives(self, keep: int = 12) -> list:
        """(total bytes, kind, result shapes, count) largest first: the
        reference's ``top_collectives`` with the loop multiplier as the
        number of calls of that shape."""
        rows = [(b, k, s, n) for (k, s), (b, n) in self._colls.items()]
        rows.sort(reverse=True)
        return rows[:keep]

    def profile(self, name: str, *, chips: int, model_flops: float = 0.0,
                per_chip_batch: float = 0.0,
                divergence: float = 0.0) -> StepProfile:
        prof = StepProfile(
            name=name, flops=self.flops, hbm_bytes=self.hbm_bytes,
            coll_bytes=self.coll_bytes,
            coll_breakdown={k: int(v) for k, v in self.coll_breakdown.items()},
            peak_memory=float(self.peak_bytes), chips=chips,
            model_flops=model_flops, per_chip_batch=per_chip_batch,
            divergence=divergence)
        prof.raw = {"ops": dict(sorted(self.ops.items())),
                    "flops_by_op": dict(sorted(self.flops_by_op.items())),
                    "arg_bytes": self.arg_bytes,
                    "top_collectives": self.top_collectives()}
        return prof


def profile_from_step(name: str, fn: Callable, *args, chips: int,
                      model_flops: float = 0.0, per_chip_batch: float = 0.0,
                      divergence: float = 0.0) -> StepProfile:
    """Run ``fn(*args)`` once under a :class:`StepCounter` and build its
    :class:`StepProfile` (the counterpart of ``profile_from_compiled``);
    ``raw["trace_s"]`` is the run's wall time."""
    t0 = time.perf_counter()
    with StepCounter(args) as sc:
        fn(*args)
    prof = sc.profile(name, chips=chips, model_flops=model_flops,
                      per_chip_batch=per_chip_batch, divergence=divergence)
    prof.raw["trace_s"] = time.perf_counter() - t0
    return prof
