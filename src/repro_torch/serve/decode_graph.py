"""Decode as one CUDA graph per live decode state.

Eager, a decode step enqueues every kernel from the host: ~2,200 launches
for falcon-mamba-7b, ~3,500 for deepseek-moe-16b, at 36-60 us each, so the
device waits on the host.  :class:`DecodeGraphs` is the decode closure
that :func:`repro_torch.serve.engine.make_decode_fn` hands to every group.
The first call on a decode state it has not seen captures
``transformer.decode_step`` on that state's own tensors, the weights and a
``(B, 1)`` token buffer, and replays it once (a capture runs nothing);
every later call on the same state copies the new tokens into the buffer
and replays.  The captured step writes its whole result back into the
state it was given (``pos + 1`` into ``state.pos``, each ``rest`` leaf
into its tensor; the ``reps`` leaves are written in place by the step
itself), so the state stays the part's own tensors: nothing is copied
between calls and no state memory is added, and the returned state is the
one that came in.  The logits returned are a copy of the graph's output,
so a caller may hold them across later calls.

A graph is keyed by its state's ``pos`` tensor and goes when that tensor
does: a part that drains, a re-cut (``state_utils.take`` / ``concat`` make
new tensors) and a new prefill wave each drop their states, and so their
graphs.  All graphs of a device draw their temporaries from one private
memory pool: they replay one after another on one stream, and no graph's
output is read after another graph has run.  Where a capture runs out of
memory, that call runs eagerly and is counted (``eager``).

The graph path is taken where its inputs allow it: the state's leaves,
the token rows and the weights are plain tensors on a CUDA device and no
device mesh is active.  Everything else (the CPU; a ``DTensor`` state or
any mesh, whose collectives cannot be captured) runs ``decode_step``
eagerly as before.  Host-side work inside the step runs at capture only:
:data:`repro_torch.kernels.ops.launches` is counted again at each replay
from what the capture counted, and a CUDA event made inside the capture
is recorded into the graph, so each replay records it again.

The counts ``captures``, ``replays``, ``eager`` and ``capture_s`` (host
seconds of captures) are plain attributes; the span log sees each capture
and replay as ``model.decode_capture`` and ``model.decode_replay`` inside
``group.decode`` (``repro_torch.obs.spans``).
"""
from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.obs.spans import SPANS
from repro_torch.parallel import shardctx
from repro_torch.serve import state_utils as su

clock = time.perf_counter


@contextlib.contextmanager
def _launches_kept():
    """``ops.launches`` as it was on entry once the block ends: the
    block's host-side launches are not the device work they count."""
    kept = dict(ops.launches)
    try:
        yield
    finally:
        ops.launches.update(kept)


@contextlib.contextmanager
def _events_into_graph():
    """``torch.cuda.Event``s made here record into a capture as the
    graph's own event nodes (``external``).  An event recorded into a
    capture otherwise stays unusable (``elapsed_time`` raises), which would
    break a caller that times work inside the step (the benchmark's
    per-layer timers do).  The patch is of the class, for the whole
    process, while a capture lasts; captures run on one thread."""
    cls = torch.cuda.Event
    own = cls.__dict__["__new__"]
    new = cls.__new__

    def as_node(c, enable_timing=False, blocking=False, interprocess=False,
                external=False):
        return new(c, enable_timing=enable_timing, blocking=blocking,
                   interprocess=interprocess, external=True)

    cls.__new__ = staticmethod(as_node)
    try:
        yield
    finally:
        cls.__new__ = own


class CudaCapture:
    """The CUDA calls of :class:`DecodeGraphs`, in one object so that a
    test can put a stand-in in its place."""

    def owns(self, t: torch.Tensor) -> bool:
        return t.is_cuda

    def stream(self, device: torch.device):
        return torch.cuda.Stream(device)

    def pool(self, device: torch.device):
        return torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def on(self, stream):
        """Work on ``stream``, ordered after the current stream's and
        before what the current stream does next."""
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            yield
        cur.wait_stream(stream)

    def capture(self, fn: Callable[[], None], stream, pool):
        """A ``torch.cuda.CUDAGraph`` of ``fn`` captured on ``stream``
        into ``pool``; nothing runs.  Where ``fn`` raises, the capture is
        ended and ``fn``'s error raised, whatever ending it says."""
        graph = torch.cuda.CUDAGraph()
        with self.on(stream), _events_into_graph():
            graph.capture_begin(pool=pool)
            try:
                fn()
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
        return graph


@dataclass
class _Side:
    """One device's capture stream and memory pool.  ``anchor``, a one-op
    graph of the pool's own, keeps the pool open: PyTorch's allocators
    close a pool once its last graph has gone, and no capture may join it
    after."""
    stream: Any
    pool: Any
    anchor: Any = None


@dataclass
class _Graph:
    graph: Any
    leaves: Tuple[int, ...]    # every state leaf's data_ptr at capture
    params: Any                # the weights the graph reads
    tokens: torch.Tensor       # the static (B, 1) input
    out: Dict[str, torch.Tensor] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)


class DecodeGraphs:
    """``decode_fn(params, state, tokens) -> (logits, state)``: the
    decode step replayed as one CUDA graph per live decode state where
    the inputs allow it, else ``transformer.decode_step`` eagerly."""

    def __init__(self, cfg: ModelConfig, rt: T.Runtime,
                 cuda: Optional[CudaCapture] = None):
        self.cfg = cfg
        self.rt = rt
        self.cuda = cuda if cuda is not None else CudaCapture()
        self._graphs: Dict[int, _Graph] = {}
        self._sides: Dict[torch.device, _Side] = {}
        self.captures = 0
        self.replays = 0
        self.eager = 0
        self.capture_s = 0.0

    @property
    def live(self) -> int:
        """Graphs held: one per live decode state that has decoded."""
        return len(self._graphs)

    def __call__(self, params, state: T.DecodeState,
                 tokens: torch.Tensor):
        leaves = self._leaves(state, tokens)
        if leaves is None:
            return T.decode_step(params, state, tokens, self.cfg, self.rt)
        g = self._graphs.get(id(state.pos))
        if g is not None and not (g.params is params and g.leaves == leaves
                                  and g.tokens.shape == tokens.shape):
            g = None
        if g is None:
            g = self._capture(params, state, tokens, leaves)
            if g is None:
                self.eager += 1
                SPANS.annotate(eager=1)
                return T.decode_step(params, state, tokens, self.cfg,
                                     self.rt)
        with SPANS.span("model.decode_replay", batch=tokens.shape[0]):
            g.tokens.copy_(tokens)
            g.graph.replay()
        for k, n in g.launches.items():
            ops.launches[k] += n
        self.replays += 1
        return g.out["logits"].clone(), state

    # -- scope ---------------------------------------------------------------

    def _leaves(self, state, tokens) -> Optional[Tuple[int, ...]]:
        """The state leaves' data_ptrs where the graph path takes these
        inputs, else None."""
        leaves = pytree.leaves(state)
        if shardctx.current_mesh() is not None or \
                not self._on_device([tokens, *leaves]):
            return None
        return tuple(x.data_ptr() for x in leaves)

    def _on_device(self, xs) -> bool:
        """Plain tensors (no ``DTensor``) on a CUDA device, all of them."""
        return all(isinstance(x, torch.Tensor) and not shardctx.is_dtensor(x)
                   and self.cuda.owns(x) for x in xs)

    # -- capture -------------------------------------------------------------

    def _side(self, params, state, tokens) -> _Side:
        """The device's stream and pool, made at its first capture; cuBLAS's
        handle and workspace for the stream are made then by one eager step
        on a throwaway one-row copy of the state (a capture cannot make
        them, and decode writes the live state in place).  That step's
        launches are not counted: it serves no request."""
        dev = tokens.device
        side = self._sides.get(dev)
        if side is None:
            side = _Side(stream=self.cuda.stream(dev),
                         pool=self.cuda.pool(dev))
            with self.cuda.on(side.stream), torch.no_grad(), \
                    _launches_kept():
                T.decode_step(params, su.take(state, [0]), tokens[:1],
                              self.cfg, self.rt)
            one = torch.zeros(1, device=dev)
            side.anchor = self.cuda.capture(lambda: one.add_(1), side.stream,
                                            side.pool)
            self._sides[dev] = side
        return side

    def _capture(self, params, state, tokens,
                 leaves: Tuple[int, ...]) -> Optional[_Graph]:
        """Capture the step on ``state`` and run it once; None where the
        weights are not plain CUDA tensors (the call is then eager) or the
        capture ran out of memory (counted by the caller)."""
        if not self._on_device(pytree.leaves(params)):
            return None
        batch = tokens.shape[0]
        side = self._side(params, state, tokens)
        g = _Graph(graph=None, leaves=leaves, params=params,
                   tokens=tokens.clone())
        cfg, rt = self.cfg, self.rt

        def step() -> None:
            logits, new = T.decode_step(params, state, g.tokens, cfg, rt)
            state.pos.copy_(new.pos)
            T._write_(state.rest, new.rest)
            g.out["logits"] = logits

        counted = dict(ops.launches)
        t0 = clock()
        try:
            with _launches_kept(), \
                    SPANS.span("model.decode_capture", batch=batch), \
                    torch.no_grad():
                g.graph = self.cuda.capture(step, side.stream, side.pool)
                SPANS.annotate(ms=1e3 * (clock() - t0))
                # the capture counted launches that only its replays make
                g.launches = {k: n - counted[k]
                              for k, n in ops.launches.items()
                              if n != counted[k]}
        except torch.cuda.OutOfMemoryError:
            return None
        self.capture_s += clock() - t0
        self.captures += 1
        key = id(state.pos)
        self._graphs[key] = g
        # the graph goes with its state: ``pos`` is freed with it
        weakref.finalize(state.pos, self._graphs.pop, key, None)
        return g
