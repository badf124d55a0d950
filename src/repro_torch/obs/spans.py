"""Host spans inside the serving path, on the profiler's clock.

One module-level :class:`SpanLog`, ``SPANS``, off by default (as
``kernels/ops.launches`` is one module-level counter).  While it is off
and no profiler records, ``span`` returns one shared null context and
does nothing else, so an instrumented site costs one call; sites that run
once per model layer check ``SPANS.on`` first and cost one attribute read.

While the log is on, each span records its name, its start and end in
``time.perf_counter()`` seconds, its own id, the id of the span open
around it, and its attributes (``gid``, ``part``, ``tick`` and sizes),
and enters ``torch.profiler.record_function(name)``: inside a profiler
window the device's kernels and these spans then share one clock.  While
the log is off but a ``torch.profiler`` records, a span is that
``record_function`` alone, so any profiler trace of the serving path
shows where the host was (the per-layer ``model.moe`` excepted).  The
names start with ``engine.``, ``group.`` or ``model.``:

================== ========================================================
span                around
================== ========================================================
engine.tick         one pass of ``FleetEngine.run``'s loop
engine.rebalance    the fleet controller's rebalance and its plans' execution
group.admit         one part's prefill wave (admission, prefill calls, merge)
group.prefill       one ``transformer.prefill`` call inside a wave
group.control       the group controller's features and ``observe``
group.reconfigure   a re-cut (``bytes``: decode state the merge and the
                    re-slice wrote)
group.decode        one part's decode call
group.readback      ``argmax``, ``tolist`` and the token bookkeeping after
                    a decode or a prefill call
model.moe           one ``moe_forward`` call
================== ========================================================

The log is a bounded buffer of finished spans: past ``capacity`` the
oldest go and ``dropped`` counts them, as ``EventLog``'s ring does.  It is
not an ``EventLog`` event stream and not exported from
``repro_torch.obs``; import it as ``repro_torch.obs.spans``::

    from repro_torch.obs import spans
    spans.start()
    ...                      # run the engine
    got = spans.take()       # {"spans": [...], "dropped": n}; cleared
    spans.stop()
"""
from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch
import torch.profiler

clock = time.perf_counter

DEFAULT_CAPACITY = 1 << 18

# (id, parent id, name, start s, end s, attributes)
_Done = Tuple[int, Optional[int], str, float, float, Dict[str, Any]]


class _NullSpan:
    """What ``span`` returns while the log is off and no profiler
    records: one shared instance."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """One open span; recorded in its log when it closes."""
    __slots__ = ("log", "name", "attrs", "id", "parent", "start", "_rf")

    def __init__(self, log: "SpanLog", name: str, attrs: Dict[str, Any]):
        self.log = log
        self.name = name
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        """Add attributes known only once the work has run."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        log = self.log
        self.id = log._next_id
        log._next_id += 1
        self.parent = log._open[-1] if log._open else None
        log._open.append(self.id)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start = clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = clock()
        self._rf.__exit__(*exc)
        log = self.log
        log._open.pop()
        log._add((self.id, self.parent, self.name, self.start, end,
                  self.attrs))
        return False


class SpanLog:
    """A bounded log of host spans, off until :meth:`start`."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.on = False
        self.capacity = int(capacity)
        self.dropped = 0
        self._done: Deque[_Done] = collections.deque(maxlen=self.capacity)
        self._open: List[int] = []
        self._next_id = 0

    def start(self, capacity: Optional[int] = None) -> None:
        """Clear the log and turn it on (keeping at most ``capacity``)."""
        if capacity is not None:
            if int(capacity) < 1:
                raise ValueError(f"capacity {capacity!r} < 1")
            self.capacity = int(capacity)
        self._done = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self._open = []
        self._next_id = 0
        self.on = True

    def stop(self) -> None:
        """Turn the log off; what it holds stays until :meth:`take`."""
        self.on = False

    def take(self) -> Dict[str, Any]:
        """The finished spans in order of their start, as plain dicts
        (``id``, ``parent``, ``name``, ``start``, ``end``, ``attrs``), and
        the count dropped past the capacity; the log is cleared."""
        spans = [dict(id=i, parent=p, name=n, start=s, end=e,
                      attrs=dict(a))
                 for i, p, n, s, e, a in sorted(self._done,
                                                key=lambda d: d[3])]
        out = {"spans": spans, "dropped": self.dropped}
        self._done.clear()
        self.dropped = 0
        return out

    def span(self, name: str, **attrs: Any):
        """A context that records one span while the log is on, else an
        annotation while a profiler records, else the null context."""
        if self.on:
            return _Span(self, name, attrs)
        if torch.autograd._profiler_enabled():
            return torch.profiler.record_function(name)
        return NULL_SPAN

    def _add(self, done: _Done) -> None:
        if len(self._done) == self.capacity:
            self.dropped += 1
        self._done.append(done)


SPANS = SpanLog()
start = SPANS.start
stop = SPANS.stop
take = SPANS.take
span = SPANS.span
