"""Spans and counters of the model path, on the profiler's clock.

The flight recorder of this package times simulated requests in simulated
time; this module times the host's own work on the model path (a prefill,
a decode step, a train step and the layers under them), so a device
trace's idle gap can be put down to the layer the host was in.

* ``span(name, **attrs)`` is a context manager around a layer's work;
  ``traced(name)`` is the same around every call of a function.
* ``count(name, value)`` adds to a counter; ``value`` is a number, or a
  function of no arguments that gives one when ``counters`` is read (so
  a counter can hold a tensor the step computed anyway and reduce it
  later, launching nothing and waiting for nothing inside the step).

Both record exactly while a ``torch.profiler`` records (its on/off state,
``torch.autograd.profiler._is_profiler_enabled``), so the spans and the
device trace cover the same window.  Otherwise a span is one flag read
and a shared no-op context: nothing is recorded or launched.

A span records its name, its start and end in ``time.time_ns()`` (the
clock of the profiler's events), its id, its parent (the span open on
the same thread when it began; each thread keeps its own stack, so the
spans autograd opens on its backward thread nest there), the thread, and
its unit: the id of the outermost span open when it began, on its thread
or, for a thread with none open (autograd's), on any other.  ``prefill``,
``decode_step`` and ``train_step`` each open a unit.  Records stay in
memory, at most ``CAP`` of each kind (``dropped`` counts the rest), until
``clear()``.

Typical use::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        logits, cache = prefill(cfg, params, batch, max_len)
    spans.records()       # [Span(name="prefill", ...), Span(name="block"...
    spans.counters()      # {"moe.copies_routed": ..., "moe.copies_dropped": ...}
"""
from __future__ import annotations

import bisect
import functools
import itertools
import threading
import time
from typing import Any, Callable, NamedTuple

from torch.autograd import profiler as _profiler

CAP = 1_000_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    unit: int
    thread: int
    attrs: dict


class Count(NamedTuple):
    name: str
    unit: int | None
    value: Any            # a number, or a function of no arguments


_spans: list[Span] = []
_counts: list[Count] = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_unit: int | None = None        # the open outermost span of any thread
dropped = 0


def recording() -> bool:
    """Whether a ``torch.profiler`` is recording, and so this module."""
    return _profiler._is_profiler_enabled


def _keep(store: list, rec) -> None:
    global dropped
    with _lock:
        if len(store) < CAP:
            store.append(rec)
        else:
            dropped += 1


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "unit", "start", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _unit
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        else:
            self.parent = None
            if _unit is None:
                _unit = self.id
            self.unit = _unit
        stack.append(self)
        self.stack = stack
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _unit
        end = time.time_ns()
        self.stack.pop()
        if _unit == self.id:
            _unit = None
        _keep(_spans, Span(self.name, self.start, end, self.id, self.parent,
                           self.unit, threading.get_ident(), self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` around its body while a
    profiler records (module docstring), else does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def traced(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a function of no arguments giving one
    when ``counters`` is read) to counter ``name`` while a profiler
    records."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    _keep(_counts, Count(name, stack[-1].unit if stack else _unit, value))


def records(since_ns: int | None = None,
            until_ns: int | None = None) -> list[Span]:
    """The recorded spans, in the order they ended; with bounds, those
    that overlap [since_ns, until_ns]."""
    with _lock:
        out = list(_spans)
    return [s for s in out if (since_ns is None or s.end_ns >= since_ns)
            and (until_ns is None or s.start_ns <= until_ns)]


def counters(units=None) -> dict[str, float]:
    """Each counter's total over its counts (with ``units``, a set of
    span ids, those made in one of those units).  A count given as a
    function is called now, once: its number then replaces it."""
    with _lock:
        for i, c in enumerate(_counts):
            if callable(c.value):
                _counts[i] = c._replace(value=c.value())
        out = list(_counts)
    totals: dict[str, float] = {}
    for c in out:
        if units is None or c.unit in units:
            totals[c.name] = totals.get(c.name, 0) + c.value
    return totals


def clear() -> None:
    """Forget every span and count."""
    global dropped
    with _lock:
        _spans.clear()
        _counts.clear()
        dropped = 0


def self_ns(spans: list[Span]) -> dict[int, int]:
    """Each span's duration less what its children among ``spans`` cover,
    by span id."""
    kids: dict[int, list[tuple[int, int]]] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, at = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, at), min(b, s.end_ns)
            if b > a:
                covered += b - a
                at = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


def attribute(spans: list[Span], intervals) -> dict[str | None, int]:
    """Where the host was during each (start_ns, end_ns) of ``intervals``
    (a device trace's idle gaps, say): ns by the name of the innermost
    open span (the open span that began last, on any thread), under None
    where no span was open."""
    points = sorted({p for s in spans for p in (s.start_ns, s.end_ns)})
    starts = sorted(spans, key=lambda s: s.start_ns)
    pieces, active, k = [], [], 0           # (a, b, name) over the points
    for a, b in zip(points, points[1:]):
        while k < len(starts) and starts[k].start_ns <= a:
            active.append(starts[k])
            k += 1
        active = [s for s in active if s.end_ns > a]
        if active:
            pieces.append((a, b, max(active, key=lambda s: s.start_ns).name))
    ends = [b for _, b, _ in pieces]
    out: dict[str | None, int] = {}
    for lo, hi in intervals:
        inside, i = 0, bisect.bisect_right(ends, lo)
        while i < len(pieces) and pieces[i][0] < hi:
            a, b, name = pieces[i]
            a, b = max(a, lo), min(b, hi)
            out[name] = out.get(name, 0) + b - a
            inside += b - a
            i += 1
        if hi - lo - inside:
            out[None] = out.get(None, 0) + hi - lo - inside
    return out


__all__ = ["Span", "Count", "CAP", "recording", "span", "traced", "count",
           "records", "counters", "clear", "self_ns", "attribute"]
