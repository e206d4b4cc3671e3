"""Spans and counters of the port: where an engine call's time goes, stage
by stage, on the profiler's clock.

A span is recorded only while a ``torch.profiler`` is recording (the CLI's
``--profile``, a benchmark's traced run) or inside :func:`recording`;
otherwise :func:`span` returns one shared null context after a flag read.
A recorded span is a :class:`Span`: name, start and end on
``time.perf_counter_ns``, parent, the id of the engine call it belongs
to, the counts made while it was the innermost open span. While a
profiler records, a span is also a ``torch.profiler.record_function``, so
it lands in the profiler's trace on the profiler's own clock, beside the
device's kernels and copies, and it is kept in memory until :func:`take`
hands the kept spans over and forgets them (at most :data:`KEEP`, so a
process profiled again and again without a reader holds no more).
:func:`recording` collects the spans of its block into its own list, and
emits no ``record_function``. Nothing is written out on the way.

Spans nest lexically on the calling thread. A span named ``call`` is the
root of an engine call (its entry is decorated with ``traced("call")``, so
that the span also holds the teardown of the entry's frame): it gets a new
id, which its descendants carry. While a recorded call is open, a
``gc.callbacks`` hook records each collection of the garbage collector as
a ``gc`` span, a child of the span open on the thread that collects.

:func:`count` always adds to a process total (:func:`counter`,
:func:`counts`, :func:`launched`); while recording, also to the innermost
open span's record, so that a counter can be read per call. PERF.md lists
the spans and counters with the metrics that read them.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _profiler

_lock = threading.Lock()
_local = threading.local()
_sinks: list = []  # the span list of every open recording() block
_totals: dict[str, int] = {}
KEEP = 1 << 17  # spans kept for take(): some 20 MB
_kept: list = []
_call_ids = itertools.count(1)
_calls_open = 0  # recorded calls open, for the gc hook


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Clock:
    """Two readings of ``time.perf_counter_ns``, at entry and at exit."""

    __slots__ = ("t0", "t1")

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span(_Clock):
    """One recorded span. ``t1`` is 0 while it is open; ``parent`` is the
    span open around it on its thread (None at the root); ``call`` the id
    of the engine call it belongs to (None outside one); ``counts`` the
    counts made while it was the innermost open span (None if none)."""

    __slots__ = ("name", "parent", "call", "counts", "_rf")

    def __init__(self, name: str, call: int | None = None):
        self.name = name
        self.t0 = self.t1 = 0
        self.parent = None
        self.call = call
        self.counts = None
        self._rf = None

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent = stack[-1]
            if self.call is None:
                self.call = self.parent.call
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            if len(_kept) < KEEP:
                _kept.append(self)
        for spans in _sinks:
            spans.append(self)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


class _Call(Span):
    """The root span of an engine call (``span("call")``): a new call id,
    and the gc hook installed while it is open."""

    __slots__ = ()

    def __enter__(self):
        global _calls_open
        with _lock:
            _calls_open += 1
            if _calls_open == 1:
                gc.callbacks.append(_on_gc)
        return super().__enter__()

    def __exit__(self, *exc):
        global _calls_open
        super().__exit__(*exc)
        with _lock:
            _calls_open -= 1
            if _calls_open == 0 and _on_gc in gc.callbacks:
                gc.callbacks.remove(_on_gc)
        return False


def _on_gc(phase, info):
    """gc.callbacks hook: a ``gc`` span from a collection's start to its
    stop, on the collecting thread."""
    if phase == "start":
        if _sinks or _profiler._is_profiler_enabled:
            _local.gc = Span("gc").__enter__()
    else:
        s = getattr(_local, "gc", None)
        if s is not None:
            _local.gc = None
            s.__exit__(None, None, None)


def _new(name: str) -> Span:
    return _Call(name, next(_call_ids)) if name == "call" else Span(name)


def span(name: str):
    """A context that records the span ``name`` while a profiler records or
    a :func:`recording` block is open, else the shared null context."""
    if not (_sinks or _profiler._is_profiler_enabled):
        return _NULL
    return _new(name)


def timed(name: str):
    """A context whose ``seconds`` is the time between its entry and its
    exit, always; recorded as the span ``name`` where :func:`span` would
    be, on the same two clock readings."""
    if not (_sinks or _profiler._is_profiler_enabled):
        return _Clock()
    return Span(name)


def traced(name: str):
    """Decorator: the function's body in the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (_sinks or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _new(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the counter ``name``: to its process total, and while
    spans are recorded to the innermost open span's record on this
    thread."""
    with _lock:
        _totals[name] = _totals.get(name, 0) + n
    if _sinks or _profiler._is_profiler_enabled:
        stack = _stack()
        if stack:
            s = stack[-1]
            if s.counts is None:
                s.counts = {}
            s.counts[name] = s.counts.get(name, 0) + n


def counter(name: str) -> int:
    """The process total of the counter ``name`` (0 before its first
    count)."""
    with _lock:
        return _totals.get(name, 0)


def counts() -> dict:
    """A copy of every counter's process total."""
    with _lock:
        return dict(_totals)


def launched(route: str, since: dict | None = None) -> int:
    """Launches of the kernel route ``route`` (the counter
    ``launches.<route>``) in this process, or since ``since``, a
    :func:`counts` snapshot."""
    name = "launches." + route
    return counter(name) - (since or {}).get(name, 0)


def take() -> list:
    """The spans kept while a profiler recorded, in the order they opened
    (a span still open has ``t1`` 0), since the last take; the record is
    left empty."""
    global _kept
    with _lock:
        spans, _kept = _kept, []
    return spans


@contextlib.contextmanager
def recording():
    """Record spans while the block runs, with no profiler needed (a span
    is a ``record_function`` only while one records); yields the list of
    the spans recorded on every thread while the block is open, in the
    order they opened."""
    spans: list = []
    with _lock:
        _sinks.append(spans)
    try:
        yield spans
    finally:
        with _lock:
            _sinks[:] = [s for s in _sinks if s is not spans]


def to_device(device, *arrays: np.ndarray) -> tuple:
    """The host arrays as tensors on ``device`` (copies from pageable
    memory on a card), in one ``h2d`` span; their ``nbytes`` counted in
    ``h2d_bytes``."""
    with span("h2d"):
        count("h2d_bytes", sum(a.nbytes for a in arrays))
        return tuple(torch.from_numpy(a).to(device) for a in arrays)


def to_host(t: torch.Tensor) -> np.ndarray:
    """The tensor ``t`` as a host array, in a ``sync`` span: on a card the
    copy waits for the work queued before it."""
    with span("sync"):
        return t.cpu().numpy()


def synchronize(device) -> None:
    """``torch.cuda.synchronize(device)`` in a ``sync`` span."""
    with span("sync"):
        torch.cuda.synchronize(device)
