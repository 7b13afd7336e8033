"""Structured logging, the tracer, and a profiler hook (port of
``utils/logging.py``).

Every phase emits one JSON line and phases nest; :func:`profiler_trace`
wraps a block in a ``torch.profiler`` trace whose Chrome trace lands in a
directory.

The tracer is process-wide: :func:`span` records named host intervals with
ids, parents and a request id, in memory. It records after :func:`enable`, or while ``torch.profiler``
records; otherwise a call tests that switch and does nothing else.
Span times are ``time.time_ns()``, the clock of the profiler's events, so
spans and device intervals share one timeline; while a profiler records,
each span also opens ``record_function(name)``, and the profiler's own trace
shows the spans beside the kernels.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 20   # spans kept; older ones are dropped, and counted


class Span(NamedTuple):
    """One closed span. ``parent`` is the id of the innermost span open on
    the same thread when it opened (None for a root); ``rid`` the request id,
    given, else the parent's, else (a root) the span's own id."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    rid: Any
    attrs: Optional[Dict[str, Any]]


class _Off:
    """The context manager of a span while nothing records: no clock, no
    allocation, no record."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """An open span of :class:`Tracer`; recorded when it closes."""

    __slots__ = ("tracer", "name", "rid", "attrs", "id", "parent", "start_ns", "rf")

    def __init__(self, tracer: "Tracer", name: str, rid, attrs) -> None:
        self.tracer, self.name, self.rid, self.attrs = tracer, name, rid, attrs

    def __enter__(self):
        stack = self.tracer._stack()
        up = stack[-1] if stack else None
        self.id = next(self.tracer._ids)
        self.parent = up.id if up is not None else None
        if self.rid is None:
            self.rid = up.rid if up is not None else self.id
        stack.append(self)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def annotate(self, **attrs) -> None:
        """Adds ``attrs`` to the span, for a result known only inside it."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.tracer._stack().pop()
        self.tracer._record(Span(self.name, self.start_ns, end_ns, self.id, self.parent,
                                 self.rid, self.attrs or None))
        return False


class Tracer:
    """Spans in memory, bounded to ``max_spans`` spans (the oldest go
    first; ``dropped`` counts them). Appends take a lock, as threads
    (Felzenszwalb's batch pool, the HTTP server) record too; the parent
    stack is per thread."""

    def __init__(self, max_spans: int = MAX_SPANS) -> None:
        self.on = False
        self._spans: collections.deque = collections.deque(maxlen=max_spans)
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def span(self, name: str, rid=None, **attrs):
        """A context manager recording one span named ``name``, with request
        id ``rid`` (None: inherited) and small ``attrs``. It enters as the
        open span (see ``_Open.annotate``), or as None while nothing
        records."""
        if not (self.on or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _Open(self, name, rid, attrs)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)


TRACER = Tracer()
span, spans, clear = TRACER.span, TRACER.spans, TRACER.clear
enable, disable = TRACER.enable, TRACER.disable


class PhaseLogger:
    """JSON-line logger with nested phase timing.

    >>> log = PhaseLogger()
    >>> with log.phase("segment", image=3):
    ...     pass
    emits {"phase": "segment", "seconds": ..., "image": 3}
    """

    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream or sys.stderr
        self.enabled = enabled
        self._stack = []

    def emit(self, record: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        self.stream.write(json.dumps(record, default=str) + "\n")
        self.stream.flush()

    @contextlib.contextmanager
    def phase(self, name: str, *, span: Optional[str] = None, rid=None, **fields):
        """One phase: a span of the tracer named ``span`` (default ``name``)
        with request id ``rid`` and ``fields`` as attributes and, where the
        logger is enabled, one JSON line of the dotted phase name, its
        seconds and ``fields``."""
        with TRACER.span(span or name, rid, **fields):
            if not self.enabled:
                yield
                return
            self._stack.append(name)
            t0 = time.time_ns()
            try:
                yield
            finally:
                dt = (time.time_ns() - t0) / 1e9
                self._stack.pop()
                self.emit({"phase": ".".join(self._stack + [name]) if self._stack else name,
                           "seconds": round(dt, 6), **fields})

    def metric(self, name: str, value: float, **fields) -> None:
        self.emit({"metric": name, "value": value, **fields})


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Trace a block with ``torch.profiler`` (CPU, and CUDA where there is a
    card) when ``log_dir`` is given; the Chrome trace is written to
    ``log_dir/trace.json``, the tracer's spans among its events."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
