"""Spans of the vector-search service, recorded while a ``torch.profiler``
session records and only then.

A span is one tuple ``(name, id, parent, req, batch, start_ns, end_ns,
attrs)`` in a bounded ring (``CAPACITY`` spans; the oldest are dropped and
counted).  ``req`` is the id of the request's root span and ``batch`` the id
of the micro-batch's, so every span of one request shares its ``req`` and
every span of a batch its ``batch``.  Times are ``time.perf_counter_ns()``
(CLOCK_MONOTONIC), the clock ``time.perf_counter`` reads, so the spans can
be set beside any host timestamp of the same process and, through a
``record_function`` range held open on both clocks, beside the profiler's
device timeline.

Off (no profiler session), a site costs one flag read and a call: ``span``
returns one shared no-op context, and no clock is read.  The switch is the
process-wide flag that ``torch.profiler`` sets while it records
(``torch.autograd.profiler._is_profiler_enabled``); the thread-local
``torch._C._autograd._profiler_enabled()`` reads False on every thread but
the one that started the profiler, and the batcher's collector and
executor threads are other threads.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, List, Optional, Tuple

from torch.autograd import profiler as _profiler

CAPACITY = 65536

_ring: "collections.deque[Tuple]" = collections.deque(maxlen=CAPACITY)
_ring_lock = threading.Lock()
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


def on() -> bool:
    """Whether spans are recorded: a ``torch.profiler`` session records."""
    return _profiler._is_profiler_enabled


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _append(entry: Tuple) -> None:
    global _dropped
    with _ring_lock:
        if len(_ring) == CAPACITY:
            _dropped += 1
        _ring.append(entry)


class _Span:
    """An open span: a context whose ``id``, ``req`` and ``batch`` its
    children and the spans recorded for it by other threads take."""

    __slots__ = ("name", "root", "attrs", "id", "parent", "req", "batch", "start")

    def __init__(self, name: str, root: str, attrs: dict) -> None:
        self.name, self.root, self.attrs = name, root, attrs

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.id = next(_ids)
        if stack and self.root != "batch":
            up = stack[-1]
            self.parent, self.req, self.batch = up.id, up.req, up.batch
        else:
            self.parent = None
            self.req = self.id if self.root == "req" else None
            self.batch = self.id if self.root == "batch" else None
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _stack().pop()
        _append((self.name, self.id, self.parent, self.req, self.batch, self.start, end, self.attrs))
        return False

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)


class _Off:
    """The span of a site while nothing records."""

    id = parent = req = batch = None

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_OFF = _Off()


def span(name: str, *, root: str = "req", **attrs: Any):
    """A context that records the span ``name`` around its body.  Opened
    inside another span of the same thread it is that span's child and
    takes its ``req`` and ``batch``; opened with none, it is a root and its
    own id becomes the ``req`` of its children.  A ``root="batch"`` span is
    always a root, whose own id becomes the ``batch`` of its children: a
    batch serves many requests, so it is no request's child, even where it
    runs on one request's thread (the micro-batcher's idle path)."""
    if not on():
        return _OFF
    return _Span(name, root, attrs)


def record(name: str, start_ns: int, end_ns: int, *, parent: Optional[int] = None, req: Optional[int] = None,
           batch: Optional[int] = None, **attrs: Any) -> None:
    """Record a span whose two ends were stamped (``time.perf_counter_ns``)
    apart, possibly in different threads."""
    _append((name, next(_ids), parent, req, batch, start_ns, end_ns, attrs))


def current():
    """The innermost span open on this thread, else the no-op span (whose
    ``id``, ``req`` and ``batch`` are None)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else _OFF


def spans() -> List[Tuple]:
    """A snapshot of the ring, oldest first."""
    with _ring_lock:
        return list(_ring)


def dropped() -> int:
    """How many spans the ring has dropped, oldest first, since ``clear``."""
    return _dropped


def clear() -> None:
    global _dropped
    with _ring_lock:
        _ring.clear()
        _dropped = 0
