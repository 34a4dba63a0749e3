"""Host spans of the TN-KDE query and serve path, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session records; there is
no other switch. Off, :func:`span` reads the profiler's one module-level
flag and returns a shared no-op context: no clock reading, no allocation of
its own, no stack. On, a span

* opens ``torch.profiler.record_function("repro_torch." + name)``, so the
  range sits in the device trace on the profiler's own clock;
* stamps ``t0_ns`` / ``t1_ns`` with :func:`time.time_ns`, the clock the
  profiler stamps host events with (Unix-epoch nanoseconds);
* appends a :class:`Record` to a bounded in-memory buffer (:data:`CAPACITY`
  records; the spans past it are counted in :func:`dropped`). The parent is
  the innermost span open on the same thread.

A span's context value is its attribute dict while tracing is on and
``None`` while it is off, so attributes learned inside the span are set
without cost when nobody records::

    with obs.span("tnkde.tables") as sp:
        ...
        if sp is not None:
            sp["hit"] = hit

Records are appended when their span closes (children before parents).
:func:`records`, :func:`clear` and :func:`dropped` are the whole export;
nothing is written to disk.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["CAPACITY", "PREFIX", "Record", "span", "records", "clear", "dropped"]

CAPACITY = 1 << 16
PREFIX = "repro_torch."


class Record(NamedTuple):
    id: int
    parent: Optional[int]  # id of the enclosing span on the same thread
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict


_buf: List[Record] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "stack", "range", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        # stamped outside the range: the record encloses the profiler's event
        self.t0 = time.time_ns()
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        return self.attrs

    def __exit__(self, *exc):
        global _dropped
        self.range.__exit__(*exc)
        t1 = time.time_ns()
        self.stack.pop()
        rec = Record(self.id, self.parent, self.name, self.t0, t1, self.attrs)
        with _lock:
            if len(_buf) < CAPACITY:
                _buf.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, **attrs):
    """A context manager timing its block as the span ``name`` while a
    profiler records; a shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def records() -> List[Record]:
    """A copy of the buffer, in the order the spans closed."""
    with _lock:
        return list(_buf)


def clear() -> None:
    """Empty the buffer and zero the dropped count."""
    global _dropped
    with _lock:
        _buf.clear()
        _dropped = 0


def dropped() -> int:
    """Spans that closed while the buffer was full."""
    return _dropped
