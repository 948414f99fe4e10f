"""Spans of the port's host work, on the profiler's timeline and on the
host's ``perf_counter``.

``with span(name, **attrs):`` marks one stretch of host work.  While no
``torch.profiler`` records on the calling thread
(``torch.autograd._profiler_enabled()`` is false, as in every timed run),
``span`` returns one shared null context and does nothing else: no clock
read, no ``record_function``, nothing kept.  While a profiler records, the
span opens a ``torch.profiler.record_function`` of its name, so it lies on
the device trace's timeline, and on leaving it appends a :class:`Record`
to a bounded buffer: its name, id, the id of the span open around it on the
same thread (its parent), the thread, its ends in ``time.perf_counter_ns()``
and its attributes.  :func:`spans` returns a copy of the buffer, and
:func:`clear` empties it.

The profiler's recording state is per thread and does not follow work
handed to a pool's thread.  A worker's span is :func:`thread_span`, which
records into the buffer unconditionally (and opens no ``record_function``:
the profiler would not see it there); it is opened only where the thread
that handed the work over found :func:`recording` true.

A span never stays open across a ``yield``: a generator's consumer's time
is not the generator's.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

LIMIT = 1 << 16   # records kept; the oldest go first

recording = torch.autograd._profiler_enabled


class Record(NamedTuple):
    name: str
    id: int
    parent: int | None   # the span open around it on its thread
    thread: int          # threading.get_ident()
    t0: int              # time.perf_counter_ns() at its start
    t1: int              # ... and at its end
    attrs: dict


_records = deque(maxlen=LIMIT)
_ids = itertools.count(1)
_local = threading.local()


class _Null:
    """The span while nothing records: enters, sets and leaves as a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "profiled", "rf", "id", "parent", "t0")

    def __init__(self, name, attrs, profiled):
        self.name, self.attrs, self.profiled = name, attrs, profiled

    def set(self, **attrs):
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        if self.profiled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.profiled:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        _records.append(Record(self.name, self.id, self.parent,
                               threading.get_ident(), self.t0, t1,
                               self.attrs))
        return False


def span(name, **attrs):
    """A span named ``name`` over the ``with`` block: recorded where a
    ``torch.profiler`` records on this thread, else the shared null
    context (beyond the call's own keyword dict, one flag check).  The
    context's ``set(**attrs)`` adds attributes known later."""
    if not recording():
        return NULL
    return _Span(name, attrs, True)


def thread_span(name, **attrs):
    """A span on a pool's thread, recorded into the buffer only (no
    ``record_function``); open it only where the thread that handed the
    work over found :func:`recording` true."""
    return _Span(name, attrs, False)


def spans():
    """A copy of the recorded spans, oldest first (at most ``LIMIT``)."""
    return list(_records)


def clear():
    """Forget every recorded span."""
    _records.clear()
