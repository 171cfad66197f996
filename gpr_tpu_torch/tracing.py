"""Spans of the program's layers, on the profiler's clock.

A span marks one call at a layer boundary: an optimizer iteration, an
objective evaluation, the training step's statistics, epilogue and
backward, a predictor, a collective.  ``torch.profiler`` is the switch:

* with no profiler running, :func:`span` returns a shared no-op and costs
  one check of the profiler's state;
* while one runs, each span opens a host range in the profiler's timeline
  (``torch._C._profiler._RecordFunctionFast``: a CPU event of the function
  scope, which the profiler does not copy onto the device's timeline as it
  copies a ``record_function``; ``on_timeline=False`` opens none) and,
  when it closes, appends one :class:`Span` to an in-memory record, read
  by :func:`recorded`.

Turn it on with ``utils.profile_trace(logdir)`` (a Chrome trace) or any
``torch.profiler.profile``.  A recording holds the spans recorded since a
span last found the profiler off on the thread that began the recording:
the first span under a new profiler starts a new one (a thread the
profiler does not follow finds it off and ends nothing).  It keeps the
newest ``LIMIT`` spans and counts those it dropped.

Nesting is by time on one process-wide stack, and the root (the current
evaluation or predictor call) is one process-wide variable: the custom
backward, which autograd runs on its device thread while the caller waits
in ``torch.autograd.grad``, nests in that call's spans.  Two threads that
trace at once may nest each other's spans.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

#: spans a recording keeps (the oldest are dropped past it)
LIMIT = 1 << 20

_profiler_on = torch._C._autograd._profiler_enabled
_host_range = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_NOOP = contextlib.nullcontext()


class Span(NamedTuple):
    """One closed span: its name, its host-clock interval (``time.time_ns``,
    the profiler's epoch clock), its number in the recording (``seq``, in
    the order spans opened), the ``seq`` of the span open around it and of
    the root it ran under (-1 for none), its thread and its fields."""

    name: str
    t0_ns: int
    t1_ns: int
    seq: int
    parent: int
    root: int
    thread: int
    fields: dict


class _Recording:
    def __init__(self):
        self.spans: deque = deque(maxlen=LIMIT)
        self.dropped = 0
        self.seq = itertools.count()
        self.stack: list = []
        self.root = -1
        self.ended = False
        self.owner = None  # the thread of the recording's first span


_rec = _Recording()


class _Open:
    """An open span (the context manager :func:`span` returns while a
    profiler runs)."""

    __slots__ = ("name", "fields", "is_root", "on_timeline", "seq", "parent",
                 "prev_root", "range", "t0")

    def __init__(self, name, is_root, fields, on_timeline=True):
        self.name, self.is_root, self.fields = name, is_root, fields
        self.on_timeline = on_timeline

    def __enter__(self):
        global _rec
        if _rec.ended:
            _rec = _Recording()
        rec = _rec
        if rec.owner is None:
            rec.owner = threading.get_ident()
        self.seq = next(rec.seq)
        self.parent = rec.stack[-1] if rec.stack else -1
        self.prev_root = rec.root
        if self.is_root:
            rec.root = self.seq
        rec.stack.append(self.seq)
        self.range = None
        if self.on_timeline and _host_range is not None:
            self.range = _host_range(self.name)
            self.range.__enter__()
        # read after the range opened, so the record lies inside it
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = _rec
        if self.seq in rec.stack:
            rec.stack.remove(self.seq)
        if self.is_root:
            rec.root = self.prev_root
        if len(rec.spans) == LIMIT:
            rec.dropped += 1
        rec.spans.append(Span(self.name, self.t0, t1, self.seq, self.parent,
                              self.seq if self.is_root else rec.root,
                              threading.get_ident(), self.fields))
        return False


def span(name: str, *, root: bool = False, on_timeline: bool = True,
         **fields):
    """A context manager that records ``name`` with ``fields`` while a
    ``torch.profiler`` runs, else does nothing.  ``root`` marks the call
    that the spans opened inside it belong to (an evaluation, a predictor
    call); ``on_timeline=False`` keeps the span out of the profiler's
    timeline, in memory only."""
    if not _profiler_on():
        if _rec.owner == threading.get_ident():
            _rec.ended = True
        return _NOOP
    return _Open(name, root, fields, on_timeline)


def host_read(t: torch.Tensor):
    """``t.item()``, the host's read of a device scalar, inside a
    ``gpr.optim.host_read`` span: its count is the reads, its duration the
    host's wait for the device."""
    with span("gpr.optim.host_read"):
        return t.item()


def recorded() -> list:
    """The current recording's spans, in the order they closed."""
    return list(_rec.spans)


def dropped() -> int:
    """Spans the current recording dropped past ``LIMIT``."""
    return _rec.dropped


def clear() -> None:
    """Drop the recording."""
    global _rec
    _rec = _Recording()
