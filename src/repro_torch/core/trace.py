"""Spans of the port's launches, kept only while a ``torch.profiler`` runs.

``with span(name):`` marks a piece of a launch at the boundary where its
work happens.  While a profiler is active (``torch.autograd.profiler.
_is_profiler_enabled``) the span opens a profiler range of the same name
(a C++ ``record_function``), so the profiler's own trace holds it, and
keeps a :class:`Span` in a bounded buffer: its name, its start and end on
the host clock (``time.perf_counter`` seconds), the innermost span of the
same thread open around it (``parent``, a name) and the thread.
:func:`spans` reads the buffer and :func:`clear` empties it;
:func:`dropped` counts the spans a full buffer lost.  A span's start is
read once its range has opened and its end once it has closed, so it
sits within about a microsecond of its range's stamps, but where the
profiler works on after stamping a range's end (11-14 us after a
training step's replay on an H100's host); a host stall inside the
profiler's bookkeeping between a range's time stamp and the span's
reading (a few spans in ten thousand) puts it further.  With no profiler active a span costs one
flag test: no range, no clock reading and no allocation.

A device span is the device time between two timing events (a CUDA
graph's external events, recorded again by every replay; the host clock on
the CPU, :class:`~repro_torch.core.process._HostEvent`), taken in the
innermost span of the calling thread (:func:`device_span`).  It is kept
with that span's host start and as its child, ``end - start`` being the
device time, once its work has completed: :func:`settle` reads it
without waiting, at the next launch of its owner or in :func:`spans`.

The spans the port records, and the benchmark metric that reads each
(``perfbench/metrics/``):

* ``process.launch``: :meth:`Process.launch` (a ``SimpleMRIRecon``
  launch is its chain's, one span a call); ``launch_self_us.recon``,
  ``idle_in_launch_share.recon``.
* ``process.replay``: the graph replay inside it;
  ``replay_us_per_launch.recon``.
* ``process.capture``: a capture inside it (a graph built again inside a
  traced window shows here).
* ``train.launch``: :meth:`TrainProcess.launch`;
  ``idle_in_launch_share.train``.
* ``train.replay``: the step graph's replay inside it.
* ``train.optimizer``: the device time of the step's clip, AdamW and
  parameter cast (:func:`~repro_torch.train.step.make_train_step`), a
  device span; ``optimizer_ms.train``.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: the most spans the buffer holds; the oldest go first
LIMIT = 1 << 17

_clock = time.perf_counter
#: the profiler's range: ``record_function``'s C++ form, about 1 us of host
#: time where ``record_function`` takes about 10 (a ``cpu_op`` in the trace)
_range = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    start: float                 # host perf_counter seconds
    end: float
    parent: Optional[str]        # the innermost span open around it, same thread
    thread: int


_LOCK = threading.Lock()
_BUFFER: collections.deque = collections.deque(maxlen=LIMIT)
_dropped = 0
#: device spans whose end event has not been read yet
_PENDING: List["_Pending"] = []
#: per thread: ``open``, the spans open in it, innermost last
_LOCAL = threading.local()


def active() -> bool:
    """Whether a profiler is active, so that spans are kept."""
    return _autograd_profiler._is_profiler_enabled


def _keep(s: Span) -> None:
    global _dropped
    with _LOCK:
        if len(_BUFFER) == LIMIT:
            _dropped += 1
        _BUFFER.append(s)


class _Off:
    """The span with no profiler active: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "start", "_range", "_open")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._open = getattr(_LOCAL, "open", None)
        if self._open is None:
            self._open = _LOCAL.open = []
        self._open.append(self)
        self._range = _range(self.name)
        self._range.__enter__()
        self.start = _clock()

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        end = _clock()
        self._open.pop()
        parent = self._open[-1].name if self._open else None
        _keep(Span(self.name, self.start, end, parent, threading.get_ident()))
        return False


def span(name: str):
    """A context manager that keeps the span ``name`` while a profiler is
    active, and does nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


class _Pending:
    """A device span whose events have not been read yet."""

    __slots__ = ("name", "start_event", "end_event", "ready", "start", "parent", "thread")

    def __init__(self, name, start_event, end_event, ready, start, parent, thread):
        self.name, self.start_event, self.end_event = name, start_event, end_event
        self.ready, self.start, self.parent, self.thread = ready, start, parent, thread


def device_span(name: str, start_event, end_event, ready) -> Optional[_Pending]:
    """Keep the device time from ``start_event`` to ``end_event`` as the
    span ``name``, a child of the innermost span open in this thread, at
    that span's start, once ``ready`` (an event recorded on the stream
    after the work that records the pair) has completed.  A graph's event
    is recorded when its node runs, so until then it still holds the
    replay before: ``ready``, recorded at the call, says when the pair is
    this replay's.  Returns the pending span, for its owner to
    :func:`settle` before it records the pair again; None (nothing kept)
    outside an open span."""
    opened = getattr(_LOCAL, "open", None)
    if not opened:
        return None
    p = _Pending(name, start_event, end_event, ready, opened[-1].start, opened[-1].name,
                 threading.get_ident())
    with _LOCK:
        _PENDING.append(p)
    return p


def settle(p: _Pending, last: bool = False) -> None:
    """Keep the pending span ``p`` if its work has completed, without
    waiting; with ``last`` (its events are about to be recorded again)
    drop it otherwise, counted in :func:`dropped`."""
    global _dropped
    done = p.ready.query()
    with _LOCK:
        if p not in _PENDING or not (done or last):
            return
        _PENDING.remove(p)
        if not done:
            _dropped += 1
            return
    seconds = p.start_event.elapsed_time(p.end_event) / 1e3
    _keep(Span(p.name, p.start, p.start + seconds, p.parent, p.thread))


def spans() -> List[Span]:
    """The kept spans, in the order they were kept (device spans whose
    work has completed are read first)."""
    with _LOCK:
        pending = list(_PENDING)
    for p in pending:
        settle(p)
    with _LOCK:
        return list(_BUFFER)


def dropped() -> int:
    """Spans lost since the last :func:`clear`: the oldest, to a full
    buffer, and device spans recorded again before they completed."""
    return _dropped


def clear() -> None:
    """Empty the buffer, forget pending device spans and the drop count."""
    global _dropped
    with _LOCK:
        _BUFFER.clear()
        _PENDING.clear()
        _dropped = 0
