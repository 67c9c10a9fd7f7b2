"""Spans of the training step and the prefetch worker, kept in memory.

The recorder follows the profiler: ``Trainer`` calls ``follow_profiler``
once a step on the thread that steps, which turns recording on exactly
while ``torch.profiler`` runs there.  Each turn from off to on starts a
new session and clears the buffer (two profiler runs with no step
between them make one session).  While recording is off ``span``
returns one shared no-op context (no clock read, no
``record_function``), so an untraced step pays a few microseconds.

While it is on:

  - ``span(name)`` records ``Span(name, thread, start, end, ordinal)``
    on the ``time.perf_counter`` clock, the ordinal being the step that
    ``follow_profiler`` was last given, and enters
    ``torch.profiler.record_function(name)``, so that the span is also
    in the profiler's trace, on the device trace's clock;
  - ``record(name, start, end, ordinal)`` keeps a span whose clock reads
    the caller already took, in memory only: the prefetch worker's
    (``prefetch.pack``, ``prefetch.copy``), on a thread the profiler
    does not record.

``spans()`` returns the session's records, oldest first; the buffer
keeps the newest ``CAPACITY``.  The spans and what reads them
(``perfbench/metrics/``): ``trainer.step``, the step's body after its
batch is drawn; ``trainer.forward`` (the loss, with the autodiff
readout's create-graph backward), ``trainer.backward``,
``trainer.optimizer`` (norm, clip, Adam) and ``trainer.read`` (the
step's one device read) inside it; the worker's ``prefetch.pack`` (the
source: sampling and packing) and ``prefetch.copy`` (pin, copy, wait
for the copy) per item.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple

import torch

# records kept: a few thousand steps of five step spans and two
# worker spans each
CAPACITY = 1 << 15


class Span(NamedTuple):
    name: str
    thread: int
    start: float
    end: float
    ordinal: int


_NULL = contextlib.nullcontext()
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_on = False
_ordinal = 0


def follow_profiler(ordinal: int = 0) -> bool:
    """Record while a profiler runs on the calling thread; a turn from
    off to on starts a new session.  ``ordinal`` is the step the next
    ``span``s belong to.  Returns whether recording is on."""
    global _on, _ordinal
    on = torch.autograd._profiler_enabled()
    if on and not _on:
        _records.clear()
    _on, _ordinal = on, ordinal
    return on


def on() -> bool:
    """Whether spans are being recorded."""
    return _on


class _Span:
    __slots__ = ("name", "start", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the clock first: entering the profiler's range runs an operator
        # that lets go of the GIL, and taking it back may wait for another
        # thread, while the profiler's own start is taken inside
        self._rf = torch.profiler.record_function(self.name)
        self.start = time.perf_counter()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self._rf.__exit__(*exc)
        _records.append(Span(self.name, threading.get_ident(), self.start,
                             end, _ordinal))
        return False


def span(name: str):
    """A context that records ``name`` while recording is on, and does
    nothing otherwise."""
    return _Span(name) if _on else _NULL


def record(name: str, start: float, end: float, ordinal: int) -> None:
    """Keep a span timed by the caller (``time.perf_counter`` seconds);
    the caller checks ``on()`` first."""
    _records.append(Span(name, threading.get_ident(), start, end, ordinal))


def spans() -> list[Span]:
    """The current session's records, oldest first."""
    return list(_records)
