"""Spans of the ensemble call path, recorded while ``torch.profiler`` runs.

The profiler is the only switch. With it off a span costs one check of
its flag: no clock read, no allocation, no profiler annotation. With it
on, each span is kept in memory (:func:`spans`, at most ``CAPACITY``
records; :func:`dropped` counts the rest) and entered as a profiler
annotation of the same name, so it shows in the profiler's tables and
in its Chrome trace.

A span holds its name, its start and end on ``time.time_ns()`` (the
clock of the profiler's own events on Linux, so the two compare
directly), the call it belongs to (one id per ``ensemble_solve``, -1
outside one), the driver iteration (-1 where none) and the index of its
parent in :func:`spans` (-1 for a top-level span).

The top-level spans of a call are its phases and never nest in each
other:

* ``vec_ode.entry``: ``ensemble_solve``'s checks, norm dispatch, save
  grid, h0 check and choice of route;
* ``vec_ode.loop.launch``: the loop route's preparation and each launch
  of the loop kernel;
* ``vec_ode.driver.init``: the host driver's step function and carry;
* ``vec_ode.driver.step``: one driver iteration, with its index;
* ``vec_ode.solution``: the ``Solution``: saves, counters, the grid per
  trajectory;
* ``vec_ode.sync.<site>``: a read of the device by the host
  (:func:`read`), top level where it is a loop's condition
  (``driver_cond``, ``loop_cond``), nested in its phase elsewhere
  (``grid``: the save grid's checks). Their count is the count of host
  syncs.

A span (not a read) that opens right where the last span of its level
closed, with the same name, call, iteration and parent, extends that
span: a phase that two functions share (the loop's preparation and its
launch; the driver's Solution and the ensemble's grid per trajectory) is
one span, which then brackets both of its annotations.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

CAPACITY = 1 << 20
SYNC = "vec_ode.sync."

_profiling = torch._C._autograd._profiler_enabled
# the profiler's annotation; its lighter form where this torch has one
_annotate = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
             or torch.profiler.record_function)
_clock = time.time_ns
_OFF = contextlib.nullcontext()
_calls = itertools.count()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int      # -1 while the span is open
    call: int
    iteration: int
    parent: int


class _Log:
    """The records of every thread: [name, start, end, call, iteration,
    parent] in the order the spans opened."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records = []
        self.dropped = 0


class _Thread(threading.local):
    """A thread's open spans, (index, record) each (index -1: dropped),
    the one that closed last at the current level, and its call id."""

    def __init__(self):
        self.stack = []
        self.last = None
        self.call = -1


_log = _Log()
_thread = _Thread()


class _Span:
    __slots__ = ("name", "iteration", "merge", "entry", "ann")

    def __init__(self, name: str, iteration: int, merge: bool):
        self.name, self.iteration, self.merge = name, iteration, merge

    def __enter__(self):
        start = _clock()
        th, log = _thread, _log
        parent = th.stack[-1][0] if th.stack else -1
        last, th.last = th.last, None
        if (self.merge and last is not None and last[0] >= 0
                and last[1][0] == self.name
                and last[1][3:] == [th.call, self.iteration, parent]):
            entry = last
        else:
            rec = [self.name, start, -1, th.call, self.iteration, parent]
            with log.lock:
                if len(log.records) < CAPACITY:
                    entry = (len(log.records), rec)
                    log.records.append(rec)
                else:
                    log.dropped += 1
                    entry = (-1, rec)
        th.stack.append(entry)
        self.entry = entry
        self.ann = _annotate(self.name)
        self.ann.__enter__()
        return self

    def __exit__(self, *exc):
        self.ann.__exit__(*exc)
        th = _thread
        th.stack.pop()
        th.last = self.entry
        self.entry[1][2] = _clock()
        return False


class _Call:
    __slots__ = ("prev",)

    def __enter__(self):
        th = _thread
        self.prev, th.call, th.last = th.call, next(_calls), None
        return self

    def __exit__(self, *exc):
        _thread.call = self.prev
        return False


def span(name: str, iteration: int = -1):
    """The span ``name`` over a ``with`` block, or a no-op where the
    profiler is off."""
    if not _profiling():
        return _OFF
    return _Span(name, iteration, True)


def call():
    """One ensemble solve over a ``with`` block: its spans share a new call
    id (a no-op where the profiler is off)."""
    if not _profiling():
        return _OFF
    return _Call()


def read(site: str, value: torch.Tensor, done=None):
    """``value.item()``, a read of the device by the host, recorded as the
    span ``vec_ode.sync.<site>`` where the profiler is on. ``done``: a
    CUDA event recorded after a copy from the device fills the host
    tensor ``value`` (a lagged read), waited for before the read."""
    if not _profiling():
        if done is not None:
            done.synchronize()
        return value.item()
    with _Span(SYNC + site, -1, False):
        if done is not None:
            done.synchronize()
        return value.item()


def spans() -> list:
    """Every recorded :class:`Span`, in the order they opened."""
    with _log.lock:
        return [Span(*r) for r in _log.records]


def dropped() -> int:
    """Spans left out since the last :func:`clear`, the list being full."""
    return _log.dropped


def clear() -> None:
    """Forget every recorded span (between solves: a span open across a
    clear keeps its index into the list it was recorded in)."""
    with _log.lock:
        _log.records = []
        _log.dropped = 0
