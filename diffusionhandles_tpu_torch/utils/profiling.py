"""Spans of the program's layers, and device traces.

A span names a stretch of host time at a layer boundary:

    with span("guidance.backward"):
        (grad,) = torch.autograd.grad(energy, lat)

Tracing is off by default; a span is then one check and a shared no-op
context. It is on while a `torch.profiler` profile records, and inside
`tracing()`. A span entered while tracing is on is recorded when it exits:
its name, its start and end in ns on the clock of the profiler's events
(Unix-epoch ns, `time.time_ns`), the index of its parent (the innermost
recorded span open on the same thread when it was entered, else -1), the
id of the request it belongs to, and whether a profiler recorded from its
entry to its exit. While a profiler records, a span also opens a
RecordFunction named `name`, so that it appears as a CPU event of the
trace, on the device trace's clock.

An entry point of the program opens its span with `request(name)`, which
gives the spans inside it (on its thread) a new request id, taken from a
counter that advances whether tracing is on or not. Spans named
`sync.<site>` wrap the statements at which the host waits for the device:
their count is the number of syncs, their duration the host's wait.

The record holds the last MAX_SPANS spans: `spans()` returns it and
`clear()` empties it.

    with tracing():
        handles.transform_foreground(...)
    for s in spans(): ...

    with device_trace("traces/edit"):   # open in Perfetto or chrome://tracing
        run()
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import pathlib
import threading
import time
from typing import Iterator, List, NamedTuple

import torch

MAX_SPANS = 1 << 17

_profiler_enabled = torch._C._autograd._profiler_enabled
# a RecordFunction of an op's scope, opened without the dispatcher: a tenth
# of `torch.profiler.record_function`'s host cost, and unlike its user
# annotations it adds no event on the device's timeline
_RecordFunction = torch._C._profiler._RecordFunctionFast
_NOOP = contextlib.nullcontext()
_record: collections.deque = collections.deque(maxlen=MAX_SPANS)
_indices = itertools.count()
_requests = itertools.count(1)
_lock = threading.Lock()
_forced = 0


class Span(NamedTuple):
    index: int       # unique in the process, in order of entry
    name: str
    start_ns: int    # Unix-epoch ns, the profiler's clock
    end_ns: int
    parent: int      # the parent span's index, or -1
    request: int     # the request id, or 0 outside any request
    profiled: bool   # entered and left while a profiler recorded


class _Local(threading.local):
    def __init__(self):
        self.stack: List[int] = []   # indices of the open recorded spans
        self.request = 0


_tls = _Local()


class _Recorded:
    __slots__ = ("name", "index", "parent", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _tls.stack
        self.index = next(_indices)
        self.parent = stack[-1] if stack else -1
        stack.append(self.index)
        self.start = time.time_ns()
        if _profiler_enabled():
            self.rf = _RecordFunction(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        _tls.stack.pop()
        _record.append(Span(self.index, self.name, self.start, end,
                            self.parent, _tls.request,
                            self.rf is not None and _profiler_enabled()))
        return False


def span(name: str):
    """A context that records a span named `name` if tracing is on when it
    is entered (see the module docstring)."""
    if _forced or _profiler_enabled():
        return _Recorded(name)
    return _NOOP


@contextlib.contextmanager
def request(name: str) -> Iterator[None]:
    """The span of an entry point: outside any request on this thread it
    takes a new request id for the spans inside it; inside one (an entry
    point that calls another) it keeps that request's."""
    outer = _tls.request
    if not outer:
        _tls.request = next(_requests)
    try:
        with span(name):
            yield
    finally:
        _tls.request = outer


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record spans inside the block, with or without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def spans() -> List[Span]:
    """The recorded spans, in order of their exit (the last MAX_SPANS)."""
    return list(_record)


def clear() -> None:
    _record.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Trace the block with `torch.profiler` (host ops and the program's
    spans, and the card's kernels when CUDA is available) and write
    `log_dir/trace.json`, a chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
