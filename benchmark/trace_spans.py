"""Device time inside the program's spans, from a traced request's
profiler events.

The digest (`trace.py`) sums device time by kernel name; a reader that
splits it by the program's phase needs each device operation's launch.
An entry calls `note(session.tap)` as it serves a request: while the
harness traces that request, the tap's `on_call` is the trace session's,
which keeps its events after it stops. `share(name)` then attributes each
device operation (kernel, copy, set) to the host call that launched it,
through the profiler's correlation ids, and counts it inside a `name` span
when that launch lies within one on the same thread. Work that autograd's
thread launches in a backward lies in no span of the main thread.
"""

from __future__ import annotations

import bisect
from typing import List, Optional

_SESSIONS: List[object] = []


def note(tap) -> None:
    """Keep the trace session armed on `tap`, if any (the traced
    request's), for the readers that run after it."""
    session = getattr(getattr(tap, "on_call", None), "__self__", None)
    if session is not None and session not in _SESSIONS:
        _SESSIONS.append(session)


def _device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def share(name: str) -> Optional[float]:
    """Percent of the last noted trace's device time launched inside the
    program's `name` spans; None without a trace, a span or a device
    operation whose launch could be found."""
    if not _SESSIONS or getattr(_SESSIONS[-1], "events", None) is None:
        return None
    events = _SESSIONS[-1].events
    cpu = [e for e in events if not _device(e)]
    dev = [e for e in events if _device(e)]
    spans = {}
    for e in cpu:
        if e.name() == name:
            spans.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    if not spans or not dev:
        return None
    for iv in spans.values():
        iv.sort()
    launch = {}  # correlation id -> (host time, thread) of the launch
    for e in cpu:
        key = e.correlation_id()
        if key and (key not in launch or e.name().startswith("cu")):
            launch[key] = (e.start_ns(), e.start_thread_id())

    def inside(t: int, thread: int) -> bool:
        iv = spans.get(thread, [])
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]

    total = found = within = 0
    for e in dev:
        ns = e.duration_ns()
        total += ns
        at = launch.get(e.correlation_id()) or launch.get(
            e.linked_correlation_id())
        if at is None:
            continue
        found += ns
        if inside(*at):
            within += ns
    if not found:
        return None
    return 100.0 * within / total
