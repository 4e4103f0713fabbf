"""Phase timers and device traces.

The counterpart of the JAX package's `utils/profiling.py`: per-phase
wall-clock totals, synchronized with the card at each phase's end so that
asynchronous launches do not hide work, and a `torch.profiler` trace:

    with phase_timer("guided_inference"):
        ...
    print(report())

    with device_trace("traces/edit"):   # open in Perfetto or chrome://tracing
        run()
"""

from __future__ import annotations

import contextlib
import pathlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase_timer(name: str) -> Iterator[None]:
    """Accumulate wall clock under `name`; at exit, wait for the card's
    work when CUDA is initialized (the JAX package's effects barrier)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - start
        with _lock:
            _totals[name] += dt
            _counts[name] += 1


def report(reset: bool = False) -> str:
    with _lock:
        lines = ["phase                          total_s   calls   mean_s"]
        for name in sorted(_totals, key=lambda k: -_totals[k]):
            t, n = _totals[name], _counts[name]
            lines.append(f"{name:<30} {t:8.3f} {n:7d} {t / n:8.3f}")
        if reset:
            _totals.clear()
            _counts.clear()
    return "\n".join(lines)


def timings() -> Dict[str, float]:
    with _lock:
        return dict(_totals)


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Trace the block with `torch.profiler` (host ops, and the card's
    kernels when CUDA is available) and write `log_dir/trace.json`, a
    chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
