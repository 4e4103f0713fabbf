"""The traced part of a `--trace 1` run: one request's U-Net calls from
index `first` to `last` (the mix's "trace_calls"), profiled with
`torch.profiler` (CPU and CUDA activity), and its digest.

The trace is kept in memory and never written to disk. The digest holds
what the per-layer readers take: the device's busy time as the union of
its operations' intervals (overlapping kernels count once), the traced
window, device time by kernel name, the idle gaps by the host operation
that was running in them, and per kernel id (kernels.json) its device
time, its launches by the program's counter, and the least time its
launches could take (counting.py). A kernel id whose name patterns and
launch counter disagree makes the run fail instead of reading a wrong
share.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional

import torch

from benchmark import counting
from benchmark.tap import SiteRecorder, launch_counter


class TraceError(RuntimeError):
    pass


@dataclasses.dataclass
class Digest:
    window_s: float
    busy_s: float
    device_ops: List[list]       # [[name, seconds]] by device time
    idle_gaps: List[list]        # [[host op, seconds]] by idle time
    kernel_s: Dict[str, float]   # K-id -> device seconds
    kernel_bound_s: Dict[str, float]
    launches: Dict[str, int]
    layout_copy_s: float
    device_s: float              # all device operations' time, summed


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class TraceSession:
    """Profile U-Net calls [first, last) of the request it is armed for."""

    def __init__(self, first: int, last: int):
        self.first, self.last = first, last
        self.recorder = SiteRecorder()
        self.prof = None
        self.events = None
        self._counts0: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}

    def on_call(self, index: int, module) -> None:
        if index == self.first:
            self._start()
        if index == self.last:
            self.stop()
        if self.prof is not None and self.events is None:
            self.recorder.attach(module)

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        _sync()
        self._counts0 = {k: launch_counter(v["counter"])
                         for k, v in counting.KERNELS["kernels"].items()}
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        """End the traced part (at the `last` call, or at the request's end
        if it has fewer calls)."""
        if self.prof is None or self.events is not None:
            return
        self.recorder.detach()
        _sync()
        self.prof.stop()
        self.launches = {k: launch_counter(v["counter"]) - self._counts0[k]
                         for k, v in counting.KERNELS["kernels"].items()}
        self.events = self.prof.profiler.kineto_results.events()

    def digest(self) -> Optional[Digest]:
        if self.events is None:
            return None
        return digest(self.events, self.recorder, self.launches)


def _kernel_bounds(rec: SiteRecorder) -> Dict[str, tuple]:
    """K-id -> (launches the recorded sites imply, their bound seconds)."""
    fwd = [counting.attention_fwd(*a[:5]) for a in rec.attention]
    bwd = [counting.attention_bwd(*a[:5]) for a in rec.attention if a[5]]
    k9 = [counting.gn_silu_conv3x3_fwd(*h[:6]) for h in rec.halves]
    k9 += [counting.gn_silu_conv3x3_dx(*h[:6]) for h in rec.halves if h[6]]
    return {"K1": (len(fwd), sum(counting.bound_s(*c) for c in fwd)),
            "K2": (len(bwd), sum(counting.bound_s(*c) for c in bwd)),
            "K9": (len(k9), sum(counting.bound_s(*c) for c in k9))}


def digest(events, rec: SiteRecorder, launches: Dict[str, int]) -> Digest:
    dev, cpu = [], []
    for e in events:
        kind = str(e.device_type())
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (dev if kind.endswith("CUDA") else cpu).append(span)
    if not dev:
        raise TraceError("the profiler recorded no device operation")
    lo = min(s for s, _, _ in dev + cpu)
    hi = max(e for _, e, _ in dev + cpu)
    busy = _union([[s, e] for s, e, _ in dev])
    busy_ns = sum(e - s for s, e in busy)

    by_name = collections.Counter()
    for s, e, n in dev:
        by_name[n] += e - s
    device_ops = [[n[:160], ns * 1e-9] for n, ns in by_name.most_common(10)]

    # idle gaps, named by the innermost host operation running at their
    # middle
    cpu.sort()
    starts = [s for s, _, _ in cpu]
    idle = collections.Counter()
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = "host (no profiled operation)"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            s, e, n = cpu[i]
            if e >= mid:
                name = n
                break
            i -= 1
            if mid - s > 10 ** 9:
                break
        idle[name[:160]] += b - a
    idle_gaps = [[n, ns * 1e-9] for n, ns in idle.most_common(10)]

    bounds = _kernel_bounds(rec)
    kernel_s, kernel_bound_s = {}, {}
    for kid, spec in counting.KERNELS["kernels"].items():
        match = counting.kernel_matcher(kid)
        hits = [(s, e, n) for s, e, n in dev if match(n)]
        n_launch = launches.get(kid, 0)
        per = spec.get("kernels_per_launch")
        implied, bound = bounds[kid]
        if bool(hits) != bool(n_launch):
            raise TraceError(f"{kid}: {len(hits)} kernels match its "
                             f"patterns but the program counted "
                             f"{n_launch} launches")
        if per and len(hits) != per * n_launch:
            raise TraceError(f"{kid}: {len(hits)} kernels matched, "
                             f"{per} x {n_launch} launches expected")
        if implied != n_launch:
            raise TraceError(f"{kid}: the recorded sites imply {implied} "
                             f"launches, the program counted {n_launch}")
        if hits:
            kernel_s[kid] = sum(e - s for s, e, _ in hits) * 1e-9
            kernel_bound_s[kid] = bound
    copy = counting.layout_copy_matcher()
    return Digest(
        window_s=(hi - lo) * 1e-9, busy_s=busy_ns * 1e-9,
        device_ops=device_ops, idle_gaps=idle_gaps, kernel_s=kernel_s,
        kernel_bound_s=kernel_bound_s, launches=dict(launches),
        layout_copy_s=sum(e - s for s, e, n in dev if copy(n)) * 1e-9,
        device_s=sum(e - s for s, e, _ in dev) * 1e-9)
