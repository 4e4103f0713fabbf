"""What the metric readers (`metrics/<metric>.py`) share: each reads a
harness.Run and returns a number, or None where the run has nothing to
read (the harness then leaves the metric out of the line)."""

from __future__ import annotations


def per_unit_s(run):
    """The window's seconds over the edits, photos, ... it completed."""
    return run.window_s / run.units if run.units else None


def calls_per_unit(run):
    """U-Net calls in the window, forwards and calls that record a graph,
    over the units completed."""
    if not run.units:
        return None
    return sum(len(s.calls) for s in run.requests) / run.units


def idle_share(run):
    """Share of the traced window in which no operation ran on the device
    (the union of the device intervals, never their sum), in percent."""
    d = run.digest
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)


def roofline(kid: str):
    """The reader of kernel `kid`'s share of its roofline: the least time
    of its traced launches (counting.py at their recorded shapes) over
    their device time, in percent."""
    def read(run):
        d = run.digest
        if d is None or d.kernel_s.get(kid, 0.0) <= 0:
            return None
        return 100.0 * d.kernel_bound_s[kid] / d.kernel_s[kid]
    return read


def mfu(run):
    """The window's model FLOPs (the entry's count) over its seconds times
    the card's bf16 peak, in percent."""
    from benchmark.counting import PEAK_FLOPS
    if run.window_s <= 0:
        return None
    flops = sum(run.flops(s) for s in run.requests)
    return 100.0 * flops / (run.window_s * PEAK_FLOPS)
