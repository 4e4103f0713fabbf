"""Host milliseconds of one U-Net call, from its start to its return,
with no synchronize (the enqueue of a forward): the mean over the
window's calls.

None where the run has nothing to read."""


def read(run):
    ns = [c.host_ns for s in run.requests for c in s.calls]
    return sum(ns) / len(ns) * 1e-6 if ns else None
