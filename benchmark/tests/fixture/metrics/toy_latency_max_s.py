"""An end-to-end metric that only the harness's tests name: the longest
time from a request's arrival to its finish."""


def read(run):
    return max(s.timing.finish - s.timing.arrival for s in run.requests)
