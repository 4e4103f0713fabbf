"""A per-layer metric that only the harness's tests name: the requests
the window served."""


def read(run):
    return len(run.requests)
