"""The allocator's peak over the window (reset at its start, the models
included), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
