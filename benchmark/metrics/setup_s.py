"""Seconds from the process's start to the window's first request:
imports, the kernels, the weights, the cell's own set-up and warm-up."""


def read(run):
    return run.setup_s
