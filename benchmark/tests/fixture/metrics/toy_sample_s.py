"""An end-to-end metric that only the harness's tests name: the window's
seconds over the samples completed in it."""

from benchmark.readers import per_unit_s as read  # noqa: F401
