"""Seconds per photo: the window's seconds over the photos it
inverted."""

from benchmark.readers import per_unit_s as read  # noqa: F401
