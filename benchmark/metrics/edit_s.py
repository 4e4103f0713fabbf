"""Seconds per edit: the window's seconds over the edits it completed."""

from benchmark.readers import per_unit_s as read  # noqa: F401
