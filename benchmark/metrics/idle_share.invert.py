"""Idle share of the device over an inversion's traced calls, in
percent."""

from benchmark.readers import idle_share as read  # noqa: F401
