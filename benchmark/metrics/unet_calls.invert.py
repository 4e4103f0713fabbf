"""U-Net calls per inverted photo in the window (the null-text loop's
early stop included)."""

from benchmark.readers import calls_per_unit as read  # noqa: F401
