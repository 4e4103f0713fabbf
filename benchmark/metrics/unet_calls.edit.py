"""U-Net calls per edit in the window."""

from benchmark.readers import calls_per_unit as read  # noqa: F401
