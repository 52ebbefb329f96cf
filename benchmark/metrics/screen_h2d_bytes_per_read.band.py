"""``screen_h2d_bytes_per_read.band``: ``screen_h2d_bytes_per_read`` in the
cells whose step counts and screens in hash bands."""

from benchmark.metrics.screen_h2d_bytes_per_read import read  # noqa: F401
