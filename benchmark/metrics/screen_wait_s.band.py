"""``screen_wait_s.band``: ``screen_wait_s`` in the cells whose step counts
and screens in hash bands."""

from benchmark.metrics.screen_wait_s import read  # noqa: F401
