"""``screen_self_s.band``: ``screen_self_s`` in the cells whose step counts
and screens in hash bands."""

from benchmark.metrics.screen_self_s import read  # noqa: F401
