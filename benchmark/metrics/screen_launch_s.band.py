"""``screen_launch_s.band``: ``screen_launch_s`` in the cells whose step
counts and screens in hash bands."""

from benchmark.metrics.screen_launch_s import read  # noqa: F401
